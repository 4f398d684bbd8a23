"""Conjugate-gradient solver driven by the SpMV kernels — the 'flagship model'.

The reference library is the kernel a solver like this would call in production
(SpMV dominates CG's cost); BASELINE.json config 5 makes the CG loop the multi-host
benchmark driver.  Two variants:

  * :func:`cg_solve` — single-device, any SpMV strategy, optional ILU(0)/Jacobi
    preconditioning.
  * :func:`dist_cg_solve` — mesh-distributed: row-partitioned A, all dot products
    reduced with ``psum`` over the mesh, SpMV as in :mod:`spmv_acc_tpu.parallel.dist_spmv`.

Both run a fixed ``max_iters`` ``lax.while_loop`` with a residual-norm stopping test —
compiler-friendly control flow (no data-dependent Python branching).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..formats.containers import CSR

__all__ = ["CGResult", "cg_solve", "jacobi_preconditioner"]


class CGResult(NamedTuple):
    x: jax.Array
    iters: jax.Array
    residual_norm: jax.Array


def _vdot(a, c):
    """Vector dot at full precision (no reduced-precision contraction)."""
    return jnp.dot(a, c, precision=jax.lax.Precision.HIGHEST)


def jacobi_preconditioner(csr: CSR):
    """M^{-1} = 1/diag(A) — the cheap baseline preconditioner."""
    import numpy as np

    rp, ci, v, (m, _) = csr.to_numpy()
    diag = np.ones(m, dtype=v.dtype)
    rows = np.repeat(np.arange(m), np.diff(rp))
    on_diag = rows == ci
    diag[rows[on_diag]] = v[on_diag]
    inv = jnp.asarray(1.0 / diag)
    return lambda r: inv * r


def _cg_loop(matvec: Callable, precond: Optional[Callable], b, x0, tol, max_iters, dot):
    """Textbook preconditioned CG on arbitrary matvec/dot (local or psum-reduced)."""
    M = precond if precond is not None else (lambda r: r)

    r0 = b - matvec(x0)
    z0 = M(r0)
    state0 = (x0, r0, z0, z0, dot(r0, z0), jnp.asarray(0, jnp.int32))
    b_norm2 = dot(b, b)
    tol2 = tol * tol * jnp.maximum(b_norm2, jnp.asarray(1e-300, b.dtype))

    def cond(state):
        _, r, _, _, rz, it = state
        return jnp.logical_and(dot(r, r) > tol2, it < max_iters)

    def body(state):
        x, r, z, p, rz, it = state
        ap = matvec(p)
        alpha = rz / dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        return (x, r, z, p, rz_new, it + 1)

    x, r, _, _, _, it = jax.lax.while_loop(cond, body, state0)
    return CGResult(x=x, iters=it, residual_norm=jnp.sqrt(dot(r, r)))


def cg_solve(
    csr: CSR,
    b,
    x0=None,
    tol: float = 1e-8,
    max_iters: int = 1000,
    strategy: str = "adaptive",
    precond: Optional[Callable] = None,
):
    """Solve A x = b (A symmetric positive definite) with the strategy zoo's SpMV.

    ``precond`` is a callable ``r -> M^{-1} r``, e.g. :func:`jacobi_preconditioner`
    or the ``solve`` of :func:`spmv_acc_tpu.ops.trisolve.ilu0` (an ``ILU0`` is
    accepted as is)."""
    from ..dispatch import make_spmv_fn
    from ..ops.trisolve import ILU0

    if x0 is None:
        x0 = jnp.zeros_like(b)
    if isinstance(precond, ILU0):
        precond = precond.solve
    step, _ = make_spmv_fn(csr, alpha=1.0, beta=0.0, strategy=strategy)
    zero = jnp.zeros((csr.rows,), b.dtype)

    def matvec(v):
        return step(v, zero)

    return _cg_loop(matvec, precond, b, x0, jnp.asarray(tol, b.dtype), max_iters, _vdot)


def dist_cg_solve(
    part,
    b,
    mesh,
    tol: float = 1e-8,
    max_iters: int = 200,
    axis: str = "x",
):
    """Mesh-distributed CG on a row-partitioned SPD matrix.

    A is square-partitioned so the per-shard y rows line up with the per-shard x rows
    (requires ``partition_rows(csr, D, balance=False)`` with uniform row blocks and
    ``local_rows * D == padded x length``).  All vectors stay sharded over ``axis``;
    dot products psum over the mesh axis; SpMV gathers x inside shard_map (a
    1-hop halo exchange when the partition allows it, else an all-gather).  ``b`` must be
    the padded-length (D*local_rows,) right-hand side.
    """
    import functools

    from jax.sharding import NamedSharding, PartitionSpec as P
    from ..parallel._compat import shard_map

    D = part.num_shards
    lr = part.local_rows
    m, n = part.global_shape
    dtype = b.dtype

    # 1-hop halo exchange when every shard's (padded-coordinate) column span
    # fits its own x block plus the two neighbors — banded/FEM partitions; the
    # collective volume is then O(3 n / D) per device instead of O(n)
    import numpy as _np

    _cip = _np.asarray(part.col_idx_padded)
    _rid = _np.asarray(part.row_ids)
    use_halo = True
    for _s in range(D):
        _live = _rid[_s] < lr
        if not _live.any():
            continue
        _lo, _hi = int(_cip[_s][_live].min()), int(_cip[_s][_live].max())
        if _lo < (_s - 1) * lr or _hi >= (_s + 2) * lr:
            use_halo = False
            break

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
        check_rep=False,
    )
    def matvec_sm(values, col_idx_padded, row_ids, v_local):
        if use_halo:
            right = [(s, s + 1) for s in range(D - 1)]
            left = [(s + 1, s) for s in range(D - 1)]
            xl = jax.lax.ppermute(v_local, axis, right)
            xr = jax.lax.ppermute(v_local, axis, left)
            x_halo = jnp.concatenate([xl, v_local, xr])  # (3*lr,)
            base = (jax.lax.axis_index(axis) - 1) * lr
            prod = values[0] * x_halo[col_idx_padded[0] - base]
        else:
            x_full = jax.lax.all_gather(v_local, axis, tiled=True)  # (D*lr,) padded coords
            prod = values[0] * x_full[col_idx_padded[0]]
        y_local = jax.ops.segment_sum(
            prod, row_ids[0], num_segments=lr + 1, indices_are_sorted=True
        )[:lr]
        return y_local

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=P(), check_rep=False
    )
    def dot_sm(a, c):
        return jax.lax.psum(_vdot(a, c), axis)

    def matvec(v):
        return matvec_sm(part.values, part.col_idx_padded, part.row_ids, v)

    def dot(a, c):
        return dot_sm(a, c)

    @jax.jit
    def run(b, x0):
        return _cg_loop(matvec, None, b, x0, jnp.asarray(tol, dtype), max_iters, dot)

    x0 = jnp.zeros_like(b)
    sh = NamedSharding(mesh, P(axis))
    return run(jax.device_put(b, sh), jax.device_put(x0, sh))
