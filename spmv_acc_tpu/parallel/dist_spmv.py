"""Distributed SpMV over a device mesh via ``shard_map`` + collectives.

Row blocks of A live on different devices (``PartitionedCSR``); x is sharded the
same way.  Each step all-gathers x over the mesh axis and computes the local
row-block product.  This is the correctness-first variant SURVEY.md §7.2 calls
for; the halo-exchange optimisation (ppermute of only the needed x segments,
overlapped with local compute) keys on column-range analysis and lands on top of the
same partition layout.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from ._compat import shard_map

from .partition import PartitionedCSR

__all__ = ["dist_spmv", "make_mesh", "shard_partitioned", "dist_spmv_fn",
           "dist_spmv_halo_fn", "halo_feasible"]


def make_mesh(n_devices: int | None = None, axis: str = "x") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(devs[:n], (axis,))


def shard_partitioned(part: PartitionedCSR, mesh: Mesh, axis: str = "x") -> PartitionedCSR:
    """Place each shard's slab on its device (leading dim sharded over the mesh)."""
    sh = NamedSharding(mesh, P(axis))

    def put(a):
        return jax.device_put(a, sh)

    return PartitionedCSR(
        values=put(part.values),
        col_idx=put(part.col_idx),
        row_ids=put(part.row_ids),
        row_offset=put(part.row_offset),
        col_idx_padded=put(part.col_idx_padded),
        num_shards=part.num_shards,
        local_rows=part.local_rows,
        global_shape=part.global_shape,
        nnz=part.nnz,
    )


def _local_spmv(values, col_idx, row_ids, x_full, local_rows):
    """One shard's row-block product.  Padding lanes carry row_id == local_rows."""
    prod = values * x_full[col_idx]
    return jax.ops.segment_sum(prod, row_ids, num_segments=local_rows + 1, indices_are_sorted=True)[
        :local_rows
    ]


def dist_spmv_fn(mesh: Mesh, part: PartitionedCSR, axis: str = "x"):
    """Build the jitted distributed SpMV: (part_arrays, x_sharded) -> y_sharded.

    x enters sharded as (D * x_pad,) rows; internally all-gathered over the mesh axis.
    """
    local_rows = part.local_rows
    m, n = part.global_shape
    D = part.num_shards
    x_pad = -(-n // D)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
        check_rep=False,
    )
    def _shard_fn(values, col_idx, row_ids, x_local):
        # values/col_idx/row_ids: (1, nnz_pad) local slab; x_local: (x_pad,)
        x_full = jax.lax.all_gather(x_local, axis, tiled=True)  # (D * x_pad,)
        y_local = _local_spmv(values[0], col_idx[0], row_ids[0], x_full[:n], local_rows)
        return y_local

    @jax.jit
    def run(values, col_idx, row_ids, x_sharded):
        return _shard_fn(values, col_idx, row_ids, x_sharded)

    return run, x_pad


def halo_feasible(part: PartitionedCSR) -> bool:
    """True iff every shard's column span fits its own x block plus the two
    neighbor blocks — the condition for the 1-hop halo exchange."""
    import numpy as np

    D = part.num_shards
    n = part.global_shape[1]
    x_pad = -(-n // D)
    ci = np.asarray(part.col_idx)      # (D, nnz_pad); padding lanes carry 0
    ri = np.asarray(part.row_ids)      # padding lanes carry local_rows
    for s in range(D):
        live = ri[s] < part.local_rows
        if not live.any():
            continue
        lo, hi = int(ci[s][live].min()), int(ci[s][live].max())
        if lo < (s - 1) * x_pad or hi >= (s + 2) * x_pad:
            return False
    return True


def dist_spmv_halo_fn(mesh: Mesh, part: PartitionedCSR, axis: str = "x"):
    """Build the 1-hop HALO-EXCHANGE distributed SpMV (SURVEY.md §7's target
    design): instead of all-gathering x, each shard ppermutes only its two
    neighbor x blocks and gathers from the 3-block window.  Collective
    volume per step drops from O(n) to O(3 n / D) per device, which is what the
    ≥75% weak-scaling target needs; requires :func:`halo_feasible`."""
    local_rows = part.local_rows
    m, n = part.global_shape
    D = part.num_shards
    x_pad = -(-n // D)
    right = [(s, s + 1) for s in range(D - 1)]   # block s lands on shard s+1 (its LEFT halo)
    left = [(s + 1, s) for s in range(D - 1)]    # block s+1 lands on shard s (its RIGHT halo)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
        check_rep=False,
    )
    def _shard_fn(values, col_idx, row_ids, x_local):
        xl = jax.lax.ppermute(x_local, axis, right)   # left neighbor's block (zeros at s=0)
        xr = jax.lax.ppermute(x_local, axis, left)    # right neighbor's block (zeros at s=D-1)
        x_halo = jnp.concatenate([xl, x_local, xr])   # (3 * x_pad,)
        s = jax.lax.axis_index(axis)
        base = (s - 1) * x_pad
        cols = col_idx[0] - base                      # into the 3-block window
        prod = values[0] * x_halo[cols]
        y = jax.ops.segment_sum(prod, row_ids[0], num_segments=local_rows + 1,
                                indices_are_sorted=True)
        return y[:local_rows]

    @jax.jit
    def run(values, col_idx, row_ids, x_sharded):
        return _shard_fn(values, col_idx, row_ids, x_sharded)

    return run, x_pad


def dist_spmv(part: PartitionedCSR, x, mesh: Mesh | None = None, axis: str = "x",
              halo: bool | None = None):
    """y = A @ x with A row-partitioned over the mesh.  Returns the *padded*
    per-shard y of shape (D * local_rows,); map back to global rows via
    ``part.row_offset`` (unpad with :func:`unpad_y`).

    ``halo=None`` auto-selects the 1-hop halo exchange when every shard's
    column span allows it (banded/FEM row partitions), else all-gather."""
    mesh = mesh or make_mesh(part.num_shards, axis)
    if halo is None:
        halo = halo_feasible(part)
    build = dist_spmv_halo_fn if halo else dist_spmv_fn
    run, x_pad = build(mesh, part, axis)
    n = part.global_shape[1]
    D = part.num_shards
    xp = jnp.zeros((D * x_pad,), x.dtype).at[:n].set(x)
    xp = jax.device_put(xp, NamedSharding(mesh, P(axis)))
    return run(part.values, part.col_idx, part.row_ids, xp)


def unpad_y(part: PartitionedCSR, y_padded) -> jnp.ndarray:
    """Gather the valid rows of the padded per-shard y back into global order."""
    import numpy as np

    D, lr = part.num_shards, part.local_rows
    off = np.asarray(part.row_offset)
    m = part.global_shape[0]
    counts = np.diff(np.concatenate([off, [m]]))
    idx = np.concatenate(
        [d * lr + np.arange(counts[d]) for d in range(D)]
    ).astype(np.int32)
    return jnp.asarray(y_padded)[jnp.asarray(idx)]
