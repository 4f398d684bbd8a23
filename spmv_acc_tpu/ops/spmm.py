"""CSR SpMM (multi-RHS) — new scope vs the reference (SpMV-only), per BASELINE.json
config 4: each gathered row index serves all k RHS columns.

Strategies:
  * ``spmm_segment`` — gather rows of X per nnz, segment-sum (irregular matrices).
  * ``spmm_ell``     — padded (m, width) x (width→contract) einsum (regular matrices;
    re-exported from ops.xla).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .xla import axpby_finish, spmm_ell

__all__ = ["spmm_segment", "spmm_ell", "spmm"]


@functools.partial(jax.jit, static_argnames=("num_rows",))
def _spmm_segment_core(values, col_idx, row_ids, X, num_rows):
    prod = values[:, None] * X[col_idx]  # (nnz, k)
    return jax.ops.segment_sum(prod, row_ids, num_segments=num_rows, indices_are_sorted=True)


def spmm_segment(alpha, beta, csr, X, Y, plan):
    ax = _spmm_segment_core(csr.values, csr.col_idx, plan.row_ids[: csr.nnz], X, csr.rows)
    return axpby_finish(alpha, beta, ax, Y)


def spmm(csr, X, Y=None, alpha=1.0, beta=0.0, strategy: str = "adaptive"):
    """Y_out = alpha*A@X + beta*Y with X of shape (n, k)."""
    from ..dispatch import _get_ell
    from ..plan import get_plan

    plan = get_plan(csr)
    if Y is None:
        Y = jnp.zeros((csr.rows, X.shape[1]), dtype=csr.values.dtype)
        beta = 0.0
    if strategy == "adaptive":
        s = plan.stats
        regular = s.row_len_cv < 0.5 and s.max_nnz_per_row <= 4 * max(s.avg_nnz_per_row, 1)
        strategy = "ell" if regular else "segment"
    if strategy == "ell":
        ell = _get_ell(csr, plan.tune)
        return spmm_ell(alpha, beta, ell, X, Y, csr.rows)
    if strategy == "segment":
        return spmm_segment(alpha, beta, csr, X, Y, plan)
    raise ValueError(f"unknown spmm strategy {strategy!r} (one of adaptive, ell, segment)")
