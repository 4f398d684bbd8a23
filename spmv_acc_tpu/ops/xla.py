"""Pure-XLA SpMV strategies (no Pallas) — correctness anchors and fusion baselines.

These re-imagine the reference's strategy zoo for XLA's compilation model: every
strategy is a jittable function with the uniform contract

    y_out = strategy(alpha, beta, csr_arrays..., x, y, plan_arrays...)

mirroring the reference's single ``*_sparse_spmv(trans, alpha, beta, desc, x, y)``
signature (src/acc/strategy_picker.cpp:19-65).  Shapes are static; the host ``Plan``
carries what the GPU computed in analysis kernels (break points, row ids).

Strategies here:
  * ``spmv_default``   — scatter-add segment sum; the sanity kernel
    (analog of src/acc/hip/spmv_hip_acc_imp.cpp:15-35).
  * ``spmv_line``      — stage all products, prefix-scan, take row-boundary
    differences: the CSR-Stream/"line" idea (hip-line/line_imp_one_pass.inl:52-86)
    expressed as cumsum + gather, which XLA pipelines over HBM.
  * ``spmv_ell``       — row-padded dense reduction (vector-row analog,
    hip-vector-row/vector_row_native.hpp:13-58): each row is one padded lane-vector.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["spmv_default", "spmv_line", "spmv_ell", "spmm_ell", "axpby_finish"]


@jax.jit
def axpby_finish(alpha, beta, ax, y):
    """y_out = alpha*(A@x) + beta*y — true alpha/beta semantics.

    The reference's line/line-enhance/flat kernels silently assume beta == 1
    (SURVEY.md §7.3, line_imp_one_pass.inl:86); here every strategy funnels through
    this one combiner so the contract always holds.
    """
    dtype = ax.dtype
    alpha = jnp.asarray(alpha, dtype)
    beta = jnp.asarray(beta, dtype)
    return alpha * ax + beta * y.astype(dtype)


@functools.partial(jax.jit, static_argnames=("num_rows",))
def _segment_spmv(values, col_idx, row_ids, x, num_rows):
    prod = values * x[col_idx]
    return jax.ops.segment_sum(prod, row_ids, num_segments=num_rows, indices_are_sorted=True)


def spmv_default(alpha, beta, csr, x, y, plan):
    """Scatter-add segment sum over (value, col, row_id) triplets."""
    nnz = csr.nnz
    ax = _segment_spmv(csr.values, csr.col_idx, plan.row_ids[:nnz], x, csr.rows)
    return axpby_finish(alpha, beta, ax, y)


@jax.jit
def _line_core(values, col_idx, row_ptr, x):
    prod = values * x[col_idx]
    # The prefix grows to the sum of all products and a row's sum is the
    # difference of two prefixes, so the scan's rounding scales with the whole
    # matrix: an f32 scan over af23560 (484k nnz) misses rel 1e-3 on thousands
    # of rows.  The scan runs in f64 whenever x64 is on.
    s = jnp.cumsum(prod, dtype=jax.dtypes.canonicalize_dtype(jnp.float64))
    # row i sum = s[row_ptr[i+1]-1] - s[row_ptr[i]-1]; empty rows yield 0.
    zero = jnp.zeros((1,), s.dtype)
    s0 = jnp.concatenate([zero, s])
    return (s0[row_ptr[1:]] - s0[row_ptr[:-1]]).astype(prod.dtype)


def spmv_line(alpha, beta, csr, x, y, plan=None):
    """Prefix-scan formulation (CSR-Stream / hip-line analog)."""
    ax = _line_core(csr.values, csr.col_idx, csr.row_ptr, x)
    return axpby_finish(alpha, beta, ax, y)


@functools.partial(jax.jit, static_argnames=("num_rows",))
def _ell_core(ell_cols, ell_vals, x, num_rows):
    prod = ell_vals * x[ell_cols]  # (m_pad, width)
    return jnp.sum(prod, axis=1)[:num_rows]


def spmv_ell(alpha, beta, ell, x, y, num_rows):
    """Row-padded dense reduction — best when rows are near-uniform length
    (the picker's 'regular' branch; vector-row analog)."""
    ax = _ell_core(ell.col_idx, ell.values, x, num_rows)
    return axpby_finish(alpha, beta, ax, y)


@functools.partial(jax.jit, static_argnames=("num_rows",))
def _spmm_ell_core(ell_cols, ell_vals, X, num_rows):
    # (m_pad, width, k): gather rows of X then contract the width
    gathered = X[ell_cols]  # (m_pad, width, k)
    return jnp.einsum(
        "mw,mwk->mk", ell_vals, gathered, preferred_element_type=ell_vals.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )[:num_rows]


def spmm_ell(alpha, beta, ell, X, Y, num_rows):
    """Multi-RHS SpMM on the padded format; the gather amortises over RHS columns."""
    ax = _spmm_ell_core(ell.col_idx, ell.values, X, num_rows)
    return axpby_finish(alpha, beta, ax, Y)
