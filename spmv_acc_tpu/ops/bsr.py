"""BSR (block-CSR) SpMV/SpMM — dense (bh, bw) blocks as small dense products.

New scope vs the scalar-CSR reference: sparse structure at block granularity turns
every stored block into a dense tile op.  The gather of x happens at block
granularity (contiguous bw-wide slices), so it is a *vectorised* gather — friendlier
to device memory than scalar CSR gathers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..formats.containers import BSR
from .xla import axpby_finish

__all__ = ["bsr_spmv", "bsr_spmm"]


@functools.partial(jax.jit, static_argnames=("block_rows",))
def _bsr_spmv_core(values, col_idx, block_row_ids, x_blocks, block_rows):
    # values: (nblocks, bh, bw); x_blocks: (nb, bw)
    xb = x_blocks[col_idx]  # (nblocks, bw)
    prod = jnp.einsum("nij,nj->ni", values, xb, preferred_element_type=values.dtype,
                      precision=jax.lax.Precision.HIGHEST)
    out = jax.ops.segment_sum(
        prod, block_row_ids, num_segments=block_rows, indices_are_sorted=True
    )  # (mb, bh)
    return out.reshape(-1)


def _block_row_ids(bsr: BSR):
    import numpy as np

    rp = np.asarray(bsr.row_ptr)
    return jnp.asarray(
        np.repeat(np.arange(bsr.block_rows, dtype=np.int32), np.diff(rp))
    )


def bsr_spmv(bsr: BSR, x, y=None, alpha=1.0, beta=0.0):
    """y = alpha*A@x + beta*y on BSR.  x length must equal bsr.shape[1]."""
    bh, bw = bsr.blocksize
    if y is None:
        y = jnp.zeros((bsr.shape[0],), dtype=bsr.values.dtype)
        beta = 0.0
    xb = x.reshape(-1, bw)
    ax = _bsr_spmv_core(bsr.values, bsr.col_idx, _block_row_ids(bsr), xb, bsr.block_rows)
    return axpby_finish(alpha, beta, ax, y)


@functools.partial(jax.jit, static_argnames=("block_rows",))
def _bsr_spmm_core(values, col_idx, block_row_ids, X_blocks, block_rows):
    # X_blocks: (nb, bw, k); one batched matmul over the stored blocks
    xb = X_blocks[col_idx]  # (nblocks, bw, k)
    prod = jnp.einsum("nij,njk->nik", values, xb, preferred_element_type=values.dtype,
                      precision=jax.lax.Precision.HIGHEST)
    out = jax.ops.segment_sum(
        prod, block_row_ids, num_segments=block_rows, indices_are_sorted=True
    )  # (mb, bh, k)
    return out.reshape(out.shape[0] * out.shape[1], out.shape[2])


def bsr_spmm(bsr: BSR, X, Y=None, alpha=1.0, beta=0.0):
    bh, bw = bsr.blocksize
    if Y is None:
        Y = jnp.zeros((bsr.shape[0], X.shape[1]), dtype=bsr.values.dtype)
        beta = 0.0
    Xb = X.reshape(-1, bw, X.shape[1])
    ax = _bsr_spmm_core(bsr.values, bsr.col_idx, _block_row_ids(bsr), Xb, bsr.block_rows)
    return axpby_finish(alpha, beta, ax, Y)
