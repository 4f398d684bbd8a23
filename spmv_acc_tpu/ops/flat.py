"""Flat strategy: pure nnz-splitting — the XLA analog of hip-flat (the HPDC'23
paper's first algorithm, flat_imp.inl / flat_reduce.hpp).

The GPU version assigns each block a fixed nnz chunk, stages products in LDS, and
resolves rows crossing chunk borders with atomicAdd (flat_reduce.hpp:65-156).  Here
the same decomposition maps to a chunked computation where cross-chunk accumulation
is deterministic:

  1. products = values * x[cols]   (XLA native gather)
  2. per-chunk segment sums keyed by *local* row offset (row - chunk_first_row),
     bounded by ``max_rows_per_chunk`` from the analyze pass (the break_points
     array, flat_imp.inl:107-131)
  3. scatter-add of the (num_chunks, max_rows_per_chunk) partials onto y — at most
     two chunks touch any row boundary, so this is the fixup pass the GPU does with
     atomics, expressed as one segment_sum over static shapes.

For matrices whose chunks span few rows (avg nnz/row ≥ chunk/rows ratio) this keeps
every intermediate in small tiles; when a single chunk can span many
rows the plan falls back to the direct segment-sum formulation (equivalent math,
``jax.ops.segment_sum`` with sorted indices).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .xla import axpby_finish

__all__ = ["spmv_flat"]

# If one chunk can span more rows than this, the two-level decomposition stops
# paying (partials tensor bloats); use the direct sorted segment sum instead.
MAX_ROWS_PER_CHUNK = 1024


@functools.partial(jax.jit, static_argnames=("num_rows", "num_chunks", "chunk_nnz", "max_rpc"))
def _flat_two_level(values, col_idx, row_ids, chunk_first_row, x, num_rows, num_chunks, chunk_nnz, max_rpc):
    nnz_pad = num_chunks * chunk_nnz
    prod = values * x[col_idx]
    if nnz_pad > prod.shape[0]:
        pad = jnp.zeros((nnz_pad - prod.shape[0],), prod.dtype)
        prod = jnp.concatenate([prod, pad])
        row_ids = jnp.concatenate(
            [row_ids, jnp.full((nnz_pad - row_ids.shape[0],), num_rows, jnp.int32)]
        )
    prod = prod.reshape(num_chunks, chunk_nnz)
    rows = row_ids.reshape(num_chunks, chunk_nnz)
    first = chunk_first_row[:num_chunks][:, None]  # (C, 1)
    local = jnp.clip(rows - first, 0, max_rpc - 1)
    # mask padding rows (sentinel == num_rows) into the last local slot with 0 value
    valid = rows < num_rows
    prod = jnp.where(valid, prod, 0.0)
    # per-chunk local segment sums via one-dimension-batched scatter-add
    partial = jax.vmap(
        lambda p, l: jax.ops.segment_sum(p, l, num_segments=max_rpc, indices_are_sorted=True)
    )(prod, local)  # (C, max_rpc)
    # global fixup: partial[c, r] belongs to row chunk_first_row[c] + r
    out_rows = first + jax.lax.broadcasted_iota(jnp.int32, (num_chunks, max_rpc), 1)
    out_rows = jnp.minimum(out_rows, num_rows)  # clamp pad rows to sink
    y = jax.ops.segment_sum(
        partial.reshape(-1), out_rows.reshape(-1), num_segments=num_rows + 1
    )
    return y[:num_rows]


@functools.partial(jax.jit, static_argnames=("num_rows",))
def _flat_direct(values, col_idx, row_ids, x, num_rows):
    prod = values * x[col_idx]
    return jax.ops.segment_sum(
        prod, row_ids, num_segments=num_rows, indices_are_sorted=True
    )


def spmv_flat(alpha, beta, csr, x, y, plan):
    import numpy as np

    nnz = csr.nnz
    m = csr.rows
    cfr = np.asarray(plan.chunk_first_row)
    max_rpc = int((cfr[1:] - cfr[:-1]).max()) + 1 if len(cfr) > 1 else m
    # +1: a chunk may end mid-row, touching first_row..first_row+span inclusive
    max_rpc = min(-(-max_rpc // 8) * 8, MAX_ROWS_PER_CHUNK)
    span_ok = bool(((cfr[1:] - cfr[:-1]) + 1 <= max_rpc).all()) if len(cfr) > 1 else False
    if span_ok and plan.num_chunks > 1:
        ax = _flat_two_level(
            csr.values,
            csr.col_idx,
            plan.row_ids[:nnz],
            plan.chunk_first_row,
            x,
            m,
            plan.num_chunks,
            plan.chunk_nnz,
            max_rpc,
        )
    else:
        ax = _flat_direct(csr.values, csr.col_idx, plan.row_ids[:nnz], x, m)
    return axpby_finish(alpha, beta, ax, y)
