"""CSR vector-row SpMV as a Pallas kernel compiled through Triton.

The reference's VECTOR_ROW design (hip-vector-row/vector_row_native.hpp:13-58):
one vector of V lanes owns one row, strides its nnz, reduces across the lanes
and writes ``alpha*A@x + beta*y``.  Here one program owns a block of R rows and
holds an (R, V) tile:

  * V is a power of two from 2 to 64, chosen from avg nnz/row with the
    reference's thresholds (hip-vector-row/vector_row.cpp:15-27);
  * the program walks its rows' nnz in masked chunks of V, reading
    ``col_idx`` and ``values`` once, straight from CSR;
  * x is gathered inside the kernel (an array-indexed load);
  * the lane reduction and the alpha/beta combine end in one store of y.

No ELL padding, row-id array or scatter is involved: the kernel moves the
reference's 12 B/nnz (f64) plus the row pointers and the two y vectors.  f64
runs natively; f32 accumulates in f32.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import pallas_interpret
from .xla import axpby_finish

__all__ = ["lanes_for", "spmv_vector_row", "vector_row_ax"]

# avg nnz/row thresholds -> lanes per row (hip-vector-row/vector_row.cpp:15-27)
_LANE_THRESHOLDS = ((4, 2), (8, 4), (16, 8), (32, 16), (64, 32))
# elements of one program's (rows, lanes) tile per loop step, with 4 warps: on
# an H100, within 6% of the best tile on five corpus stand-ins (PERF.md)
TILE = 256


def lanes_for(avg_nnz_per_row: float) -> int:
    for limit, lanes in _LANE_THRESHOLDS:
        if avg_nnz_per_row <= limit:
            return lanes
    return 64


def _kernel(ab_ref, row_ptr_ref, col_ref, val_ref, x_ref, y_ref, o_ref, *,
            num_rows, block_rows, lanes):
    rows = pl.program_id(0) * block_rows + jnp.arange(block_rows, dtype=jnp.int32)
    row_ok = rows < num_rows
    start = plgpu.load(row_ptr_ref.at[rows], mask=row_ok, other=0)
    end = plgpu.load(row_ptr_ref.at[rows + 1], mask=row_ok, other=0)
    lane = jnp.arange(lanes, dtype=jnp.int32)
    acc_dtype = o_ref.dtype

    def chunk(step, acc):
        offs = start[:, None] + step * lanes + lane[None, :]
        live = offs < end[:, None]
        cols = plgpu.load(col_ref.at[offs], mask=live, other=0)
        vals = plgpu.load(val_ref.at[offs], mask=live, other=0)
        xs = plgpu.load(x_ref.at[cols], mask=live, other=0)
        return acc + vals * xs

    steps = (jnp.max(end - start) + (lanes - 1)) // lanes
    acc = jax.lax.fori_loop(jnp.int32(0), steps, chunk,
                            jnp.zeros((block_rows, lanes), acc_dtype))
    y = plgpu.load(y_ref.at[rows], mask=row_ok, other=0)
    out = ab_ref[0] * jnp.sum(acc, axis=1) + ab_ref[1] * y
    plgpu.store(o_ref.at[rows], out, mask=row_ok)


@functools.partial(jax.jit, static_argnames=("lanes", "tile", "interpret"))
def _vector_row_call(alpha, beta, row_ptr, col_idx, values, x, y, *, lanes, tile, interpret):
    dtype = values.dtype
    num_rows = y.shape[0]
    block_rows = max(1, tile // lanes)
    ab = jnp.stack([jnp.asarray(alpha, dtype), jnp.asarray(beta, dtype)])
    kernel = functools.partial(_kernel, num_rows=num_rows, block_rows=block_rows,
                               lanes=lanes)
    return pl.pallas_call(
        kernel,
        grid=(pl.cdiv(num_rows, block_rows),),
        out_shape=jax.ShapeDtypeStruct((num_rows,), dtype),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name=f"vector_row_v{lanes}_r{block_rows}",
    )(ab, row_ptr, col_idx, values, x.astype(dtype), y.astype(dtype))


def vector_row_ax(csr, x, y, alpha, beta, lanes: int, tile: int):
    """``alpha*A@x + beta*y`` for CSR ``A``: ``lanes`` per row (a power of two),
    ``tile`` elements per program step (``tile // lanes`` rows per program)."""
    if csr.nnz == 0:
        return axpby_finish(alpha, beta, jnp.zeros((csr.rows,), csr.values.dtype), y)
    return _vector_row_call(alpha, beta, csr.row_ptr, csr.col_idx, csr.values, x, y,
                            lanes=lanes, tile=tile, interpret=pallas_interpret())


def spmv_vector_row(alpha, beta, csr, x, y, plan):
    """Strategy entry: lanes from the plan's avg nnz/row, tile ``TILE``."""
    lanes = lanes_for(plan.stats.avg_nnz_per_row)
    return vector_row_ax(csr, x, y, alpha, beta, lanes, TILE)
