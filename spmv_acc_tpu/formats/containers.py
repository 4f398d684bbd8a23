"""Sparse-matrix containers as registered JAX pytrees.

A re-imagination of the reference's ``csr_desc<I,T>`` / ``var_csr_desc<I,T>``
(reference ``src/acc/api/types.h:8-41``): instead of raw device pointers we carry JAX
arrays inside immutable dataclasses whose *shape* is static aux-data, so they can flow
through ``jit`` / ``shard_map`` boundaries and be donated/sharded like any other pytree.

Containers:
  * :class:`CSR`  — compressed sparse row; the main format (types.h:12-27).
  * :class:`COO`  — coordinate triplets; ingest format (cli/sparse_format.h:84-98).
  * :class:`BSR`  — block CSR with dense ``(bh, bw)`` blocks (new scope).
  * :class:`ELL`  — row-padded format used by the ``ell`` strategy and ELL SpMM (new
    scope; the analog of the reference's per-vector row processing, hip-vector-row/).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["CSR", "COO", "BSR", "ELL", "sparse_operation"]


class sparse_operation:
    """Transpose flag enum (reference src/acc/api/types.h:8-10)."""

    SPARSE_OPERATION_NON_TRANSPOSE = "N"
    SPARSE_OPERATION_TRANSPOSE = "T"


def _asarray_nodowncast(values) -> jax.Array:
    """``jnp.asarray`` that refuses to silently narrow float values.

    With ``jax_enable_x64`` off, ``jnp.asarray(float64_array)`` quietly produces
    f32 — downstream plans then crash (or verify wrong) far from the cause.
    Callers who want the narrowing must cast explicitly before constructing."""
    arr = np.asarray(values)
    out = jnp.asarray(arr)
    if np.issubdtype(arr.dtype, np.floating) and out.dtype.itemsize < arr.dtype.itemsize:
        raise ValueError(
            f"silent float downcast {arr.dtype} -> {out.dtype} (jax_enable_x64="
            f"{jax.config.jax_enable_x64}); cast values explicitly "
            f"(values.astype) or enable x64 before constructing the container"
        )
    return out


def _register(cls, data_fields, static_fields):
    def flatten(obj):
        return (
            tuple(getattr(obj, f) for f in data_fields),
            tuple(getattr(obj, f) for f in static_fields),
        )

    def unflatten(aux, children):
        kwargs = dict(zip(data_fields, children))
        kwargs.update(dict(zip(static_fields, aux)))
        return cls(**kwargs)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls


@dataclasses.dataclass(frozen=True)
class CSR:
    """CSR matrix: ``row_ptr`` (m+1, int32), ``col_idx`` (nnz, int32), ``values`` (nnz, T).

    ``shape`` is static metadata (pytree aux), mirroring how the reference passes
    ``rows/cols/nnz`` alongside the three device pointers (types.h:12-27).
    """

    row_ptr: jax.Array
    col_idx: jax.Array
    values: jax.Array
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def rows(self) -> int:
        return int(self.shape[0])

    @property
    def cols(self) -> int:
        return int(self.shape[1])

    @property
    def dtype(self):
        return self.values.dtype

    def astype(self, dtype) -> "CSR":
        return CSR(self.row_ptr, self.col_idx, self.values.astype(dtype), self.shape)

    @staticmethod
    def from_numpy(row_ptr, col_idx, values, shape) -> "CSR":
        return CSR(
            jnp.asarray(np.asarray(row_ptr), dtype=jnp.int32),
            jnp.asarray(np.asarray(col_idx), dtype=jnp.int32),
            _asarray_nodowncast(values),
            (int(shape[0]), int(shape[1])),
        )

    def to_numpy(self):
        return (
            np.asarray(self.row_ptr),
            np.asarray(self.col_idx),
            np.asarray(self.values),
            self.shape,
        )


@dataclasses.dataclass(frozen=True)
class COO:
    """COO triplets, the Matrix-Market ingest format (cli/sparse_format.h:84-98)."""

    rows: jax.Array
    cols: jax.Array
    values: jax.Array
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @staticmethod
    def from_numpy(rows, cols, values, shape) -> "COO":
        return COO(
            jnp.asarray(np.asarray(rows), dtype=jnp.int32),
            jnp.asarray(np.asarray(cols), dtype=jnp.int32),
            _asarray_nodowncast(values),
            (int(shape[0]), int(shape[1])),
        )


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-CSR with dense ``(bh, bw)`` blocks stored as ``values[nblocks, bh, bw]``.

    New scope relative to the reference (which is scalar CSR only): dense blocks become
    small dense products for SpMV/SpMM.
    """

    row_ptr: jax.Array  # (mb + 1,) int32 — block-row pointer
    col_idx: jax.Array  # (nblocks,) int32 — block-column index
    values: jax.Array  # (nblocks, bh, bw)
    shape: Tuple[int, int]  # element shape (m, n); multiples of (bh, bw)
    blocksize: Tuple[int, int]

    @property
    def nblocks(self) -> int:
        return int(self.values.shape[0])

    @property
    def block_rows(self) -> int:
        return self.shape[0] // self.blocksize[0]

    @property
    def nnz(self) -> int:
        """Stored element count (incl. explicit zeros inside blocks)."""
        return self.nblocks * self.blocksize[0] * self.blocksize[1]


@dataclasses.dataclass(frozen=True)
class ELL:
    """Row-padded ELLPACK slab: ``col_idx``/``values`` are ``(m_padded, width)``.

    ``col_idx`` padding entries point at column 0 with value 0 so gathers stay in
    bounds.  Produced by :func:`spmv_acc_tpu.formats.convert.csr_to_ell`.
    """

    col_idx: jax.Array  # (m_padded, width) int32
    values: jax.Array  # (m_padded, width)
    shape: Tuple[int, int]  # logical (m, n)

    @property
    def width(self) -> int:
        return int(self.values.shape[1])

    @property
    def padded_rows(self) -> int:
        return int(self.values.shape[0])


_register(CSR, ("row_ptr", "col_idx", "values"), ("shape",))
_register(COO, ("rows", "cols", "values"), ("shape",))
_register(BSR, ("row_ptr", "col_idx", "values"), ("shape", "blocksize"))
_register(ELL, ("col_idx", "values"), ("shape",))
