"""Host-side (numpy) format conversions.

The reference does COO→CSR with an OpenMP task-parallel quicksort + counting pass
(``cli/sparse_format.h:100-128``, ``cli/sort_omp.hpp:12-62``).  Here the host side is
numpy (vectorised C loops), with an optional native C++ fast path in
:mod:`spmv_acc_tpu.io.native` for the very large matrices.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .containers import BSR, COO, CSR, ELL

__all__ = [
    "coo_to_csr_arrays",
    "coo_to_csr",
    "csr_to_coo",
    "csr_to_dense",
    "csr_to_ell_arrays",
    "csr_to_ell",
    "csr_to_bsr",
    "csr_transpose_arrays",
]


def coo_to_csr_arrays(
    rows: np.ndarray, cols: np.ndarray, values: np.ndarray, shape: Tuple[int, int]
):
    """Sort (row, col) and build row_ptr by counting (cli/sparse_format.h:100-128).

    Duplicate (row, col) entries are summed (Matrix-Market symmetric mirroring can
    produce them for off-diagonal self-pairs in malformed files; summing matches
    conventional sparse-library behavior).
    """
    m, _ = shape
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    values = np.asarray(values)
    order = np.lexsort((cols, rows))
    rows, cols, values = rows[order], cols[order], values[order]
    if len(rows) > 1:
        dup = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
        if dup.any():
            keep = np.concatenate(([True], ~dup))
            group = np.cumsum(keep) - 1
            values = np.bincount(group, weights=values, minlength=group[-1] + 1).astype(
                values.dtype, copy=False
            )
            rows, cols = rows[keep], cols[keep]
    counts = np.bincount(rows, minlength=m)
    row_ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return (
        row_ptr.astype(np.int32),
        cols.astype(np.int32),
        values,
    )


def coo_to_csr(coo: COO) -> CSR:
    r = np.asarray(coo.rows)
    c = np.asarray(coo.cols)
    v = np.asarray(coo.values)
    row_ptr, col_idx, values = coo_to_csr_arrays(r, c, v, coo.shape)
    return CSR.from_numpy(row_ptr, col_idx, values, coo.shape)


def csr_to_coo(csr: CSR) -> COO:
    row_ptr = np.asarray(csr.row_ptr)
    rows = np.repeat(np.arange(csr.rows, dtype=np.int32), np.diff(row_ptr))
    return COO.from_numpy(rows, np.asarray(csr.col_idx), np.asarray(csr.values), csr.shape)


def csr_to_dense(row_ptr, col_idx, values, shape) -> np.ndarray:
    m, n = shape
    row_ptr = np.asarray(row_ptr)
    dense = np.zeros((m, n), dtype=np.asarray(values).dtype)
    rows = np.repeat(np.arange(m), np.diff(row_ptr))
    dense[rows, np.asarray(col_idx)] = np.asarray(values)
    return dense


def csr_transpose_arrays(row_ptr, col_idx, values, shape):
    """Host transpose A^T: CSR(m,n) → CSR(n,m).  Used for trans='T' and SpGEMM."""
    m, n = shape
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(np.asarray(row_ptr)))
    return coo_to_csr_arrays(np.asarray(col_idx), rows, np.asarray(values), (n, m))


def csr_to_ell_arrays(row_ptr, col_idx, values, shape, width_multiple=8, sublanes=8):
    """Pad each row to a uniform width (multiple of ``width_multiple``) and pad rows
    to a multiple of ``sublanes``.  Pad cols point at column 0 with value 0.

    This is the padded analog of assigning one fixed-size vector per row
    (hip-vector-row/vector_row.cpp:15-27): the pad width plays the vector-size role.
    Returns (ell_cols, ell_vals, width, padded_rows).
    """
    row_ptr = np.asarray(row_ptr)
    col_idx = np.asarray(col_idx)
    values = np.asarray(values)
    m = shape[0]
    lens = np.diff(row_ptr)
    width = int(lens.max()) if m else 0
    width = max(width_multiple, -(-width // width_multiple) * width_multiple)
    mp = max(sublanes, -(-m // sublanes) * sublanes)
    ell_cols = np.zeros((mp, width), dtype=np.int32)
    ell_vals = np.zeros((mp, width), dtype=values.dtype)
    # scatter: position within row
    if len(col_idx):
        rows = np.repeat(np.arange(m), lens)
        offs = np.arange(len(col_idx)) - np.repeat(row_ptr[:-1], lens)
        ell_cols[rows, offs] = col_idx
        ell_vals[rows, offs] = values
    return ell_cols, ell_vals, width, mp


def csr_to_ell(csr: CSR, width_multiple=8, sublanes=8) -> ELL:
    rp, ci, v, shape = csr.to_numpy()
    ec, ev, _, _ = csr_to_ell_arrays(rp, ci, v, shape, width_multiple, sublanes)
    import jax.numpy as jnp

    return ELL(jnp.asarray(ec), jnp.asarray(ev), csr.shape)


def csr_to_bsr(csr: CSR, blocksize=(8, 128)) -> BSR:
    """Group nnz into dense (bh, bw) blocks; zero-fill.  Host-side, numpy."""
    bh, bw = blocksize
    rp, ci, v, (m, n) = csr.to_numpy()
    mb, nb = -(-m // bh), -(-n // bw)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
    brow, bcol = rows // bh, ci.astype(np.int64) // bw
    key = brow * nb + bcol
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, starts = np.unique(key_s, return_index=True)
    nblocks = len(uniq)
    vals = np.zeros((nblocks, bh, bw), dtype=v.dtype)
    block_of = np.searchsorted(uniq, key)
    vals[block_of, rows % bh, ci % bw] = v
    b_rows = (uniq // nb).astype(np.int64)
    b_cols = (uniq % nb).astype(np.int32)
    row_ptr = np.zeros(mb + 1, dtype=np.int32)
    np.cumsum(np.bincount(b_rows, minlength=mb), out=row_ptr[1:])
    import jax.numpy as jnp

    return BSR(
        jnp.asarray(row_ptr),
        jnp.asarray(b_cols),
        jnp.asarray(vals),
        (mb * bh, nb * bw),
        (bh, bw),
    )
