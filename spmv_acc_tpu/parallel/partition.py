"""Row-partitioning of CSR matrices over a device mesh.

The reference is strictly single-device (``hipSetDevice(0)``, cli/main.cpp:89); this
is the new-scope distribution layer demanded by BASELINE.json: contiguous row blocks
per shard (each shard's nnz padded to the global max so shapes are uniform), with x
column-sharded the same way.  Collectives run inside ``shard_map``
(:mod:`spmv_acc_tpu.parallel.dist_spmv`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.containers import CSR

__all__ = ["PartitionedCSR", "partition_rows", "balance_row_cuts", "pad_vector", "unpad_vector"]


@dataclasses.dataclass(frozen=True)
class PartitionedCSR:
    """Stacked per-shard CSR slabs, leading dim = num_shards.

    ``local_rows`` rows per shard (row-padded), ``nnz_pad`` stored elements per shard
    (nnz-padded with col 0 / value 0 / row sentinel ``local_rows``).  ``row_offset``
    maps local to global row ids.
    """

    values: jax.Array  # (D, nnz_pad)
    col_idx: jax.Array  # (D, nnz_pad) — GLOBAL column indices
    row_ids: jax.Array  # (D, nnz_pad) — LOCAL row ids, sentinel = local_rows
    row_offset: jax.Array  # (D,) int32 global first row of each shard
    # (D, nnz_pad) column indices in PADDED coordinates: global col j owned by shard
    # d (cuts[d] <= j < cuts[d+1]) maps to d*local_rows + (j - cuts[d]).  This is the
    # coordinate system of a tiled all_gather of per-shard (local_rows,) vectors —
    # used by square-partitioned solvers (dist CG) where x is sharded like y.
    col_idx_padded: jax.Array
    num_shards: int
    local_rows: int
    global_shape: Tuple[int, int]
    nnz: int

    @property
    def padded_rows(self) -> int:
        return self.num_shards * self.local_rows


def balance_row_cuts(row_ptr: np.ndarray, num_shards: int) -> np.ndarray:
    """Choose contiguous row cut points equalising nnz per shard (the distributed
    analog of flat's nnz splitting, hip-flat/flat.cpp:47-57): cut k at the row where
    cumulative nnz crosses k * nnz/D."""
    m = len(row_ptr) - 1
    nnz = int(row_ptr[-1])
    targets = (np.arange(1, num_shards) * nnz) // num_shards
    cuts = np.searchsorted(row_ptr, targets, side="left")
    return np.concatenate([[0], np.clip(cuts, 0, m), [m]]).astype(np.int64)


def partition_rows(csr: CSR, num_shards: int, balance: bool = True) -> PartitionedCSR:
    rp, ci, v, (m, n) = csr.to_numpy()
    rp = rp.astype(np.int64)
    if balance:
        cuts = balance_row_cuts(rp, num_shards)
    else:
        step = -(-m // num_shards)
        cuts = np.minimum(np.arange(num_shards + 1) * step, m)
    local_rows = int(max(np.diff(cuts).max(), 1))
    # round local rows up to a multiple of 8 for clean tiling
    local_rows = -(-local_rows // 8) * 8
    shard_nnz = rp[cuts[1:]] - rp[cuts[:-1]]
    nnz_pad = int(max(shard_nnz.max(), 1))
    nnz_pad = -(-nnz_pad // 128) * 128

    vals = np.zeros((num_shards, nnz_pad), dtype=v.dtype)
    cols = np.zeros((num_shards, nnz_pad), dtype=np.int32)
    cols_pad = np.zeros((num_shards, nnz_pad), dtype=np.int32)
    rows = np.full((num_shards, nnz_pad), local_rows, dtype=np.int32)
    # owner shard of every global column (for square layouts where x is sharded
    # like y; only meaningful when n == m, else cols_pad degenerates to clamp)
    col_cuts = np.minimum(cuts, n)
    for d in range(num_shards):
        a, b = int(rp[cuts[d]]), int(rp[cuts[d + 1]])
        k = b - a
        vals[d, :k] = v[a:b]
        cols[d, :k] = ci[a:b]
        gl_rows = np.repeat(
            np.arange(cuts[d], cuts[d + 1], dtype=np.int64), np.diff(rp[cuts[d] : cuts[d + 1] + 1])
        )
        rows[d, :k] = (gl_rows - cuts[d]).astype(np.int32)
        owner = np.clip(np.searchsorted(col_cuts, ci[a:b], side="right") - 1, 0, num_shards - 1)
        cols_pad[d, :k] = (owner * local_rows + (ci[a:b] - col_cuts[owner])).astype(np.int32)
    return PartitionedCSR(
        values=jnp.asarray(vals),
        col_idx=jnp.asarray(cols),
        row_ids=jnp.asarray(rows),
        row_offset=jnp.asarray(cuts[:-1].astype(np.int32)),
        col_idx_padded=jnp.asarray(cols_pad),
        num_shards=num_shards,
        local_rows=local_rows,
        global_shape=(m, n),
        nnz=csr.nnz,
    )


def _pad_map(part: PartitionedCSR) -> np.ndarray:
    """Global row i → padded index d*local_rows + (i - cuts[d])."""
    off = np.asarray(part.row_offset).astype(np.int64)
    m = part.global_shape[0]
    counts = np.diff(np.concatenate([off, [m]]))
    return np.concatenate(
        [d * part.local_rows + np.arange(counts[d]) for d in range(part.num_shards)]
    ).astype(np.int64)


def pad_vector(part: PartitionedCSR, v) -> jnp.ndarray:
    """Scatter a global (m,) vector into padded per-shard layout (D*local_rows,)."""
    idx = _pad_map(part)
    out = np.zeros(part.num_shards * part.local_rows, dtype=np.asarray(v).dtype)
    out[idx] = np.asarray(v)
    return jnp.asarray(out)


def unpad_vector(part: PartitionedCSR, v_padded) -> jnp.ndarray:
    """Gather the valid rows of a padded per-shard vector back to global order."""
    return jnp.asarray(np.asarray(v_padded)[_pad_map(part)])


jax.tree_util.register_pytree_node(
    PartitionedCSR,
    lambda p: (
        (p.values, p.col_idx, p.row_ids, p.row_offset, p.col_idx_padded),
        (p.num_shards, p.local_rows, p.global_shape, p.nnz),
    ),
    lambda aux, ch: PartitionedCSR(*ch, *aux),
)
