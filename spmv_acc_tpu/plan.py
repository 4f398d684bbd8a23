"""Host-side analyze pass and plan cache.

The reference's strategies that need host knowledge receive ``h_csr_desc`` alongside
the device descriptor (src/acc/api/spmv.h:20-21): adaptive samples ``row_ptr`` at
m/4..m (hip-adaptive/adaptive.cpp:24-31), flat precomputes per-chunk ``break_points``
(hip-flat/flat_imp.inl:107-152), and csr-adaptive-plus walks ``row_ptr`` once building
``break_points`` + ``first_process_block_of_row`` with a long-row flag
(hip-csr-adaptive-plus/csr_adaptive_plus_analyze.cpp:12-98).

Here this becomes a single O(m) numpy scan producing a :class:`Plan` of device
arrays, cached per (matrix, tuning) so repeated SpMV (e.g. a CG loop) amortises it —
the economics the reference profiles via its pre/calc/destroy phases
(src/acc/api/handle.h:8-13).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import DEFAULT_TUNE, TuneConfig
from .formats.containers import CSR

__all__ = ["RowStats", "Plan", "analyze", "get_plan", "clear_plan_cache"]


@dataclasses.dataclass(frozen=True)
class RowStats:
    """Matrix statistics driving the strategy picker (adaptive.cpp:24-31 analog)."""

    rows: int
    cols: int
    nnz: int
    avg_nnz_per_row: float
    max_nnz_per_row: int
    min_nnz_per_row: int
    empty_rows: int
    # nnz in each quarter of the row range (reference samples row_ptr at m/4..m)
    quarter_nnz: Tuple[int, int, int, int]
    # std/avg of row lengths — an addition for picking padded strategies
    row_len_cv: float

    @property
    def half_imbalance(self) -> float:
        """max(first half, second half) / min(...) nnz ratio (adaptive.cpp:33-40)."""
        h1 = self.quarter_nnz[0] + self.quarter_nnz[1]
        h2 = self.quarter_nnz[2] + self.quarter_nnz[3]
        lo = min(h1, h2)
        return float(max(h1, h2)) / float(max(lo, 1))


def _row_stats(row_ptr: np.ndarray, cols: int) -> RowStats:
    m = len(row_ptr) - 1
    nnz = int(row_ptr[-1])
    lens = np.diff(row_ptr)
    q = row_ptr[[m // 4, m // 2, (3 * m) // 4, m]] if m >= 4 else np.array([0, 0, 0, nnz])
    q0 = int(q[0])
    q1 = int(q[1]) - int(q[0])
    q2 = int(q[2]) - int(q[1])
    q3 = nnz - int(q[2])
    avg = nnz / max(m, 1)
    std = float(lens.std()) if m else 0.0
    return RowStats(
        rows=m,
        cols=cols,
        nnz=nnz,
        avg_nnz_per_row=avg,
        max_nnz_per_row=int(lens.max()) if m else 0,
        min_nnz_per_row=int(lens.min()) if m else 0,
        empty_rows=int((lens == 0).sum()),
        quarter_nnz=(q0, q1, q2, q3),
        row_len_cv=std / max(avg, 1e-30),
    )


@dataclasses.dataclass(frozen=True)
class Plan:
    """Device-side analysis arrays shared by the strategy zoo.

    ``row_ids`` plays the role the implicit row loop plays in the reference's
    kernels; ``chunk_first_row`` is the flat strategy's break_points array
    (flat_imp.inl:107-131).
    """

    stats: RowStats
    # (nnz,) int32: row index of every stored element (sorted ascending)
    row_ids: jax.Array
    # (nnz_padded,) padded to the flat chunk size with row id == rows (out of range)
    nnz_padded: int
    chunk_nnz: int
    num_chunks: int
    # (num_chunks + 1,) int32: first row touched by each chunk (flat break_points)
    chunk_first_row: jax.Array
    tune: TuneConfig


def analyze(csr: CSR, tune: TuneConfig = DEFAULT_TUNE) -> Plan:
    """O(m)+O(nnz) host scan — the csr_adaptive_plus_analyze.cpp:12-98 analog."""
    row_ptr = np.asarray(csr.row_ptr)
    m, n = csr.shape
    nnz = csr.nnz
    stats = _row_stats(row_ptr, n)

    row_ids = np.repeat(np.arange(m, dtype=np.int32), np.diff(row_ptr))

    chunk_nnz = tune.flat_chunk_nnz
    num_chunks = max(1, -(-nnz // chunk_nnz))
    nnz_padded = num_chunks * chunk_nnz
    if nnz_padded > nnz:
        pad = np.full(nnz_padded - nnz, m, dtype=np.int32)
        row_ids_p = np.concatenate([row_ids, pad])
    else:
        row_ids_p = row_ids
    # first row of each chunk boundary: searchsorted right then -1, clamped
    bounds = np.arange(num_chunks + 1, dtype=np.int64) * chunk_nnz
    cfr = np.searchsorted(row_ptr, np.minimum(bounds, nnz), side="right") - 1
    cfr = np.clip(cfr, 0, m).astype(np.int32)

    return Plan(
        stats=stats,
        row_ids=jnp.asarray(row_ids_p),
        nnz_padded=nnz_padded,
        chunk_nnz=chunk_nnz,
        num_chunks=num_chunks,
        chunk_first_row=jnp.asarray(cfr),
        tune=tune,
    )


# --- plan cache -------------------------------------------------------------
# Keyed on the identity of the CSR's values array buffer + tuning. A CG loop reuses
# the same CSR object, so repeated spmv() calls hit the cache.
_PLAN_CACHE: dict = {}


def get_plan(csr: CSR, tune: TuneConfig = DEFAULT_TUNE) -> Plan:
    key = (id(csr.row_ptr), csr.shape, csr.nnz, tune)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = analyze(csr, tune)
        _PLAN_CACHE[key] = plan
    return plan


def clear_plan_cache():
    _PLAN_CACHE.clear()
