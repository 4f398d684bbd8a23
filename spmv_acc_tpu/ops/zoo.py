"""The remaining work-distribution strategies of the reference zoo, re-expressed
as XLA programs.

The reference's strategies differ in HOW work maps to hardware lanes
(src/acc/CMakeLists.txt:2-14 enumerates eleven).  ``dispatch.py`` already carries
default / line / ell / flat / vector_row; this module adds XLA analogs for the
rest.  On the reference's GPU they differ by thread/wavefront/block row ownership
and reduction network; as XLA programs the degrees of freedom are the *padded
packing width* (how many consecutive slots one row owns in a dense row pack) and
the *reduction staging* (single dense reduce vs strided two-stage vs carried
rounds):

| reference strategy | GPU work unit        | analog here                           |
|--------------------|----------------------|---------------------------------------|
| THREAD_ROW         | 1 thread ↔ 1 row     | row-per-slot: width-max pack, one dense
|                    | (thread_row.inl)     | axis-1 reduce (`spmv_thread_row`)      |
| WF_ROW             | 1 wavefront ↔ 1 row  | row-per-group: (m,k,8) strided
|                    | (wavefront_row_*.hpp)| two-stage reduce (`spmv_wf_row`)       |
| BLOCK_ROW_ORDINARY | 1 block ↔ 1 row      | row-per-128-group: (m,k,128) staging
|                    | (spmv_hip_acc_imp)   | (`spmv_block_row`)                     |
| LIGHT              | dynamic atomic row   | static balanced batches; the same
|                    | queue (LightSpMV)    | vector-width heuristic drives a
|                    |                      | deterministic packing (`spmv_light`)   |
| LINE_ENHANCE       | fixed rows/block,    | `lax.scan` over fixed-size nnz rounds
|                    | nnz rounds in LDS    | with a carried row accumulator
|                    | (line_enhance_*.inl) | (`spmv_line_enhance`)                  |

All compute ``y = alpha*A@x + beta*y`` with true alpha/beta semantics via
``axpby_finish`` (the reference's line/flat variants silently assume beta==1,
SURVEY.md §7.3 — deliberately fixed here).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .xla import axpby_finish

__all__ = [
    "spmv_thread_row",
    "spmv_wf_row",
    "spmv_block_row",
    "spmv_light",
    "spmv_line_enhance",
    "spmv_acsr",
]

_PACK_CACHE: dict = {}

# Padded-width cap: without it one dense row makes the pack O(m * n) (the
# load-imbalance case LIGHT exists for in the reference,
# hip-thread-row/thread_row.cpp:17-49 gates on avg<=4 and falls back).  Rows
# longer than the cap spill their excess nnz into a COO tail handled by an
# exact segment-sum — the analog of the reference's long-row fallback.
_WIDTH_CAP = 512
# only bother spilling when the dense pack would actually be large
_SPILL_MIN_CELLS = 1 << 24


def _empty_tail(dtype):
    return (
        jnp.zeros((0,), jnp.int32),
        jnp.zeros((0,), jnp.int32),
        jnp.zeros((0,), dtype),
    )


def _row_packed(csr, width_unit: int):
    """Pad each row to a multiple of ``width_unit`` slots; returns
    (cols (m, W) int32, vals (m, W), tail) with zero padding (col 0, val 0).
    ``tail = (rows, col_idx, values)`` holds the spilled nnz of rows longer than
    the width cap (empty for bounded-width matrices)."""
    key = (id(csr.row_ptr), csr.shape, csr.nnz, "pack", width_unit, str(csr.values.dtype))
    hit = _PACK_CACHE.get(key)
    if hit is not None and hit[0] is csr.row_ptr:
        return hit[1]
    rp, ci, v, (m, n) = csr.to_numpy()
    lens = np.diff(rp)
    maxlen = max(int(lens.max()) if m else 1, 1)
    width = max(width_unit, -(-maxlen // width_unit) * width_unit)
    tail = _empty_tail(v.dtype)
    if width > _WIDTH_CAP and m * width > _SPILL_MIN_CELLS:
        width = max(width_unit, _WIDTH_CAP // width_unit * width_unit)
    rows = np.repeat(np.arange(m), lens)
    slots = np.arange(len(rows)) - np.repeat(rp[:-1], lens)
    over = slots >= width
    if over.any():
        tail = (
            jnp.asarray(rows[over].astype(np.int32)),
            jnp.asarray(ci[over].astype(np.int32)),
            jnp.asarray(v[over]),
        )
        keep = ~over
        rows, slots, ci, v = rows[keep], slots[keep], ci[keep], v[keep]
    cols = np.zeros((m, width), dtype=np.int32)
    vals = np.zeros((m, width), dtype=v.dtype)
    cols[rows, slots] = ci
    vals[rows, slots] = v
    out = (jnp.asarray(cols), jnp.asarray(vals), tail)
    _PACK_CACHE[key] = (csr.row_ptr, out)
    return out


def _add_tail(ax, tail, x, m):
    trows, tci, tv = tail
    if trows.shape[0] == 0:
        return ax
    return ax + jax.ops.segment_sum(tv * x[tci], trows, num_segments=m)


@functools.partial(jax.jit, static_argnames=())
def _reduce_flat(cols, vals, x):
    return jnp.sum(vals * x[cols], axis=1)


@functools.partial(jax.jit, static_argnames=("w",))
def _reduce_staged(cols, vals, x, w):
    m, width = cols.shape
    prod = (vals * x[cols]).reshape(m, width // w, w)
    partial = prod.sum(axis=1)  # strided accumulation (the per-lane serial loop)
    return partial.sum(axis=1)  # the cross-lane reduction (shfl/LDS tree analog)


def spmv_thread_row(alpha, beta, csr, x, y, plan=None):
    """Row-per-lane (THREAD_ROW analog, hip-thread-row/thread_row.inl:17-98).
    Best when rows are uniformly ultra-short (the reference gates on avg<=4,
    thread_row.cpp:17-49).

    The reference's five opt levels are load-staging choices (wavefront/block
    LDS staging, 2-wide unrolled loads, x-remap column reordering —
    thread_row_config.h:8-28): here the dense row-packed gather is the staged
    coalesced load; the x-remap analog is not built."""
    cols, vals, tail = _row_packed(csr, 1)
    ax = _add_tail(_reduce_flat(cols, vals, x), tail, x, csr.rows)
    return axpby_finish(alpha, beta, ax, y)


def _reduce_tree(cols, vals, x, w):
    """Strided accumulation then a log-step pairwise fold — the `__shfl_down`
    ladder analog (SHFL_DOWN_WF_REDUCE, src/acc/common/utils.h:38-59).  Same
    value set as _reduce_staged in a different summation ORDER, exactly like
    the reference's REG vs DEFAULT reduce variants."""
    m, width = cols.shape
    prod = (vals * x[cols]).reshape(m, width // w, w).sum(axis=1)
    k = w
    while k > 1:
        k //= 2
        prod = prod[:, :k] + prod[:, k : 2 * k]
    return prod[:, 0]


def _reduce_segsum(cols, vals, x, w):
    """Materialized per-slot products reduced by row ids — the LDS shared-
    memory tree analog (wavefront_row_lds.hpp:17-62): products hit 'memory'
    (an XLA buffer) before a reduce-by-key pass."""
    import jax

    m, width = cols.shape
    prod = (vals * x[cols]).reshape(-1)
    rows = jnp.repeat(jnp.arange(m, dtype=jnp.int32), width)
    return jax.ops.segment_sum(prod, rows, num_segments=m, indices_are_sorted=True)


# the WF_REDUCE build-variant analog (reference config.cmake:30-34: DEFAULT
# dpp / LDS tree / REG shfl ladder): same row-per-group assignment, three
# reduction mechanisms with distinct summation orders
_WF_REDUCERS = {"default": _reduce_staged, "reg": _reduce_tree,
                "lds": _reduce_segsum}


def _wf_reduce_mode():
    import os

    mode = os.environ.get("SPMV_WF_REDUCE", "default").lower()
    return _WF_REDUCERS.get(mode, _reduce_staged)


def spmv_wf_row(alpha, beta, csr, x, y, plan=None):
    """Row-per-sublane-group (WF_ROW analog, hip-wf-row/wavefront_row_default.hpp:48-92):
    each row's slots are strided over an 8-wide group, reduced in two stages like the
    wavefront's strided loads + shuffle tree.  `SPMV_WF_REDUCE` selects the
    reduce variant (default / reg / lds) mirroring the `WF_REDUCE` build flag
    (config.cmake:30-34)."""
    cols, vals, tail = _row_packed(csr, 8)
    ax = _add_tail(_wf_reduce_mode()(cols, vals, x, 8), tail, x, csr.rows)
    return axpby_finish(alpha, beta, ax, y)


def spmv_block_row(alpha, beta, csr, x, y, plan=None):
    """Row-per-128-group (BLOCK_ROW_ORDINARY analog,
    hip-block-row-ordinary/spmv_hip_acc_imp.cpp:16-75): all 128 lanes stride one row,
    then a tree reduce — profitable only for long rows, exactly like the original.
    Honors `SPMV_WF_REDUCE` like wf_row (the original's manual shared-memory
    tree corresponds to the 'lds' variant)."""
    cols, vals, tail = _row_packed(csr, 128)
    ax = _add_tail(_wf_reduce_mode()(cols, vals, x, 128), tail, x, csr.rows)
    return axpby_finish(alpha, beta, ax, y)


# LightSpMV vector-size thresholds from avg nnz/row (hip-light/light_spmv.cpp:16-42)
_LIGHT_THRESHOLDS = ((2, 1), (4, 2), (8, 4), (16, 8), (32, 16), (64, 32))


def spmv_light(alpha, beta, csr, x, y, plan=None):
    """LIGHT analog (LightSpMV, hip-light/spmv_hip_acc_imp.inl:35-77): the original
    balances load with a global atomic row counter claiming row batches per vector.
    Here the pack is static and atomics-free, so the same vector-size heuristic
    (avg nnz/row thresholds, light_spmv.cpp:16-42) instead selects a static packing
    width; scheduling fairness comes from the dense reduce covering all rows."""
    avg = csr.nnz / max(csr.rows, 1)
    w = 64
    for thresh, cand in _LIGHT_THRESHOLDS:
        if avg <= thresh:
            w = cand
            break
    cols, vals, tail = _row_packed(csr, w)
    if w == 1:
        ax = _reduce_flat(cols, vals, x)
    else:
        ax = _reduce_staged(cols, vals, x, w)
    return axpby_finish(alpha, beta, _add_tail(ax, tail, x, csr.rows), y)


def _acsr_bins(csr):
    """Log-scale row-length binning (ACSR analog, benchmark/acsr/ACSR.cpp:130-216,
    bins at :51-75): rows land in bin b when 2^(b-1) < len <= 2^b, and each bin
    packs its rows densely at width exactly 2^b.  Total pack memory is <= 2*nnz
    regardless of the length distribution — the fix for the global-max padding
    that power-law matrices blow up (one dense row no longer densifies every
    row).  Over-cap rows spill their excess into the shared COO tail like the
    other zoo members."""
    key = (id(csr.row_ptr), csr.shape, csr.nnz, "acsr", str(csr.values.dtype))
    hit = _PACK_CACHE.get(key)
    if hit is not None and hit[0] is csr.row_ptr:
        return hit[1]
    rp, ci, v, (m, n) = csr.to_numpy()
    lens = np.diff(rp)
    widths = np.maximum(1, np.int64(1) << np.maximum(
        0, np.ceil(np.log2(np.maximum(lens, 1))).astype(np.int64)))
    widths = np.minimum(widths, _WIDTH_CAP)
    rows_all = np.repeat(np.arange(m), lens)
    slots = np.arange(len(rows_all)) - np.repeat(rp[:-1], lens)
    over = slots >= widths[rows_all]
    tail = _empty_tail(v.dtype)
    if over.any():
        tail = (
            jnp.asarray(rows_all[over].astype(np.int32)),
            jnp.asarray(ci[over].astype(np.int32)),
            jnp.asarray(v[over]),
        )
        keep = ~over
        rows_all, slots, ci, v = rows_all[keep], slots[keep], ci[keep], v[keep]
    bins = []
    for w in np.unique(widths):
        sel_rows = np.flatnonzero(widths == w)
        inbin = widths[rows_all] == w  # O(nnz) direct lookup, no sort/search
        rnew = np.searchsorted(sel_rows, rows_all[inbin])
        cols = np.zeros((len(sel_rows), int(w)), dtype=np.int32)
        vals = np.zeros((len(sel_rows), int(w)), dtype=v.dtype)
        cols[rnew, slots[inbin]] = ci[inbin]
        vals[rnew, slots[inbin]] = v[inbin]
        bins.append((jnp.asarray(sel_rows.astype(np.int32)), jnp.asarray(cols),
                     jnp.asarray(vals), int(w)))
    out = (bins, tail)
    _PACK_CACHE[key] = (csr.row_ptr, out)
    return out


@functools.partial(jax.jit, static_argnames=("m", "ws"))
def _acsr_reduce(bin_arrays, x, m, ws):
    ax = jnp.zeros((m,), x.dtype)
    for (rows_b, cols, vals), w in zip(bin_arrays, ws):
        part = _reduce_flat(cols, vals, x) if w <= 2 else _reduce_staged(
            cols, vals, x, min(w, 128))
        ax = ax.at[rows_b].set(part.astype(x.dtype))
    return ax


def spmv_acsr(alpha, beta, csr, x, y, plan=None):
    """ACSR analog (benchmark/acsr/ACSR.cpp:130-216): one specialized reduce per
    log-scale row-length bin — the binned answer to load imbalance, vs LIGHT's
    single heuristic width.  <= log2(cap)+1 bins, each a dense (mb, 2^b) reduce."""
    bins, tail = _acsr_bins(csr)
    bin_arrays = tuple((rb, cols, vals) for rb, cols, vals, _ in bins)
    ws = tuple(w for *_, w in bins)
    ax = _acsr_reduce(bin_arrays, x, csr.rows, ws)
    return axpby_finish(alpha, beta, _add_tail(ax, tail, x, csr.rows), y)


ROUND_NNZ = 1 << 16


@functools.partial(jax.jit, static_argnames=("num_rows", "rounds", "rnnz"))
def _line_enhance_core(values, col_idx, row_ids, x, num_rows, rounds, rnnz):
    nnz_pad = rounds * rnnz
    prod = values * x[col_idx]
    if nnz_pad > prod.shape[0]:
        pad = nnz_pad - prod.shape[0]
        prod = jnp.concatenate([prod, jnp.zeros((pad,), prod.dtype)])
        row_ids = jnp.concatenate([row_ids, jnp.full((pad,), num_rows, jnp.int32)])
    prod = prod.reshape(rounds, rnnz)
    rows = row_ids.reshape(rounds, rnnz)

    def body(carry, chunk):
        p, r = chunk
        contrib = jax.ops.segment_sum(p, r, num_segments=num_rows + 1, indices_are_sorted=True)
        return carry + contrib[:num_rows], None

    out, _ = jax.lax.scan(body, jnp.zeros((num_rows,), prod.dtype), (prod, rows))
    return out


def spmv_line_enhance(alpha, beta, csr, x, y, plan):
    """LINE_ENHANCE analog (hip-line-enhance/line_enhance_spmv_imp.inl:11-95): the
    original streams a block's nnz through LDS in R rounds, accumulating per-row
    partials across rounds.  Here `lax.scan` carries the row accumulator across
    fixed-size nnz rounds — the same rounds-loop shape."""
    nnz = csr.nnz
    m = csr.rows
    rounds = max(1, -(-nnz // ROUND_NNZ))
    if rounds == 1:
        from .flat import _flat_direct

        ax = _flat_direct(csr.values, csr.col_idx, plan.row_ids[:nnz], x, m)
    else:
        ax = _line_enhance_core(
            csr.values, csr.col_idx, plan.row_ids[:nnz], x, m, rounds, ROUND_NNZ
        )
    return axpby_finish(alpha, beta, ax, y)
