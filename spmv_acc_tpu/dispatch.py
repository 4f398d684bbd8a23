"""Public SpMV API + runtime strategy picker.

The reference picks its one strategy at *compile* time (#ifdef fan-out,
src/acc/strategy_picker.cpp:19-65) plus a runtime meta-adaptive strategy
(hip-adaptive/adaptive.cpp:16-67).  Here both collapse into one runtime
dispatch: ``spmv(..., strategy=...)`` selects a jittable kernel family, and
``strategy='adaptive'`` walks the reference's decision tree over host row statistics.
Each (strategy, matrix-shape-bucket) pair JIT-specializes exactly once — the analog of
the reference's explicit template-instantiation tables
(hip-csr-adaptive-plus/csr_adaptive_plus_spmv.cpp:195-265).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp

from .config import DEFAULT_TUNE, IMBALANCE_RATIO, SHORT_ROW_AVG_NNZ, SMALL_NNZ, TuneConfig
from .formats.containers import CSR, ELL, sparse_operation
from .formats.convert import csr_to_ell_arrays, csr_transpose_arrays
from .plan import Plan, get_plan
from .ops import xla as _xla

__all__ = ["Handle", "spmv", "pick_strategy", "STRATEGIES", "sparse_csr_spmv"]


@dataclasses.dataclass
class Handle:
    """Profiling handle (SpMVAccHanele analog, src/acc/api/handle.h:8-13):
    carries analyze/kernel phase times in µs out of a call."""

    analyze_time_us: float = 0.0
    kernel_time_us: float = 0.0
    destroy_time_us: float = 0.0  # plan eviction; ~0 here (GC'd), kept for parity
    strategy_used: str = ""


# ELL side-cache (host conversion is heavy; cache alongside the plan)
_ELL_CACHE: dict = {}

# Densifying to (m, max_row_len) is O(m * maxlen): one 4120-long row in a
# 200k-row power-law matrix makes the ELL slab ~3 GB.  The reference's analog
# gates on row stats and falls back (hip-thread-row/thread_row.cpp:17-49); the
# `ell` strategy falls back to `flat` past this cell budget.
_ELL_MAX_CELLS = 1 << 27

# GPU branch of pick_strategy: on an H100 the vector_row kernel beat every XLA
# form where the ELL slab would pad CSR by at least this factor; below it the
# padded dense reduce (`ell`) was the fastest form (PERF.md, kernel decisions).
GPU_KERNEL_MIN_ELL_PAD = 1.25


def ell_cells(plan: Plan) -> int:
    """Padded cell count the dense ELL of the plan's matrix would allocate."""
    wm = plan.tune.ell_width_multiple
    width = max(wm, -(-plan.stats.max_nnz_per_row // wm) * wm)
    return plan.stats.rows * width


def _get_ell(csr: CSR, tune: TuneConfig) -> ELL:
    key = (id(csr.row_ptr), csr.shape, csr.nnz, "ell", tune.ell_width_multiple)
    e = _ELL_CACHE.get(key)
    if e is None:
        rp, ci, v, shape = csr.to_numpy()
        ec, ev, _, _ = csr_to_ell_arrays(
            rp, ci, v, shape, width_multiple=tune.ell_width_multiple
        )
        e = ELL(jnp.asarray(ec), jnp.asarray(ev), csr.shape)
        _ELL_CACHE[key] = e
    return e


_T_CACHE: dict = {}


def _get_transposed(csr: CSR) -> CSR:
    key = (id(csr.row_ptr), csr.shape, csr.nnz, "T")
    t = _T_CACHE.get(key)
    if t is None:
        rp, ci, v, shape = csr.to_numpy()
        trp, tci, tv = csr_transpose_arrays(rp, ci, v, shape)
        t = CSR.from_numpy(trp, tci, tv, (shape[1], shape[0]))
        _T_CACHE[key] = t
    return t


def pick_strategy(plan: Plan) -> str:
    """Strategy selection: the reference's adaptive decision tree
    (hip-adaptive/adaptive.cpp:16-67) over host row statistics, mapped onto
    this zoo, with a GPU branch in front of it.

    GPU branch (measured on an H100, PERF.md): the compiled vector_row kernel
    (ops/vector_row.py) where ELL would pad the matrix by GPU_KERNEL_MIN_ELL_PAD
    or more, or past its cell budget; otherwise `ell`, the fastest XLA form on
    every corpus matrix measured.

    reference:                              mapping here:
      ① half-nnz imbalance ≥ 4×   → weighted vector-row   → 'flat' (nnz splitting is
                                                            the stronger balancer)
      ② avg nnz/row ≤ 4           → adaptive line          → 'line' (prefix-scan)
      ③ nnz ≤ 0xC00000 (12.6M)    → line-enhance           → 'ell' when rows are
                                                            near-uniform else 'flat'
      ④ nnz > 2^23                → flat                   → 'flat'
      ⑤ else                      → line-enhance           → 'flat'
    """
    s = plan.stats
    if s.rows == 0 or s.nnz == 0:
        return "default"
    if jax.default_backend() == "gpu":
        cells = ell_cells(plan)
        if cells >= GPU_KERNEL_MIN_ELL_PAD * s.nnz or cells > _ELL_MAX_CELLS:
            return "vector_row"
        return "ell"
    if s.half_imbalance >= IMBALANCE_RATIO:
        return "flat"
    if s.avg_nnz_per_row <= SHORT_ROW_AVG_NNZ:
        return "line"
    if s.nnz <= SMALL_NNZ:
        # near-uniform rows: padded dense reduce wins; irregular: nnz splitting
        if s.row_len_cv < 0.5 and s.max_nnz_per_row <= 4 * s.avg_nnz_per_row:
            return "ell"
        return "flat"
    return "flat"


def _run(strategy: str, alpha, beta, csr: CSR, x, y, plan: Plan):
    if strategy == "default":
        return _xla.spmv_default(alpha, beta, csr, x, y, plan)
    if strategy == "line":
        return _xla.spmv_line(alpha, beta, csr, x, y, plan)
    if strategy == "ell":
        if ell_cells(plan) > _ELL_MAX_CELLS:  # dense-ELL blowup guard
            from .ops import flat as _flat

            return _flat.spmv_flat(alpha, beta, csr, x, y, plan)
        ell = _get_ell(csr, plan.tune)
        return _xla.spmv_ell(alpha, beta, ell, x, y, csr.rows)
    if strategy == "flat":
        from .ops import flat as _flat

        return _flat.spmv_flat(alpha, beta, csr, x, y, plan)
    if strategy == "vector_row":
        from .ops import vector_row as _vr

        return _vr.spmv_vector_row(alpha, beta, csr, x, y, plan)
    if strategy in _ZOO:
        from .ops import zoo as _zoo

        return getattr(_zoo, f"spmv_{strategy}")(alpha, beta, csr, x, y, plan)
    raise ValueError(f"unknown strategy {strategy!r} (one of {sorted(STRATEGIES)})")


# full parity with the reference's eleven-strategy zoo (src/acc/CMakeLists.txt:2-14):
# DEFAULT->default, THREAD_ROW->thread_row, WF_ROW->wf_row, BLOCK_ROW_ORDINARY->
# block_row, LIGHT->light, VECTOR_ROW->vector_row, LINE->line, LINE_ENHANCE->
# line_enhance, FLAT->flat, ADAPTIVE->adaptive (+ ell as an addition; + acsr
# from the reference's benchmark tree, benchmark/acsr/ACSR.cpp:130-216 —
# log-scale row-length bins).  CSR_ADAPTIVE_PLUS has no build here.
_ZOO = {"thread_row", "wf_row", "block_row", "light", "line_enhance", "acsr"}
STRATEGIES = {"adaptive", "default", "line", "ell", "flat", "vector_row"} | _ZOO


def spmv(
    csr: CSR,
    x,
    y=None,
    alpha=1.0,
    beta=0.0,
    trans: str = sparse_operation.SPARSE_OPERATION_NON_TRANSPOSE,
    strategy: str = "adaptive",
    tune: TuneConfig = DEFAULT_TUNE,
    handle: Optional[Handle] = None,
):
    """``y_out = alpha * op(A) @ x + beta * y`` — the public entry point
    (analog of ``sparse_csr_spmv``, src/acc/api/spmv.h:20-21).

    ``trans='T'`` computes A^T@x via a cached host transpose (the reference accepts
    the flag but only implements 'N'; we implement both).
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r} (one of {sorted(STRATEGIES)})")
    if trans == sparse_operation.SPARSE_OPERATION_TRANSPOSE or trans == "T":
        csr = _get_transposed(csr)
    m = csr.rows
    if y is None:
        y = jnp.zeros((m,), dtype=csr.values.dtype)
        beta = 0.0
    t0 = time.perf_counter()
    plan = get_plan(csr, tune)
    t1 = time.perf_counter()
    chosen = pick_strategy(plan) if strategy == "adaptive" else strategy
    out = _run(chosen, alpha, beta, csr, x, y, plan)
    if handle is not None:
        out.block_until_ready()
        t2 = time.perf_counter()
        handle.analyze_time_us = (t1 - t0) * 1e6
        handle.kernel_time_us = (t2 - t1) * 1e6
        handle.strategy_used = chosen
    return out


_FN_CACHE: dict = {}


def make_spmv_fn(
    csr: CSR,
    alpha=1.0,
    beta=1.0,
    strategy: str = "adaptive",
    tune: TuneConfig = DEFAULT_TUNE,
):
    """Build ``step(x, y) -> y_out`` for repeated calls on one matrix.

    The plan, the strategy choice and every derived layout (ELL slab, zoo
    packs) are made once here, so a call only launches the strategy's jitted
    cores, which take the matrix arrays as arguments.  (A jit that closes over
    them would embed the whole matrix in the executable as constants.)

    Returns (step, chosen_strategy_name).
    """
    plan = get_plan(csr, tune)
    chosen = pick_strategy(plan) if strategy == "adaptive" else strategy
    if chosen not in STRATEGIES:
        raise ValueError(f"unknown strategy {chosen!r} (one of {sorted(STRATEGIES)})")
    key = (id(csr.row_ptr), csr.shape, csr.nnz, float(alpha), float(beta), chosen)
    hit = _FN_CACHE.get(key)
    if hit is not None:
        return hit

    def step(x, y):
        return _run(chosen, alpha, beta, csr, x, y, plan)

    # Build the derived layouts eagerly: several strategies memoize device
    # arrays on first use, and a first use inside a caller's jit trace would
    # capture tracers (UnexpectedTracerError on the next trace).
    step(
        jnp.zeros((csr.shape[1],), csr.values.dtype),
        jnp.zeros((csr.shape[0],), csr.values.dtype),
    )
    _FN_CACHE[key] = (step, chosen)
    return step, chosen


def sparse_csr_spmv(trans, alpha, beta, csr: CSR, x, y, strategy: str = "adaptive"):
    """Signature-compatible shim mirroring the reference's public API
    (src/acc/api/spmv.h:20-21): ``sparse_csr_spmv(trans, alpha, beta, desc, dx, dy)``."""
    return spmv(csr, x, y, alpha=alpha, beta=beta, trans=trans, strategy=strategy)
