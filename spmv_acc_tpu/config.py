"""Global configuration constants for spmv_acc_tpu.

The reference (hpcde/spmv-acc) carries its configuration in three tiers: CMake cache
variables compiled into ``building_config.h`` (reference ``config.cmake:1-51``), per-strategy
``*_config.h`` headers, and runtime CLI flags.  Here the compile-time tier becomes JIT
specialization keys; this module is the single home for the remaining constants, the
backend rule for Pallas kernels and the on-disk cache locations.
"""

from __future__ import annotations

import dataclasses
import os

# --- Numeric verification contract (reference cli/verification.cpp:15-54) ---
# A result element fails when relative error >= REL_TOL, except near zero
# (|golden| <= NEAR_ZERO) where the gate is absolute error >= ABS_TOL.
REL_TOL = 1e-7
ABS_TOL = 1e-14
NEAR_ZERO = 1e-12

# Looser gates used when the compute dtype is float32 (the reference is double-only
# so these are new, scaled from f32's ~1e-7 ulp).
REL_TOL_F32 = 1e-3
ABS_TOL_F32 = 1e-5
NEAR_ZERO_F32 = 1e-4

# --- Benchmark protocol (reference benchmark/csr_spmv.hpp:48-74, benchmark_time.h:10) ---
WARMUP_ITERS = 10
BENCHMARK_ARRAY_SIZE = 3  # median-of-3 timed repetitions

# --- bin2 on-disk format (reference cli/csr_binary_reader.hpp:37-56) ---
BIN2_MAGIC = 0x20211015
BIN2_VERSION = 2

# --- Strategy-picker thresholds (reference hip-adaptive/adaptive.cpp:16-67) ---
# Starting points carried over from the reference's decision tree (dispatch.py).
IMBALANCE_RATIO = 4.0          # half-matrix nnz imbalance that triggers weighted split
SHORT_ROW_AVG_NNZ = 4.0        # avg nnz/row at or below which rows are "short"
SMALL_NNZ = 0x0C00000          # adaptive.cpp:52 boundary (12.58M)


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """Tunable knobs of the strategy zoo (analog of the per-strategy *_config.h)."""

    # flat strategy: nnz handled per chunk (reference R*THREADS products per block,
    # hip-flat/flat_config.h:8-16).
    flat_chunk_nnz: int = 8 * 1024
    # ell strategy: padded row width is a multiple of this
    ell_width_multiple: int = 8


DEFAULT_TUNE = TuneConfig()

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_dir(kind: str) -> str:
    """Disk-cache directory for ``kind`` ("corpus" or "jax"), created on use.

    The corpus cache honours ``SPMV_CORPUS_CACHE``; otherwise both live in the
    gitignored ``.cache/<kind>`` of this checkout."""
    d = os.environ.get("SPMV_CORPUS_CACHE") if kind == "corpus" else None
    d = d or os.path.join(_ROOT, ".cache", kind)
    os.makedirs(d, exist_ok=True)
    return d


def setup_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; every entry point calls this.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and nothing is
    changed; otherwise the cache goes to ``<checkout>/.cache/jax``.  Returns the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    d = cache_dir("jax")
    jax.config.update("jax_compilation_cache_dir", d)
    return d


def pallas_interpret() -> bool:
    """Whether Pallas kernels run in the interpreter: on the CPU backend (the
    tests) they do, on the GPU they compile through Triton, and any other
    backend has no build of them."""
    import jax

    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(
        f"no Pallas kernel build for backend {backend!r}: kernels compile for "
        "'gpu' and run in interpret mode on 'cpu'")
