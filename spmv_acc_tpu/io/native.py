"""ctypes bindings to the native C++ host library (native/spmv_native.cpp), with
transparent numpy fallbacks.

The reference keeps its ingest/analyze hot loops in C++ (OpenMP parse,
cli/csr_mtx_reader.hpp:116-162; sort, cli/sort_omp.hpp; analyze,
csr_adaptive_plus_analyze.cpp); this module is this package's equivalent.  The
shared library is built lazily (``make -C native``) on first use; absence of a
compiler degrades to the numpy paths without functional loss.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["get_lib", "parse_doubles", "coo_to_csr_native", "ilu0_factor_native",
           "trisolve_levels_native", "available"]

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libspmv_native.so")
_lock = threading.Lock()
_lib = None
_tried = False


_ABI_VERSION = 6


def _build(force: bool = False) -> bool:
    try:
        cmd = ["make", "-C", _NATIVE_DIR, "-s"] + (["-B"] if force else [])
        r = subprocess.run(cmd, capture_output=True, timeout=120)
        return r.returncode == 0 and os.path.exists(_LIB_PATH)
    except Exception:
        return False


def _load_fresh():
    """CDLL via a temp copy: re-CDLL of the same path can return the already-
    mapped stale handle (same inode, no dlclose), so a rebuilt .so must be
    loaded under a new path to actually remap."""
    import shutil
    import tempfile

    tmp = tempfile.NamedTemporaryFile(
        prefix="spmv_native_", suffix=".so", delete=False
    )
    tmp.close()
    shutil.copy2(_LIB_PATH, tmp.name)
    return ctypes.CDLL(tmp.name)


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            lib.spmv_native_abi_version.restype = ctypes.c_int32
            if lib.spmv_native_abi_version() != _ABI_VERSION:
                # stale build: FORCE the rebuild (plain make won't rebuild when
                # the stale .so is newer than its sources) and load the fresh
                # binary under a new path
                if not _build(force=True):
                    return None
                lib = _load_fresh()
                lib.spmv_native_abi_version.restype = ctypes.c_int32
                if lib.spmv_native_abi_version() != _ABI_VERSION:
                    return None
            lib.parse_doubles.restype = ctypes.c_int64
            lib.parse_doubles.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.c_int32,
            ]
            lib.coo_to_csr.restype = ctypes.c_int32
            lib.ilu0_factor.restype = ctypes.c_int64
            lib.trisolve_levels.restype = ctypes.c_int64
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return get_lib() is not None


def parse_doubles(text: bytes, expect_hint: int = 0, threads: int | None = None):
    """Parse whitespace-separated numbers from bytes; returns float64 array or None."""
    lib = get_lib()
    if lib is None:
        return None
    threads = threads or min(os.cpu_count() or 1, 8)
    cap = max(expect_hint, len(text) // 2 + 16)
    out = np.empty(cap, dtype=np.float64)
    n = lib.parse_doubles(
        text,
        len(text),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cap,
        threads,
    )
    if n < 0:
        return None
    return out[:n]


def coo_to_csr_native(rows, cols, vals, m):
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    nnz = len(vals)
    row_ptr = np.empty(m + 1, dtype=np.int32)
    out_cols = np.empty(nnz, dtype=np.int32)
    out_vals = np.empty(nnz, dtype=np.float64)
    rc = lib.coo_to_csr(
        rows.ctypes.data_as(ctypes.c_void_p),
        cols.ctypes.data_as(ctypes.c_void_p),
        vals.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(nnz),
        ctypes.c_int32(m),
        row_ptr.ctypes.data_as(ctypes.c_void_p),
        out_cols.ctypes.data_as(ctypes.c_void_p),
        out_vals.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        return None
    return row_ptr, out_cols, out_vals


def ilu0_factor_native(rp, ci, values, m):
    """Native in-pattern ILU(0).  Returns the combined LU value array (f64, same
    CSR pattern) or None (library absent / missing diagonal)."""
    lib = get_lib()
    if lib is None:
        return None
    rp = np.ascontiguousarray(rp, dtype=np.int64)
    ci = np.ascontiguousarray(ci, dtype=np.int32)
    lu = np.array(values, dtype=np.float64, copy=True)
    rc = lib.ilu0_factor(
        rp.ctypes.data_as(ctypes.c_void_p),
        ci.ctypes.data_as(ctypes.c_void_p),
        lu.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(m),
    )
    if rc < 0:
        raise ValueError(f"ILU(0) requires a full diagonal; row {-rc - 1} has none")
    return lu


def trisolve_levels_native(rp, ci, m, lower):
    """Native dependency-level pass.  Returns (level int32 (m,), num_levels) or None."""
    lib = get_lib()
    if lib is None:
        return None
    rp = np.ascontiguousarray(rp, dtype=np.int64)
    ci = np.ascontiguousarray(ci, dtype=np.int32)
    level = np.zeros(m, dtype=np.int32)
    nl = lib.trisolve_levels(
        rp.ctypes.data_as(ctypes.c_void_p),
        ci.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(m),
        ctypes.c_int32(1 if lower else 0),
        level.ctypes.data_as(ctypes.c_void_p),
    )
    return level, max(int(nl), 1)
