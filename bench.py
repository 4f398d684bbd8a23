"""Corpus benchmark for the GPU; prints ONE JSON line (the last one).

Protocol (reference lineage: 10 warmups + timed reps, benchmark/csr_spmv.hpp:48-74):
per matrix, one adaptive-strategy SpMV is golden-verified, then the same compiled
step (``make_spmv_fn``) is timed: warm calls, then the median of ``TIMED_CALLS``
calls each ended by ``block_until_ready``.

Corpora mirror the reference's example sets (examples/batch.sh small set;
examples/large-data-set-batch.sh large set — structure-matched synthetic stand-ins,
see formats/generate.py).  Metrics use the reference's bytes/FLOP models
(statistics_logger.cpp:43-49) against the device's published memory bandwidth
(utils/stats.PEAKS); a device without an entry there is an error.

Headline: geometric-mean roofline fraction over the LARGE set (the reference's own
headline corpus); ``vs_baseline = value/0.80`` (BASELINE.md).

Robustness:
  * the LARGE set (the headline) runs FIRST;
  * after EVERY matrix a complete result JSON with ``"partial": true`` is printed,
    so a killed run still leaves a parseable last line;
  * SIGTERM/SIGINT emit the partial result before exiting;
  * a self-imposed wall budget ($SPMV_BENCH_BUDGET_S, default 2700s) finalizes
    early rather than being killed mid-matrix;
  * the corpus cache is populated by a background CPU-only process
    (scripts/populate_caches.py), walking the corpus in REVERSE so it meets the
    bench in the middle.

Run: ``python bench.py`` on a machine with one GPU.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from spmv_acc_tpu.config import cache_dir, setup_compile_cache  # noqa: E402
from spmv_acc_tpu.dispatch import Handle, make_spmv_fn, spmv  # noqa: E402
from spmv_acc_tpu.formats.generate import example_like, random_x_y  # noqa: E402
from spmv_acc_tpu.ops.golden import host_spmm, host_spmv  # noqa: E402
from spmv_acc_tpu.utils.stats import (  # noqa: E402
    BenchTimes,
    bytes_moved,
    chip_peak_gbs,
    flops,
    print_statistics,
)
from spmv_acc_tpu.utils.verify import verify_y  # noqa: E402

SMALL = ["rajat03", "poli_large", "dw4096", "bayer10", "epb1", "bcsstk18", "coater2", "nemeth03", "exdata_1", "af23560"]
# the reference's FULL 10-matrix large corpus (examples/large-data-set-batch.sh:24-51)
LARGE = ["largebasis", "Ga41As41H72", "TSOPF_RS_b2383", "boneS10", "Hardesty3",
         "dielFilterV3real", "RM07R", "vas_stokes_2M", "Cube_Coup_dt6", "Bump_2911"]
DTYPE = np.float64
BASELINE_ROOFLINE = 0.80
BUDGET_S = float(os.environ.get("SPMV_BENCH_BUDGET_S", "2700"))
TIMED_CALLS = 20

_T_START = time.perf_counter()
# mutable run state read by emit() and the signal handler
_STATE = {"results": {}, "all_ok": True, "spmm": [], "skipped": []}


def geomean(vals):
    return float(np.exp(np.mean(np.log(np.maximum(vals, 1e-9))))) if vals else 0.0


def median_call_us(fn, *args, calls: int = TIMED_CALLS, warm: int = 3) -> float:
    """Median wall time in µs of ``fn(*args)``, each call ended by
    ``block_until_ready``, after ``warm`` untimed calls."""
    for _ in range(warm):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e6


def emit(partial: bool):
    """Print a complete result JSON for everything measured so far.

    Printed after every matrix so that a timeout/kill still leaves a parseable
    final line; readers take the LAST JSON line.
    """
    results = _STATE["results"]
    large_fracs = [results[n][0] for n in LARGE if n in results]
    small_fracs = [results[n][0] for n in SMALL if n in results]
    if large_fracs:
        headline = geomean(large_fracs)
        metric = "spmv_roofline_fraction_f64_geomean_large_set"
    elif small_fracs:
        headline = geomean(small_fracs)
        metric = "spmv_roofline_fraction_f64_geomean_SMALL_SET_FALLBACK_large_set_failed"
    else:
        headline, metric = 0.0, "spmv_roofline_fraction"
    dev = jax.devices()[0]
    out = {
        "metric": metric,
        "value": headline,
        "unit": "fraction_of_HBM_speed_of_light",
        "vs_baseline": headline / BASELINE_ROOFLINE,
        "verify_all_pass": bool(_STATE["all_ok"]),
        "small_set_geomean": geomean(small_fracs),
        "gflops_geomean_large": geomean([results[n][1] for n in LARGE if n in results]),
        "corpus": len(results),
        "large_done": len(large_fracs),
        "elapsed_s": time.perf_counter() - _T_START,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    if partial:
        out["partial"] = True
    out["per_matrix_roofline"] = {n: v[0] for n, v in results.items()}
    out["per_matrix_strategy"] = {n: v[2] for n, v in results.items()}
    if _STATE["skipped"]:
        out["skipped"] = _STATE["skipped"]
    if _STATE["spmm"]:
        out["spmm_k8_speedup_geomean"] = geomean(_STATE["spmm"])
    if _STATE.get("spgemm"):
        out.update(_STATE["spgemm"])
    if _STATE.get("solver"):
        out.update(_STATE["solver"])
    print(json.dumps(out), flush=True)


def _on_signal(signum, frame):  # emit what we have, then die cleanly
    try:
        _STATE["skipped"].append(f"signal_{signum}")
        emit(partial=True)
    finally:
        os._exit(0)


def spawn_populate():
    """Background CPU-only corpus-cache population, reverse corpus order (meets
    the bench in the middle).  The child never opens the GPU."""
    cdir = cache_dir("corpus")
    lock = os.path.join(cdir, "populate.lock")
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.close(fd)
    except FileExistsError:
        return None
    names = list(reversed(LARGE + SMALL))
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "populate_caches.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    logf = open(os.path.join(cdir, "populate.log"), "w")
    return subprocess.Popen([sys.executable, script, *names], env=env, stdout=logf, stderr=logf)


def bench_matrix(name: str, log, peak_gbs: float):
    t0 = time.perf_counter()
    csr = example_like(name, dtype=DTYPE)
    m, n = csr.shape
    x, y0 = random_x_y(n, m, seed=42, dtype=DTYPE)
    dx = jnp.asarray(x)
    dy = jnp.asarray(y0)
    t_gen = time.perf_counter() - t0

    # correctness: one adaptive-strategy call vs the CPU golden
    t0 = time.perf_counter()
    handle = Handle()
    out = spmv(csr, dx, dy, alpha=1.0, beta=1.0, strategy="adaptive", handle=handle)
    golden = host_spmv(1.0, 1.0, *csr.to_numpy()[:3], x, y0)
    rep = verify_y(np.asarray(out), golden, dtype=DTYPE)
    t_first = time.perf_counter() - t0

    fn, _ = make_spmv_fn(csr, alpha=1.0, beta=1.0, strategy=handle.strategy_used)
    per_us = median_call_us(fn, dx, dy)
    b = bytes_moved(m, csr.nnz, np.dtype(DTYPE).itemsize)
    gbs = b / (per_us * 1e-6) / 1e9
    if gbs > peak_gbs:
        raise RuntimeError(f"impossible reading: {gbs:.1f} GB/s exceeds the device's "
                           f"published peak {peak_gbs:.0f} GB/s ({per_us:.1f}us)")
    gflops = flops(csr.nnz) / (per_us * 1e-6) / 1e9
    frac = gbs / peak_gbs
    times = BenchTimes(pre=handle.analyze_time_us, calc=per_us)
    print_statistics(name, handle.strategy_used, m, n, csr.nnz, times, rep, file=log)
    print(f"  {name}: {per_us:.1f}us  {gbs:.1f} GB/s  {gflops:.2f} GFLOP/s  "
          f"roofline={frac:.3f}  strategy={handle.strategy_used}  gen={t_gen:.0f}s "
          f"first={t_first:.0f}s  verify={'OK' if rep.ok else 'FAIL'}",
          file=log, flush=True)
    return frac, gflops, handle.strategy_used, rep.ok, per_us


SPMM_MATRICES = ["TSOPF_RS_b2383", "boneS10"]
SPMM_K = 8


def bench_spmm(name: str, spmv_per_us: float, log):
    """k-column SpMM vs k SpMVs (multi-RHS amortization; new scope — the
    reference is SpMV-only).  Returns the speedup of one SpMM over k SpMVs."""
    from spmv_acc_tpu.ops.spmm import spmm

    csr = example_like(name, dtype=DTYPE)
    m, n = csr.shape
    rng = np.random.default_rng(7)
    Xh = rng.uniform(-1, 1, size=(n, SPMM_K)).astype(DTYPE)
    X = jnp.asarray(Xh)
    golden = host_spmm(1.0, 0.0, *csr.to_numpy()[:3], Xh, np.zeros((m, SPMM_K)))
    ok = verify_y(np.asarray(spmm(csr, X)).ravel(), golden.ravel(), dtype=DTYPE).ok
    _STATE["all_ok"] &= ok
    per_us = median_call_us(lambda XX: spmm(csr, XX), X)
    speedup = SPMM_K * spmv_per_us / per_us if per_us > 0 else 0.0
    print(f"  spmm {name}: k={SPMM_K} {per_us:.1f}us vs {SPMM_K}x{spmv_per_us:.1f}us "
          f"SpMV -> speedup {speedup:.2f}x verify={'OK' if ok else 'FAIL'}",
          file=log, flush=True)
    return speedup


SPGEMM_MATRICES = ["af23560", "epb1", "dw4096"]


def bench_spgemm(log):
    """SpGEMM section: C = A @ A on corpus matrices via the two-phase
    symbolic/numeric split (ops/spgemm.py) — symbolic host seconds, numeric
    device µs per call, verified against the host Gustavson golden.  Matrices
    are the small-set members whose product expansion stays bounded."""
    from spmv_acc_tpu.ops.spgemm import spgemm_host, spgemm_numeric, spgemm_symbolic

    out = {}
    all_ok = True
    for name in SPGEMM_MATRICES:
        csr = example_like(name, dtype=DTYPE)
        t0 = time.perf_counter()
        pattern, a_pos, b_pos, out_pos, c_nnz = spgemm_symbolic(csr, csr)
        t_sym = time.perf_counter() - t0
        av = jnp.asarray(csr.values)
        c_vals = np.asarray(spgemm_numeric(av, av, a_pos, b_pos, out_pos, c_nnz))
        rp, ci, v, shape = csr.to_numpy()
        g_rp, g_ci, g_v, _ = spgemm_host(rp, ci, v, shape, rp, ci, v, shape)
        ok = (c_nnz == len(g_ci)
              and np.allclose(c_vals, g_v, rtol=1e-7, atol=1e-12))
        all_ok &= bool(ok)
        per_us = median_call_us(spgemm_numeric, av, av, a_pos, b_pos, out_pos, c_nnz)
        print(f"  spgemm {name}: A@A nnz {csr.nnz} -> {c_nnz}, symbolic "
              f"{t_sym:.2f}s, numeric {per_us:.0f}us, verify "
              f"{'OK' if ok else 'FAIL'}", file=log, flush=True)
        out[f"spgemm_{name}_symbolic_s"] = t_sym
        out[f"spgemm_{name}_numeric_us"] = per_us
        out[f"spgemm_{name}_c_nnz"] = int(c_nnz)
    out["spgemm_verify_all_pass"] = bool(all_ok)
    return out


def bench_solver(log):
    """Solver section: CG with Jacobi vs ILU(0) (3 Jacobi sweeps per triangular
    solve) on 2D anisotropic diffusion (512^2, eps=1e-4) — SPD and only weakly
    diagonally dominant, so ILU(0) captures the strong coupling.  Records the
    factor time, iteration counts and wall time to solution at tol 1e-8, and
    ``solver_total_wall_win`` = Jacobi wall / ILU wall."""
    from spmv_acc_tpu.formats.generate import aniso_laplacian_csr
    from spmv_acc_tpu.models.cg import cg_solve, jacobi_preconditioner
    from spmv_acc_tpu.ops.trisolve import ilu0

    nx = ny = 512
    m = nx * ny
    csr = aniso_laplacian_csr(nx, ny, 1e-4)
    rp, ci, v, _ = csr.to_numpy()
    x_true = np.random.default_rng(5).standard_normal(m)
    b = jnp.asarray(host_spmv(1.0, 0.0, rp, ci, v, x_true, np.zeros(m)))
    t0 = time.perf_counter()
    fact = ilu0(csr, sweeps=3)
    t_factor = time.perf_counter() - t0
    out = {"solver_factor_s": t_factor}
    for label, pre in (("jacobi", jacobi_preconditioner(csr)), ("ilu", fact)):
        cg_solve(csr, b, tol=1e-8, max_iters=4000, precond=pre).x.block_until_ready()
        t0 = time.perf_counter()
        res = cg_solve(csr, b, tol=1e-8, max_iters=4000, precond=pre)
        res.x.block_until_ready()
        wall = time.perf_counter() - t0
        err = float(np.linalg.norm(np.asarray(res.x) - x_true) / np.linalg.norm(x_true))
        _STATE["all_ok"] &= err < 1e-5
        out[f"solver_aniso_cg_iters_{label}"] = int(res.iters)
        out[f"solver_aniso_wall_s_{label}"] = wall
        print(f"  solver aniso-512^2 cg[{label}]: iters={int(res.iters)} "
              f"wall={wall:.3f}s relerr={err:.1e}", file=log, flush=True)
    out["solver_total_wall_win"] = (out["solver_aniso_wall_s_jacobi"]
                                    / out["solver_aniso_wall_s_ilu"])
    return out


def _clear_device_caches():
    # evict per-matrix device plans — the corpus exceeds device memory if cached
    from spmv_acc_tpu import dispatch as _d
    from spmv_acc_tpu import plan as _p

    _d._FN_CACHE.clear()
    _d._ELL_CACHE.clear()
    _d._T_CACHE.clear()
    _p.clear_plan_cache()


def main():
    log = sys.stderr
    setup_compile_cache()
    dev = jax.devices()[0]
    print(f"platform={dev.platform} device_kind={dev.device_kind} "
          f"device_count={len(jax.devices())}", file=log, flush=True)
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found {dev.platform!r}")
    peak = chip_peak_gbs(dev)
    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    spawn_populate()
    print(f"peak {peak:.0f} GB/s, budget {BUDGET_S:.0f}s", file=log, flush=True)
    per_us_by_name = {}
    only = os.environ.get("SPMV_BENCH_ONLY")  # debug: comma-separated subset
    order = only.split(",") if only else LARGE + SMALL
    for name in order:  # LARGE first: the headline must land before any timeout
        if time.perf_counter() - _T_START > BUDGET_S:
            _STATE["skipped"].append(name)
            continue
        try:
            frac, gf, strat, ok, per_us = bench_matrix(name, log, peak)
            _STATE["results"][name] = (frac, gf, strat)
            per_us_by_name[name] = per_us
            _STATE["all_ok"] &= ok
        except Exception as e:  # robust harness (csr_spmv.hpp:52-62 analog)
            print(f"  {name}: ERROR {type(e).__name__}: {e}", file=log, flush=True)
            _STATE["all_ok"] = False
        finally:
            _clear_device_caches()
        emit(partial=True)
    for name in SPMM_MATRICES:
        if time.perf_counter() - _T_START > BUDGET_S:
            _STATE["skipped"].append(f"spmm_{name}")
            continue
        if per_us_by_name.get(name, 0) > 0:
            try:
                _STATE["spmm"].append(bench_spmm(name, per_us_by_name[name], log))
            except Exception as e:
                print(f"  spmm {name}: ERROR {type(e).__name__}: {e}", file=log, flush=True)
                _STATE["all_ok"] = False
            finally:
                _clear_device_caches()
    for key, section in (("spgemm", bench_spgemm), ("solver", bench_solver)):
        if time.perf_counter() - _T_START > BUDGET_S:
            _STATE["skipped"].append(key)
            continue
        try:
            _STATE[key] = section(log)
        except Exception as e:
            print(f"  {key}: ERROR {type(e).__name__}: {e}", file=log, flush=True)
            _STATE["all_ok"] = False
        finally:
            _clear_device_caches()
    if not _STATE["results"]:
        print(json.dumps({"metric": "spmv_roofline_fraction", "value": 0.0, "unit": "fraction", "vs_baseline": 0.0}))
        return 1
    emit(partial=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
