"""Smoke run of the main path on the GPU, compiled, at the sizes users run.

    python chip_smoke.py           # phases 1-5 on one GPU
    python chip_smoke.py --time    # + vector_row kernel vs XLA forms, after the phases
    python chip_smoke.py --four    # only the multi-device path, on four GPUs

Phases (one line each; any failure raises and exits non-zero):
  1. SpMV on the boneS10 stand-in (914,898 rows, 28.2M nnz, f64) through
     ``spmv(strategy="adaptive")`` and ``make_spmv_fn``, alpha=2.5, beta=-1;
  2. every name in ``STRATEGIES`` on af23560 and a power-law matrix, f64 and f32;
  3. the CLIs: ``spmv-cli`` on af23560 written as .csr text, ``spmv-solve`` with
     ILU(0);
  4. CG with Jacobi and with ILU(0) on the 512^2 anisotropic Laplacian, tol 1e-8;
  5. SpMM (k=8) and SpGEMM af23560 @ af23560.

Every result is checked against the host references (``ops/golden.py``,
``spgemm_host``) with ``utils/verify.verify_y``: f64 at the reference gates
(rel 1e-7, abs 1e-14); f32 at ``REL_TOL_F32`` (rel 1e-3) with full-precision
contractions, on positive data so that the gate bounds the kernel's error and
not the conditioning of f32 cancellation.

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

SPMV_MATRIX = "boneS10"
TIME_MATRICES = ["boneS10", "Hardesty3", "TSOPF_RS_b2383", "Ga41As41H72", "af23560"]
XLA_FORMS = ["flat", "ell", "line", "default"]
F64 = np.float64


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    """Card name and power limit, read by a child that never imports JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def _check(out, golden, dtype, what):
    from spmv_acc_tpu.utils.verify import verify_y

    rep = verify_y(np.asarray(out).ravel(), np.asarray(golden).ravel(), dtype=dtype)
    if not rep.ok:
        raise AssertionError(f"{what}: golden mismatch {rep}")
    return rep.max_error


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


def kernel_is_compiled(csr, x, y) -> bool:
    """True iff the vector_row kernel lowers to a Triton call (not the
    Pallas interpreter) on the current backend."""
    from spmv_acc_tpu.config import pallas_interpret
    from spmv_acc_tpu.ops import vector_row as vr

    text = vr._vector_row_call.lower(
        1.0, 0.0, csr.row_ptr, csr.col_idx, csr.values, x, y, lanes=8,
        tile=vr.TILE, interpret=pallas_interpret()).as_text()
    return "triton" in text


def phase_spmv(csr, alpha=2.5, beta=-1.0):
    """Phase 1: adaptive SpMV through both public entry points, f64."""
    import jax.numpy as jnp

    from spmv_acc_tpu.dispatch import Handle, make_spmv_fn, spmv
    from spmv_acc_tpu.formats.generate import random_x_y
    from spmv_acc_tpu.ops.golden import host_spmv

    m, n = csr.shape
    x, y = random_x_y(n, m, seed=42, dtype=F64)
    golden = host_spmv(alpha, beta, *csr.to_numpy()[:3], x, y)
    dx, dy = jnp.asarray(x), jnp.asarray(y)
    handle = Handle()
    err1 = _check(spmv(csr, dx, dy, alpha=alpha, beta=beta, handle=handle), golden, F64,
                  "spmv(adaptive)")
    fn, chosen = make_spmv_fn(csr, alpha=alpha, beta=beta)
    assert chosen == handle.strategy_used, (chosen, handle.strategy_used)
    err2 = _check(fn(dx, dy), golden, F64, "make_spmv_fn(adaptive)")
    return (f"phase 1 spmv: rows={m} nnz={csr.nnz} f64 alpha={alpha} beta={beta} "
            f"strategy={chosen} max_err={max(err1, err2):.3e} "
            f"peak_bytes_in_use={_peak_bytes()}")


def phase_strategies(matrices, require_compiled=True):
    """Phase 2: every strategy in STRATEGIES once per matrix and dtype."""
    import jax.numpy as jnp

    from spmv_acc_tpu.dispatch import STRATEGIES, spmv
    from spmv_acc_tpu.formats.containers import CSR
    from spmv_acc_tpu.formats.generate import random_x_y
    from spmv_acc_tpu.ops.golden import host_spmv

    runs = 0
    for name, csr in matrices.items():
        m, n = csr.shape
        rp, ci, v, _ = csr.to_numpy()
        x, y = random_x_y(n, m, seed=3, dtype=F64)
        # f32 on positive data: no cancellation, so rel 1e-3 bounds the kernel
        pos = CSR.from_numpy(rp, ci, np.abs(v).astype(np.float32), (m, n))
        x32, y32 = np.abs(x).astype(np.float32), np.abs(y).astype(np.float32)
        cases = (
            (csr, x, y, -1.0, F64),
            (pos, x32, y32, 0.5, np.float32),
        )
        for a, xx, yy, beta, dtype in cases:
            golden = host_spmv(1.5, beta, *a.to_numpy()[:3], xx, yy)
            for strategy in sorted(STRATEGIES):
                out = spmv(a, jnp.asarray(xx), jnp.asarray(yy), alpha=1.5, beta=beta,
                           strategy=strategy)
                _check(out, golden, dtype, f"{strategy} on {name} {np.dtype(dtype).name}")
                runs += 1
        if require_compiled and not kernel_is_compiled(csr, jnp.asarray(x), jnp.asarray(y)):
            raise AssertionError("vector_row did not lower to a compiled Triton kernel")
    compiled = "compiled" if require_compiled else "not required"
    return (f"phase 2 strategies: {len(STRATEGIES)} strategies x {list(matrices)} x "
            f"f64 (rel 1e-7) + f32 (rel 1e-3, HIGHEST precision, positive data): "
            f"{runs} runs golden-matched; vector_row Triton kernel {compiled}")


def phase_clis(csr, workdir):
    """Phase 3: spmv-cli and spmv-solve (ILU(0)) on a .csr text file."""
    from spmv_acc_tpu.cli.main import main as spmv_cli
    from spmv_acc_tpu.cli.solve import main as solve_cli
    from spmv_acc_tpu.formats.generate import random_x_y
    from spmv_acc_tpu.io.csr_text import write_csr_text

    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "smoke.csr")
    rp, ci, v, (m, n) = csr.to_numpy()
    x, _ = random_x_y(n, m, seed=5, dtype=F64)
    write_csr_text(path, rp, ci, v, x)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = spmv_cli([path, "-f", "csr", "--warmups", "2"])
    out = buf.getvalue()
    if rc != 0 or f"Congratulation, pass {m} validation!" not in out:
        raise AssertionError(f"spmv-cli rc={rc}: {out}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc2 = solve_cli([path, "-f", "csr", "--precond", "ilu0"])
    out2 = buf.getvalue()
    if rc2 != 0 or "Congratulation, solution verified!" not in out2:
        raise AssertionError(f"spmv-solve rc={rc2}: {out2}")
    solve_line = next(l for l in out2.splitlines() if "cg[ilu0]" in l)
    return (f"phase 3 clis: spmv-cli pass {m} validation; "
            f"spmv-solve {solve_line.split(' ', 1)[1]}")


def phase_cg(csr, tol=1e-8, max_iters=4000, sweeps=3):
    """Phase 4: CG with Jacobi and with ILU(0) to ``tol``; true residual checked."""
    import jax.numpy as jnp

    from spmv_acc_tpu.models.cg import cg_solve, jacobi_preconditioner
    from spmv_acc_tpu.ops.golden import host_spmv
    from spmv_acc_tpu.ops.trisolve import ilu0

    rp, ci, v, (m, _) = csr.to_numpy()
    x_true = np.random.default_rng(5).standard_normal(m)
    b = host_spmv(1.0, 0.0, rp, ci, v, x_true, np.zeros(m))
    parts = []
    for label, pre in (("jacobi", jacobi_preconditioner(csr)),
                       ("ilu0", ilu0(csr, sweeps=sweeps))):
        t0 = time.perf_counter()
        res = cg_solve(csr, jnp.asarray(b), tol=tol, max_iters=max_iters, precond=pre)
        xs = np.asarray(res.x)
        wall = time.perf_counter() - t0
        rel = np.linalg.norm(b - host_spmv(1.0, 0.0, rp, ci, v, xs, np.zeros(m))) / np.linalg.norm(b)
        if not (int(res.iters) < max_iters and rel <= 10 * tol):
            raise AssertionError(f"cg[{label}] iters={int(res.iters)} true rel residual {rel:.3e}")
        parts.append(f"{label} iters={int(res.iters)} rel_residual={rel:.2e} wall={wall:.2f}s")
    return f"phase 4 cg: rows={m} nnz={csr.nnz} tol={tol}: " + "; ".join(parts)


def phase_spmm_spgemm(csr, k=8):
    """Phase 5: SpMM (ell and segment forms) and SpGEMM A @ A vs host references."""
    import jax.numpy as jnp

    from spmv_acc_tpu.ops.golden import host_spmm
    from spmv_acc_tpu.ops.spgemm import spgemm, spgemm_host
    from spmv_acc_tpu.ops.spmm import spmm

    rp, ci, v, (m, n) = csr.to_numpy()
    rng = np.random.default_rng(9)
    X, Y = rng.uniform(-1, 1, (n, k)), rng.uniform(-1, 1, (m, k))
    golden = host_spmm(1.5, -0.5, rp, ci, v, X, Y)
    for strategy in ("adaptive", "ell", "segment"):
        out = spmm(csr, jnp.asarray(X), jnp.asarray(Y), alpha=1.5, beta=-0.5, strategy=strategy)
        _check(out, golden, F64, f"spmm[{strategy}] k={k}")
    c = spgemm(csr, csr)
    g_rp, g_ci, g_v, _ = spgemm_host(rp, ci, v, (m, n), rp, ci, v, (m, n))
    c_rp, c_ci, c_v, _ = c.to_numpy()
    if not (np.array_equal(c_rp, g_rp) and np.array_equal(c_ci, g_ci)):
        raise AssertionError("spgemm pattern differs from spgemm_host")
    err = _check(c_v, g_v, F64, "spgemm A@A")
    return (f"phase 5 spmm/spgemm: spmm k={k} (adaptive, ell, segment) golden-matched; "
            f"spgemm A@A nnz {csr.nnz} -> {len(g_v)} max_err={err:.3e}")


def device_us_per_call(fn, args, calls, trace_dir):
    """Device busy time per call of ``fn(*args)`` from a profiler trace of
    ``calls`` calls: the union of the event intervals on the GPU's stream
    lines, divided by ``calls``.  Returns (µs, names of the lines used)."""
    import glob

    import jax

    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(trace_dir):
        for _ in range(calls):
            jax.block_until_ready(fn(*args))
    path = max(glob.glob(os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb")),
               key=os.path.getmtime)
    spans, used, seen = [], set(), []
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        seen.append((plane.name, [line.name for line in plane.lines]))
        if not plane.name.startswith("/device:GPU:0"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            used.add(line.name)
            spans += [(e.start_ns, e.end_ns) for e in line.events]
    if not spans:
        raise AssertionError(f"no GPU stream events in {path}; planes and lines: {seen}")
    busy, end = 0, -1
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / calls / 1e3, sorted(used)


def time_kernel_vs_xla(names, trace_root, calls=20):
    """The vector_row kernel (default tuning) against what XLA makes of the
    other forms, one line per matrix: the median wall time of ``calls`` warm
    calls each ended by block_until_ready, and the device busy time per call
    from a profiler trace.  Also the row statistics the GPU branch of
    ``pick_strategy`` reads, and what it picked."""
    import jax
    import jax.numpy as jnp

    from spmv_acc_tpu import dispatch, plan as plan_mod
    from spmv_acc_tpu.formats.generate import example_like, random_x_y

    def median_us(fn, *args):
        for _ in range(3):
            jax.block_until_ready(fn(*args))
        ts = []
        for _ in range(calls):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) * 1e6

    records = []
    for name in names:
        csr = example_like(name, dtype=F64)
        m, n = csr.shape
        x, y = random_x_y(n, m, seed=42, dtype=F64)
        dx, dy = jnp.asarray(x), jnp.asarray(y)
        plan = plan_mod.get_plan(csr)
        times = {}
        for form in ["vector_row"] + XLA_FORMS:
            fn, _ = dispatch.make_spmv_fn(csr, alpha=1.0, beta=1.0, strategy=form)
            wall = median_us(fn, dx, dy)
            dev, _ = device_us_per_call(fn, (dx, dy), calls,
                                        os.path.join(trace_root, f"{name}_{form}"))
            times[form] = {"wall_us": wall, "device_us": dev}
            dispatch._FN_CACHE.clear()
            dispatch._ELL_CACHE.clear()
        best = min(XLA_FORMS, key=lambda f: times[f]["device_us"])
        rec = {"matrix": name, "rows": m, "nnz": csr.nnz,
               "avg_nnz_per_row": plan.stats.avg_nnz_per_row,
               "max_nnz_per_row": plan.stats.max_nnz_per_row,
               "ell_cells_per_nnz": dispatch.ell_cells(plan) / csr.nnz,
               "times": times, "best_xla": best,
               "kernel_speedup_vs_best_xla": times[best]["device_us"] / times["vector_row"]["device_us"],
               "picked": dispatch.pick_strategy(plan)}
        log("time " + json.dumps(rec))
        records.append(rec)
        plan_mod.clear_plan_cache()
    return records


def phase_four(n_devices, gather_csr, gather_name, side):
    """The multi-device path on ``n_devices`` cards over a 1-D mesh: all-gather
    SpMV on ``gather_csr``, halo SpMV and CG on a shifted ``side``^2 2-D
    Laplacian, each against the host golden and the one-card result."""
    import jax
    import jax.numpy as jnp

    from spmv_acc_tpu.dispatch import spmv
    from spmv_acc_tpu.formats.generate import random_x_y
    from spmv_acc_tpu.models.cg import cg_solve, dist_cg_solve
    from spmv_acc_tpu.ops.golden import host_spmv
    from spmv_acc_tpu.parallel import (dist_spmv, make_mesh, pad_vector, partition_rows,
                                       shard_partitioned, unpad_y)
    from spmv_acc_tpu.parallel.dist_spmv import halo_feasible

    assert len(jax.devices()) >= n_devices, f"need {n_devices} devices, have {jax.devices()}"
    mesh = make_mesh(n_devices)
    parts = []

    def dist_check(csr, halo, label):
        m, n = csr.shape
        x, _ = random_x_y(n, m, seed=21, dtype=F64)
        part = shard_partitioned(partition_rows(csr, n_devices, balance=False), mesh)
        assert halo_feasible(part) or not halo, f"{label}: halo not feasible"
        y_pad = dist_spmv(part, jnp.asarray(x), mesh, halo=halo)
        assert len(y_pad.sharding.device_set) == n_devices, "y not sharded over the mesh"
        y = np.asarray(unpad_y(part, y_pad))
        golden = host_spmv(1.0, 0.0, *csr.to_numpy()[:3], x, np.zeros(m))
        err = _check(y, golden, F64, f"{label} vs host golden")
        one = np.asarray(spmv(csr, jax.device_put(jnp.asarray(x), jax.devices()[0])))
        _check(y, one, F64, f"{label} vs one-card spmv")
        parts.append(f"{label} rows={m} nnz={csr.nnz} max_err={err:.2e}")

    dist_check(gather_csr, False, f"all-gather {gather_name}")
    lap = _shifted_laplacian(side, side, shift=4.0)
    dist_check(lap, True, f"halo laplacian-{side}^2")

    m = lap.rows
    rp, ci, v, _ = lap.to_numpy()
    x_true = np.random.default_rng(6).standard_normal(m)
    b = host_spmv(1.0, 0.0, rp, ci, v, x_true, np.zeros(m))
    part = shard_partitioned(partition_rows(lap, n_devices, balance=False), mesh)
    res = dist_cg_solve(part, pad_vector(part, b), mesh, tol=1e-10, max_iters=500)
    assert len(res.x.sharding.device_set) == n_devices, "x not sharded over the mesh"
    xs = np.asarray(unpad_y(part, res.x))
    one = np.asarray(cg_solve(lap, jnp.asarray(b), tol=1e-10, max_iters=500).x)
    err = float(np.linalg.norm(xs - x_true) / np.linalg.norm(x_true))
    diff = float(np.linalg.norm(xs - one) / np.linalg.norm(one))
    if not (err < 1e-8 and diff < 1e-8):
        raise AssertionError(f"dist CG: rel err {err:.3e}, vs one-card {diff:.3e}")
    parts.append(f"dist_cg iters={int(res.iters)} rel_err={err:.2e} vs_one_card={diff:.2e}")
    return f"four-card path on a 1-D mesh of {n_devices}: " + "; ".join(parts)


def _shifted_laplacian(nx, ny, shift):
    """5-point Laplacian plus ``shift`` on the diagonal: SPD, well conditioned."""
    from spmv_acc_tpu.formats.containers import CSR
    from spmv_acc_tpu.formats.generate import aniso_laplacian_csr

    rp, ci, v, shape = aniso_laplacian_csr(nx, ny, 1.0).to_numpy()
    rows = np.repeat(np.arange(shape[0]), np.diff(rp))
    v = np.where(ci == rows, v + shift, v)
    return CSR.from_numpy(rp, ci, v, shape)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="chip_smoke", description=__doc__.split("\n\n")[0])
    p.add_argument("--time", action="store_true",
                   help="also time the vector_row kernel against the XLA forms")
    p.add_argument("--four", action="store_true",
                   help="run only the multi-device path, on four GPUs")
    args = p.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {dev.platform!r}")
    jax.config.update("jax_enable_x64", True)
    from spmv_acc_tpu.config import setup_compile_cache

    log(f"device_kind={dev.device_kind} device_count={len(jax.devices())} "
        f"jax={jax.__version__} compile_cache={setup_compile_cache()}")
    log(nvidia_smi())
    t0 = time.perf_counter()

    from spmv_acc_tpu.formats.generate import aniso_laplacian_csr, example_like, powerlaw_csr

    if args.four:
        log(phase_four(4, example_like(SPMV_MATRIX, dtype=F64), SPMV_MATRIX, 2048))
        count = 4
    else:
        log(phase_spmv(example_like(SPMV_MATRIX, dtype=F64)))
        af = example_like("af23560", dtype=F64)
        log(phase_strategies({"af23560": af,
                              "powerlaw": powerlaw_csr(100_000, 100_000, avg_nnz=8, seed=3)}))
        log(phase_clis(af, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        ".cache", "smoke")))
        log(phase_cg(aniso_laplacian_csr(512, 512, 1e-4)))
        log(phase_spmm_spgemm(af))
        if args.time:
            here = os.path.dirname(os.path.abspath(__file__))
            time_kernel_vs_xla(TIME_MATRICES, os.path.join(here, ".cache", "traces"))
        count = len(jax.devices())
    log(f"all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
