"""Multi-engine benchmark harness — the `spmv-gpu-benchmark` equivalent
(reference benchmark/main.cpp:87-144 + csr_spmv.hpp:23-100).

For one matrix, run every enabled engine (our strategy zoo plus CPU baselines),
following the reference protocol: warmups with y reset, BENCHMARK_ARRAY_SIZE timed
repetitions, median-of-3 by calc time, host-golden verification, and one CSV row per
engine in the 18-column schema (benchmark/utils/statistics_logger.cpp:11-57).
Engines that crash are logged and skipped (csr_spmv.hpp:52-62 try/catch analog).

Device timing uses chained-slope measurement (see utils/timer.time_chained): each
step depends on the last, and the slope between two chain lengths drops the fixed
cost of dispatch and readback.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..config import BENCHMARK_ARRAY_SIZE, WARMUP_ITERS, setup_compile_cache
from ..dispatch import STRATEGIES, make_spmv_fn, spmv
from ..formats.containers import CSR
from ..formats.generate import random_x_y
from ..io import load_matrix
from ..ops.golden import host_spmv
from ..utils.stats import CSV_HEADER, BenchTimes, print_statistics
from ..utils.timer import WallTimer, time_chained
from ..utils.verify import verify_y

# engine registry: name -> strategy kwarg (None = special-cased)
ENGINES = [
    ("spmv-acc-adaptive", "adaptive"),
    ("spmv-acc-default", "default"),
    ("spmv-acc-line", "line"),
    ("spmv-acc-ell", "ell"),
    ("spmv-acc-flat", "flat"),
    ("spmv-acc-vector-row", "vector_row"),
    ("spmv-acc-thread-row", "thread_row"),
    ("spmv-acc-wf-row", "wf_row"),
    ("spmv-acc-block-row", "block_row"),
    ("spmv-acc-light", "light"),
    ("spmv-acc-line-enhance", "line_enhance"),
    ("spmv-acc-acsr", "acsr"),
    ("numpy-cpu", None),
    # independent on-device engines — the analog of the reference's 6 external
    # comparators (rocSPARSE/cuSPARSE/CUB/HOLA/merge-path/ACSR, benchmark/main.cpp:107-141):
    # speedup claims get a non-self-referential on-device denominator.
    ("jax-sparse-bcoo", "@bcoo"),
    ("jax-sparse-bcsr", "@bcsr"),
    ("dense-anchor", "@dense_anchor"),
]


def _bench_bcoo(csr, x_np, y_np, alpha, beta, iters, warmups, dtype):
    """jax.experimental.sparse BCOO matvec — an external on-device sparse engine."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse

    rp, ci, v, shape = csr.to_numpy()
    rows = np.repeat(np.arange(shape[0], dtype=np.int32), np.diff(rp))
    indices = jnp.asarray(np.stack([rows, ci.astype(np.int32)], axis=1))
    mat = jsparse.BCOO((jnp.asarray(v.astype(dtype)), indices), shape=shape)
    dx = jnp.asarray(x_np)
    dy = jnp.asarray(y_np)
    a = jnp.asarray(alpha, dtype)
    b = jnp.asarray(beta, dtype)

    @jax.jit
    def fn(xx, yy):
        return a * (mat @ xx) + b * yy

    for _ in range(warmups):
        out = fn(dx, dy)
    np.asarray(out)
    step = lambda y: a * (mat @ dx) + 1.0 * y
    jstep = jax.jit(step)
    reps = []
    for _ in range(BENCHMARK_ARRAY_SIZE):
        per_us, _ = time_chained(jstep, dy, iters=iters, baseline_iters=max(iters // 10, 2))
        reps.append(per_us)
    reps.sort()
    return BenchTimes(calc=reps[len(reps) // 2]), np.asarray(fn(dx, dy))


def _bench_bcsr(csr, x_np, y_np, alpha, beta, iters, warmups, dtype):
    """jax.experimental.sparse BCSR matvec — third independent on-device
    engine (the reference compares six: benchmark/main.cpp:107-141)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse

    rp, ci, v, shape = csr.to_numpy()
    mat = jsparse.BCSR(
        (jnp.asarray(v.astype(dtype)), jnp.asarray(ci.astype(np.int32)),
         jnp.asarray(rp.astype(np.int32))),
        shape=shape,
    )
    dx = jnp.asarray(x_np)
    dy = jnp.asarray(y_np)
    a = jnp.asarray(alpha, dtype)
    b = jnp.asarray(beta, dtype)

    @jax.jit
    def fn(xx, yy):
        return a * (mat @ xx) + b * yy

    for _ in range(warmups):
        out = fn(dx, dy)
    np.asarray(out)
    jstep = jax.jit(lambda y: a * (mat @ dx) + 1.0 * y)
    reps = []
    for _ in range(BENCHMARK_ARRAY_SIZE):
        per_us, _ = time_chained(jstep, dy, iters=iters, baseline_iters=max(iters // 10, 2))
        reps.append(per_us)
    reps.sort()
    return BenchTimes(calc=reps[len(reps) // 2]), np.asarray(fn(dx, dy))


def _bench_dense_anchor(csr, x_np, y_np, alpha, beta, iters, warmups, dtype):
    """Dense matvec moving ~the bytes of the CSR problem: the practical HBM
    speed-of-light anchor.  Its GB/s column IS the achievable roofline; a sparse
    engine at the same GB/s has zero format overhead."""
    import jax
    import jax.numpy as jnp

    m, n = csr.shape
    # pick (mm x k) so mm*k*itemsize ~= the CSR bytes model, k a multiple of 128
    target = (2 * m + csr.nnz) * dtype.itemsize + (m + 1 + csr.nnz) * 4
    k = int(np.clip(target // max(m, 1) // dtype.itemsize, 128, 4096)) & ~127
    mm = max(128, min(m, target // (k * dtype.itemsize)))
    rng = np.random.default_rng(0)
    dmat = jnp.asarray(rng.standard_normal((mm, k)).astype(dtype))
    dx = jnp.asarray(rng.standard_normal((k,)).astype(dtype))

    @jax.jit
    def step(xx):
        r = jnp.dot(dmat, xx, precision=jax.lax.Precision.HIGHEST)
        # feed back through a cheap reduction so iterations chain
        return xx * (1.0 + 0.0 * r[0])

    for _ in range(warmups):
        out = step(dx)
    np.asarray(out)
    reps = []
    for _ in range(BENCHMARK_ARRAY_SIZE):
        per_us, _ = time_chained(step, dx, iters=iters, baseline_iters=max(iters // 10, 2))
        reps.append(per_us)
    reps.sort()
    # report in the matrix's bytes model: scale measured dense GB/s onto the CSR
    # byte count so the CSV row is comparable (time column = equivalent time)
    dense_bytes = mm * k * dtype.itemsize
    equiv_us = reps[len(reps) // 2] * target / max(dense_bytes, 1)
    return BenchTimes(calc=equiv_us), None


def bench_engine(name, strategy, csr, x_np, y_np, alpha, beta, iters, warmups, dtype):
    import jax
    import jax.numpy as jnp

    m, n = csr.shape
    golden = host_spmv(alpha, beta, *csr.to_numpy()[:3], x_np, y_np)

    if strategy == "@bcoo":
        times, out = _bench_bcoo(csr, x_np, y_np, alpha, beta, iters, warmups, dtype)
        return times, verify_y(out, golden, dtype=dtype)
    if strategy == "@bcsr":
        times, out = _bench_bcsr(csr, x_np, y_np, alpha, beta, iters, warmups, dtype)
        return times, verify_y(out, golden, dtype=dtype)
    if strategy == "@dense_anchor":
        times, _ = _bench_dense_anchor(csr, x_np, y_np, alpha, beta, iters, warmups, dtype)
        # the anchor computes a different product by design; its verification
        # columns are vacuous (verify_beta_y()=false analog, csr_spmv.hpp:28)
        return times, verify_y(golden, golden, dtype=dtype)

    if strategy is None:  # CPU baseline (numpy vectorised golden loop)
        t = WallTimer().start()
        for _ in range(max(iters, 1)):
            out = host_spmv(alpha, beta, *csr.to_numpy()[:3], x_np, y_np)
        per_us = t.stop() / max(iters, 1)
        rep = verify_y(out, golden, dtype=dtype)
        return BenchTimes(calc=per_us), rep

    dx = jnp.asarray(x_np)
    dy = jnp.asarray(y_np)
    pre_t = WallTimer().start()
    fn, _ = make_spmv_fn(csr, alpha=alpha, beta=1.0, strategy=strategy)
    pre_us = pre_t.stop()  # analyze/plan phase (SpMVAccHanele.pre analog)
    # warmup with y reset each iteration (csr_spmv.hpp:48-63)
    for _ in range(warmups):
        out = fn(dx, dy)
    np.asarray(out)

    # chained timing: y <- alpha*A*x + 1.0*y keeps the dependency chain real
    step = lambda y: fn(dx, y)
    reps = []
    for _ in range(BENCHMARK_ARRAY_SIZE):
        per_us, _ = time_chained(step, dy, iters=iters, baseline_iters=max(iters // 10, 2))
        reps.append(per_us)
    reps.sort()
    calc_us = reps[len(reps) // 2]  # median (benchmark_time.cpp:23-43)

    out = spmv(csr, dx, dy, alpha=alpha, beta=beta, strategy=strategy)
    rep = verify_y(np.asarray(out), golden, dtype=dtype)
    return BenchTimes(pre=pre_us, calc=calc_us), rep


def build_parser():
    p = argparse.ArgumentParser(prog="spmv-benchmark", description="all-engine SpMV comparison")
    p.add_argument("file")
    p.add_argument("-f", "--format", default=None, choices=[None, "csr", "mtx", "bin2"])
    p.add_argument("--engines", default=None, help="comma-separated engine filter")
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--dtype", default="float64", choices=["float64", "float32"])
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--warmups", type=int, default=WARMUP_ITERS)
    p.add_argument("--seed", type=int, default=42)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import jax

    setup_compile_cache()
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    dtype = np.dtype(args.dtype)

    row_ptr, col_idx, values, shape, file_x = load_matrix(args.file, fmt=args.format, dtype=dtype)
    m, n = shape
    x, y = random_x_y(n, m, seed=args.seed, dtype=dtype)
    if file_x is not None and len(file_x) == n:
        x = np.asarray(file_x, dtype=dtype)
    csr = CSR.from_numpy(row_ptr, col_idx, values, shape)
    matrix_name = args.file.rsplit("/", 1)[-1]
    print(f"matrix {matrix_name}: rows={m} cols={n} nnz={len(values)}", file=sys.stderr)
    print(CSV_HEADER)

    wanted = set(args.engines.split(",")) if args.engines else None
    failures = 0
    for name, strategy in ENGINES:
        if wanted and name not in wanted:
            continue
        try:
            times, rep = bench_engine(
                name, strategy, csr, x, y, args.alpha, args.beta, args.iters, args.warmups, dtype
            )
            print_statistics(
                matrix_name, name, m, n, csr.nnz, times, rep, value_bytes=dtype.itemsize
            )
            if not rep.ok:
                failures += 1
        except Exception as e:  # skip crashed engines, keep benchmarking
            print(f"ERROR,{matrix_name},{name},{type(e).__name__}: {e}", file=sys.stderr)
            failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
