"""spmv-cli equivalent: load a matrix, run SpMV on the device, verify against the CPU golden.

Mirrors the reference CLI's flow (cli/main.cpp:33-140): parse ``-f csr|mtx|bin2``,
ingest, create host data (keep the file-provided x for csr format, random x
otherwise, random y always — cli/utils.hpp:65-85), 10 warmup iterations, one timed
run printing ``<file> elapsed time: X(us)``, rerun for the result, golden-verify with
``alpha = beta = 1.0`` (cli/main.cpp:95-96) and print the pass/fail verdict
(cli/verification.cpp:43-54).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..config import WARMUP_ITERS, setup_compile_cache
from ..dispatch import Handle, make_spmv_fn, spmv
from ..formats.containers import CSR
from ..formats.generate import random_x_y
from ..io import load_matrix
from ..ops.golden import host_spmv
from ..utils.timer import WallTimer
from ..utils.verify import verify


def build_parser():
    p = argparse.ArgumentParser(
        prog="spmv-cli",
        description="SpMV: y = alpha*A*x + beta*y with golden verification",
    )
    p.add_argument("file", help="path of input matrix file")
    p.add_argument(
        "-f",
        "--format",
        default="csr",
        choices=["csr", "mtx", "bin2"],
        help="input matrix file format (default: csr)",
    )
    p.add_argument(
        "-s",
        "--strategy",
        default="adaptive",
        help="kernel strategy (default: adaptive)",
    )
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--dtype", default="float64", choices=["float64", "float32"])
    p.add_argument("--warmups", type=int, default=WARMUP_ITERS)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument(
        "--device-verify",
        action="store_true",
        help="verify against the on-device XLA-native SpMV instead of the CPU "
        "golden (analog of the reference's DEVICE_SIDE_VERIFY rocSPARSE check, "
        "config.cmake:7-9 / cli/verification.cpp:81-113)",
    )
    return p


def test_spmv(args) -> int:
    import jax

    if args.dtype == "float64":
        # Without x64, jnp.asarray silently downcasts f64 -> f32 and the reference
        # tolerance gate (rel 1e-7) cannot hold.
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    dtype = np.dtype(args.dtype)
    row_ptr, col_idx, values, shape, file_x = load_matrix(
        args.file, fmt=args.format, dtype=dtype
    )
    m, n = shape
    print(f"loaded {args.file}: rows={m} cols={n} nnz={len(values)}")

    # host data (cli/utils.hpp:65-85): keep file x when present, random otherwise
    x, y = random_x_y(n, m, seed=args.seed, dtype=dtype)
    if file_x is not None and len(file_x) == n:
        x = np.asarray(file_x, dtype=dtype)

    csr = CSR.from_numpy(row_ptr, col_idx, values, shape)
    dx = jnp.asarray(x)
    dy = jnp.asarray(y)

    handle = Handle()
    # plan, strategy choice and derived layouts are built once, outside the timing
    fn, chosen = make_spmv_fn(
        csr, alpha=args.alpha, beta=args.beta, strategy=args.strategy
    )
    handle.strategy_used = chosen
    # warmup (cli/main.cpp:99-103)
    for _ in range(args.warmups):
        out = fn(dx, dy)
    np.asarray(out)  # force execution

    timer = WallTimer().start()
    fn(dx, dy).block_until_ready()
    elapsed = timer.stop()
    print(f"{args.file} elapsed time: {elapsed:.1f}(us)  [strategy: {handle.strategy_used}]")

    # rerun for the verified result (cli/main.cpp:116-118)
    hy = np.asarray(
        spmv(csr, dx, dy, alpha=args.alpha, beta=args.beta, strategy=chosen)
    )

    if args.device_verify:
        # device-side golden: the XLA-native segment-sum strategy on the SAME
        # device (the reference verifies against rocSPARSE's independent device
        # path when DEVICE_SIDE_VERIFY is set)
        golden = np.asarray(
            spmv(csr, dx, dy, alpha=args.alpha, beta=args.beta, strategy="default")
        )
    else:
        golden = host_spmv(args.alpha, args.beta, row_ptr, col_idx, values, x, y)
    ok = verify(hy, golden, dtype=dtype)
    return 0 if ok else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_compile_cache()
    try:
        return test_spmv(args)
    except FileNotFoundError as e:
        print(f"file open failed, file: {e.filename}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
