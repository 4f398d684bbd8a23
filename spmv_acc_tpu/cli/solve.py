"""spmv-solve: CG on a loaded matrix with the strategy zoo's SpMV — the solver
companion to spmv-cli (new scope: the reference is a kernel library; this is the
production driver a kernel library exists for, per BASELINE.json config 5).

Flow: ingest (same ``-f csr|mtx|bin2`` surface as cli/main.cpp:33-86), SPD-ize
unless ``--assume-spd`` (0.5(A+A^T) + diagonal dominance — CG requires SPD and
arbitrary inputs aren't), manufacture b from a known x_true, solve with the
chosen preconditioner, report iterations / residual / wall time and verify the
solution against x_true.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..config import setup_compile_cache
from ..formats.containers import CSR
from ..io import load_matrix


def build_parser():
    p = argparse.ArgumentParser(
        prog="spmv-solve",
        description="Preconditioned CG driven by the SpMV strategies",
    )
    p.add_argument("file", help="path of input matrix file")
    p.add_argument("-f", "--format", default="csr", choices=["csr", "mtx", "bin2"])
    p.add_argument("-s", "--strategy", default="adaptive",
                   help="SpMV strategy for the matvec (default: adaptive)")
    p.add_argument("--precond", default="jacobi",
                   choices=["none", "jacobi", "ilu0"],
                   help="preconditioner (default: jacobi)")
    p.add_argument("--sweeps", type=int, default=None,
                   help="ILU(0) triangular-solve Jacobi sweeps (default: auto)")
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--max-iters", type=int, default=1000)
    p.add_argument("--assume-spd", action="store_true",
                   help="matrix is already SPD; skip the SPD-izing transform")
    p.add_argument("--seed", type=int, default=7)
    return p


def _spdize(rp, ci, v, m):
    from ..formats.convert import coo_to_csr_arrays

    rr = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
    off = ci != rr
    rr_s = np.concatenate([rr[off], ci[off], np.arange(m, dtype=np.int64)])
    cc_s = np.concatenate([ci[off], rr[off], np.arange(m, dtype=np.int64)])
    dom = np.zeros(m)
    np.add.at(dom, rr[off], 0.5 * np.abs(v[off]))
    np.add.at(dom, ci[off], 0.5 * np.abs(v[off]))
    v_s = np.concatenate([0.5 * v[off], 0.5 * v[off], dom + 1.0])
    return coo_to_csr_arrays(rr_s, cc_s, v_s, (m, m))


def main(argv=None) -> int:
    import jax

    args = build_parser().parse_args(argv)
    jax.config.update("jax_enable_x64", True)
    setup_compile_cache()
    import jax.numpy as jnp

    from ..models.cg import cg_solve, jacobi_preconditioner
    from ..ops.golden import host_spmv

    rp, ci, v, shape, _x = load_matrix(args.file, args.format, dtype=np.float64)
    m, n = shape
    if m != n:
        print(f"matrix is {m}x{n}; CG needs square", file=sys.stderr)
        return 2
    if not args.assume_spd:
        rp, ci, v = _spdize(np.asarray(rp).astype(np.int64),
                            np.asarray(ci).astype(np.int64), np.asarray(v), m)
        print(f"SPD-ized: nnz {shape} -> {len(ci)}", flush=True)
    csr = CSR.from_numpy(rp, ci, v, (m, m))

    precond = None
    t0 = time.perf_counter()
    if args.precond == "jacobi":
        precond = jacobi_preconditioner(csr)
    elif args.precond == "ilu0":
        from ..ops.trisolve import ilu0

        precond = ilu0(csr, sweeps=args.sweeps)
    t_pre = time.perf_counter() - t0

    rng = np.random.default_rng(args.seed)
    x_true = rng.standard_normal(m)
    b = jnp.asarray(host_spmv(1.0, 0.0, rp, ci, v, x_true, np.zeros(m)))

    t0 = time.perf_counter()
    res = cg_solve(csr, b, tol=args.tol, max_iters=args.max_iters,
                   strategy=args.strategy, precond=precond)
    x_sol = np.asarray(res.x)
    t_solve = time.perf_counter() - t0
    err = float(np.linalg.norm(x_sol - x_true) / max(np.linalg.norm(x_true), 1e-300))
    ok = err < 1e-6
    print(f"{args.file} cg[{args.precond}] iters={int(res.iters)} "
          f"residual={float(res.residual_norm):.3e} rel_err={err:.3e} "
          f"precond_setup={t_pre:.2f}s solve={t_solve:.2f}s")
    print("Congratulation, solution verified!" if ok
          else f"solution FAILED verification (rel err {err:.3e})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
