"""Weak-scaling benchmark for distributed SpMV (BASELINE.json config 5).

Weak scaling: per-device problem size is fixed; the matrix grows with the device
count.  Reports nnz/s per device count and parallel efficiency vs 1 device.  Runs on
whatever mesh is available: several GPUs of one host, or the virtual CPU mesh
(``--xla_force_host_platform_device_count``), which validates the
sharding/collective structure (compile + execute) but whose timings say nothing
about a device: every virtual device shares the host's cores, so ``efficiency``
trends to 1/D there by construction.

Usage: python -m spmv_acc_tpu.parallel.scaling_bench [--devices 1,2,4]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def run_weak_scaling(device_counts, rows_per_device=32768, avg_nnz=16, iters=20,
                     dtype=None):
    """Time the distributed SpMV on a banded matrix of ``rows_per_device * D``
    rows for each device count D (halo exchange when the partition allows it,
    else all-gather).  ``dtype=None`` follows ``jax_enable_x64`` (f64 when on,
    f32 otherwise)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..formats.generate import banded_csr
    from ..utils.timer import time_device_loop
    from . import make_mesh, partition_rows, shard_partitioned
    from .dist_spmv import dist_spmv_fn, dist_spmv_halo_fn, halo_feasible

    if dtype is None:
        dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
    results = []
    base_rate = None
    for d in device_counts:
        if d > len(jax.devices()):
            print(f"skip D={d}: only {len(jax.devices())} devices", file=sys.stderr)
            continue
        m = rows_per_device * d
        csr = banded_csr(m, bandwidth=min(avg_nnz | 1, m), seed=11, dtype=dtype)
        mesh = make_mesh(d)
        part = shard_partitioned(partition_rows(csr, d, balance=False), mesh)
        halo = halo_feasible(part)
        run, x_pad = (dist_spmv_halo_fn if halo else dist_spmv_fn)(mesh, part)
        x = jnp.zeros((d * x_pad,), dtype=csr.values.dtype)
        x = jax.device_put(x.at[: csr.cols].set(1.0), NamedSharding(mesh, P("x")))

        def step(x):
            y = run(part.values, part.col_idx, part.row_ids, x)
            # renormalised feedback keeps the chain honest without divergence
            flat = y.reshape(-1)[: d * x_pad]
            return flat * (1.0 / jnp.maximum(jnp.max(jnp.abs(flat)), 1e-30))

        # ONE on-device fori_loop program (CG-loop shape): the mesh runs one
        # executable per measurement instead of one rendezvous per iteration
        per_us, _ = time_device_loop(step, x, iters=iters)
        rate = csr.nnz / (per_us * 1e-6) if per_us > 0 else 0.0
        per_dev = rate / d
        if base_rate is None:
            base_rate = per_dev
        eff = per_dev / base_rate if base_rate else 0.0
        results.append(dict(devices=d, rows=m, nnz=csr.nnz, halo=halo,
                            us_per_spmv=per_us, nnz_per_s=rate, efficiency=eff))
        print(f"D={d}: m={m} nnz={csr.nnz} halo={halo} {per_us:.1f}us/spmv "
              f"{rate/1e6:.1f}M nnz/s eff={eff:.2%}", file=sys.stderr)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="scaling-bench")
    p.add_argument("--devices", default="1,2,4")
    p.add_argument("--rows-per-device", type=int, default=32768)
    p.add_argument("--avg-nnz", type=int, default=16)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--out", default=None, help="also write the JSON record here")
    args = p.parse_args(argv)
    import jax

    counts = [int(c) for c in args.devices.split(",")]
    results = run_weak_scaling(counts, args.rows_per_device, args.avg_nnz, args.iters)
    dev = jax.devices()[0]
    doc = {"weak_scaling": results, "platform": dev.platform,
           "device_kind": dev.device_kind, "device_count": len(jax.devices())}
    print(json.dumps(doc))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
