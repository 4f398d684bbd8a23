"""Populate the corpus disk cache (bin2 stand-ins of the bench matrices) on the
CPU, so a later `bench.py` run loads each matrix in seconds instead of
generating it.  Safe to run beside a GPU run: it never opens the GPU
(JAX_PLATFORMS=cpu) and cache writes are atomic (tmp+rename).

Usage: JAX_PLATFORMS=cpu python scripts/populate_caches.py [names...]
"""
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)  # CSR holds jnp arrays; without x64 values downcast to f32
import numpy as np  # noqa: E402

DEFAULT = [
    "rajat03", "poli_large", "dw4096", "bayer10", "epb1", "bcsstk18",
    "coater2", "nemeth03", "exdata_1", "af23560",
    "largebasis", "Ga41As41H72", "TSOPF_RS_b2383", "boneS10", "Hardesty3",
    "dielFilterV3real", "RM07R", "vas_stokes_2M", "Cube_Coup_dt6", "Bump_2911",
]

if __name__ == "__main__":
    from spmv_acc_tpu.formats.generate import example_like

    for name in sys.argv[1:] or DEFAULT:
        t0 = time.perf_counter()
        csr = example_like(name, dtype=np.float64)
        print(f"{name}: rows={csr.rows} nnz={csr.nnz} gen+cache "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
