"""spmv_acc_tpu — a JAX sparse linear-algebra framework for the GPU.

Brand-new JAX/XLA/Pallas implementation with the capabilities of hpcde/spmv-acc
(HPDC'23 "Efficient Algorithm Design of Optimizing SpMV on GPU"): CSR/COO/BSR/ELL
containers, a zoo of SpMV kernel strategies behind a runtime picker, SpMM/SpGEMM,
ILU(0) + triangular solves, matrix ingest (csr/mtx/bin2) with golden verification,
a benchmark harness, and multi-device row-partitioned SpMV via shard_map.

Public API highlights::

    from spmv_acc_tpu import CSR, spmv, spmm, spgemm
    y = spmv(csr, x, alpha=1.0, beta=1.0, strategy="adaptive")
"""

from .config import DEFAULT_TUNE, TuneConfig
from .dispatch import Handle, STRATEGIES, pick_strategy, sparse_csr_spmv, spmv
from .formats import (
    BSR,
    COO,
    CSR,
    ELL,
    banded_csr,
    coo_to_csr,
    csr_to_bsr,
    csr_to_ell,
    example_like,
    powerlaw_csr,
    random_csr,
    sparse_operation,
)
from .io import load_matrix, read_bin2, read_csr_text, read_mtx, write_bin2
from .ops.bsr import bsr_spmm, bsr_spmv
from .ops.spgemm import spgemm
from .ops.spmm import spmm
from .ops.trisolve import ilu0, trisolve
from .plan import Plan, analyze, get_plan
from .utils import verify, verify_y

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_TUNE",
    "TuneConfig",
    "Handle",
    "STRATEGIES",
    "pick_strategy",
    "sparse_csr_spmv",
    "spmv",
    "BSR",
    "COO",
    "CSR",
    "ELL",
    "banded_csr",
    "coo_to_csr",
    "csr_to_bsr",
    "csr_to_ell",
    "example_like",
    "powerlaw_csr",
    "random_csr",
    "sparse_operation",
    "load_matrix",
    "read_bin2",
    "read_csr_text",
    "read_mtx",
    "write_bin2",
    "bsr_spmm",
    "bsr_spmv",
    "spgemm",
    "spmm",
    "ilu0",
    "trisolve",
    "Plan",
    "analyze",
    "get_plan",
    "verify",
    "verify_y",
    "__version__",
]
