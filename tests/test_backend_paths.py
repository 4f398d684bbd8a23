"""What decides the path a call takes: the strategy picker's GPU branch, the
refusal of strategy names with no build, the peak table, the compile-cache
helper and the profiler wrapper.  Backends are monkeypatched inside each test;
nothing here depends on the machine the tests run on."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmv_acc_tpu import config, dispatch
from spmv_acc_tpu.formats import banded_csr, dense_row_outlier_csr, powerlaw_csr, random_csr
from spmv_acc_tpu.formats.containers import CSR
from spmv_acc_tpu.formats.generate import fem_like_csr, random_x_y
from spmv_acc_tpu.plan import get_plan
from spmv_acc_tpu.utils import stats

MATRICES = {
    "banded": lambda: banded_csr(200, bandwidth=5, seed=0),
    "random": lambda: random_csr(150, 120, 1800, seed=1),
    "powerlaw": lambda: powerlaw_csr(180, 180, avg_nnz=6, seed=2),
    "outlier": lambda: dense_row_outlier_csr(128, 128, avg_nnz=3, n_dense=2, seed=3),
    "short_rows": lambda: random_csr(300, 300, 600, seed=4),
    "fem": lambda: fem_like_csr(240, 240, 7200, block=3, seed=5),
    "single_row": lambda: random_csr(1, 64, 30, seed=6),
}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_pick_strategy_gpu_branch(monkeypatch, name):
    """On the GPU: the vector_row kernel where ELL would pad by
    GPU_KERNEL_MIN_ELL_PAD or more (where it won on the card), else ELL."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    csr = MATRICES[name]()
    plan = get_plan(csr)
    pad = dispatch.ell_cells(plan) / csr.nnz
    expect = "vector_row" if pad >= dispatch.GPU_KERNEL_MIN_ELL_PAD else "ell"
    assert dispatch.pick_strategy(plan) == expect


def _uniform_rows(m, k, n=4096, seed=0):
    rng = np.random.default_rng(seed)
    ci = np.sort(np.stack([rng.choice(n, size=k, replace=False) for _ in range(m)]), axis=1)
    rp = np.arange(m + 1, dtype=np.int32) * k
    return CSR.from_numpy(rp, ci.reshape(-1).astype(np.int32), rng.uniform(-1, 1, m * k), (m, n))


@pytest.mark.parametrize("k,expect", [(16, "ell"), (24, "ell"), (13, "ell"),
                                      (12, "vector_row"), (5, "vector_row")])
def test_pick_strategy_gpu_padding_rule(monkeypatch, k, expect):
    """Uniform rows of k nnz: ELL pads to a multiple of 8 (16 -> 1.0x,
    24 -> 1.0x, 13 -> 1.23x, 12 -> 1.33x, 5 -> 1.6x)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert dispatch.pick_strategy(get_plan(_uniform_rows(64, k))) == expect


def test_pick_strategy_gpu_ell_budget(monkeypatch):
    """A slab past the ELL cell budget goes to the kernel, which reads CSR as stored."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(dispatch, "_ELL_MAX_CELLS", 100)
    assert dispatch.pick_strategy(get_plan(_uniform_rows(64, 16))) == "vector_row"


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_pick_strategy_cpu_keeps_reference_tree(name):
    assert dispatch.pick_strategy(get_plan(MATRICES[name]())) in {"line", "ell", "flat"}


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_pick_strategy_empty_matrix(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    empty = CSR.from_numpy(np.zeros(4, np.int32), np.zeros(0, np.int32), np.zeros(0), (3, 3))
    assert dispatch.pick_strategy(get_plan(empty)) == "default"


@pytest.mark.parametrize("name", ["adaptive_plus", "swell", "bogus"])
def test_strategy_without_build_is_refused(name):
    csr = random_csr(20, 20, 60, seed=1)
    x = jnp.ones(20)
    with pytest.raises(ValueError, match="vector_row"):
        dispatch.spmv(csr, x, strategy=name)
    with pytest.raises(ValueError, match="one of"):
        dispatch.make_spmv_fn(csr, strategy=name)


def test_cli_refuses_removed_strategy(tmp_path, capsys):
    from spmv_acc_tpu.cli.main import main
    from spmv_acc_tpu.io.csr_text import write_csr_text

    csr = random_csr(30, 30, 120, seed=2)
    rp, ci, v, (m, n) = csr.to_numpy()
    path = str(tmp_path / "m.csr")
    write_csr_text(path, rp, ci, v, random_x_y(n, m, seed=3)[0])
    assert main([path, "-f", "csr", "-s", "adaptive_plus"]) == 2
    assert "unknown strategy 'adaptive_plus'" in capsys.readouterr().err


class _Dev:
    def __init__(self, kind):
        self.device_kind = kind


def test_peak_table_h100():
    peaks = stats.chip_peaks(_Dev("NVIDIA H100 80GB HBM3"))
    assert peaks["hbm_gbs"] == 3350.0
    assert peaks["f64_tflops_vector"] == 34.0 and peaks["f64_tflops_tensor"] == 67.0
    assert stats.chip_peak_gbs(_Dev("NVIDIA H100 80GB HBM3")) == 3350.0


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        stats.chip_peak_gbs(_Dev(kind))


def test_roofline_needs_a_known_device():
    """Without an explicit peak the CPU test device has no entry: an error,
    never a silent default."""
    with pytest.raises(KeyError):
        stats.roofline_fraction(1000, 100000, time_us=10.0)
    assert stats.roofline_fraction(1000, 100000, time_us=10.0, peak_gbs=3350.0) > 0


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    before = jax.config.jax_compilation_cache_dir
    assert config.setup_compile_cache() == str(tmp_path / "jc")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        d = config.setup_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(config.__file__)))
        assert d == os.path.join(root, ".cache", "jax") and os.path.isdir(d)
        assert jax.config.jax_compilation_cache_dir == d
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_profiler_trace_raises_when_it_cannot_start(monkeypatch, tmp_path):
    from spmv_acc_tpu.utils import profiling

    def refuse(_):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(jax.profiler, "start_trace", refuse)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with profiling.trace(str(tmp_path)):
            pass
