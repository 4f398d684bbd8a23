"""Per-strategy parametrized SpMV tests across row-length distributions — the test
matrix SURVEY.md §4 calls for (the reference had only embedded golden checks)."""

import jax.numpy as jnp
import numpy as np
import pytest

from spmv_acc_tpu import CSR, spmv
from spmv_acc_tpu.dispatch import Handle, sparse_csr_spmv
from spmv_acc_tpu.formats import (
    banded_csr,
    dense_row_outlier_csr,
    powerlaw_csr,
    random_csr,
)
from spmv_acc_tpu.formats.generate import random_x_y
from spmv_acc_tpu.ops.golden import host_spmv
from spmv_acc_tpu.utils.verify import verify_y

MATRICES = {
    "banded": lambda: banded_csr(200, bandwidth=5, seed=0),
    "random": lambda: random_csr(150, 120, 1800, seed=1),
    "powerlaw": lambda: powerlaw_csr(180, 180, avg_nnz=6, seed=2),
    "outlier": lambda: dense_row_outlier_csr(128, 128, avg_nnz=3, n_dense=2, seed=3),
    "short_rows": lambda: random_csr(300, 300, 600, seed=4),  # avg 2/row, empty rows
    "tiny": lambda: random_csr(5, 7, 12, seed=5),
    "single_row": lambda: random_csr(1, 64, 30, seed=6),
}

STRATEGIES = ["default", "line", "ell", "flat", "vector_row",
              "thread_row", "wf_row", "block_row", "light", "line_enhance", "acsr"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("matrix_name", sorted(MATRICES))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_matches_golden(matrix_name, strategy, dtype):
    """f64 at the reference gate (rel 1e-7); f32 at REL_TOL_F32 (rel 1e-3) on
    positive data, so the gate bounds the strategy's error and not f32
    cancellation."""
    csr = MATRICES[matrix_name]()
    m, n = csr.shape
    x, y = random_x_y(n, m, seed=11)
    alpha, beta = 1.25, -0.5
    if dtype == np.float32:
        rp, ci, v, shape = csr.to_numpy()
        csr = CSR.from_numpy(rp, ci, np.abs(v).astype(np.float32), shape)
        x, y = np.abs(x).astype(np.float32), np.abs(y).astype(np.float32)
        beta = 0.5
    golden = host_spmv(alpha, beta, *csr.to_numpy()[:3], x, y)
    out = spmv(csr, jnp.asarray(x), jnp.asarray(y), alpha=alpha, beta=beta, strategy=strategy)
    assert out.dtype == dtype
    rep = verify_y(np.asarray(out), golden, dtype=dtype)
    assert rep.ok, f"{strategy} on {matrix_name} {np.dtype(dtype).name}: {rep}"


@pytest.mark.parametrize("mode", ["default", "reg", "lds"])
@pytest.mark.parametrize("strategy", ["wf_row", "block_row"])
def test_wf_reduce_variants_match_golden(strategy, mode, monkeypatch):
    """The WF_REDUCE build-variant analog (reference config.cmake:30-34):
    all three reduce mechanisms (staged / shfl-ladder tree / LDS segment-sum)
    pass the golden gate on an irregular matrix."""
    monkeypatch.setenv("SPMV_WF_REDUCE", mode)
    csr = MATRICES["powerlaw"]()
    m, n = csr.shape
    x, y = random_x_y(n, m, seed=21)
    alpha, beta = 0.75, 2.0
    golden = host_spmv(alpha, beta, *csr.to_numpy()[:3], x, y)
    out = spmv(csr, jnp.asarray(x), jnp.asarray(y), alpha=alpha, beta=beta,
               strategy=strategy)
    rep = verify_y(np.asarray(out), golden)
    assert rep.ok, f"{strategy}[{mode}]: {rep}"


@pytest.mark.parametrize("matrix_name", sorted(MATRICES))
def test_adaptive_matches_golden(matrix_name):
    csr = MATRICES[matrix_name]()
    m, n = csr.shape
    x, y = random_x_y(n, m, seed=12)
    golden = host_spmv(1.0, 1.0, *csr.to_numpy()[:3], x, y)
    handle = Handle()
    out = spmv(csr, jnp.asarray(x), jnp.asarray(y), alpha=1.0, beta=1.0, handle=handle)
    rep = verify_y(np.asarray(out), golden)
    assert rep.ok, f"adaptive({handle.strategy_used}) on {matrix_name}: {rep}"
    assert handle.strategy_used in {"default", "line", "ell", "flat", "vector_row"}
    assert handle.kernel_time_us > 0


def test_alpha_beta_semantics():
    """True alpha/beta handling — the reference's line/flat kernels silently assume
    beta == 1 (SURVEY.md §7.3); ours must honor arbitrary values everywhere."""
    csr = random_csr(64, 64, 512, seed=7)
    m, n = csr.shape
    x, y = random_x_y(n, m, seed=13)
    for alpha, beta in [(0.0, 2.0), (1.0, 0.0), (-3.5, 1.0), (2.0, -2.0)]:
        golden = host_spmv(alpha, beta, *csr.to_numpy()[:3], x, y)
        out = spmv(csr, jnp.asarray(x), jnp.asarray(y), alpha=alpha, beta=beta, strategy="line")
        assert verify_y(np.asarray(out), golden).ok, (alpha, beta)


def test_transpose():
    csr = random_csr(50, 70, 400, seed=8)
    x = np.random.default_rng(0).random(50)
    from spmv_acc_tpu.formats.convert import csr_to_dense

    dense = csr_to_dense(*csr.to_numpy())
    golden = dense.T @ x
    out = spmv(csr, jnp.asarray(x), trans="T", strategy="default")
    assert verify_y(np.asarray(out), golden).ok


def test_reference_shim_signature():
    csr = random_csr(32, 32, 128, seed=9)
    x, y = random_x_y(32, 32, seed=14)
    out = sparse_csr_spmv("N", 1.0, 1.0, csr, jnp.asarray(x), jnp.asarray(y))
    golden = host_spmv(1.0, 1.0, *csr.to_numpy()[:3], x, y)
    assert verify_y(np.asarray(out), golden).ok


def test_float32_path():
    csr = random_csr(64, 64, 400, seed=10).astype(jnp.float32)
    x, y = random_x_y(64, 64, seed=15, dtype=np.float32)
    golden = host_spmv(1.0, 1.0, *csr.to_numpy()[:3], x, y)
    out = spmv(csr, jnp.asarray(x), jnp.asarray(y), alpha=1.0, beta=1.0, strategy="line")
    rep = verify_y(np.asarray(out), golden, dtype=np.float32)
    assert rep.ok, rep


@pytest.mark.parametrize("strategy", ["thread_row", "wf_row", "block_row", "light", "acsr"])
def test_zoo_dense_row_spill(strategy):
    """A single 100k-nnz row must NOT make the zoo pack O(m * 100k): rows past
    the width cap spill to a COO tail (the reference's long-row fallback spirit,
    hip-thread-row/thread_row.cpp:17-49), and results still match golden."""
    csr = dense_row_outlier_csr(1000, 200_000, avg_nnz=3, n_dense=1, seed=21)
    m, n = csr.shape
    assert int(np.diff(csr.to_numpy()[0]).max()) >= 100_000  # the outlier row

    from spmv_acc_tpu.ops.zoo import _WIDTH_CAP, _row_packed

    cols, vals, tail = _row_packed(csr, 8)
    assert cols.shape[1] <= _WIDTH_CAP, "pack width must be capped"
    assert tail[0].shape[0] > 0, "outlier nnz must land in the COO tail"

    x, y = random_x_y(n, m, seed=22)
    golden = host_spmv(1.5, -0.5, *csr.to_numpy()[:3], x, y)
    out = spmv(csr, jnp.asarray(x), jnp.asarray(y), alpha=1.5, beta=-0.5, strategy=strategy)
    rep = verify_y(np.asarray(out), golden)
    assert rep.ok, f"{strategy}: {rep}"


@pytest.mark.slow
def test_make_spmv_fn_retrace_safe():
    """Strategy plan caches must hold real arrays, not tracers: wrapping the
    jitted fn in ANOTHER jit re-traces it, which dies with
    UnexpectedTracerError if a first-use cache captured traced intermediates
    (regression: ell/zoo engines under the benchmark harness's chained timer)."""
    import jax
    import jax.numpy as jnp

    from spmv_acc_tpu.dispatch import make_spmv_fn
    from spmv_acc_tpu.formats.generate import banded_csr, random_x_y

    csr = banded_csr(400, bandwidth=5, seed=13)
    x, y = random_x_y(400, 400, seed=14)
    for strategy in ("ell", "thread_row", "light", "vector_row"):
        fn, _ = make_spmv_fn(csr, strategy=strategy)

        @jax.jit
        def outer(xx, yy, fn=fn):
            return fn(xx, yy) * 2.0

        out = outer(jnp.asarray(x), jnp.asarray(y))
        assert out.shape == (400,)


def test_ell_blowup_guard_falls_back(monkeypatch):
    """A long-row outlier must not densify to O(m * maxlen): the ell branch
    falls back to flat past _ELL_MAX_CELLS (a 4120-long row in a 200k-row
    power-law matrix makes the ELL slab ~3 GB).  vector_row reads CSR as
    stored and needs no guard: it must stay exact on the same matrix."""
    import jax.numpy as jnp

    from spmv_acc_tpu import dispatch
    from spmv_acc_tpu.formats.generate import dense_row_outlier_csr, random_x_y
    from spmv_acc_tpu.ops.golden import host_spmv

    csr = dense_row_outlier_csr(3000, 3000, avg_nnz=4, seed=43)
    rp, ci, v, _ = csr.to_numpy()
    x, y = random_x_y(3000, 3000, seed=44)
    golden = host_spmv(1.0, 1.0, rp, ci, v, x, y)
    monkeypatch.setattr(dispatch, "_ELL_MAX_CELLS", 1 << 16)
    from spmv_acc_tpu.plan import get_plan

    assert dispatch.ell_cells(get_plan(csr)) > 1 << 16
    for strat in ("vector_row", "ell"):
        out = np.asarray(dispatch.spmv(csr, jnp.asarray(x), jnp.asarray(y),
                                       alpha=1.0, beta=1.0, strategy=strat))
        assert verify_y(out, golden).ok, strat
