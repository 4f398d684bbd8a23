"""The Triton vector_row kernel in interpret mode against the host golden: every
matrix family x dtype x (lanes, tile), the shapes that stress its masking, the
lane-width rule, and the backend rule that decides interpret vs compiled."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmv_acc_tpu import config
from spmv_acc_tpu.formats import banded_csr, dense_row_outlier_csr, powerlaw_csr, random_csr
from spmv_acc_tpu.formats.containers import CSR
from spmv_acc_tpu.formats.generate import fem_like_csr, random_x_y
from spmv_acc_tpu.ops.golden import host_spmv
from spmv_acc_tpu.ops.vector_row import lanes_for, vector_row_ax
from spmv_acc_tpu.utils.verify import verify_y

FAMILIES = {
    "banded": lambda dt: banded_csr(200, bandwidth=5, seed=0, dtype=dt),
    "random": lambda dt: random_csr(150, 120, 1800, seed=1, dtype=dt),
    "powerlaw": lambda dt: powerlaw_csr(180, 180, avg_nnz=6, seed=2, dtype=dt),
    "outlier": lambda dt: dense_row_outlier_csr(128, 128, avg_nnz=3, n_dense=2, seed=3, dtype=dt),
    "short_rows": lambda dt: random_csr(300, 300, 600, seed=4, dtype=dt),
    "fem": lambda dt: fem_like_csr(240, 240, 7200, block=3, seed=5, dtype=dt),
    "single_row": lambda dt: random_csr(1, 64, 30, seed=6, dtype=dt),
}
# (lanes, tile): rows per program = tile // lanes, from 1 to 64
SHAPES = [(2, 64), (4, 16), (16, 256), (64, 1024)]


def _run(csr, dtype, lanes, tile, alpha=1.25, beta=-0.5, positive=False, seed=11):
    m, n = csr.shape
    x, y = random_x_y(n, m, seed=seed, dtype=dtype)
    if positive:
        x, y = np.abs(x), np.abs(y)
    out = vector_row_ax(csr, jnp.asarray(x), jnp.asarray(y), alpha, beta, lanes, tile)
    golden = host_spmv(alpha, beta, *csr.to_numpy()[:3], x, y)
    return out, golden


@pytest.mark.parametrize("lanes,tile", SHAPES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_kernel_matches_golden(family, dtype, lanes, tile):
    csr = FAMILIES[family](dtype)
    if dtype == np.float32:  # positive data: the f32 gate bounds the kernel, not cancellation
        rp, ci, v, shape = csr.to_numpy()
        csr = CSR.from_numpy(rp, ci, np.abs(v), shape)
    out, golden = _run(csr, dtype, lanes, tile, beta=0.5 if dtype == np.float32 else -0.5,
                       positive=dtype == np.float32)
    assert out.dtype == dtype and out.shape == (csr.rows,)
    rep = verify_y(np.asarray(out), golden, dtype=dtype)
    assert rep.ok, f"{family} {np.dtype(dtype).name} lanes={lanes} tile={tile}: {rep}"


def _from_rows(row_lens, n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    rp = np.concatenate([[0], np.cumsum(row_lens)]).astype(np.int32)
    ci = np.concatenate([np.sort(rng.choice(n, size=k, replace=False)) for k in row_lens]
                        or [np.zeros(0, np.int64)]).astype(np.int32)
    v = rng.uniform(-1, 1, size=int(rp[-1])).astype(dtype)
    return CSR.from_numpy(rp, ci, v, (len(row_lens), n))


@pytest.mark.parametrize("lanes,tile", [(2, 64), (8, 256), (32, 128)])
def test_empty_rows(lanes, tile):
    csr = _from_rows([0, 3, 0, 0, 7, 0, 1, 0, 0, 0, 5, 0], 40, seed=1)
    out, golden = _run(csr, np.float64, lanes, tile)
    assert verify_y(np.asarray(out), golden).ok


@pytest.mark.parametrize("lanes", [2, 16, 64])
def test_one_very_long_row(lanes):
    """One 3000-nnz row among short rows: its program loops ~3000/lanes times
    while its neighbours' lanes stay masked."""
    csr = _from_rows([2, 1, 3000, 0, 4] * 3, 4000, seed=2)
    out, golden = _run(csr, np.float64, lanes, 128)
    assert verify_y(np.asarray(out), golden).ok


@pytest.mark.parametrize("rows", [1, 7, 33, 129])
def test_rows_not_divisible_by_block(rows):
    csr = random_csr(rows, 50, rows * 4, seed=rows)
    out, golden = _run(csr, np.float64, 4, 128)  # 32 rows per program
    assert out.shape == (rows,)
    assert verify_y(np.asarray(out), golden).ok


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nnz_zero(dtype):
    csr = CSR.from_numpy(np.zeros(6, np.int32), np.zeros(0, np.int32),
                         np.zeros(0, dtype), (5, 9))
    out, golden = _run(csr, dtype, 8, 256, alpha=3.0, beta=2.0)
    assert out.shape == (5,) and out.dtype == dtype
    np.testing.assert_allclose(np.asarray(out), golden, rtol=1e-6)


@pytest.mark.parametrize("alpha,beta", [(0.0, 2.0), (1.0, 0.0), (-3.5, 1.0), (2.0, -2.0)])
def test_alpha_beta(alpha, beta):
    csr = random_csr(64, 64, 512, seed=7)
    out, golden = _run(csr, np.float64, 8, 256, alpha=alpha, beta=beta)
    assert verify_y(np.asarray(out), golden).ok, (alpha, beta)


def test_traced_alpha_beta_under_jit():
    """alpha/beta may be traced: one compile serves every value."""
    csr = random_csr(64, 64, 512, seed=8)
    x, y = random_x_y(64, 64, seed=9)

    @jax.jit
    def f(a, b, xx, yy):
        return vector_row_ax(csr, xx, yy, a, b, 8, 256)

    for a, b in [(1.0, 0.0), (0.5, 3.0)]:
        golden = host_spmv(a, b, *csr.to_numpy()[:3], x, y)
        assert verify_y(np.asarray(f(a, b, jnp.asarray(x), jnp.asarray(y))), golden).ok


@pytest.mark.parametrize("avg,lanes", [(0.5, 2), (4.0, 2), (4.1, 4), (8.0, 4),
                                       (12.0, 8), (30.8, 16), (35.0, 32), (424.0, 64)])
def test_lanes_for_reference_thresholds(avg, lanes):
    """hip-vector-row/vector_row.cpp:15-27: avg <= 4/8/16/32/64 -> 2..32, else 64."""
    assert lanes_for(avg) == lanes


@pytest.mark.parametrize("backend,expect", [("cpu", True), ("gpu", False)])
def test_pallas_interpret_backend_rule(monkeypatch, backend, expect):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert config.pallas_interpret() is expect


@pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
def test_pallas_interpret_refuses_other_backends(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match="no Pallas kernel build"):
        config.pallas_interpret()


@pytest.mark.parametrize("nnz,lanes", [(7200, 16), (960, 2), (24000, 64)])
def test_strategy_takes_lanes_from_plan(monkeypatch, nnz, lanes):
    """spmv(strategy='vector_row') takes lanes from avg nnz/row, tile TILE."""
    from spmv_acc_tpu import spmv
    from spmv_acc_tpu.ops import vector_row as vr

    seen = []
    orig = vr.vector_row_ax
    monkeypatch.setattr(vr, "vector_row_ax",
                        lambda *a: seen.append(a[-2:]) or orig(*a))
    csr = fem_like_csr(240, 240, nnz, block=3, seed=5)
    x, y = random_x_y(240, 240, seed=1)
    spmv(csr, jnp.asarray(x), jnp.asarray(y), strategy="vector_row")
    assert seen == [(lanes, vr.TILE)]
