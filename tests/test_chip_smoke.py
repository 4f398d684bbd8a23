"""chip_smoke.py's phases at a tiny size on the CPU (Pallas in interpret mode),
and its refusal to run anywhere but on a GPU."""

import jax
import numpy as np
import pytest

import chip_smoke
from spmv_acc_tpu.formats import random_csr
from spmv_acc_tpu.formats.generate import aniso_laplacian_csr, fem_like_csr, powerlaw_csr


def test_main_refuses_non_gpu(capsys):
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_main_four_refuses_non_gpu(capsys):
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.main(["--four"])
    assert '"ok"' not in capsys.readouterr().out


def test_phase_spmv_tiny():
    line = chip_smoke.phase_spmv(fem_like_csr(600, 600, 12000, seed=1))
    assert line.startswith("phase 1 spmv: rows=600 nnz=12000") and "alpha=2.5" in line


def test_phase_strategies_tiny():
    line = chip_smoke.phase_strategies(
        {"rand": random_csr(120, 100, 900, seed=2),
         "pl": powerlaw_csr(150, 150, avg_nnz=6, seed=3)}, require_compiled=False)
    assert "48 runs golden-matched" in line


def test_kernel_is_not_compiled_on_cpu():
    """On the CPU the kernel runs in the interpreter, so the compiled check
    that phase 2 makes on the GPU must say no here."""
    import jax.numpy as jnp

    csr = random_csr(40, 40, 200, seed=4)
    assert not chip_smoke.kernel_is_compiled(csr, jnp.ones(40), jnp.ones(40))
    with pytest.raises(AssertionError, match="Triton"):
        chip_smoke.phase_strategies({"r": csr})


def test_phase_clis_tiny(tmp_path):
    line = chip_smoke.phase_clis(fem_like_csr(300, 300, 4800, seed=4), str(tmp_path))
    assert "spmv-cli pass 300 validation" in line and "cg[ilu0]" in line


def test_phase_cg_tiny():
    line = chip_smoke.phase_cg(aniso_laplacian_csr(20, 20, 1e-2))
    assert "jacobi iters=" in line and "ilu0 iters=" in line


def test_phase_spmm_spgemm_tiny():
    line = chip_smoke.phase_spmm_spgemm(random_csr(80, 80, 600, seed=5))
    assert "spmm k=8" in line and "spgemm A@A nnz 600" in line


def test_phase_four_on_virtual_devices():
    assert len(jax.devices()) >= 4
    line = chip_smoke.phase_four(4, fem_like_csr(4000, 4000, 60000, seed=6), "fem", 32)
    assert "all-gather fem" in line and "halo laplacian-32^2" in line and "dist_cg" in line


def test_shifted_laplacian_is_spd():
    csr = chip_smoke._shifted_laplacian(6, 5, shift=4.0)
    from spmv_acc_tpu.formats.convert import csr_to_dense

    d = csr_to_dense(*csr.to_numpy())
    np.testing.assert_allclose(d, d.T)
    assert np.linalg.eigvalsh(d).min() > 3.9
