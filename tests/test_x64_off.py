"""x64-OFF regression tests (VERDICT r3 #1).

The main suite force-enables x64 (conftest), so an x64-off environment is never
seen there: f64 numpy values would be silently downcast to f32 by
``jnp.asarray``.  These tests run the hazard paths in a subprocess with x64 OFF.
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest


def _run_x64_off(code: str, timeout=240):
    """Run ``code`` in a fresh interpreter with x64 off on the CPU backend."""
    prelude = textwrap.dedent(
        """
        import jax
        jax.config.update("jax_platforms", "cpu")
        assert not jax.config.jax_enable_x64
        import numpy as np
        """
    )
    return subprocess.run(
        [sys.executable, "-c", prelude + textwrap.dedent(code)],
        capture_output=True, text=True, timeout=timeout,
    )


def test_from_numpy_refuses_silent_downcast():
    r = _run_x64_off(
        """
        from spmv_acc_tpu.formats.containers import CSR
        rp = np.array([0, 1], np.int32); ci = np.array([0], np.int32)
        try:
            CSR.from_numpy(rp, ci, np.array([1.0], np.float64), (1, 1))
        except ValueError as e:
            assert "downcast" in str(e), e
            print("GUARD_OK")
        else:
            raise SystemExit("silent downcast not caught")
        # explicit cast is the sanctioned path
        c = CSR.from_numpy(rp, ci, np.array([1.0], np.float32), (1, 1))
        assert c.values.dtype == np.float32
        print("EXPLICIT_OK")
        """
    )
    assert r.returncode == 0, r.stderr
    assert "GUARD_OK" in r.stdout and "EXPLICIT_OK" in r.stdout


@pytest.mark.slow
def test_weak_scaling_gate_x64_off():
    """run_weak_scaling with its default dtype under x64-off must run (f32)
    and report an efficiency."""
    r = _run_x64_off(
        """
        from spmv_acc_tpu.parallel.scaling_bench import run_weak_scaling
        scal = run_weak_scaling([1], rows_per_device=32768, iters=2)
        assert len(scal) == 1, scal
        assert scal[0]["efficiency"] == 1.0, scal
        print("SCAL_OK", scal[0]["us_per_spmv"])
        """,
        timeout=420,
    )
    assert r.returncode == 0, r.stderr
    assert "SCAL_OK" in r.stdout
