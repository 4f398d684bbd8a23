"""Stats/CSV schema, verify gates, timers."""

import numpy as np
import pytest

from spmv_acc_tpu.utils.stats import (
    BenchTimes,
    bytes_moved,
    flops,
    print_statistics,
    roofline_fraction,
)
from spmv_acc_tpu.utils.timer import WallTimer, time_chained
from spmv_acc_tpu.utils.verify import VerifyReport, verify, verify_y


def test_bytes_and_flop_models():
    # statistics_logger.cpp:43-49: T*(2m+nnz) + I*(m+1+nnz); 2*nnz flops
    assert bytes_moved(10, 100, 8, 4) == 8 * (20 + 100) + 4 * (11 + 100)
    assert flops(100) == 200


def test_csv_row_schema(capsys):
    times = BenchTimes(pre=10.0, calc=100.0, fixup=5.0, destroy=1.0)
    rep = VerifyReport(max_error=1e-9, first_failed_at=-1, failed_count=0)
    row = print_statistics("mat", "flat", 1000, 1000, 5000, times, rep)
    fields = row.split(",")
    assert fields[0] == "PERFORMANCE"
    assert len(fields) == 19  # PERFORMANCE + 18 data columns
    assert fields[1] == "mat" and fields[2] == "flat"
    assert float(fields[15]) == pytest.approx(116.0)  # total us


def test_verify_y_tolerances():
    golden = np.array([1.0, 1e-13, 2.0])
    # rel err 5e-8 (pass), abs err 5e-15 near zero (pass), rel 2e-7 (fail)
    y = np.array([1.0 + 5e-8, 1e-13 + 5e-15, 2.0 + 4e-7])
    rep = verify_y(y, golden)
    assert rep.failed_count == 1 and rep.first_failed_at == 2


def test_verify_messages(capsys):
    ok = verify(np.array([1.0]), np.array([1.0]))
    out = capsys.readouterr().out
    assert ok and "Congratulation, pass 1 validation!" in out
    bad = verify(np.array([2.0]), np.array([1.0]))
    out = capsys.readouterr().out
    assert not bad and "failed at 0" in out


def test_verify_strict_relative_quirk():
    # reference verify divides by |golden| with no near-zero guard
    # (cli/verification.cpp:46): tiny golden + tiny abs error = relative blowup
    golden = np.array([1e-20])
    y = np.array([1e-20 + 1e-15])
    assert not verify(y, golden, strict_relative=True, quiet=True)
    assert verify(y, golden, strict_relative=False, quiet=True)


def test_wall_timer():
    t = WallTimer().start()
    x = sum(range(10000))
    el = t.stop()
    assert el >= 0


def test_time_chained_counts_iterations():
    calls = []

    def step(c):
        calls.append(1)
        return c + 1

    import jax.numpy as jnp

    per, out = time_chained(step, jnp.zeros(()), iters=10, baseline_iters=2)
    assert per >= 0
    assert float(out) == 10.0


def test_roofline_fraction_monotone():
    f_fast = roofline_fraction(1000, 100000, time_us=10.0, peak_gbs=819.0)
    f_slow = roofline_fraction(1000, 100000, time_us=100.0, peak_gbs=819.0)
    assert f_fast > f_slow > 0


def test_cache_dir_env_override_and_repo_local(monkeypatch, tmp_path):
    """cache_dir: env override wins; default is the checkout's .cache/<kind>."""
    from spmv_acc_tpu.config import cache_dir

    monkeypatch.setenv("SPMV_CORPUS_CACHE", str(tmp_path / "c"))
    assert cache_dir("corpus") == str(tmp_path / "c")
    monkeypatch.delenv("SPMV_CORPUS_CACHE", raising=False)
    d = cache_dir("corpus")
    import os

    assert d.endswith(os.path.join(".cache", "corpus")) and os.path.isdir(d)
