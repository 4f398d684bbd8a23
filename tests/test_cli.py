"""CLI-layer tests: spmv-cli flow, csr-tool, suitesparse-dl offline subcommands."""

import numpy as np
import pytest

from spmv_acc_tpu.cli.csr_tool import main as csr_tool_main
from spmv_acc_tpu.cli.main import main as spmv_cli_main
from spmv_acc_tpu.cli.suitesparse_dl import bucket_of, main as ssdl_main
from spmv_acc_tpu.formats import random_csr
from spmv_acc_tpu.formats.generate import random_x_y
from spmv_acc_tpu.io.csr_text import write_csr_text
from spmv_acc_tpu.io.matrix_market import write_mtx


@pytest.fixture
def csr_file(tmp_path):
    csr = random_csr(40, 40, 300, seed=51)
    rp, ci, v, shape = csr.to_numpy()
    x, _ = random_x_y(shape[1], shape[0], seed=52)
    path = tmp_path / "test.csr"
    write_csr_text(path, rp, ci, v, x)
    return str(path)


def test_spmv_cli_pass(csr_file, capsys):
    rc = spmv_cli_main([csr_file, "-f", "csr"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "elapsed time:" in out
    assert "Congratulation, pass 40 validation!" in out


def test_spmv_cli_strategy_flag(csr_file, capsys):
    rc = spmv_cli_main([csr_file, "-f", "csr", "-s", "line", "--alpha", "2.0", "--beta", "-1.0"])
    assert rc == 0
    assert "pass 40 validation" in capsys.readouterr().out


def test_spmv_cli_missing_file(tmp_path, capsys):
    rc = spmv_cli_main([str(tmp_path / "nope.csr"), "-f", "csr"])
    assert rc == 2


def test_csr_tool_nnz(csr_file, capsys):
    rc = csr_tool_main(["nnz", "-i", csr_file, "-p", "4"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "part,rows,nnz,avg_nnz_per_row" in out
    assert len([l for l in out.splitlines() if l and l[0].isdigit()]) == 4


def test_csr_tool_dist(csr_file, capsys):
    rc = csr_tool_main(["dist", "-i", csr_file])
    out = capsys.readouterr().out
    assert rc == 0
    assert "row_length,count" in out


def test_ssdl_conv_and_list(tmp_path, capsys):
    csr = random_csr(12, 12, 40, seed=53)
    rp, ci, v, shape = csr.to_numpy()
    rows = np.repeat(np.arange(shape[0]), np.diff(rp))
    mtx = tmp_path / "small.mtx"
    write_mtx(mtx, rows, ci, v, shape)
    rc = ssdl_main(["conv", str(mtx)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "wrote" in out and "nnz=40" in out
    from spmv_acc_tpu.io.binary import read_bin2

    rp2, ci2, v2, shape2 = read_bin2(tmp_path / "small.bin2")
    assert shape2 == shape and np.allclose(v2, v)

    rc = ssdl_main(["list", str(tmp_path)])
    assert rc == 0
    assert "small.mtx" in capsys.readouterr().out


def test_ssdl_gen(tmp_path, capsys):
    csr = random_csr(8, 8, 20, seed=54)
    rp, ci, v, shape = csr.to_numpy()
    x, _ = random_x_y(8, 8, seed=55)
    write_csr_text(tmp_path / "a.csr", rp, ci, v, x)
    rc = ssdl_main(["gen", str(tmp_path), "-o", str(tmp_path / "batch")])
    assert rc == 0
    scripts = list((tmp_path / "batch").glob("*.sh"))
    assert len(scripts) == 1
    text = scripts[0].read_text()
    assert "spmv_acc_tpu.cli.main" in text and "#SBATCH" in text


def test_bucket_of():
    assert bucket_of(500) == "1k"
    assert bucket_of(5_000_000) == "10M"


def test_benchmark_harness(csr_file, capsys):
    from spmv_acc_tpu.cli.benchmark import main as bench_main

    rc = bench_main([csr_file, "-f", "csr", "--iters", "3", "--warmups", "1",
                     "--engines", "spmv-acc-line,numpy-cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    lines = [l for l in out.splitlines() if l.startswith("PERFORMANCE,") and "matrix,strategy" not in l]
    assert len(lines) == 2
    assert out.startswith("PERFORMANCE,matrix,strategy")


def test_benchmark_external_engines(csr_file, capsys):
    """The independent on-device engines (reference analog: the 6 external
    comparators in benchmark/main.cpp:107-141): BCOO must golden-verify, the
    dense anchor emits an equivalent-time row."""
    from spmv_acc_tpu.cli.benchmark import main as bench_main

    rc = bench_main([csr_file, "-f", "csr", "--iters", "3", "--warmups", "1",
                     "--engines", "jax-sparse-bcoo,jax-sparse-bcsr,dense-anchor"])
    out = capsys.readouterr().out
    assert rc == 0
    lines = [l for l in out.splitlines()
             if l.startswith("PERFORMANCE,") and "matrix,strategy" not in l]
    assert len(lines) == 3
    for eng in ("jax-sparse-bcoo", "jax-sparse-bcsr"):
        row = next(l for l in lines if eng in l)
        assert row.split(",")[-2] == "0"  # failed_count


def test_solve_cli(csr_file, capsys):
    """spmv-solve: preconditioned CG end-to-end from a matrix file."""
    from spmv_acc_tpu.cli.solve import main as solve_main

    rc = solve_main([csr_file, "-f", "csr", "--precond", "jacobi",
                     "--strategy", "line"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Congratulation, solution verified!" in out


def test_solve_cli_ilu0(csr_file, capsys):
    from spmv_acc_tpu.cli.solve import main as solve_main

    rc = solve_main([csr_file, "-f", "csr", "--precond", "ilu0", "--sweeps", "4"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "cg[ilu0]" in out and "verified" in out
