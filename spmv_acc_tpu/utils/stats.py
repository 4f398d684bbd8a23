"""Benchmark statistics — the reference's 18-column CSV schema and derived metrics.

Column order and formulas reproduce benchmark/utils/statistics_logger.cpp:11-57:
``PERFORMANCE,matrix,strategy,rows,cols,nnz,nnz/row,GB/s(calc),GFLOPS(calc),
GB/s(total),GFLOPS(total),pre,calc,fixup,destroy,total,first_failed_at,failed_count,
max_error`` with times in microseconds,
``bytes = sizeof(T)*(2m+nnz) + sizeof(int)*(m+1+nnz)`` (statistics_logger.cpp:43) and
``flops = 2*nnz`` (…:46,49).  New here: roofline fraction vs the device's published
memory bandwidth, using the same bytes model.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "CSV_HEADER",
    "bytes_moved",
    "flops",
    "roofline_fraction",
    "chip_peak_gbs",
    "chip_peaks",
    "PEAKS",
    "print_statistics",
    "BenchTimes",
]

CSV_HEADER = (
    "PERFORMANCE,matrix,strategy,rows,cols,nnz,nnz/row,GB/s(calc),GFLOPS(calc),"
    "GB/s(total),GFLOPS(total),pre(us),calc(us),fixup(us),destroy(us),total(us),"
    "first_failed_at,failed_count,max_error"
)

# Published peaks by ``device_kind`` as JAX reports it.  Source: NVIDIA H100
# Tensor Core GPU datasheet, SXM5 column: 3.35 TB/s HBM3, FP64 34 TFLOP/s,
# FP64 Tensor Core 67 TFLOP/s (dense).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbs": 3350.0, "f64_tflops_vector": 34.0,
                              "f64_tflops_tensor": 67.0},
}


def chip_peaks(device=None) -> dict:
    """The published peaks of ``device`` (default: the first JAX device).  A
    device with no entry in :data:`PEAKS` is an error, never a default."""
    import jax

    kind = (device or jax.devices()[0]).device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


def chip_peak_gbs(device=None) -> float:
    return chip_peaks(device)["hbm_gbs"]


def bytes_moved(rows: int, nnz: int, value_bytes: int = 8, index_bytes: int = 4) -> int:
    """statistics_logger.cpp:43 — T*(2m+nnz) + I*(m+1+nnz)."""
    return value_bytes * (2 * rows + nnz) + index_bytes * (rows + 1 + nnz)


def flops(nnz: int) -> int:
    """statistics_logger.cpp:46 — 2*nnz (one mul + one add per stored element)."""
    return 2 * nnz


def roofline_fraction(rows: int, nnz: int, time_us: float, value_bytes=8, peak_gbs=None) -> float:
    if time_us <= 0:
        return 0.0
    peak = peak_gbs or chip_peak_gbs()
    gbs = bytes_moved(rows, nnz, value_bytes) / (time_us * 1e-6) / 1e9
    return gbs / peak


@dataclasses.dataclass
class BenchTimes:
    """Phase times in µs (reference benchmark/utils/benchmark_time.h:12-41)."""

    pre: float = 0.0
    calc: float = 0.0
    fixup: float = 0.0  # 'calc2' in the reference
    destroy: float = 0.0

    @property
    def total(self) -> float:
        return self.pre + self.calc + self.fixup + self.destroy


def median_times(times: list) -> "BenchTimes":
    """Median-of-N by calc time (benchmark/utils/benchmark_time.cpp:23-43)."""
    order = sorted(range(len(times)), key=lambda i: times[i].calc)
    return times[order[len(times) // 2]]


def print_statistics(
    matrix: str,
    strategy: str,
    rows: int,
    cols: int,
    nnz: int,
    times: "BenchTimes",
    report,
    value_bytes: int = 8,
    file=None,
):
    """Emit one CSV row in the reference schema (statistics_logger.cpp:11-57)."""
    calc_s = times.calc * 1e-6
    total_s = times.total * 1e-6
    b = bytes_moved(rows, nnz, value_bytes)
    f = flops(nnz)
    gbs_calc = b / calc_s / 1e9 if calc_s > 0 else 0.0
    gflops_calc = f / calc_s / 1e9 if calc_s > 0 else 0.0
    gbs_total = b / total_s / 1e9 if total_s > 0 else 0.0
    gflops_total = f / total_s / 1e9 if total_s > 0 else 0.0
    row = (
        f"PERFORMANCE,{matrix},{strategy},{rows},{cols},{nnz},{nnz / max(rows, 1):.3f},"
        f"{gbs_calc:.3f},{gflops_calc:.3f},{gbs_total:.3f},{gflops_total:.3f},"
        f"{times.pre:.3f},{times.calc:.3f},{times.fixup:.3f},{times.destroy:.3f},"
        f"{times.total:.3f},{report.first_failed_at},{report.failed_count},"
        f"{report.max_error:.6e}"
    )
    print(row, file=file)
    return row
