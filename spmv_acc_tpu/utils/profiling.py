"""Tracing / profiling utilities — parity with the reference's three mechanisms
(SURVEY.md §5): wall timers (cli/timer.h), device event timers
(benchmark/utils/timer_utils.h), and per-phase API profiling (SpMVAccHanele).

Equivalents here: ``jax.profiler`` traces (viewable in TensorBoard/XProf),
phase-scoped wall timers, and a bandwidth/roofline readout mirroring the ad-hoc
macros in src/acc/common/mem_bandwidth.hpp:19-38.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import jax

from .stats import bytes_moved, chip_peak_gbs

__all__ = ["trace", "PhaseTimer", "bandwidth_report"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace of the device work in a code region.

    View with: ``tensorboard --logdir <log_dir>`` (or xprof).  A profiler
    that cannot start raises; nothing is silently skipped."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class PhaseTimer:
    """Named phase accumulation (analyze/kernel/fixup/destroy — handle.h analog)."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (time.perf_counter() - t0) * 1e6

    def report(self) -> str:
        total = sum(self.phases.values())
        parts = ", ".join(f"{k}={v:.1f}us" for k, v in self.phases.items())
        return f"{parts}, total={total:.1f}us"


def bandwidth_report(rows: int, nnz: int, time_us: float, value_bytes: int = 8, peak_gbs: Optional[float] = None) -> str:
    """The mem_bandwidth.hpp:19-38 printout, against the device's published peak."""
    peak = peak_gbs or chip_peak_gbs()
    b = bytes_moved(rows, nnz, value_bytes)
    gbs = b / (time_us * 1e-6) / 1e9 if time_us > 0 else 0.0
    return (
        f"bytes={b} time={time_us:.1f}us bandwidth={gbs:.1f}GB/s "
        f"peak={peak:.0f}GB/s roofline={gbs / peak:.3f}"
    )
