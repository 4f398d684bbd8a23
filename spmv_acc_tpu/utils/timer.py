"""Timers — wall-clock (reference cli/timer.h:11-19) and a device-event analog.

JAX exposes no hipEvent; the device-accurate protocol is: ``block_until_ready``
before starting, run, ``block_until_ready``, take wall time.  For sub-millisecond
kernels we amortise over ``iters`` inner launches (the reference's median-of-3 outer
protocol lives in the bench harness, benchmark/csr_spmv.hpp:67-74).
"""

from __future__ import annotations

import time

import jax

__all__ = ["WallTimer", "time_fn", "time_device_loop"]


class WallTimer:
    """gettimeofday-style microsecond wall timer (cli/timer.h)."""

    def __init__(self):
        self._t0 = None
        self.elapsed_us = 0.0

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        self.elapsed_us = (time.perf_counter() - self._t0) * 1e6
        return self.elapsed_us


def time_fn(fn, *args, iters: int = 1, block=True):
    """Time ``fn(*args)`` over ``iters`` launches; returns (result, per-call µs)."""
    out = fn(*args)
    if block:
        jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    if block:
        jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / max(iters, 1)
    return out, dt * 1e6


def _run_chain(step_fn, carry, iters):
    t0 = time.perf_counter()
    for _ in range(iters):
        carry = step_fn(carry)
    _sink(carry)
    return (time.perf_counter() - t0) * 1e6, carry


def _sink(carry):
    """Force real execution by reading back a few bytes of the carry."""
    leaf = jax.tree_util.tree_leaves(carry)[0]
    import numpy as np

    if getattr(leaf, "ndim", 0) > 0:
        leaf = leaf[..., :1]
    np.asarray(jax.device_get(leaf))


def time_chained(step_fn, init, iters: int = 50, baseline_iters: int = 3):
    """Per-iteration device time of ``carry = step_fn(carry)`` via two-point slope.

    Chained dependencies force serialized execution, and a final host readback forces
    completion; the slope between ``baseline_iters`` and ``iters`` runs removes the
    fixed cost of the first dispatch and the readback.  Returns (per-iteration µs,
    final carry).
    """
    # warmup/compile
    _run_chain(step_fn, init, 1)
    t1, _ = _run_chain(step_fn, init, baseline_iters)
    t2, carry = _run_chain(step_fn, init, iters)
    per = (t2 - t1) / max(iters - baseline_iters, 1)
    return max(per, 0.0), carry


def time_device_loop(step_fn, init, iters: int = 64, reps: int = 3):
    """Per-iteration device time of ``carry = step_fn(carry)`` with the loop ON DEVICE.

    Python-side dispatch costs tens of µs per execution, which swamps short
    kernels.  This compiles ``lax.fori_loop(0, n, step, init)``
    into ONE program, executes it for two iteration counts, and returns the slope —
    pure device time, representative of real iterative callers (CG loops run exactly
    this shape).  Returns (per-iteration µs, final carry).
    """
    import numpy as np

    @jax.jit
    def run(c, n):
        return jax.lax.fori_loop(0, n, lambda i, c: step_fn(c), c)

    def once(n):
        t0 = time.perf_counter()
        out = run(init, n)
        leaf = jax.tree_util.tree_leaves(out)[0]
        np.asarray(jax.device_get(leaf if getattr(leaf, "ndim", 0) == 0 else leaf.ravel()[:1]))
        return time.perf_counter() - t0, out

    once(1)  # compile / warm
    once(1 + iters)
    lo = min(once(1)[0] for _ in range(reps))
    hi, carry = 1e18, None
    for _ in range(reps):
        t, c = once(1 + iters)
        if t < hi:
            hi, carry = t, c
    per = max(hi - lo, 0.0) / iters * 1e6
    return per, carry
