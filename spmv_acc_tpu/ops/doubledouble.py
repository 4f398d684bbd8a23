"""Double-float ("df64") arithmetic: float64-accurate math from float32 pairs.

For hardware without a fast f64 path, compensated arithmetic carries every f64
value as an unevaluated pair ``(hi, lo)`` of f32 with ``hi + lo == value`` to
~2^-48 relative accuracy (~3.6e-15) — far inside the reference's rel-1e-7 verification gate
(cli/verification.cpp:43-54).

All operations are classic error-free transformations (Dekker 1971, Knuth TAOCP v2):
``two_sum``, ``split``/``two_prod`` (FMA-free Dekker product), plus df64 add/mul and
a compensated accumulate used by the SpMV width-fold.  Everything is elementwise f32
→ fully fusable by XLA.  Nothing on the main path uses this module.

NOTE: correctness depends on XLA *not* reassociating float ops.  XLA's algebraic
simplifier preserves IEEE semantics for f32 adds/muls by default; the unit tests
(tests/test_doubledouble.py) assert the error terms survive compilation.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "DF64",
    "two_sum",
    "fast_two_sum",
    "two_prod",
    "df64_from_f64",
    "df64_to_f64",
    "df64_add",
    "df64_add_f32",
    "df64_mul_f32f32",
    "df64_mul",
    "df64_scale",
    "df64_zeros",
]

_SPLIT_CONST = np.float32(4097.0)  # 2^12 + 1 for binary32 Dekker split


class DF64(NamedTuple):
    """An unevaluated f32 pair; value = hi + lo, |lo| <= ulp(hi)/2."""

    hi: jax.Array
    lo: jax.Array

    @property
    def shape(self):
        return self.hi.shape

    @property
    def dtype(self):
        return self.hi.dtype


def two_sum(a, b) -> Tuple[jax.Array, jax.Array]:
    """s + err == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def fast_two_sum(a, b) -> Tuple[jax.Array, jax.Array]:
    """Requires |a| >= |b|; cheaper than two_sum."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a) -> Tuple[jax.Array, jax.Array]:
    c = _SPLIT_CONST * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b) -> Tuple[jax.Array, jax.Array]:
    """p + err == a * b exactly (Dekker, FMA-free)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def df64_from_f64(x) -> DF64:
    """Host-side decomposition of an f64 array into an f32 pair."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return DF64(jnp.asarray(hi), jnp.asarray(lo))


def df64_to_f64(d: DF64) -> np.ndarray:
    return np.asarray(jax.device_get(d.hi), dtype=np.float64) + np.asarray(
        jax.device_get(d.lo), dtype=np.float64
    )


def df64_add(a: DF64, b: DF64) -> DF64:
    """Accurate double-float addition (QD ieee_add): error ~2^-50 relative to the
    inputs' magnitudes, well-behaved under cancellation."""
    s1, s2 = two_sum(a.hi, b.hi)
    t1, t2 = two_sum(a.lo, b.lo)
    s2 = s2 + t1
    s1, s2 = fast_two_sum(s1, s2)
    s2 = s2 + t2
    hi, lo = fast_two_sum(s1, s2)
    return DF64(hi, lo)


def df64_add_f32(a: DF64, b) -> DF64:
    s, e = two_sum(a.hi, b)
    e = e + a.lo
    hi, lo = fast_two_sum(s, e)
    return DF64(hi, lo)


def df64_mul_f32f32(a, b) -> DF64:
    """Exact product of two f32s as a df64."""
    p, e = two_prod(a, b)
    return DF64(p, e)


def df64_mul(a: DF64, b: DF64) -> DF64:
    p, e = two_prod(a.hi, b.hi)
    e = e + (a.hi * b.lo + a.lo * b.hi)
    hi, lo = fast_two_sum(p, e)
    return DF64(hi, lo)


def df64_scale(a: DF64, s) -> DF64:
    """a * s with s an f32 scalar/array."""
    p, e = two_prod(a.hi, s)
    e = e + a.lo * s
    hi, lo = fast_two_sum(p, e)
    return DF64(hi, lo)


def df64_zeros(shape, dtype=jnp.float32) -> DF64:
    z = jnp.zeros(shape, dtype)
    return DF64(z, z)
