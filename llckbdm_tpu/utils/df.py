"""Double-float (float32-pair) arithmetic.

The accuracy gate is 1e-8 relative on pole parameters (BASELINE.json:5) —
beyond f32's 1.2e-7 epsilon — while the bulk pipeline runs in f32.  This module implements error-free-transformation arithmetic
(Dekker/Knuth two-sum / two-prod) on (hi, lo) float32 pairs, giving ~2^-48
(~3.6e-15) effective relative precision.  It is used by the Gauss-Newton pole
refinement stage (llckbdm_tpu.solver.refine) — the f32 bulk pipeline hands
poles at ~1e-4 and refinement polishes them to ~1e-12 against the
double-float signal.

IMPORTANT: these algorithms require IEEE-correct f32 add/mul WITHOUT
reassociation or FMA contraction.  XLA HLO is IEEE-strict, but the XLA:CPU
LLVM backend CONTRACTS mul+add into fma on FMA-capable ISAs (AVX2+), and
fusion rematerializes shared subexpressions into multiple kernels where the
contraction choice can differ per copy — measured to silently destroy the
error-free transforms (a double-float product lost its entire lo limb:
2.5e-8 relative instead of 3e-15).  Every EFT below therefore pins its
rounding-critical head value (the sum `s`, the product `p`) with
``lax.reduce_precision(x, 8, 23)`` — an f32 identity that is a compiler
barrier against contraction (verified on an AVX2 CPU, and on the GPU by
tests/test_gpu.py, which runs these transforms compiled for the card).

All functions are elementwise and batch/shape polymorphic.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def _rp(x):
    """f32 identity that blocks FMA contraction / inconsistent remat (see
    module docstring)."""
    return jax.lax.reduce_precision(x, 8, 23)


class DF(NamedTuple):
    """A double-float real array: value = hi + lo, |lo| <= ulp(hi)/2."""

    hi: jax.Array
    lo: jax.Array

    @property
    def shape(self):
        return self.hi.shape

    def __getitem__(self, idx):
        return DF(self.hi[idx], self.lo[idx])


class DFC(NamedTuple):
    """A double-float complex array: (re, im) each a DF."""

    re: DF
    im: DF

    @property
    def shape(self):
        return self.re.hi.shape

    def __getitem__(self, idx):
        return DFC(self.re[idx], self.im[idx])


# ---------------------------------------------------------------------------
# Error-free transformations
# ---------------------------------------------------------------------------

_SPLITTER = np.float32(4097.0)  # 2**12 + 1 for f32 (24-bit mantissa)


def two_sum(a, b):
    """s + e == a + b exactly."""
    s = _rp(a + b)
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Requires |a| >= |b|. s + e == a + b exactly."""
    s = _rp(a + b)
    e = b - (s - a)
    return s, e


def _split(a):
    c = _SPLITTER * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """p + e == a * b exactly (Dekker)."""
    p = _rp(a * b)
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ---------------------------------------------------------------------------
# DF construction / conversion
# ---------------------------------------------------------------------------

def df_from_f32(x) -> DF:
    x = jnp.asarray(x, jnp.float32)
    return DF(x, jnp.zeros_like(x))


def df_from_np(x) -> DF:
    """Split a float64 numpy array into an exact (hi, lo) f32 pair."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return DF(jnp.asarray(hi), jnp.asarray(lo))


def df_to_np(x: DF) -> np.ndarray:
    return np.asarray(x.hi, np.float64) + np.asarray(x.lo, np.float64)


def dfc_from_np(x) -> DFC:
    x = np.asarray(x)
    return DFC(df_from_np(x.real), df_from_np(x.imag))


def dfc_to_np(x: DFC) -> np.ndarray:
    return df_to_np(x.re) + 1j * df_to_np(x.im)


def dfc_from_f32(re, im) -> DFC:
    return DFC(df_from_f32(re), df_from_f32(im))


# ---------------------------------------------------------------------------
# DF real arithmetic
# ---------------------------------------------------------------------------

def df_add(a: DF, b: DF) -> DF:
    s, e = two_sum(a.hi, b.hi)
    e = e + (a.lo + b.lo)
    s, e = quick_two_sum(s, e)
    return DF(s, e)


def df_neg(a: DF) -> DF:
    return DF(-a.hi, -a.lo)


def df_sub(a: DF, b: DF) -> DF:
    return df_add(a, df_neg(b))


def df_mul(a: DF, b: DF) -> DF:
    p, e = two_prod(a.hi, b.hi)
    e = e + (a.hi * b.lo + a.lo * b.hi)
    p, e = quick_two_sum(p, e)
    return DF(p, e)


def df_scale(a: DF, s) -> DF:
    """Multiply by a plain f32 value."""
    p, e = two_prod(a.hi, s)
    e = e + a.lo * s
    p, e = quick_two_sum(p, e)
    return DF(p, e)


def df_div(a: DF, b: DF) -> DF:
    q1 = a.hi / b.hi
    r = df_sub(a, df_scale(b, q1))
    q2 = r.hi / b.hi
    r = df_sub(r, df_scale(b, q2))
    q3 = r.hi / b.hi
    s, e = quick_two_sum(q1, q2)
    return df_add(DF(s, e), df_from_f32(q3))


def df_sqrt(a: DF) -> DF:
    """Newton iteration on f32 sqrt; a must be >= 0."""
    x = jnp.sqrt(jnp.maximum(a.hi, 0.0))
    safe = x > 0
    x = jnp.where(safe, x, 1.0)
    # one Newton step in df: x' = x + (a - x^2) / (2x)
    x2 = df_mul(DF(x, jnp.zeros_like(x)), DF(x, jnp.zeros_like(x)))
    diff = df_sub(a, x2)
    corr = diff.hi / (2.0 * x)
    s, e = two_sum(x, corr)
    out = DF(s, e + diff.lo / (2.0 * x))
    return DF(jnp.where(safe, out.hi, 0.0), jnp.where(safe, out.lo, 0.0))


def df_sum(a: DF, axis=None):
    """Sum-reduce a DF array along an axis.

    ONE variadic ``lax.reduce`` over the (hi, lo) pair with :func:`df_add`
    as the combiner: XLA applies the combiner in an implementation-defined
    (tree-like) order, so error growth is O(log n) on top of df's 2^-48 —
    same numerics class as an explicit pairwise tree.

    Why not an explicit halving loop: the former slice-based pairwise
    reduction, rooted over a deep df producer chain (e.g. dfc_powers ->
    dfc_mul), drove XLA:CPU compilation superlinear — a (4, 8, 256) df
    model-sum took >9 MINUTES to compile (optimization barriers did not
    help; the pass walking the sliced producer re-expands it per consumer).
    The single Reduce op compiles in ~1 s (variadic reduce is core HLO).
    """
    if axis is None:
        a = DF(a.hi.ravel(), a.lo.ravel())
        axis = 0

    def comb(x, y):
        s = df_add(DF(x[0], x[1]), DF(y[0], y[1]))
        return (s.hi, s.lo)

    zero = (jnp.float32(0.0), jnp.float32(0.0))
    hi, lo = jax.lax.reduce((a.hi, a.lo), zero, comb, (axis % a.hi.ndim,))
    return DF(hi, lo)


def df_where(mask, a: DF, b: DF) -> DF:
    return DF(jnp.where(mask, a.hi, b.hi), jnp.where(mask, a.lo, b.lo))


# ---------------------------------------------------------------------------
# DFC complex arithmetic
# ---------------------------------------------------------------------------

def dfc_add(a: DFC, b: DFC) -> DFC:
    return DFC(df_add(a.re, b.re), df_add(a.im, b.im))


def dfc_sub(a: DFC, b: DFC) -> DFC:
    return DFC(df_sub(a.re, b.re), df_sub(a.im, b.im))


def dfc_neg(a: DFC) -> DFC:
    return DFC(df_neg(a.re), df_neg(a.im))


def dfc_mul(a: DFC, b: DFC) -> DFC:
    re = df_sub(df_mul(a.re, b.re), df_mul(a.im, b.im))
    im = df_add(df_mul(a.re, b.im), df_mul(a.im, b.re))
    return DFC(re, im)


def dfc_conj(a: DFC) -> DFC:
    return DFC(a.re, df_neg(a.im))


def dfc_abs2(a: DFC) -> DF:
    return df_add(df_mul(a.re, a.re), df_mul(a.im, a.im))


def dfc_div(a: DFC, b: DFC) -> DFC:
    d = dfc_abs2(b)
    num = dfc_mul(a, dfc_conj(b))
    return DFC(df_div(num.re, d), df_div(num.im, d))


def dfc_scale(a: DFC, s) -> DFC:
    return DFC(df_scale(a.re, s), df_scale(a.im, s))


def dfc_sum(a: DFC, axis=None) -> DFC:
    return DFC(df_sum(a.re, axis), df_sum(a.im, axis))


def dfc_where(mask, a: DFC, b: DFC) -> DFC:
    return DFC(df_where(mask, a.re, b.re), df_where(mask, a.im, b.im))


def dfc_zeros(shape) -> DFC:
    z = jnp.zeros(shape, jnp.float32)
    return DFC(DF(z, z), DF(z, z))


def dfc_pow_traced(z: DFC, e, nbits: int = 16) -> DFC:
    """z^e for a TRACED non-negative int exponent e (broadcastable to z).

    Binary exponentiation with a fixed nbits unroll (default 16 covers
    exponents to 65535 — far beyond any signal length in the configs).
    Used by the time-sharded refinement to seed each shard's local
    Vandermonde block at z^(chunk_offset) (parallel.grid).
    """
    e = jnp.asarray(e, jnp.int32)
    shape = jnp.broadcast_shapes(z.shape, e.shape) if e.ndim else z.shape
    one = jnp.ones(shape, jnp.float32)
    zero = jnp.zeros(shape, jnp.float32)
    out = DFC(DF(one, zero), DF(zero, zero))
    base = DFC(DF(jnp.broadcast_to(z.re.hi, shape),
                  jnp.broadcast_to(z.re.lo, shape)),
               DF(jnp.broadcast_to(z.im.hi, shape),
                  jnp.broadcast_to(z.im.lo, shape)))
    for j in range(nbits):
        bit = (e >> j) & 1
        out = dfc_where(bit > 0, dfc_mul(out, base), out)
        if j + 1 < nbits:
            base = dfc_mul(base, base)
    return out


def dfc_powers(z: DFC, n: int) -> DFC:
    """All powers z^0 .. z^(n-1) along a new trailing axis, in df precision.

    Uses the binary decomposition z^k = prod_j z^(2^j * bit_j(k)): log2(n)
    repeated squarings, then a fully parallel product over set bits — no
    O(n) sequential chain.

    A two-level factorization z^(i*c+k) = (z^c)^i z^k (one full-size df
    multiply instead of the log2(n) chained ones) materializes full-size
    broadcast operands, where XLA fuses the chained where/multiply passes.
    """
    nbits = max(1, int(np.ceil(np.log2(max(n, 2)))))
    # squarings: z^(2^j)
    sq = [z]
    for _ in range(nbits - 1):
        sq.append(dfc_mul(sq[-1], sq[-1]))
    ks = np.arange(n)
    out = None
    for j in range(nbits):
        bit = jnp.asarray((ks >> j) & 1, jnp.float32)  # (n,)
        zj = sq[j]
        # broadcast: factor = bit ? z^(2^j) : 1
        shape = (*z.shape, n)
        zb = DFC(DF(jnp.broadcast_to(zj.re.hi[..., None], shape),
                    jnp.broadcast_to(zj.re.lo[..., None], shape)),
                 DF(jnp.broadcast_to(zj.im.hi[..., None], shape),
                    jnp.broadcast_to(zj.im.lo[..., None], shape)))
        one = DFC(DF(jnp.ones(shape, jnp.float32), jnp.zeros(shape, jnp.float32)),
                  DF(jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)))
        factor = dfc_where(bit > 0, zb, one)
        out = factor if out is None else dfc_mul(out, factor)
    return out
