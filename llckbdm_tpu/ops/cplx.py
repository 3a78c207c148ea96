"""Complex arithmetic as explicit (real, imag) float32/float64 pairs.

The framework represents a complex array as a ``CArr(re, im)`` pair of real
arrays: complex matmuls are four real matmuls, elementwise complex ops are
real elementwise ops, and the matmul count is explicit.  The small dense
linear-algebra calls (ops.linalg) cross to native complex64 at the call.

All functions are shape-polymorphic over leading batch dimensions and work
under jit/vmap/shard_map on GPU and CPU alike.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class CArr(NamedTuple):
    """A complex array as a (re, im) pair of equally-shaped real arrays."""

    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):
        return self.re.dtype

    @property
    def ndim(self):
        return self.re.ndim

    def __getitem__(self, idx):
        return CArr(self.re[idx], self.im[idx])


# ---------------------------------------------------------------------------
# Construction / conversion
# ---------------------------------------------------------------------------

def from_np(x, dtype=jnp.float32) -> CArr:
    """Build a CArr from a numpy (possibly complex) array."""
    x = np.asarray(x)
    return CArr(jnp.asarray(x.real, dtype), jnp.asarray(x.imag, dtype))


def to_np(x: CArr) -> np.ndarray:
    return np.asarray(x.re, dtype=np.float64) + 1j * np.asarray(x.im, np.float64)


def czeros(shape, dtype=jnp.float32) -> CArr:
    z = jnp.zeros(shape, dtype)
    return CArr(z, z)


def ceye(n, dtype=jnp.float32, batch=()) -> CArr:
    e = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (*batch, n, n))
    return CArr(e, jnp.zeros_like(e))


def creal(x: CArr) -> jax.Array:
    return x.re


def cimag(x: CArr) -> jax.Array:
    return x.im


# ---------------------------------------------------------------------------
# Elementwise ops
# ---------------------------------------------------------------------------

def cadd(a: CArr, b: CArr) -> CArr:
    return CArr(a.re + b.re, a.im + b.im)


def csub(a: CArr, b: CArr) -> CArr:
    return CArr(a.re - b.re, a.im - b.im)


def cneg(a: CArr) -> CArr:
    return CArr(-a.re, -a.im)


def cmul(a: CArr, b: CArr) -> CArr:
    return CArr(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def cscale(a: CArr, s) -> CArr:
    """Multiply by a real scalar/array."""
    return CArr(a.re * s, a.im * s)


def conj(a: CArr) -> CArr:
    return CArr(a.re, -a.im)


def cabs2(a: CArr) -> jax.Array:
    return a.re * a.re + a.im * a.im


def cabs(a: CArr) -> jax.Array:
    # hypot is robust to overflow and matches numpy's |z|
    return jnp.hypot(a.re, a.im)


def cangle(a: CArr) -> jax.Array:
    return jnp.arctan2(a.im, a.re)


def cdiv(a: CArr, b: CArr) -> CArr:
    d = cabs2(b)
    inv = 1.0 / d
    return CArr((a.re * b.re + a.im * b.im) * inv,
                (a.im * b.re - a.re * b.im) * inv)


def crecip(b: CArr) -> CArr:
    inv = 1.0 / cabs2(b)
    return CArr(b.re * inv, -b.im * inv)


def cexp(a: CArr) -> CArr:
    r = jnp.exp(a.re)
    return CArr(r * jnp.cos(a.im), r * jnp.sin(a.im))


def clog(a: CArr) -> CArr:
    return CArr(0.5 * jnp.log(cabs2(a)), cangle(a))


def csqrt(a: CArr) -> CArr:
    """Principal square root (branch cut on negative real axis, like numpy)."""
    r = cabs(a)
    # sqrt(z) = sqrt(r) * (cos(t/2) + i sin(t/2));  use half-angle identities
    # robustly: re = sqrt((r + a.re)/2), im = sign(a.im)*sqrt((r - a.re)/2)
    re = jnp.sqrt(jnp.maximum(0.5 * (r + a.re), 0.0))
    im_mag = jnp.sqrt(jnp.maximum(0.5 * (r - a.re), 0.0))
    im = jnp.where(a.im < 0, -im_mag, im_mag)
    return CArr(re, im)


def cwhere(mask, a: CArr, b: CArr) -> CArr:
    return CArr(jnp.where(mask, a.re, b.re), jnp.where(mask, a.im, b.im))


# ---------------------------------------------------------------------------
# Matmul and transposes
# ---------------------------------------------------------------------------

def _mm(a, b):
    # Precision.HIGHEST: a default-precision f32 matmul may run in reduced
    # precision (TF32 on the GPU, ~1e-3 relative), which destroys the SVD
    # tail and rank masking.
    return jnp.matmul(a, b, preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


def cmatmul(a: CArr, b: CArr) -> CArr:
    """Complex matmul as 4 real matmuls (accuracy-first: a 3-mult Karatsuba
    variant was measured and rejected — its extra rounding is unacceptable
    on the SVD/refinement paths)."""
    return CArr(_mm(a.re, b.re) - _mm(a.im, b.im),
                _mm(a.re, b.im) + _mm(a.im, b.re))


def cmatmul_rc(a: jax.Array, b: CArr) -> CArr:
    """real @ complex"""
    return CArr(_mm(a, b.re), _mm(a, b.im))


def cmatmul_cr(a: CArr, b: jax.Array) -> CArr:
    """complex @ real"""
    return CArr(_mm(a.re, b), _mm(a.im, b))


def ctranspose(a: CArr) -> CArr:
    return CArr(jnp.swapaxes(a.re, -1, -2), jnp.swapaxes(a.im, -1, -2))


def chermitian(a: CArr) -> CArr:
    return CArr(jnp.swapaxes(a.re, -1, -2), -jnp.swapaxes(a.im, -1, -2))


def cmatmul_hn(a: CArr, b: CArr) -> CArr:
    """a^H @ b without materializing the transpose copy."""
    return cmatmul(chermitian(a), b)


def cdiag(v: CArr) -> CArr:
    """Vector -> diagonal matrix (batched over leading dims)."""
    n = v.re.shape[-1]
    e = jnp.eye(n, dtype=v.re.dtype)
    return CArr(e * v.re[..., None, :], e * v.im[..., None, :])


def cdiagonal(a: CArr) -> CArr:
    return CArr(jnp.diagonal(a.re, axis1=-2, axis2=-1),
                jnp.diagonal(a.im, axis1=-2, axis2=-1))


def cscale_cols(a: CArr, s: CArr) -> CArr:
    """a @ diag(s) — scale columns by complex vector s."""
    return cmul(a, CArr(s.re[..., None, :], s.im[..., None, :]))


def cscale_rows(s: CArr, a: CArr) -> CArr:
    """diag(s) @ a — scale rows by complex vector s."""
    return cmul(CArr(s.re[..., :, None], s.im[..., :, None]), a)


def cpow_int(a: CArr, n: jax.Array) -> CArr:
    """a**n for integer-valued real exponent array n (via exp(n log a)).

    For STATIC integer n prefer :func:`cpow_fixed`/:func:`cpowers`: this
    form costs 5 transcendentals per element (log, atan2, exp, sin,
    cos)."""
    la = clog(a)
    return cexp(CArr(la.re * n, la.im * n))


def cpow_fixed(a: CArr, n: int) -> CArr:
    """a**n for a STATIC integer n >= 0 by binary exponentiation —
    ~2 log2(n) real multiply-adds per element, no transcendentals."""
    if n == 0:
        return CArr(jnp.ones_like(a.re), jnp.zeros_like(a.re))
    out = None
    sq = a
    while n:
        if n & 1:
            out = sq if out is None else cmul(out, sq)
        n >>= 1
        if n:
            sq = cmul(sq, sq)
    return out


def cpowers(a: CArr, n: int) -> CArr:
    """All powers a^0 .. a^(n-1) along a NEW trailing axis (..., n).

    Binary decomposition (the solver.refine._c32_powers scheme): ceil(log2
    n) squarings of a plus one select/multiply chain per bit — O(n log n)
    multiplies total instead of n transcendental evaluations."""
    nbits = max(1, int(np.ceil(np.log2(max(n, 2)))))
    sq = [a]
    for _ in range(nbits - 1):
        sq.append(cmul(sq[-1], sq[-1]))
    ks = np.arange(n)
    out = None
    for j in range(nbits):
        bit = jnp.asarray((ks >> j) & 1, a.re.dtype)
        f = CArr(jnp.where(bit > 0, sq[j].re[..., None], a.re.dtype.type(1.0)),
                 bit * sq[j].im[..., None])
        out = f if out is None else cmul(out, f)
    return out
