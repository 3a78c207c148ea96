"""Batched eigenvalues of complex-symmetric matrices (the KBDM reduced
problem) by Jacobi rotations.

A = A^T (NOT Hermitian): complex-orthogonal rotations (c^2 + s^2 = 1, c and
s complex) drive the off-diagonal part to zero; the diagonal converges to
the complex eigenvalues.  The FDM literature solves the same problem with
the same transforms.  XLA has no batched eigensolver for this class (its
``eig`` is a general nonsymmetric LAPACK/cuSOLVER call per matrix), and the
pipeline solves V*S tiny matrices per fit.

Two implementations of one rotation sequence:

* GPU: the Pallas Triton kernel in ops.eig_kernel — each program holds a
  tile of matrices in registers for all sweeps;
* CPU, and the kernel's reference: the ``lax.scan`` below, one rotation per
  step, vectorized over the vmapped batch.

The choice is made at trace time by :func:`llckbdm_tpu.platform.platform`.
Oracle counterpart: scipy.linalg.eigvals.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..platform import platform
from . import eig_kernel
from .cplx import CArr


@functools.lru_cache(maxsize=None)
def _cyclic_pairs(n: int):
    """Flattened sequential cyclic ordering: all (i < j) pairs, one sweep."""
    ii = [i for i in range(n) for j in range(i + 1, n)]
    jj = [j for i in range(n) for j in range(i + 1, n)]
    return np.asarray(ii, np.int32), np.asarray(jj, np.int32)


def _eig_cs_single(a: CArr, sweeps: int):
    """Jacobi eigenvalues of one (n, n) complex-symmetric matrix and the
    final off-diagonal Frobenius norm.

    Rotations are applied SEQUENTIALLY (one pair at a time).  Unlike the
    unitary (Hermitian) case, complex-orthogonal rotations are not
    norm-preserving, and applying a round of disjoint rotations
    simultaneously was measured to diverge even in float64 — sequential
    cyclic application converges (verified against numpy eig).  The batch
    dimension still vectorizes: every step updates 2 rows + 2 cols across
    the whole vmapped batch at once.
    """
    n = a.re.shape[-1]
    pi, pj = _cyclic_pairs(n)
    pi, pj = jnp.asarray(pi), jnp.asarray(pj)
    steps_per_sweep = pi.shape[0]

    def cdiv(xr, xi, yr, yi):
        d = yr * yr + yi * yi + 1e-38
        return (xr * yr + xi * yi) / d, (xi * yr - xr * yi) / d

    def csqrt(xr, xi):
        r = jnp.hypot(xr, xi)
        re = jnp.sqrt(jnp.maximum(0.5 * (r + xr), 0.0))
        im = jnp.sqrt(jnp.maximum(0.5 * (r - xr), 0.0))
        return re, jnp.where(xi < 0, -im, im)

    def rotate(carry, k):
        ar, ai = carry
        ii, jj = pi[k % steps_per_sweep], pj[k % steps_per_sweep]
        a_r, a_i = ar[ii, ii], ai[ii, ii]
        d_r, d_i = ar[jj, jj], ai[jj, jj]
        b_r, b_i = ar[ii, jj], ai[ii, jj]
        babs = jnp.hypot(b_r, b_i)
        diag_scale = jnp.hypot(jnp.hypot(a_r, a_i), jnp.hypot(d_r, d_i)) + 1e-30
        skip = babs <= 1e-7 * diag_scale

        # tau = (d - a) / (2 b);  root = sqrt(tau^2 + 1)
        tr, ti = cdiv(d_r - a_r, d_i - a_i, 2.0 * b_r, 2.0 * b_i)
        t2r = tr * tr - ti * ti + 1.0
        t2i = 2.0 * tr * ti
        rr, ri = csqrt(t2r, t2i)
        d1 = jnp.hypot(tr + rr, ti + ri)
        d2 = jnp.hypot(tr - rr, ti - ri)
        use1 = d1 >= d2
        den_r = jnp.where(use1, tr + rr, tr - rr)
        den_i = jnp.where(use1, ti + ri, ti - ri)
        one = jnp.ones_like(den_r)
        zero = jnp.zeros_like(den_r)
        t_r, t_i = cdiv(one, zero, den_r, den_i)
        # c = 1/sqrt(1 + t^2), s = c t  (complex); guard near-defective pairs
        ct2r = t_r * t_r - t_i * t_i + 1.0
        ct2i = 2.0 * t_r * t_i
        skip = skip | (jnp.hypot(ct2r, ct2i) < 1e-12)
        sq_r, sq_i = csqrt(ct2r, ct2i)
        c_r, c_i = cdiv(one, zero, sq_r, sq_i)
        s_r = c_r * t_r - c_i * t_i
        s_i = c_r * t_i + c_i * t_r
        c_r = jnp.where(skip, 1.0, c_r)
        c_i = jnp.where(skip, 0.0, c_i)
        s_r = jnp.where(skip, 0.0, s_r)
        s_i = jnp.where(skip, 0.0, s_i)

        # Row update (J^T A): row_i' = c ri - s rj ; row_j' = s ri + c rj
        ri_r, ri_i = ar[ii, :], ai[ii, :]
        rj_r, rj_i = ar[jj, :], ai[jj, :]
        ni_r = c_r * ri_r - c_i * ri_i - (s_r * rj_r - s_i * rj_i)
        ni_i = c_r * ri_i + c_i * ri_r - (s_r * rj_i + s_i * rj_r)
        nj_r = s_r * ri_r - s_i * ri_i + c_r * rj_r - c_i * rj_i
        nj_i = s_r * ri_i + s_i * ri_r + c_r * rj_i + c_i * rj_r
        ar = ar.at[ii, :].set(ni_r).at[jj, :].set(nj_r)
        ai = ai.at[ii, :].set(ni_i).at[jj, :].set(nj_i)

        # Column update (A J): col_i' = c ci - s cj ; col_j' = s ci + c cj
        ci_r, ci_i = ar[:, ii], ai[:, ii]
        cj_r, cj_i = ar[:, jj], ai[:, jj]
        mi_r = c_r * ci_r - c_i * ci_i - (s_r * cj_r - s_i * cj_i)
        mi_i = c_r * ci_i + c_i * ci_r - (s_r * cj_i + s_i * cj_r)
        mj_r = s_r * ci_r - s_i * ci_i + c_r * cj_r - c_i * cj_i
        mj_i = s_r * ci_i + s_i * ci_r + c_r * cj_i + c_i * cj_r
        ar = ar.at[:, ii].set(mi_r).at[:, jj].set(mj_r)
        ai = ai.at[:, ii].set(mi_i).at[:, jj].set(mj_i)
        return (ar, ai), None

    carry = (a.re, a.im)
    ks = jnp.arange(steps_per_sweep * sweeps)
    carry, _ = jax.lax.scan(rotate, carry, ks)
    ar, ai = carry
    mu = CArr(jnp.diagonal(ar), jnp.diagonal(ai))
    # off-diagonal energy by MASK (not total - diag, which cancels to 0 in
    # f32 once the off-diag norm is below ~sqrt(eps) of the diagonal —
    # matches the kernel's masked accumulation)
    offm = 1.0 - jnp.eye(ar.shape[-1], dtype=ar.dtype)
    resid = jnp.sqrt(jnp.sum((ar * ar + ai * ai) * offm))
    return mu, resid


def eig_cs(a: CArr, sweeps: int = 10) -> CArr:
    """Batched eigenvalues of complex-symmetric matrices (..., n, n).

    Returns CArr (..., n) of eigenvalues (unordered).  The input MUST be
    (numerically) complex symmetric; callers symmetrize first.
    """
    return eig_cs_resid(a, sweeps=sweeps)[0]


def eig_cs_resid(a: CArr, sweeps: int = 10):
    """eig_cs plus the final off-diagonal Frobenius norm per matrix.

    Returns (mu, resid) with mu CArr (..., n) and resid (...,) — the Jacobi
    convergence counter (SURVEY.md §5 metrics row), measured on the ACTUAL
    input matrices, so bench.py can surface production convergence.
    """
    if platform() == "gpu":
        return eig_kernel.eig_cs_resid(a, sweeps=sweeps)
    fn = functools.partial(_eig_cs_single, sweeps=sweeps)
    ndim = a.re.ndim
    for _ in range(ndim - 2):
        fn = jax.vmap(fn)
    return fn(a)
