"""Batched complex-symmetric Jacobi eigensolver as one Pallas Triton kernel.

The KBDM reduced eigenproblem is V*S small (p x p) complex-symmetric
matrices per fit (71,680 at p=16 in the bench shapes).  The plain JAX
formulation (ops.jacobi, a ``lax.scan`` under ``vmap``) runs
sweeps * p(p-1)/2 dependent rotation steps, each one a launch that gathers
and scatters rows and columns across the whole batch in device memory.
Here one program holds a tile of ``block`` matrices in registers for all
sweeps: device memory is read once and the eigenvalues are written once.

Triton has no dynamic indexing into register tensors, so a row or column is
extracted with an iota mask and a reduction and written back with a select.
Because A = A^T, column i of A is also row i, so the two-sided rotation
J^T A J needs only two column extractions:

    x, y = A[:, i], A[:, j]                  masked reductions
    x', y' = c x - s y, s x + c y            rotated columns
    x'[i], x'[j] = y'[i], y'[j]              from the closed-form 2x2 block
                                             of J^T A J at (i, j)
    A[:, i] = A[i, :] = x';  A[:, j] = A[j, :] = y'     selects

The pairs are visited in the cyclic row order of ops.jacobi and the
rotation formulas are the scan's, so both apply the same rotation sequence
and differ only in f32 rounding.  Triton wants power-of-two tensor dims, so
p is zero-padded (24 -> 32); the loops visit only the true p(p-1)/2 pairs,
so padded rows stay zero and their slots are dropped from the result.

Tested on the CPU in ``interpret=True`` mode (tests/test_eig_kernel.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .cplx import CArr

# Matrices per program.  The tile (block * P * P complex f32) stays at
# ~2048 elements per real component — 16 per thread per component at 4
# warps — whatever the padded size P.
_TILE = 2048
_NUM_WARPS = 4


def padded_size(n: int) -> int:
    """Smallest power of two >= n (Triton's tensor dims)."""
    return max(2, 1 << (n - 1).bit_length())


def block_size(n: int) -> int:
    """Matrices per program for a (padded) size."""
    p = padded_size(n)
    return max(1, _TILE // (p * p))


def _cdiv(xr, xi, yr, yi):
    d = yr * yr + yi * yi + 1e-38
    return (xr * yr + xi * yi) / d, (xi * yr - xr * yi) / d


def _csqrt(xr, xi):
    r = jnp.sqrt(xr * xr + xi * xi)
    re = jnp.sqrt(jnp.maximum(0.5 * (r + xr), 0.0))
    im = jnp.sqrt(jnp.maximum(0.5 * (r - xr), 0.0))
    return re, jnp.where(xi < 0, -im, im)


def _cmul(xr, xi, yr, yi):
    return xr * yr - xi * yi, xr * yi + xi * yr


def _rotation(a_r, a_i, d_r, d_i, b_r, b_i):
    """(c, s) of the complex-orthogonal rotation zeroing b in [[a, b], [b, d]]
    (ops.jacobi._eig_cs_single's formulas; skipped pairs give c=1, s=0)."""
    babs = jnp.sqrt(b_r * b_r + b_i * b_i)
    dscale = jnp.sqrt(a_r * a_r + a_i * a_i + d_r * d_r + d_i * d_i) + 1e-30
    skip = babs <= 1e-7 * dscale
    tr, ti = _cdiv(d_r - a_r, d_i - a_i, 2.0 * b_r, 2.0 * b_i)
    rr, ri = _csqrt(tr * tr - ti * ti + 1.0, 2.0 * tr * ti)
    d1 = (tr + rr) * (tr + rr) + (ti + ri) * (ti + ri)
    d2 = (tr - rr) * (tr - rr) + (ti - ri) * (ti - ri)
    use1 = d1 >= d2
    den_r = jnp.where(use1, tr + rr, tr - rr)
    den_i = jnp.where(use1, ti + ri, ti - ri)
    one, zero = jnp.ones_like(den_r), jnp.zeros_like(den_r)
    t_r, t_i = _cdiv(one, zero, den_r, den_i)
    ct2r = t_r * t_r - t_i * t_i + 1.0
    ct2i = 2.0 * t_r * t_i
    skip = skip | (jnp.sqrt(ct2r * ct2r + ct2i * ct2i) < 1e-12)
    sq_r, sq_i = _csqrt(ct2r, ct2i)
    c_r, c_i = _cdiv(one, zero, sq_r, sq_i)
    s_r, s_i = _cmul(c_r, c_i, t_r, t_i)
    return (jnp.where(skip, 1.0, c_r), jnp.where(skip, 0.0, c_i),
            jnp.where(skip, 0.0, s_r), jnp.where(skip, 0.0, s_i))


def _kernel(ar_ref, ai_ref, mur_ref, mui_ref, off_ref, *, n: int,
            sweeps: int):
    ar, ai = ar_ref[...], ai_ref[...]                  # (B, P, P)
    p = ar.shape[-1]
    row = jax.lax.broadcasted_iota(jnp.int32, (1, p, 1), 1)
    col = jax.lax.broadcasted_iota(jnp.int32, (1, 1, p), 2)
    vec = jax.lax.broadcasted_iota(jnp.int32, (1, p), 1)

    def pick(v, m):                                    # (B, P) -> (B,)
        return jnp.sum(jnp.where(m, v, 0.0), axis=1)

    def rotate(i, j, carry):
        ar, ai = carry
        ci, cj = col == i, col == j
        xr = jnp.sum(jnp.where(ci, ar, 0.0), axis=2)   # A[:, i] = A[i, :]
        xi = jnp.sum(jnp.where(ci, ai, 0.0), axis=2)
        yr = jnp.sum(jnp.where(cj, ar, 0.0), axis=2)   # A[:, j] = A[j, :]
        yi = jnp.sum(jnp.where(cj, ai, 0.0), axis=2)
        vi, vj = vec == i, vec == j
        a_r, a_i = pick(xr, vi), pick(xi, vi)          # A[i, i]
        d_r, d_i = pick(yr, vj), pick(yi, vj)          # A[j, j]
        b_r, b_i = pick(xr, vj), pick(xi, vj)          # A[i, j]
        c_r, c_i, s_r, s_i = _rotation(a_r, a_i, d_r, d_i, b_r, b_i)

        # 2x2 block of J^T [[a, b], [b, d]] J
        b00 = _cmul(c_r, c_i, a_r, a_i)
        t = _cmul(s_r, s_i, b_r, b_i)
        b00 = (b00[0] - t[0], b00[1] - t[1])
        b01 = _cmul(c_r, c_i, b_r, b_i)
        t = _cmul(s_r, s_i, d_r, d_i)
        b01 = (b01[0] - t[0], b01[1] - t[1])
        b10 = _cmul(s_r, s_i, a_r, a_i)
        t = _cmul(c_r, c_i, b_r, b_i)
        b10 = (b10[0] + t[0], b10[1] + t[1])
        b11 = _cmul(s_r, s_i, b_r, b_i)
        t = _cmul(c_r, c_i, d_r, d_i)
        b11 = (b11[0] + t[0], b11[1] + t[1])
        nii = _cmul(c_r, c_i, *b00)
        t = _cmul(s_r, s_i, *b01)
        nii = (nii[0] - t[0], nii[1] - t[1])
        nij = _cmul(s_r, s_i, *b00)
        t = _cmul(c_r, c_i, *b01)
        nij = (nij[0] + t[0], nij[1] + t[1])
        njj = _cmul(s_r, s_i, *b10)
        t = _cmul(c_r, c_i, *b11)
        njj = (njj[0] + t[0], njj[1] + t[1])

        c_r, c_i, s_r, s_i = (c_r[:, None], c_i[:, None],
                              s_r[:, None], s_i[:, None])
        nxr = c_r * xr - c_i * xi - (s_r * yr - s_i * yi)
        nxi = c_r * xi + c_i * xr - (s_r * yi + s_i * yr)
        nyr = s_r * xr - s_i * xi + c_r * yr - c_i * yi
        nyi = s_r * xi + s_i * xr + c_r * yi + c_i * yr
        def fix(v, at_own, at_other, own, other):    # set the 2x2 entries
            return jnp.where(at_own, own[:, None],
                             jnp.where(at_other, other[:, None], v))
        nxr = fix(nxr, vi, vj, nii[0], nij[0])
        nxi = fix(nxi, vi, vj, nii[1], nij[1])
        nyr = fix(nyr, vj, vi, njj[0], nij[0])
        nyi = fix(nyi, vj, vi, njj[1], nij[1])

        ri, rj = row == i, row == j

        def write(m, nx, ny):                        # columns, then rows
            m = jnp.where(ci, nx[:, :, None],
                          jnp.where(cj, ny[:, :, None], m))
            return jnp.where(ri, nx[:, None, :],
                             jnp.where(rj, ny[:, None, :], m))
        return write(ar, nxr, nyr), write(ai, nxi, nyi)

    def over_i(i, carry):
        return jax.lax.fori_loop(i + 1, n, functools.partial(rotate, i), carry)

    def sweep(_, carry):
        return jax.lax.fori_loop(0, n - 1, over_i, carry)

    ar, ai = jax.lax.fori_loop(0, sweeps, sweep, (ar, ai))
    diag = row == col
    mur_ref[...] = jnp.sum(jnp.where(diag, ar, 0.0), axis=2)
    mui_ref[...] = jnp.sum(jnp.where(diag, ai, 0.0), axis=2)
    # Off-diagonal energy by MASK, not total minus diagonal: the difference
    # cancels to 0 in f32 once the off-diagonal norm falls below ~sqrt(eps)
    # of the diagonal, which would floor the convergence counter.
    offm = jnp.where(diag, 0.0, ar * ar + ai * ai)
    off_ref[...] = jnp.sum(jnp.sum(offm, axis=2), axis=1)


def eig_cs_resid(a: CArr, sweeps: int = 10, interpret: bool = False):
    """Eigenvalues and final off-diagonal Frobenius norm of a batch of
    complex-symmetric matrices — same contract as ops.jacobi.eig_cs_resid.

    a : CArr (..., n, n), a = a^T.  Returns (CArr (..., n), resid (...,)).
    """
    n = a.re.shape[-1]
    batch_shape = a.re.shape[:-2]
    p, blk = padded_size(n), block_size(n)
    ar = a.re.reshape(-1, n, n).astype(jnp.float32)
    ai = a.im.reshape(-1, n, n).astype(jnp.float32)
    b = ar.shape[0]
    b_pad = -(-b // blk) * blk
    pad = ((0, b_pad - b), (0, p - n), (0, p - n))
    ar, ai = jnp.pad(ar, pad), jnp.pad(ai, pad)

    mat = pl.BlockSpec((blk, p, p), lambda g: (g, 0, 0))
    vec = pl.BlockSpec((blk, p), lambda g: (g, 0))
    mur, mui, off = pl.pallas_call(
        functools.partial(_kernel, n=n, sweeps=sweeps),
        grid=(b_pad // blk,),
        in_specs=[mat, mat],
        out_specs=[vec, vec, pl.BlockSpec((blk,), lambda g: (g,))],
        out_shape=[jax.ShapeDtypeStruct((b_pad, p), jnp.float32),
                   jax.ShapeDtypeStruct((b_pad, p), jnp.float32),
                   jax.ShapeDtypeStruct((b_pad,), jnp.float32)],
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="eig_cs_jacobi",
    )(ar, ai)
    mu = CArr(mur[:b, :n].reshape(*batch_shape, n),
              mui[:b, :n].reshape(*batch_shape, n))
    resid = jnp.sqrt(jnp.maximum(off[:b], 0.0)).reshape(batch_shape)
    return mu, resid
