"""Small batched Hermitian linear algebra on the complex-as-real-pairs layout.

Plain XLA linear algebra — cuSOLVER on the GPU, LAPACK on the CPU, one
formulation for both.  Operands cross to native complex64 at the call and
back to (re, im) pairs after it.

* :func:`cholqr_rinv`    — R^{-1} of the shifted Cholesky G + shift I = R^H R,
                           the building block of CholeskyQR2
                           orthonormalization (solver.kbdm);
* :func:`takagi_small`   — Takagi factorization M = W diag(s) W^T of a small
                           complex-symmetric matrix (eigh of M M^H + phase
                           fix);
* :func:`hermitian_solve`— (H + shift I) x = b for Hermitian PSD H by
                           Cholesky with a Tikhonov shift.

All batched over leading dims.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .cplx import CArr, cangle, cexp, chermitian, cmatmul, cmul, conj, \
    cscale_cols


def _to_c(x: CArr) -> jax.Array:
    return jax.lax.complex(x.re, x.im)


def _from_c(z: jax.Array) -> CArr:
    return CArr(jnp.real(z), jnp.imag(z))


def _shifted_cholesky(h: CArr, shift) -> jax.Array:
    """Lower L (complex64) with (h + h^H)/2 + shift*I = L L^H."""
    hc = _to_c(h)
    hc = 0.5 * (hc + jnp.conj(jnp.swapaxes(hc, -1, -2)))
    eye = jnp.eye(hc.shape[-1], dtype=hc.dtype)
    shift = jnp.asarray(shift, jnp.float32)[..., None, None]
    return jnp.linalg.cholesky(hc + shift * eye)


def _mean_abs_diag(h: CArr) -> jax.Array:
    return jnp.mean(jnp.abs(jnp.diagonal(h.re, axis1=-2, axis2=-1)), axis=-1)


def cholqr_rinv(g: CArr, shift: jax.Array) -> CArr:
    """Upper-triangular R^{-1} with G + shift*I = R^H R, batched.

    g : CArr (..., k, k) Hermitian PSD (e.g. y^H y);  shift : (...,)
    absolute diagonal shift.  Q = y @ R^{-1} orthonormalizes y (CholeskyQR).
    """
    low = _shifted_cholesky(g, shift)                  # R = L^H
    eye = jnp.broadcast_to(jnp.eye(low.shape[-1], dtype=low.dtype), low.shape)
    # R^{-1} = (L^H)^{-1}: solve L^H X = I
    return _from_c(jax.lax.linalg.triangular_solve(
        low, eye, left_side=True, lower=True, transpose_a=True,
        conjugate_a=True))


def takagi_small(m: CArr):
    """Takagi factorization of a complex-symmetric (..., k, k) matrix.

    Returns (w, s): unitary w (..., k, k) and singular values s (..., k)
    sorted descending with  m ~= w diag(s) w^T.

    Method: m m^H is Hermitian PSD; eigh gives candidate vectors u with
    eigenvalues s^2.  For each simple singular value, m conj(u) = t u with
    |t| = s; rotating u by exp(i*angle(t)/2) makes t real positive, which is
    exactly the Takagi condition.  (Degenerate pairs are generically split by
    the KBDM spectra; exact ties would need an extra 2x2 rotation.)
    """
    # eigh symmetrizes its input; eigenvalues ascending -> flip
    lam, u = jnp.linalg.eigh(_to_c(cmatmul(m, chermitian(m))))
    s = jnp.sqrt(jnp.maximum(lam[..., ::-1], 0.0))
    u = _from_c(u[..., ::-1])
    # t_k = u_k^H m conj(u_k)
    mu = cmatmul(m, conj(u))                     # (..., k, k)
    prod = cmul(conj(u), mu)
    t = CArr(jnp.sum(prod.re, axis=-2), jnp.sum(prod.im, axis=-2))
    half = CArr(jnp.zeros_like(t.re), 0.5 * cangle(t))
    w = cscale_cols(u, cexp(half))               # u_k e^{i angle(t_k)/2}
    return w, s


def hermitian_solve(h: CArr, b: CArr, ridge=0.0,
                    rcond: float = 1e-12) -> CArr:
    """Solve (h + shift*I) x = b for Hermitian PSD h (..., k, k), b (..., k)
    by Cholesky, with the Tikhonov shift  ridge + rcond * mean|diag(h)|.

    ridge may be a float or an array broadcastable to the batch shape,
    possibly with a trailing singleton axis (..., 1).  The shift keeps the
    solve bounded for near-singular h (e.g. duplicate poles).  Cholesky's
    rounding is invariant to a diagonal scaling of h, which the graded
    normal matrices of the Gauss-Newton refinement need: an eigenvalue-
    truncated pseudo-inverse loses their small, well-determined directions.
    """
    r = jnp.asarray(ridge, jnp.float32)
    if r.ndim == b.re.ndim:               # (..., 1)-shaped relative ridge
        r = r[..., 0]
    low = _shifted_cholesky(h, r + rcond * _mean_abs_diag(h))
    y = jax.lax.linalg.triangular_solve(low, _to_c(b)[..., None],
                                        left_side=True, lower=True)
    x = jax.lax.linalg.triangular_solve(low, y, left_side=True, lower=True,
                                        transpose_a=True, conjugate_a=True)
    return _from_c(x[..., 0])
