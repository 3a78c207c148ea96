"""Hankel operators for KBDM (device-native).

U0[i, j] = c[i + j], U1[i, j] = c[i + j + 1] (oracle: reference.kbdm).

Two forms are provided:

:func:`hankel_matrices` materializes the m x m pair.  For the m-sweep the
*largest* m is materialized once; every smaller m is its leading submatrix,
selected by the row/col masks built in solver.kbdm.kbdm_sweep.  This turns
the whole multi-m sweep into one batched masked computation (SURVEY.md §7:
"the m-sweep must be one batched launch, not 46").

:func:`hankel_fft_spectrum` + :func:`hankel_apply_fft` implement the same
operator IMPLICITLY as FFT-based circular convolution (the north-star's
"Hankel/Toeplitz matrix construction as implicit FFT-based operators",
BASELINE.json:5): a Hankel matvec  y_i = sum_j c[i+j] x_j  is a correlation
with the raw signal, so the power-iteration applies can run in
O(nfft log nfft) per column with NO materialized (V, m, m) operator in
device memory.  Whether the implicit form beats the dense matmul apply at a
given (m, batch) is measured, not assumed — see tools/bench_fft_hankel.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .cplx import CArr


def hankel_matrices(c: CArr, m: int, shift: int = 0) -> CArr:
    """Materialize the m x m Hankel matrix H[i, j] = c[i + j + shift].

    c has shape (..., n) with n >= 2m (+ shift).  Returns (..., m, m).

    Lowered as ONE elementwise gather from the (..., n) signal.
    """
    idx = jnp.arange(m)[:, None] + jnp.arange(m)[None, :] + shift
    return CArr(c.re[..., idx], c.im[..., idx])


def fft_length(m: int) -> int:
    """Smallest power of two >= 2m (no circular-wrap contamination for
    indices i + j + shift <= 2m - 1)."""
    nfft = 1
    while nfft < 2 * m:
        nfft *= 2
    return nfft


def hankel_fft_spectrum(c: CArr, m: int, shift: int = 0,
                        n_fft: int | None = None) -> jax.Array:
    """FFT of the signal window that defines the implicit m x m Hankel.

    c : CArr (..., n) with n >= 2m (+ shift).  Returns complex64
    (..., nfft) — precompute ONCE per launch; every subsequent
    :func:`hankel_apply_fft` is two batched FFTs, no (m, m) operator.
    """
    nfft = n_fft or fft_length(m)
    n = c.re.shape[-1]
    take = min(nfft, n - shift)
    ct = jax.lax.complex(c.re[..., shift:shift + take],
                         c.im[..., shift:shift + take])
    if take < nfft:
        pad = [(0, 0)] * (ct.ndim - 1) + [(0, nfft - take)]
        ct = jnp.pad(ct, pad)
    return jnp.fft.fft(ct, axis=-1)


def hankel_apply_fft(spec: jax.Array, x: CArr, m: int) -> CArr:
    """Implicit Hankel apply  y_i = sum_{j<m} c[i+j+shift] x_j,  i < m.

    spec : (..., nfft) complex64 from :func:`hankel_fft_spectrum`
    x    : CArr (..., m, J) — J columns applied at once
    Returns CArr (..., m, J).

    Circular-convolution identity: with ct the nfft-window of the signal
    and x~ the index-REVERSED zero-padded x (whose DFT is nfft * ifft(x)),
    (ct (*) x~)[i] = sum_j ct[i+j] x_j exactly for i + j < nfft — the
    power-of-two nfft >= 2m guarantees no wraparound.  Cost per column:
    two complex FFTs of length nfft, O(nfft log nfft), independent of m^2.
    """
    nfft = spec.shape[-1]
    xc = jax.lax.complex(x.re, x.im)                    # (..., m, J)
    xc = jnp.swapaxes(xc, -1, -2)                       # (..., J, m): FFT
    pad = [(0, 0)] * (xc.ndim - 1) + [(0, nfft - m)]    # on the LAST axis
    xf = jnp.fft.ifft(jnp.pad(xc, pad), axis=-1) * nfft
    yf = spec[..., None, :] * xf
    y = jnp.fft.ifft(yf, axis=-1)[..., :m]
    y = jnp.swapaxes(y, -1, -2)                         # (..., m, J)
    return CArr(jnp.real(y), jnp.imag(y))
