"""Unit tests for the ops layer against numpy/scipy ground truth
(SURVEY.md §4: per-kernel unit tests vs oracle on random batches)."""
import numpy as np
import pytest
import scipy.linalg

import jax
import jax.numpy as jnp

from llckbdm_tpu.ops import cplx, jacobi
from llckbdm_tpu.ops.cplx import CArr, from_np, to_np
from llckbdm_tpu.ops.hankel import hankel_matrices
from llckbdm_tpu.ops.linalg import cholqr_rinv, hermitian_solve, takagi_small


def _rand_c(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


# ---------------------------------------------------------------------------
# complex-pair arithmetic
# ---------------------------------------------------------------------------

def test_cplx_roundtrip_and_arith():
    rng = np.random.default_rng(0)
    a = _rand_c(rng, 4, 5)
    b = _rand_c(rng, 4, 5)
    ca, cb = from_np(a), from_np(b)
    np.testing.assert_allclose(to_np(ca), a.astype(np.complex64), rtol=1e-6)
    np.testing.assert_allclose(to_np(cplx.cmul(ca, cb)), a * b, rtol=1e-5)
    np.testing.assert_allclose(to_np(cplx.cdiv(ca, cb)), a / b, rtol=1e-4)
    np.testing.assert_allclose(to_np(cplx.conj(ca)), np.conj(a), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(cplx.cabs(ca)), np.abs(a), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(cplx.cangle(ca)), np.angle(a),
                               rtol=1e-4, atol=1e-6)


def test_cmatmul_matches_numpy():
    rng = np.random.default_rng(1)
    a = _rand_c(rng, 3, 16, 24)
    b = _rand_c(rng, 3, 24, 8)
    got = to_np(cplx.cmatmul(from_np(a), from_np(b)))
    np.testing.assert_allclose(got, a @ b, rtol=1e-4, atol=1e-5)


def test_chermitian_and_cpow():
    rng = np.random.default_rng(2)
    a = _rand_c(rng, 6, 6)
    got = to_np(cplx.chermitian(from_np(a)))
    np.testing.assert_allclose(got, a.conj().T, rtol=1e-6)
    z = 0.99 * np.exp(1j * 0.3)
    cz = from_np(np.array([z]))
    got = to_np(cplx.cpow_int(cz, jnp.float32(37)))
    np.testing.assert_allclose(got, [z ** 37], rtol=1e-4)


def test_cpow_fixed_and_cpowers_match_numpy():
    """Binary-exponentiation powers (the transcendental-free hot path of
    _poles_to_lines) vs numpy, including n=0/1 edges and damped poles."""
    rng = np.random.default_rng(6)
    z = 0.999 * np.exp(1j * rng.uniform(-3, 3, 7)) \
        * rng.uniform(0.95, 1.0, 7)
    cz = from_np(z)
    for n in (0, 1, 2, 37, 128, 512):
        got = to_np(cplx.cpow_fixed(cz, n))
        np.testing.assert_allclose(got, z ** n, rtol=5e-4, atol=1e-6)
    got = to_np(cplx.cpowers(cz, 128))         # (7, 128)
    want = z[:, None] ** np.arange(128)[None, :]
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# Hankel construction
# ---------------------------------------------------------------------------

def test_hankel_matrices_layout():
    n, m = 32, 12
    c = np.arange(n) + 1j * np.arange(n)[::-1]
    h0 = to_np(hankel_matrices(from_np(c), m))
    h1 = to_np(hankel_matrices(from_np(c), m, shift=1))
    idx = np.arange(m)[:, None] + np.arange(m)[None, :]
    np.testing.assert_allclose(h0, c[idx].astype(np.complex64))
    np.testing.assert_allclose(h1, c[idx + 1].astype(np.complex64))


def test_hankel_batched():
    rng = np.random.default_rng(3)
    c = _rand_c(rng, 4, 40)
    h = to_np(hankel_matrices(from_np(c), 16))
    assert h.shape == (4, 16, 16)
    idx = np.arange(16)[:, None] + np.arange(16)[None, :]
    np.testing.assert_allclose(h[2], c[2][idx].astype(np.complex64),
                               rtol=1e-6)


def test_hankel_apply_fft_matches_dense():
    """The implicit FFT Hankel apply (BASELINE.json:5 'implicit FFT-based
    operators') equals the materialized matmul for both shifts.

    NOTE the implicit form is a correctness-complete alternative but NOT
    the shipped hot path (the materialized matmul apply is); compare the
    two with tools/bench_fft_hankel.py."""
    from llckbdm_tpu.ops.hankel import (fft_length, hankel_apply_fft,
                                        hankel_fft_spectrum)
    rng = np.random.default_rng(7)
    v, m, j = 3, 24, 5
    c = _rand_c(rng, v, 2 * m)
    x = _rand_c(rng, v, m, j)
    assert fft_length(m) == 64
    for shift in (0, 1):
        h = to_np(hankel_matrices(from_np(c), m, shift=shift))
        want = np.einsum("vab,vbj->vaj", h.astype(np.complex128),
                         x.astype(np.complex128))
        spec = hankel_fft_spectrum(from_np(c), m, shift=shift)
        got = to_np(hankel_apply_fft(spec, from_np(x), m))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Cholesky factors and the complex-symmetric Jacobi eigensolver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(10,), (3, 8)])
def test_cholqr_rinv_matches_scipy_cholesky(shape):
    """R^{-1} is the inverse of scipy's upper Cholesky factor of G + shift."""
    rng = np.random.default_rng(4)
    k = shape[-1]
    y = _rand_c(rng, *shape[:-1], 3 * k, k)
    g = np.swapaxes(y.conj(), -1, -2) @ y
    shift = np.full(shape[:-1], 0.25, np.float32)
    rinv = to_np(cholqr_rinv(from_np(g), shift))
    gs = (g + 0.25 * np.eye(k)).reshape(-1, k, k)
    for r, gb in zip(rinv.reshape(-1, k, k), gs):
        want = np.linalg.inv(scipy.linalg.cholesky(gb, lower=False))
        np.testing.assert_allclose(r, want, rtol=0, atol=2e-4)


def test_eig_cs_matches_scipy():
    """Complex-symmetric eigenvalues match general scipy.linalg.eig."""
    rng = np.random.default_rng(6)
    a = _rand_c(rng, 8, 8)
    a = 0.5 * (a + a.T)  # complex symmetric (NOT Hermitian)
    mu = jacobi.eig_cs(from_np(a), sweeps=16)
    mu = to_np(mu)
    mu_ref = scipy.linalg.eig(a)[0]
    # compare as sorted multisets (order-free)
    key = lambda z: (np.round(z.real, 4), np.round(z.imag, 4))
    mu_s = sorted(mu, key=key)
    ref_s = sorted(mu_ref, key=key)
    np.testing.assert_allclose(mu_s, ref_s, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# linalg: CholeskyQR, Takagi, Hermitian solve
# ---------------------------------------------------------------------------

def test_cholqr2_produces_orthonormal_basis():
    """Two shifted CholeskyQR passes (the kbdm_sweep final basis)."""
    rng = np.random.default_rng(7)
    y = _rand_c(rng, 20, 6)
    q = y
    for _ in range(2):
        g = q.conj().T @ q
        shift = np.float32(3e-6 * np.mean(np.abs(np.diag(g))))
        q = q @ to_np(cholqr_rinv(from_np(g), shift))
    np.testing.assert_allclose(q.conj().T @ q, np.eye(6), rtol=0, atol=5e-4)
    # span preserved: projection of y onto q recovers y
    proj = q @ (q.conj().T @ y)
    np.testing.assert_allclose(proj, y, rtol=0, atol=1e-3)


def test_takagi_factorization():
    """Takagi: A = U diag(s) U^T for complex-symmetric A, s >= 0 sorted."""
    rng = np.random.default_rng(8)
    a = _rand_c(rng, 6, 6)
    a = 0.5 * (a + a.T)
    u, s = takagi_small(from_np(a))
    un, sn = to_np(u), np.asarray(s)
    assert np.all(sn[:-1] >= sn[1:] - 1e-5)  # sorted descending
    recon = un @ np.diag(sn) @ un.T
    np.testing.assert_allclose(recon, a, rtol=0, atol=2e-3)
    # singular values match SVD of A
    np.testing.assert_allclose(np.sort(sn), np.sort(scipy.linalg.svdvals(a)),
                               rtol=1e-3, atol=1e-4)


def test_hermitian_solve():
    rng = np.random.default_rng(9)
    a = _rand_c(rng, 8, 8)
    h = a @ a.conj().T + 0.1 * np.eye(8)  # HPD
    b = _rand_c(rng, 8)
    x = hermitian_solve(from_np(h), from_np(b))
    np.testing.assert_allclose(to_np(x), scipy.linalg.solve(h, b),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("ridge,rcond", [(0.5, 0.0), ("per-matrix", 0.0),
                                         (0.0, 0.3)])
def test_hermitian_solve_shift_is_tikhonov(ridge, rcond):
    """The solve is (h + shift I) x = b with shift = ridge + rcond *
    mean|diag h|; ridge may be a scalar or (..., 1)-shaped per matrix."""
    rng = np.random.default_rng(10)
    a = _rand_c(rng, 3, 8, 8)
    h = a @ np.swapaxes(a.conj(), -1, -2) + 0.1 * np.eye(8)
    b = _rand_c(rng, 3, 8)
    if ridge == "per-matrix":
        ridge = np.array([[0.5], [1.0], [2.0]], np.float32)
    x = to_np(hermitian_solve(from_np(h), from_np(b), ridge=ridge,
                              rcond=rcond))
    shift = (np.broadcast_to(np.asarray(ridge).reshape(-1), (3,))
             + rcond * np.mean(np.abs(np.einsum("bii->bi", h.real)), -1))
    for i in range(3):
        want = scipy.linalg.solve(h[i] + shift[i] * np.eye(8), b[i])
        np.testing.assert_allclose(x[i], want, rtol=2e-3, atol=1e-4)
