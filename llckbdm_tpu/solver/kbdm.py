"""Device KBDM solver (oracle counterpart: oracle.reference.kbdm).

Not a port of the LAPACK-based oracle, but the same math restructured for
batched dense kernels (SURVEY.md §7):

* The truncated SVD of the m x m Hankel U0 is computed by **randomized
  subspace iteration + Rayleigh-Ritz** (a few U0-matmuls on m x k blocks)
  instead of a full O(m^3) dense SVD.  U0 is complex *symmetric* (Hankel), so
  the Rayleigh-Ritz step is a k x k **Takagi** factorization, which makes the
  right singular block exactly conj(left) and the reduced matrix exactly
  complex-symmetric.
* The reduced p x p eigenproblem is solved by the batched complex-symmetric
  Jacobi eigensolver (ops.jacobi.eig_cs; a Pallas Triton kernel on the GPU).
* Vandermonde least-squares amplitudes use the closed-form geometric-series
  Gram matrix (O(p^2) instead of O(N p^2)) plus a chunked power-scan for the
  right-hand side, solved by a shifted Cholesky factorization.
* The multi-m sweep shares ONE materialized m_max Hankel operator: the m x m
  problem is the leading submatrix, selected by row/col masks, so the whole
  sweep is a single batched launch (SURVEY.md §7 hard part 4).

Everything is fixed-shape and masked: line-list slots beyond the numerical
rank carry mask=0 and pole mu=0.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.cplx import (CArr, cabs, cangle, cmul, conj, cpow_fixed,
                        cpowers, cwhere)
from ..ops import jacobi
from ..ops.hankel import hankel_matrices
from ..ops.linalg import cholqr_rinv, hermitian_solve, takagi_small
from ..signals import LineList

_es = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


@dataclass(frozen=True)
class KbdmConfig:
    """Solver configuration (kwargs parity with the oracle: m, p, plus
    solver knobs; SURVEY.md §5 'config system')."""

    p: int = 24                  # truncation rank / line capacity per run
    oversample: int = 8          # extra subspace dims for the randomized SVD
    subspace_iters: int = 2      # power iterations (each ~ one U0 U0^H apply)
    eig_sweeps: int = 10         # Jacobi sweeps for the complex-symmetric
                                 # eigensolve; the production convergence
                                 # counter (with_diag=True) shows the
                                 # quadratic cliff: production matrices
                                 # need all 10
    final_orth_passes: int = 2   # CholeskyQR passes for the Rayleigh-Ritz
                                 # basis (CholeskyQR2); the power-iteration
                                 # bases take one
    rank_tol: float = 1e-6       # sigma truncation relative to sigma_max
    mu_log_max: float = 30.0     # clamp |mu|^N <= e^this (oracle parity)
    t2_min: float = 0.0          # keep lines with T2 > t2_min
    amp_min: float = 0.0         # keep lines with A >= amp_min
    gram_rcond: float = 1e-7     # pseudo-inverse cutoff in the Gram solve
    rhs_chunk: int = 128         # time-axis chunk for the V^H c scan
    mxu_precision: str = "highest"  # precision of the sweep's f32
                                 # matmul stages (applies + gram/mix
                                 # einsums): "highest" = true f32, "high" =
                                 # the backend's faster reduced-precision
                                 # passes.  _poles_to_lines and refinement
                                 # always run HIGHEST.
    seed: int = 0                # subspace sketch seed


def _poles_to_lines(mu: CArr, keep, c: CArr, dwell: float, n: int,
                    cfg: KbdmConfig) -> LineList:
    """Shared tail of every KBDM variant: poles -> (A, T2, f, phase) list.

    mu   : (..., p) complex poles (masked slots are ~0)
    keep : (..., p) bool validity from rank truncation
    c    : (..., n) signal (for the amplitude RHS)
    """
    dt = np.float32(dwell)
    mu_abs = cabs(mu)
    valid = keep & (mu_abs > 1e-12)

    # clamp |mu| so |mu|^n never overflows (oracle reference.kbdm does the
    # same; clamped poles keep T2 < 0 and are filtered)
    mu_max = np.float32(np.exp(cfg.mu_log_max / n))
    scale = jnp.where(mu_abs > mu_max, mu_max / jnp.maximum(mu_abs, 1e-30), 1.0)
    mu = CArr(mu.re * scale, mu.im * scale)
    mu_abs = jnp.minimum(mu_abs, mu_max)

    freq = cangle(mu) / np.float32(2.0 * np.pi) / dt
    log_abs = jnp.log(jnp.maximum(mu_abs, 1e-30))
    t2 = -dt / jnp.where(jnp.abs(log_abs) > 1e-12, log_abs, -1e-12)

    # The amplitude solve EXCLUDES growing poles (|mu|^n > e): their
    # geometric Gram entries reach e^(2*mu_log_max) ~ 1e26, and with the
    # shared f32 Gram + rcond truncation they swamp the genuine poles'
    # directions — measured: a noisy signal returned amplitude 0 for EVERY
    # line.  Excluded-but-otherwise-valid poles keep their (f, T2 < 0) and
    # get amplitude 0, so a user running with t2_min < 0 still sees them
    # (the f64 oracle's lstsq solves for their amplitude too; it can afford
    # to).  With the default t2_min = 0 they are filtered out either way.
    amp_valid = valid & (mu_abs <= np.float32(np.exp(1.0 / n)))

    # --- Vandermonde least squares ------------------------------------
    # Gram: G[j,l] = sum_n (conj(mu_j) mu_l)^n = (1 - z^N) / (1 - z)
    z = cmul(conj(CArr(mu.re[..., :, None], mu.im[..., :, None])),
             CArr(mu.re[..., None, :], mu.im[..., None, :]))  # (..., p, p)
    zsafe = cwhere(amp_valid[..., :, None] & amp_valid[..., None, :], z,
                   CArr(jnp.zeros_like(z.re), jnp.zeros_like(z.re)))
    # z^N by binary squaring (static N): ~2 log2(N) multiplies/element vs
    # 5 transcendentals per element for the exp(N log z) form
    zn = cpow_fixed(cwhere(cabs(zsafe) > 1e-30, zsafe,
                           CArr(jnp.ones_like(z.re), jnp.zeros_like(z.re))),
                    n)
    zn = cwhere(cabs(zsafe) > 1e-30, zn,
                CArr(jnp.zeros_like(z.re), jnp.zeros_like(z.re)))
    one = CArr(jnp.ones_like(z.re), jnp.zeros_like(z.re))
    num = CArr(one.re - zn.re, -zn.im)
    den = CArr(one.re - zsafe.re, -zsafe.im)
    near1 = cabs(den) < 1e-6
    den_safe = cwhere(near1, one, den)
    g_ratio = cmul(num, CArr(den_safe.re, -den_safe.im))
    g_ratio = CArr(g_ratio.re / (den_safe.re**2 + den_safe.im**2),
                   g_ratio.im / (den_safe.re**2 + den_safe.im**2))
    g_n = CArr(jnp.full_like(z.re, np.float32(n)), jnp.zeros_like(z.re))
    g = cwhere(near1, g_n, g_ratio)
    # masked slots: identity row/col so the solve stays well-posed
    pair_valid = amp_valid[..., :, None] & amp_valid[..., None, :]
    eye = jnp.eye(mu.re.shape[-1], dtype=mu.re.dtype)
    g = cwhere(pair_valid, g, CArr(jnp.broadcast_to(eye, g.re.shape),
                                   jnp.zeros_like(g.re)))

    # RHS: b_j = sum_n conj(mu_j)^n c_n, FACTORED over time chunks:
    #   mu^(i*chunk + k) = step^i * base_k  with  step = mu^chunk,
    # so  b_j = sum_i conj(step^i)_j * (sum_k conj(base_jk) c_{i,k}).
    # Both contractions are single parallel einsums — the former lax.scan
    # ran n_chunks SEQUENTIAL dependency-chained steps for the identical
    # flops (carries now come from cpowers in closed form).
    chunk = cfg.rhs_chunk
    n_chunks = (n + chunk - 1) // chunk
    n_pad = n_chunks * chunk
    c_pad = CArr(jnp.concatenate(
        [c.re, jnp.zeros((*c.re.shape[:-1], n_pad - n), c.re.dtype)], -1),
        jnp.concatenate(
        [c.im, jnp.zeros((*c.im.shape[:-1], n_pad - n), c.im.dtype)], -1))
    # base: (..., p, chunk) = mu^k for k in [0, chunk) via the binary
    # power decomposition (no transcendentals); masked slots use mu=1 so
    # every power stays finite (their contribution is zeroed below).
    mu_for_pow = CArr(jnp.where(amp_valid, mu.re, 1.0),
                      jnp.where(amp_valid, mu.im, 0.0))
    base = cpowers(mu_for_pow, chunk)
    step = cpow_fixed(mu_for_pow, chunk)              # (..., p): mu^chunk

    c_resh = CArr(c_pad.re.reshape(*c_pad.re.shape[:-1], n_chunks, chunk),
                  c_pad.im.reshape(*c_pad.im.shape[:-1], n_chunks, chunk))
    # t_ji = sum_k conj(base[j, k]) c[i, k]   -> (..., p, n_chunks)
    tr = _es('...pk,...ik->...pi', base.re, c_resh.re) + \
         _es('...pk,...ik->...pi', base.im, c_resh.im)
    ti = _es('...pk,...ik->...pi', base.re, c_resh.im) - \
         _es('...pk,...ik->...pi', base.im, c_resh.re)
    carr = cpowers(step, n_chunks)                    # (..., p, n_chunks)
    # b_j = sum_i conj(carr[j, i]) t[j, i]
    br = jnp.sum(carr.re * tr + carr.im * ti, axis=-1)
    bi = jnp.sum(carr.re * ti - carr.im * tr, axis=-1)
    b = CArr(br * jnp.where(amp_valid, 1.0, 0.0),
             bi * jnp.where(amp_valid, 1.0, 0.0))

    d = hermitian_solve(g, b, rcond=cfg.gram_rcond)
    amp = cabs(d)
    phase = cangle(d)

    final = valid & (t2 > cfg.t2_min) & (amp >= cfg.amp_min)
    t2 = jnp.where(final, t2, 1.0)
    return LineList(
        amplitude=jnp.where(final, amp, 0.0),
        t2=t2,
        frequency=jnp.where(final, freq, 0.0),
        phase=jnp.where(final, phase, 0.0),
        mask=final.astype(mu.re.dtype),
    )


def kbdm_sweep(c: CArr, dwell: float, m_values: Sequence[int],
               cfg: KbdmConfig, with_diag: bool = False,
               _stop: str | None = None):
    """Batched multi-m KBDM: c (..., N) -> LineList (..., S, p).

    One batched launch for the whole sweep: the m_max Hankel operator is
    materialized once; each sweep entry applies row/col masks selecting its
    leading m x m block.

    with_diag=True additionally returns a diagnostics dict with
    ``eig_offdiag_rel`` (..., S): the final Jacobi off-diagonal Frobenius
    norm of each PRODUCTION reduced matrix, relative to its own Frobenius
    norm — the convergence counter surfaced by bench.py (SURVEY.md §5
    metrics row), measured on real pipeline matrices rather than random
    dense inputs.

    _stop: PROFILING HOOK (tools/ablate_sweep.py) — return the named
    intermediate ("hankel" | "basis" | "m_small" | "takagi" | "reduced" |
    "eig") instead of the line list, so jitted prefixes of the REAL
    computation can be timed without maintaining a drifting mirror.
    """
    m_values = tuple(int(m) for m in m_values)
    m_max = max(m_values)
    n = c.re.shape[-1]
    if n < 2 * m_max:
        raise ValueError(f"need N >= 2*m_max: N={n}, m_max={m_max}")
    p, k = cfg.p, cfg.p + cfg.oversample
    ns = len(m_values)

    prec = (jax.lax.Precision.HIGHEST if cfg.mxu_precision == "highest"
            else jax.lax.Precision.HIGH)
    _esp = functools.partial(jnp.einsum, precision=prec)
    mmp = functools.partial(jnp.matmul, precision=prec,
                            preferred_element_type=jnp.float32)

    h0 = hankel_matrices(c, m_max)            # (..., m_max, m_max)
    # U1 is never materialized: the reduced-matrix step derives U1 applies
    # from U0 ones via the Hankel shift structure (see below) — halves the
    # operator's device-memory residency and removes the second gather.
    if _stop == "hankel":
        return h0
    masks = np.zeros((len(m_values), m_max), np.float32)
    for s, m in enumerate(m_values):
        masks[s, :m] = 1.0

    omega = jax.random.normal(jax.random.PRNGKey(cfg.seed), (m_max, k),
                              dtype=c.re.dtype)

    # LAYOUT: sweep blocks live at (..., m_max, S, k) — S and k are
    # adjacent trailing axes, NOT a leading broadcast axis.  Two reasons:
    # * every Hankel apply reshapes to (..., m_max, S*k) and runs as ONE
    #   matmul per voxel, so h is read from device memory once — an
    #   (S, ..., m, k) layout would broadcast h over S and re-read it S
    #   times per apply;
    # * the (..., S) batch reaches the eigensolver kernel flattened, so it
    #   is traced and compiled exactly once (a vmap over S would compile
    #   one kernel per sweep entry).
    mk = jnp.asarray(masks.T)[:, :, None]     # (m_max, S, 1)

    def apply_op(h, x):
        """(..., m, m) Hankel apply to x (..., m, S, j) -> (..., m, S, j).

        x may omit the batch dims (e.g. the (m, S, k) sketch)."""
        xm = CArr(x.re * mk, x.im * mk)
        j = xm.re.shape[-1]
        flat = CArr(xm.re.reshape(*xm.re.shape[:-2], ns * j),
                    xm.im.reshape(*xm.im.shape[:-2], ns * j))
        # (..., m, m) @ (..., m, S*j) at cfg.mxu_precision
        y = CArr(mmp(h.re, flat.re) - mmp(h.im, flat.im),
                 mmp(h.re, flat.im) + mmp(h.im, flat.re))
        y = CArr(y.re.reshape(*y.re.shape[:-1], ns, j),
                 y.im.reshape(*y.im.shape[:-1], ns, j))
        return CArr(y.re * mk, y.im * mk)

    # complex einsums over the (..., m, S, j) layout (cfg.mxu_precision)
    def gram_sk(a: CArr, b: CArr) -> CArr:
        """a^H b contracting m: (..., m, S, j1), (..., m, S, j2) ->
        (..., S, j1, j2)."""
        re = _esp('...msk,...msl->...skl', a.re, b.re) + \
             _esp('...msk,...msl->...skl', a.im, b.im)
        im = _esp('...msk,...msl->...skl', a.re, b.im) - \
             _esp('...msk,...msl->...skl', a.im, b.re)
        return CArr(re, im)

    def mix_sk(a: CArr, w: CArr) -> CArr:
        """a @ w per sweep entry: (..., m, S, j1) @ (..., S, j1, j2) ->
        (..., m, S, j2)."""
        re = _esp('...msk,...skl->...msl', a.re, w.re) - \
             _esp('...msk,...skl->...msl', a.im, w.im)
        im = _esp('...msk,...skl->...msl', a.re, w.im) + \
             _esp('...msk,...skl->...msl', a.im, w.re)
        return CArr(re, im)

    def orth_sk(y: CArr, passes: int) -> CArr:
        """Orthonormalize the k columns of every (m, S)-block by shifted
        CholeskyQR: one pass per intermediate subspace iteration (the
        basis only needs a bounded condition number there — Rayleigh-Ritz
        re-truncates), cfg.final_orth_passes for the final basis."""
        q = y
        for _ in range(passes):
            g = gram_sk(q, q)
            shift = 3e-6 * jnp.mean(
                jnp.abs(jnp.diagonal(g.re, axis1=-2, axis2=-1)), axis=-1)
            q = mix_sk(q, cholqr_rinv(g, shift))
        return q

    x0 = CArr(omega[:, None, :] * mk, jnp.zeros((m_max, ns, k), c.re.dtype))
    y = apply_op(h0, x0)                      # (..., m, S, k)
    for _ in range(cfg.subspace_iters):
        q = orth_sk(y, passes=1)
        y = apply_op(h0, conj(q))
    if _stop == "powiter":
        return y
    q = orth_sk(y, passes=cfg.final_orth_passes)
    if _stop == "basis":
        return q

    # Rayleigh-Ritz Takagi on the k x k projected Hankel
    t0 = apply_op(h0, conj(q))                       # (..., m, S, k)
    m_small = gram_sk(q, t0)                         # (..., S, k, k)
    m_small = CArr(0.5 * (m_small.re + jnp.swapaxes(m_small.re, -1, -2)),
                   0.5 * (m_small.im + jnp.swapaxes(m_small.im, -1, -2)))
    if _stop == "m_small":
        return m_small
    w, sig = takagi_small(m_small)
    if _stop == "takagi":
        return w, sig
    w_p = CArr(w.re[..., :p], w.im[..., :p])
    u_p = mix_sk(q, w_p)                                  # (..., m, S, p)
    sig_p = sig[..., :p]                                  # (..., S, p)
    keep_s = sig_p > sig[..., :1] * cfg.rank_tol
    s_isq = jnp.where(keep_s, jax.lax.rsqrt(jnp.maximum(sig_p, 1e-30)), 0.0)

    # reduced matrix  U~ = S^-1/2 U_p^H U1 conj(U_p) S^-1/2.
    # U1 conj(u_p) WITHOUT materializing or applying U1: the Hankel
    # shift structure gives, per sweep entry s with order m_s,
    #   (U1^(s) x)_i = (U0^(s) x)_{i+1}              for i <= m_s - 2
    #   (U1^(s) x)_{m_s-1} = sum_{j<m_s} c[m_s+j] x_j  (one new row)
    # and U0 conj(u_p) = U0 conj(q w_p) = t0 conj(w_p) — t0 already
    # exists from the Rayleigh-Ritz step.  This replaces the 8 m^2 S p V
    # dense apply (plus the (V, m, m) U1 gather and its residency)
    # with an 8 m S k p V mix (k/m ~ 10x fewer flops), a row shift, and a
    # rank-1 correction row.  Algebraically exact; f32 rounding differs
    # from the dense apply only in summation order (gates re-proven).
    t0w = mix_sk(t0, conj(w_p))                           # = U0 conj(u_p)
    zrow = jnp.zeros((*t0w.re.shape[:-3], 1, *t0w.re.shape[-2:]),
                     t0w.re.dtype)
    t = CArr(jnp.concatenate([t0w.re[..., 1:, :, :], zrow], axis=-3),
             jnp.concatenate([t0w.im[..., 1:, :, :], zrow], axis=-3))
    # correction rows: cshift[j, s] = c[m_s + j] (masked j < m_s)
    idx_np = np.empty((m_max, ns), np.int64)
    for s_i, m_s in enumerate(m_values):
        idx_np[:, s_i] = np.minimum(m_s + np.arange(m_max), n - 1)
    idxc = jnp.asarray(idx_np)
    cshift = CArr(c.re[..., idxc] * mk[..., 0], c.im[..., idxc] * mk[..., 0])
    up_c = conj(u_p)
    corr_re = _esp('...ms,...msp->...sp', cshift.re, up_c.re) - \
        _esp('...ms,...msp->...sp', cshift.im, up_c.im)
    corr_im = _esp('...ms,...msp->...sp', cshift.re, up_c.im) + \
        _esp('...ms,...msp->...sp', cshift.im, up_c.re)
    row_sel = np.zeros((m_max, ns, 1), np.float32)
    for s_i, m_s in enumerate(m_values):
        row_sel[m_s - 1, s_i, 0] = 1.0
    rs = jnp.asarray(row_sel)
    t = CArr(t.re * mk + rs * corr_re[..., None, :, :],
             t.im * mk + rs * corr_im[..., None, :, :])
    ut = gram_sk(u_p, t)                                  # (..., S, p, p)
    ut = CArr(ut.re * s_isq[..., :, None] * s_isq[..., None, :],
              ut.im * s_isq[..., :, None] * s_isq[..., None, :])
    ut = CArr(0.5 * (ut.re + jnp.swapaxes(ut.re, -1, -2)),
              0.5 * (ut.im + jnp.swapaxes(ut.im, -1, -2)))
    if _stop == "reduced":
        return ut
    if with_diag:
        mu_s, eig_resid = jacobi.eig_cs_resid(ut, sweeps=cfg.eig_sweeps)
        fro = jnp.sqrt(jnp.sum(ut.re * ut.re + ut.im * ut.im, axis=(-1, -2)))
        offdiag_rel = eig_resid / jnp.maximum(fro, 1e-30)   # (..., S)
    else:
        mu_s = jacobi.eig_cs(ut, sweeps=cfg.eig_sweeps)     # (..., S, p)
    if _stop == "eig":
        return mu_s

    c_b = CArr(c.re[..., None, :], c.im[..., None, :])  # broadcast over S
    lines = _poles_to_lines(mu_s, keep_s, c_b, dwell, n, cfg)
    if with_diag:
        return lines, {"eig_offdiag_rel": offdiag_rel}
    return lines


def kbdm_fit(c: CArr, dwell: float, m: int, cfg: KbdmConfig) -> LineList:
    """Single-m KBDM fit: c (..., N) -> LineList (..., p).

    Oracle counterpart: oracle.reference.kbdm(data, dwell, m, p).
    """
    lines = kbdm_sweep(c, dwell, (m,), cfg)
    return LineList(*(x[..., 0, :] for x in lines))
