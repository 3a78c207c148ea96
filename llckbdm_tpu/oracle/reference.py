"""CPU float64 oracle for the KBDM / LL-KBDM pipeline.

This module is the ground-truth specification of the algorithms the device
framework implements.  It is written *from the mathematical spec* (SURVEY.md
§3.1-3.2; Mandelshtam's Filter Diagonalization Method family), not ported from
the reference repo (whose mount is empty — SURVEY.md §0).  Everything runs in
float64/complex128 on CPU with scipy/sklearn, and every device kernel is tested
against it (accuracy gate: 1e-8 relative on pole parameters, BASELINE.json:5).

Line-list convention (used across the whole framework, SURVEY.md §2):
    a line = (A, T2, f, phase)
    signal model  c[n] = sum_k A_k * exp(i*phase_k)
                         * exp((i*2*pi*f_k - 1/T2_k) * n * dwell),  n = 0..N-1
    pole          mu_k  = exp((i*2*pi*f_k - 1/T2_k) * dwell)
    inverse map   f_k   = angle(mu_k) / (2*pi*dwell)
                  T2_k  = -dwell / log|mu_k|
"""
from __future__ import annotations

import numpy as np
import scipy.linalg


# ---------------------------------------------------------------------------
# Signal synthesis (SURVEY.md §3.3)
# ---------------------------------------------------------------------------

def sample_signal(params: np.ndarray, n: int, dwell: float) -> np.ndarray:
    """Sample a time-domain signal from a line list.

    params : (k, 4) array of (A, T2, f, phase) rows.
    Returns complex128 array of length ``n``.
    """
    params = np.asarray(params, dtype=np.float64)
    a, t2, f, ph = params[:, 0], params[:, 1], params[:, 2], params[:, 3]
    t = np.arange(n, dtype=np.float64) * dwell
    # (k, n) matrix of per-line contributions
    z = (2j * np.pi * f[:, None] - 1.0 / t2[:, None]) * t[None, :]
    return np.sum(a[:, None] * np.exp(1j * ph[:, None]) * np.exp(z), axis=0)


# ---------------------------------------------------------------------------
# KBDM single fit (SURVEY.md §3.1)
# ---------------------------------------------------------------------------

def kbdm(
    data: np.ndarray,
    dwell: float,
    m: int | None = None,
    p: int | None = None,
    *,
    filter_t2_min: float = 0.0,
    amp_min: float = 0.0,
    return_all: bool = False,
):
    """Single Krylov Basis Diagonalization Method fit.

    Pipeline: Hankel U0/U1 -> truncated SVD of U0 -> reduced p x p
    eigenproblem -> poles -> Vandermonde least-squares amplitudes.

    data  : complex time-domain signal, length N >= 2*m.
    dwell : sample spacing (seconds).
    m     : Hankel size (default N // 2).
    p     : truncation rank (default m).

    Returns (lines, info) where lines is a (k, 4) float64 array of
    (A, T2, f, phase) rows sorted by frequency, filtered by
    T2 > filter_t2_min and A >= amp_min (unless return_all).
    """
    c = np.asarray(data, dtype=np.complex128)
    n = c.shape[0]
    if m is None:
        m = n // 2
    if n < 2 * m:
        raise ValueError(f"need len(data) >= 2*m, got N={n}, m={m}")
    if p is None:
        p = m
    p = min(p, m)

    # Hankel matrices U0[i, j] = c[i + j], U1[i, j] = c[i + j + 1]
    idx = np.arange(m)[:, None] + np.arange(m)[None, :]
    u0 = c[idx]
    u1 = c[idx + 1]

    # Truncated SVD of U0 = L S R^H (keep top-p triplets)
    ll, s, rh = scipy.linalg.svd(u0)
    lp = ll[:, :p]
    sp = s[:p]
    rp = rh[:p, :].conj().T

    # Reduced eigenproblem  U~ = S^-1/2 L^H U1 R S^-1/2  (p x p)
    s_isqrt = 1.0 / np.sqrt(sp)
    ut = (s_isqrt[:, None] * (lp.conj().T @ u1 @ rp)) * s_isqrt[None, :]
    mu, _ = scipy.linalg.eig(ut)

    # Poles -> physical parameters
    freq = np.angle(mu) / (2.0 * np.pi * dwell)
    with np.errstate(divide="ignore"):
        t2 = -dwell / np.log(np.abs(mu))  # |mu| > 1 -> negative T2 (growing)

    # Vandermonde least squares:  V[n, k] = mu_k^n ;  d = argmin ||V d - c||
    # Spurious poles (rank > true line count) can have |mu| >> 1, overflowing
    # mu^n.  Clamp |mu| <= exp(30/N) so |mu^n| <= e^30; clamped poles keep
    # T2 < 0 and are dropped by the T2 filter below.  (Spec decision shared
    # with the device path.)
    mu_mag = np.abs(mu)
    mu_max = np.exp(30.0 / n)
    mu_cl = np.where(mu_mag > mu_max, mu * (mu_max / mu_mag), mu)
    v = mu_cl[None, :] ** np.arange(n)[:, None]
    d, *_ = scipy.linalg.lstsq(v, c, lapack_driver="gelsd")
    amp = np.abs(d)
    phase = np.angle(d)

    lines = np.stack([amp, t2, freq, phase], axis=1)
    if not return_all:
        keep = (t2 > filter_t2_min) & (amp >= amp_min) & np.isfinite(t2)
        lines = lines[keep]
    lines = lines[np.argsort(lines[:, 2])]
    info = {"singular_values": s, "poles": mu, "m": m, "p": p}
    return lines, info


# ---------------------------------------------------------------------------
# LL-KBDM: multi-m sweep + density clustering (SURVEY.md §3.2)
# ---------------------------------------------------------------------------

def transform_line_lists(
    lines: np.ndarray,
    dwell: float,
    *,
    damping_weight: float = 0.0,
) -> np.ndarray:
    """Map pooled lines into the clustering feature space.

    Features (spec'd here; device path must match exactly):
      x0 = f * dwell                      (frequency as fraction of sampling rate)
      x1 = damping_weight * dwell / T2    (per-sample damping, optional)
    Stable genuine lines recur at the same (f, T2) across the m sweep and form
    dense clusters; noise/artifact lines scatter.  Amplitude is deliberately
    NOT a feature: over-specified rank splits amplitude between near-duplicate
    poles run-to-run, which would fragment genuine clusters.
    """
    f = lines[:, 2]
    t2 = lines[:, 1]
    x0 = f * dwell
    x1 = damping_weight * dwell / np.maximum(t2, 1e-9)
    return np.stack([x0, x1], axis=1)


def llc_kbdm(
    data: np.ndarray,
    dwell: float,
    m_range,
    p: int,
    eps: float = 2e-4,
    min_samples: int = 20,
    *,
    filter_t2_min: float = 0.0,
    amp_min: float = 0.0,
    damping_weight: float = 0.0,
):
    """Line-List KBDM: m sweep -> pool -> feature transform -> DBSCAN ->
    per-cluster consolidation.

    Consolidation (spec'd here; device path must match): per-cluster
    component-wise MEDIANS — A = median(A), T2 = median(T2), f = median(f),
    phase = angle(median(Re d) + i*median(Im d)) where d = A*exp(i*phase).
    Medians are robust to the amplitude splitting that over-specified rank
    causes in individual KBDM runs.

    Returns (consolidated, pooled, labels):
      consolidated : (n_clusters, 4) (A, T2, f, phase), sorted by frequency.
      pooled       : (n_pool, 4) all pooled lines from the sweep.
      labels       : DBSCAN labels for pooled lines (-1 = noise).
    """
    from sklearn.cluster import DBSCAN

    pools = []
    for m in m_range:
        lines, _ = kbdm(
            data, dwell, m=int(m), p=p,
            filter_t2_min=filter_t2_min, amp_min=amp_min,
        )
        pools.append(lines)
    pooled = np.concatenate(pools, axis=0) if pools else np.zeros((0, 4))
    if len(pooled) == 0:
        return np.zeros((0, 4)), pooled, np.zeros((0,), dtype=int)

    feats = transform_line_lists(pooled, dwell, damping_weight=damping_weight)
    labels = DBSCAN(eps=eps, min_samples=min_samples).fit(feats).labels_

    out = []
    for lab in sorted(set(labels) - {-1}):
        grp = pooled[labels == lab]
        d = grp[:, 0] * np.exp(1j * grp[:, 3])
        out.append([
            np.median(grp[:, 0]),
            np.median(grp[:, 1]),
            np.median(grp[:, 2]),
            np.arctan2(np.median(d.imag), np.median(d.real)),
        ])
    consolidated = np.asarray(out, dtype=np.float64).reshape(-1, 4)
    consolidated = consolidated[np.argsort(consolidated[:, 2])]
    return consolidated, pooled, labels


def refine(lines: np.ndarray, data: np.ndarray, dwell: float,
           iters: int = 10, ridge: float = 1e-12,
           max_step: float = 0.1) -> np.ndarray:
    """Float64 Gauss-Newton polish of a line list against the data.

    The oracle counterpart of solver.refine.refine_lines: joint GN on
    (poles z_k, complex amplitudes d_k) of the separable model
    c_n ~= sum_k d_k z_k^n, full normal-equation solve with a tiny relative
    Tikhonov ridge (NO eigenvalue truncation — see solver/refine.py) and a
    per-pole step clip.  For noisy data the device refinement and this
    function converge to the SAME least-squares fixed point, which is what
    the 1e-8 device-vs-oracle gate compares under noise (the plain kbdm()
    linear-algebra estimate is not the LS estimator once noise is present).

    lines : (k, 4) rows of (A, T2, f, phase);  data : (N,) complex.
    Returns the refined (k, 4) list sorted by frequency.
    """
    lines = np.asarray(lines, np.float64)
    n = len(data)
    ns = np.arange(n)
    z = np.exp((2j * np.pi * lines[:, 2] - 1.0 / lines[:, 1]) * dwell)
    d = lines[:, 0] * np.exp(1j * lines[:, 3])
    c = len(z)
    for _ in range(iters):
        p = np.power(z[None, :], ns[:, None])            # (N, k)
        r = data - p @ d
        dj = d[None, :] * ns[:, None] * np.power(
            z[None, :], np.maximum(ns[:, None] - 1, 0))
        j = np.concatenate([p, dj], axis=1)
        g = j.conj().T @ j
        rhs = j.conj().T @ r
        shift = ridge * np.trace(g).real / g.shape[0]
        delta = np.linalg.solve(g + shift * np.eye(g.shape[0]), rhs)
        d = d + delta[:c]
        step = delta[c:]
        sn = np.abs(step)
        z = z + np.where(sn > max_step,
                         max_step * step / np.maximum(sn, 1e-300), step)
    with np.errstate(divide="ignore"):
        t2 = -dwell / np.log(np.abs(z))
    out = np.stack([np.abs(d), t2,
                    np.angle(z) / (2.0 * np.pi * dwell), np.angle(d)], axis=1)
    return out[np.argsort(out[:, 2])]


def line_errors(est: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Mixed accuracy metric between matched line lists (rows of A, T2, f, phase).

    A, T2, f are ratio-scale quantities -> RELATIVE error.  Phase is an
    ANGLE: a pure relative metric blows up when the reference phase is ~0
    (e.g. a line synthesized with phase exactly 0.0 recovered as 1e-12 gives
    relative error 1 against denominator 1e-12), so phase error is the
    wrapped absolute difference mod 2*pi — phases are O(1) radians, making
    wrapped-absolute the same scale as relative for nonzero phases.

    Returns an (k, 4) array of per-entry errors; ``line_errors(...).max()``
    is the quantity the 1e-8 oracle gate (BASELINE.json:5) is asserted on.
    """
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    rel = np.abs(est[:, :3] - ref[:, :3]) / np.abs(ref[:, :3])
    dphi = np.abs(est[:, 3] - ref[:, 3]) % (2.0 * np.pi)
    dphi = np.minimum(dphi, 2.0 * np.pi - dphi)
    return np.concatenate([rel, dphi[:, None]], axis=1)


def match_lines(est: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """Optimal (Hungarian) frequency matching of estimated lines to truth.

    Returns an index array ``sel`` such that est[sel[k]] corresponds to
    truth[k].  Used by tests to compare matched lines only (SURVEY.md §7
    'hard parts' #3: matching must be assignment-optimal, not raw
    eigen-order — greedy nearest-frequency can mis-pair dense or noisy
    spectra where two truth lines share the same nearest estimate).

    Cost: |f_est - f_truth| with a small relative T2-distance tie-breaker
    (distinguishes co-resonant lines of different widths).  Falls back to
    greedy if scipy is unavailable.

    Raises ValueError when fewer lines were estimated than truth rows:
    the assignment would leave sel entries at -1, and callers index
    est[sel] — a -1 would silently select the LAST estimated line and
    compare a wrong pair instead of failing loudly.
    """
    if len(est) < len(truth):
        raise ValueError(
            f"match_lines: {len(est)} estimated lines < {len(truth)} truth "
            f"lines — the estimate is missing lines; cannot match")
    df = np.abs(est[None, :, 2] - truth[:, None, 2])        # (T, E)
    dt2 = np.abs(est[None, :, 1] - truth[:, None, 1]) \
        / np.maximum(np.abs(truth[:, None, 1]), 1e-30)
    cost = df + 1e-3 * np.median(df) * dt2 if len(est) else df
    try:
        from scipy.optimize import linear_sum_assignment
        rows, cols = linear_sum_assignment(cost)
        sel = np.full(len(truth), -1, dtype=int)
        sel[rows] = cols
        return sel
    except ImportError:                       # pragma: no cover
        sel = np.full(len(truth), -1, dtype=int)
        used = np.zeros(len(est), dtype=bool)
        for k in np.argsort(-truth[:, 0]):
            dist = cost[k].copy()
            dist[used] = np.inf
            j = int(np.argmin(dist))
            sel[k] = j
            used[j] = True
        return sel
