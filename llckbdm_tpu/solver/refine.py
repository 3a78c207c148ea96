"""Double-float Gauss-Newton (VARPRO-style) pole refinement.

The f32 KBDM pipeline delivers poles to ~1e-4 relative; the accuracy gate is
1e-8 (BASELINE.json:5) on hardware with no float64.  Rather than emulate an
f64 SVD/eigensolve, this stage attacks the *actual* estimation problem: the
separable nonlinear least squares

    min_{z, d}  sum_n | c_n - sum_k d_k z_k^n |^2

with Gauss-Newton, storing the parameters (poles z_k, complex amplitudes
d_k) as double-float pairs and evaluating the residual in double-float
arithmetic (utils.df).  The normal matrix and the linear solve run in plain
f32 (mixed-precision iterative refinement: the correction direction only
needs f32 accuracy; the residual evaluation is what must not cancel).  With
2-4 iterations the genuine poles converge quadratically to the double-float
noise floor (~1e-13), matching the scipy float64 oracle far below 1e-8.

Precision structure of one Gauss-Newton step (what must be df, what not):

* residual  r = c - model   — df, genuinely cancelling O(1) quantities;
* powers    z^n             — df, relative error compounds over n;
* normal matrix G = J^H J   — f32 einsums: only steers the step;
* rhs J^H r                 — TWO f32 einsums, J^H r_hi + J^H r_lo: once r
  is exact in df, the dot has no catastrophic cancellation — its f32
  rounding (~n*eps relative to the term magnitudes) perturbs the GN fixed
  point by O(eps * |r|), far below the df noise floor.

The einsum formulation is also what makes the step compile and run sanely:
einsum/dot is a hard XLA fusion boundary, whereas feeding the deep df
elementwise chains straight into sliced/fused reductions was measured to
make XLA:CPU re-evaluate the producer chain per output element (a 64-point
toy step ran 75 s; the same math as einsums runs in milliseconds).

For a noiseless signal whose line count equals the number of refined lines,
the GN fixed point IS the exact interpolating solution — identical (to f64
rounding) to what the oracle's KBDM chain produces, which is how the 1e-8
oracle-match gate is met on f32-only hardware.

Host-side conversion (``refined_to_np``) turns df poles into (A, T2, f,
phase) in float64 — atan2/log at double precision on C scalars per voxel is
host work by design (the device has no f64 and trig to 1e-14 would need
table-based double-float argument reduction for no throughput benefit).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.cplx import CArr
from ..ops.linalg import hermitian_solve
from ..signals import LineList
from ..utils import df as D
from ..utils.df import DF, DFC


class RefinedLines(NamedTuple):
    """Refined poles/amplitudes in double-float, plus f32 LineList view."""

    z: DFC          # (..., C) poles
    d: DFC          # (..., C) complex amplitudes
    mask: jax.Array  # (..., C)
    lines: LineList  # f32 view (device-side convenience)
    gn_step: jax.Array  # (..., C) |delta z| of the LAST GN iteration
                        # (convergence counter, SURVEY.md §5 metrics row)


@dataclass(frozen=True)
class RefineConfig:
    iters: int = 3
    f32_iters: int = 0           # cheap plain-f32 GN iterations run BEFORE
                                 # the `iters` double-float ones: the early
                                 # steps only need a descent direction (the
                                 # df residual evaluation is what costs),
                                 # and GN re-converges to the same fixed
                                 # point from anywhere in the basin.
                                 # Ignored in time-sharded mode.
    ridge: float = 1e-12         # relative Tikhonov in the GN solve
    max_step: float = 0.1        # clip on |delta z| per iteration


def _dfc_bcast(x: DFC, shape) -> DFC:
    return DFC(DF(jnp.broadcast_to(x.re.hi, shape),
                  jnp.broadcast_to(x.re.lo, shape)),
               DF(jnp.broadcast_to(x.im.hi, shape),
                  jnp.broadcast_to(x.im.lo, shape)))


def _c32_powers(zr: jax.Array, zi: jax.Array, n: int):
    """All powers z^0 .. z^(n-1) in PLAIN f32 along a new trailing axis
    (the cheap counterpart of df.dfc_powers for the f32 warm-start
    iterations; same binary decomposition, ~6x fewer flops/element)."""
    nbits = max(1, int(np.ceil(np.log2(max(n, 2)))))
    sq = [(zr, zi)]
    for _ in range(nbits - 1):
        ar, ai = sq[-1]
        sq.append((ar * ar - ai * ai, 2.0 * ar * ai))
    ks = np.arange(n)
    out_r = out_i = None
    for j in range(nbits):
        bit = jnp.asarray((ks >> j) & 1, jnp.float32)
        ar, ai = sq[j]
        fr = jnp.where(bit > 0, ar[..., None], jnp.float32(1.0))
        fi = bit * ai[..., None]
        if out_r is None:
            out_r, out_i = fr, fi
        else:
            out_r, out_i = (out_r * fr - out_i * fi,
                            out_r * fi + out_i * fr)
    return out_r, out_i


def refine_lines(c: DFC, lines: LineList, dwell: float,
                 cfg: RefineConfig = RefineConfig(), *,
                 axis_name: str | None = None,
                 t_offset=None) -> RefinedLines:
    """Polish a consolidated LineList against the double-float signal.

    c     : DFC (..., N) — the measured signal split into (hi, lo) f32 pairs
            (use utils.df.dfc_from_np on the float64 data)
    lines : LineList (..., C) — f32 initial values (masked slots ignored)

    Time-sharded mode (the amplitude-RHS collective exchange,
    BASELINE.json:5): when called inside shard_map with the signal's time
    axis split over mesh axis ``axis_name``, pass the local chunk's global
    start index as ``t_offset`` (e.g. ``chunk * lax.axis_index(axis_name)``).
    The normal-matrix and right-hand-side partial sums are then psum-reduced
    across the time shards; the rhs keeps its (hi, lo) double-float split
    through the reduction (each component psummed in f32 — the per-shard
    partials carry no catastrophic cancellation once the residual itself is
    double-float, so f32 partial-sum rounding is at the same level as the
    within-shard einsum rounding).
    """
    n = c.re.hi.shape[-1]
    dt = np.float32(dwell)
    mask = lines.mask > 0.5

    # initial z = exp((i 2 pi f - 1/T2) dt), d = A e^{i phase}  (f32 -> df)
    decay = jnp.exp(-dt / jnp.maximum(lines.t2, 1e-9))
    theta = 2.0 * jnp.pi * lines.frequency * dt
    z = D.dfc_from_f32(jnp.where(mask, decay * jnp.cos(theta), 0.0),
                       jnp.where(mask, decay * jnp.sin(theta), 0.0))
    d = D.dfc_from_f32(jnp.where(mask, lines.amplitude * jnp.cos(lines.phase), 0.0),
                       jnp.where(mask, lines.amplitude * jnp.sin(lines.phase), 0.0))

    if t_offset is None:
        ns = jnp.arange(n, dtype=jnp.float32)
    else:
        ns = (jnp.asarray(t_offset, jnp.int32)
              + jnp.arange(n, dtype=jnp.int32)).astype(jnp.float32)

    es0 = lambda *a: jnp.einsum(*a, precision=jax.lax.Precision.HIGHEST)

    def gn_step(state, exact=True):
        z, d = state
        if exact:
            # P[k, n] = z_k^n in df;  shapes (..., C, N)
            p = D.dfc_powers(z, n)
            if t_offset is not None:
                # shift the local block to global time: P <- z^t0 * P
                z0 = D.dfc_pow_traced(z, t_offset)
                p = D.dfc_mul(_dfc_bcast(
                    DFC(DF(z0.re.hi[..., None], z0.re.lo[..., None]),
                        DF(z0.im.hi[..., None], z0.im.lo[..., None])),
                    p.shape), p)
            # model_n = sum_k d_k P[k, n]  (df reduce over C)
            dkp = D.dfc_mul(_dfc_bcast(
                DFC(DF(d.re.hi[..., None], d.re.lo[..., None]),
                    DF(d.im.hi[..., None], d.im.lo[..., None])),
                p.shape), p)
            model = D.dfc_sum(dkp, axis=-2)                  # (..., N)
            r = D.dfc_sub(c, model)                          # df residual
            p32_re, p32_im = p.re.hi, p.im.hi
            r_hi = (r.re.hi, r.im.hi)
            r_lo = (r.re.lo, r.im.lo)
        else:
            # f32 warm-start iteration: plain-f32 powers, model, residual
            # (the step only needs a descent direction; the exact df
            # iterations after re-converge to the df fixed point)
            p32_re, p32_im = _c32_powers(z.re.hi, z.im.hi, n)
            mr = es0('...k,...kn->...n', d.re.hi, p32_re) - \
                es0('...k,...kn->...n', d.im.hi, p32_im)
            mi = es0('...k,...kn->...n', d.re.hi, p32_im) + \
                es0('...k,...kn->...n', d.im.hi, p32_re)
            r_hi = (c.re.hi - mr, c.im.hi - mi)
            r_lo = None

        # f32 views for the Jacobian blocks J = [P; D], each (..., C, N)
        d32_re, d32_im = d.re.hi, d.im.hi
        # D[k, n] = d_k * n * z_k^(n-1) = (d_k / z_k) * n * P[k, n]
        zabs2 = z.re.hi**2 + z.im.hi**2
        inv = jnp.where(mask, 1.0 / jnp.maximum(zabs2, 1e-20), 0.0)
        doz_re = (d32_re * z.re.hi + d32_im * z.im.hi) * inv
        doz_im = (d32_im * z.re.hi - d32_re * z.im.hi) * inv
        w_re = ns * p32_re                                   # n * P
        w_im = ns * p32_im
        dj_re = doz_re[..., None] * w_re - doz_im[..., None] * w_im
        dj_im = doz_re[..., None] * w_im + doz_im[..., None] * w_re

        # Normal matrix G = J^H J blockwise (f32 einsums).  No
        # concatenate BEFORE the dots: a concat-rooted fusion re-evaluates
        # the whole df producer chain per element on XLA:CPU (see module
        # docstring); the (2C, 2C) assembly happens on materialized blocks.
        es = lambda *a: jnp.einsum(*a, precision=jax.lax.Precision.HIGHEST)

        def block(a_re, a_im, b_re, b_im):
            # Sum_n conj(a[k, n]) b[l, n] -> (..., k, l)
            re = es('...kn,...ln->...kl', a_re, b_re) + \
                 es('...kn,...ln->...kl', a_im, b_im)
            im = es('...kn,...ln->...kl', a_re, b_im) - \
                 es('...kn,...ln->...kl', a_im, b_re)
            return re, im

        gvv_re, gvv_im = block(p32_re, p32_im, p32_re, p32_im)
        gvd_re, gvd_im = block(p32_re, p32_im, dj_re, dj_im)
        gdd_re, gdd_im = block(dj_re, dj_im, dj_re, dj_im)
        # G is Hermitian: the (d, v) block is the conjugate transpose
        gdv_re = jnp.swapaxes(gvd_re, -1, -2)
        gdv_im = -jnp.swapaxes(gvd_im, -1, -2)
        g_re = jnp.concatenate(
            [jnp.concatenate([gvv_re, gvd_re], axis=-1),
             jnp.concatenate([gdv_re, gdd_re], axis=-1)], axis=-2)
        g_im = jnp.concatenate(
            [jnp.concatenate([gvv_im, gvd_im], axis=-1),
             jnp.concatenate([gdv_im, gdd_im], axis=-1)], axis=-2)

        # rhs = J^H r as TWO f32 einsums per block: J^H r_hi + J^H r_lo.
        # r is exact in df, so the dot itself has no catastrophic
        # cancellation; keeping the (hi, lo) split through the (optional)
        # psum preserves the double-float information across shards.
        def rdot(j_r, j_i):
            def one(rr, ri):
                out_re = es('...kn,...n->...k', j_r, rr) + \
                         es('...kn,...n->...k', j_i, ri)
                out_im = es('...kn,...n->...k', j_r, ri) - \
                         es('...kn,...n->...k', j_i, rr)
                return out_re, out_im
            hi_re, hi_im = one(*r_hi)
            if r_lo is None:                 # f32 warm-start iteration
                zz = jnp.zeros_like(hi_re)
                return DF(hi_re, zz), DF(hi_im, zz)
            lo_re, lo_im = one(*r_lo)
            return DF(hi_re, lo_re), DF(hi_im, lo_im)
        rhsv_re, rhsv_im = rdot(p32_re, p32_im)
        rhsd_re, rhsd_im = rdot(dj_re, dj_im)
        rhs_re_df = DF(jnp.concatenate([rhsv_re.hi, rhsd_re.hi], axis=-1),
                       jnp.concatenate([rhsv_re.lo, rhsd_re.lo], axis=-1))
        rhs_im_df = DF(jnp.concatenate([rhsv_im.hi, rhsd_im.hi], axis=-1),
                       jnp.concatenate([rhsv_im.lo, rhsd_im.lo], axis=-1))

        if axis_name is not None:
            # Cross-shard exchange of the normal-equation partial sums
            # (BASELINE.json:5): one fused psum over G and the rhs (hi, lo)
            # components; XLA's latency-hiding scheduler overlaps it with
            # the independent per-voxel work that follows.
            (g_re, g_im, rhs_hi_re, rhs_lo_re, rhs_hi_im, rhs_lo_im) = \
                jax.lax.psum((g_re, g_im,
                              rhs_re_df.hi, rhs_re_df.lo,
                              rhs_im_df.hi, rhs_im_df.lo), axis_name)
            rhs_re_df = DF(rhs_hi_re, rhs_lo_re)
            rhs_im_df = DF(rhs_hi_im, rhs_lo_im)
        rhs = CArr(rhs_re_df.hi + rhs_re_df.lo, rhs_im_df.hi + rhs_im_df.lo)

        # masked slots: identity rows
        mask2 = jnp.concatenate([mask, mask], axis=-1)
        pair = mask2[..., :, None] & mask2[..., None, :]
        eye = jnp.eye(mask2.shape[-1], dtype=g_re.dtype)
        g = CArr(jnp.where(pair, g_re, jnp.broadcast_to(eye, g_re.shape)),
                 jnp.where(pair, g_im, 0.0))
        rhs = CArr(jnp.where(mask2, rhs.re, 0.0),
                   jnp.where(mask2, rhs.im, 0.0))

        # relative Tikhonov: cfg.ridge scaled by the mean diagonal magnitude.
        # NO eigenvalue truncation (rcond ~ 0): for close line pairs (the
        # brain config) the GN step NEEDS the small-eigenvalue directions of
        # G — truncating below 1e-7*lam_max was measured to stall the GN at
        # a wrong fixed point (err 0.76 vs truth), while the tiny-ridge full
        # solve converges to ~1e-12 even with an f32 G (max_step clips the
        # occasional garbage step along noise directions).
        tr = jnp.sum(jnp.abs(jnp.diagonal(g.re, axis1=-2, axis2=-1)),
                     axis=-1, keepdims=True)
        ridge = np.float32(cfg.ridge) * tr / mask2.shape[-1]
        delta = hermitian_solve(g, rhs, ridge=ridge, rcond=1e-14)

        cc = mask.shape[-1]
        dd_re, dd_im = delta.re[..., :cc], delta.im[..., :cc]
        dz_re, dz_im = delta.re[..., cc:], delta.im[..., cc:]
        # clip pole steps
        step = jnp.hypot(dz_re, dz_im)
        clip = jnp.where(step > cfg.max_step, cfg.max_step / jnp.maximum(step, 1e-30), 1.0)
        dz_re, dz_im = dz_re * clip, dz_im * clip

        z2 = DFC(D.df_add(z.re, D.df_from_f32(jnp.where(mask, dz_re, 0.0))),
                 D.df_add(z.im, D.df_from_f32(jnp.where(mask, dz_im, 0.0))))
        d2 = DFC(D.df_add(d.re, D.df_from_f32(jnp.where(mask, dd_re, 0.0))),
                 D.df_add(d.im, D.df_from_f32(jnp.where(mask, dd_im, 0.0))))
        return (z2, d2), jnp.where(mask, step, 0.0)

    # Unrolled GN loop: iters is small (1-4) and a lax.scan here was measured
    # to pessimize XLA catastrophically (~10^4 x runtime on CPU); straight-line
    # unrolling compiles and runs at the expected cost.
    state = (z, d)
    gn_step_norm = jnp.zeros_like(lines.amplitude)
    n_f32 = 0 if (axis_name is not None or t_offset is not None) \
        else cfg.f32_iters
    for _ in range(n_f32):
        state, gn_step_norm = gn_step(state, exact=False)
    for _ in range(cfg.iters):
        state, gn_step_norm = gn_step(state)
    z, d = state

    # f32 view
    zr, zi = z.re.hi + z.re.lo, z.im.hi + z.im.lo
    dr, di = d.re.hi + d.re.lo, d.im.hi + d.im.lo
    zabs = jnp.hypot(zr, zi)
    freq = jnp.arctan2(zi, zr) / (2.0 * np.float32(np.pi) * dt)
    t2 = -dt / jnp.log(jnp.maximum(jnp.where(mask, zabs, 0.5), 1e-30))
    view = LineList(
        amplitude=jnp.where(mask, jnp.hypot(dr, di), 0.0),
        t2=jnp.where(mask, t2, 1.0),
        frequency=jnp.where(mask, freq, 0.0),
        phase=jnp.where(mask, jnp.arctan2(di, dr), 0.0),
        mask=mask.astype(jnp.float32),
    )
    return RefinedLines(z=z, d=d, mask=mask.astype(jnp.float32), lines=view,
                        gn_step=gn_step_norm)


def refined_to_np(ref: RefinedLines, dwell: float) -> np.ndarray:
    """Host-side float64 conversion: df poles -> (A, T2, f, phase) rows.

    Returns (n_valid, 4) float64 sorted by frequency (single-voxel input) —
    the array compared against the scipy oracle in the 1e-8 gate tests.
    """
    z = D.dfc_to_np(ref.z)
    d = D.dfc_to_np(ref.d)
    mask = np.asarray(ref.mask) > 0.5
    z, d = z[mask], d[mask]
    freq = np.angle(z) / (2.0 * np.pi * dwell)
    with np.errstate(divide="ignore"):
        t2 = -dwell / np.log(np.abs(z))
    out = np.stack([np.abs(d), t2, freq, np.angle(d)], axis=1)
    return out[np.argsort(out[:, 2])]
