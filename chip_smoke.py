#!/usr/bin/env python3
"""Smoke run of the LL-KBDM fit and refinement on an NVIDIA GPU.

Drives the main path once through the entry points a user calls, at the
repository's bench deployment (2048 voxels, N=512, m=120..256:4 so S=35,
p=16), and checks the outputs by the repository's own means:

1. device      the default JAX device is a GPU;
2. kernels     the compiled Triton eigensolver on production reduced matrices
               (bench and brain widths) and on matrices of known spectrum,
               against the lax.scan reference and f64 scipy; cuSOLVER's eigh
               and Cholesky (Takagi, CholeskyQR, the Hermitian solve) against
               f64 scipy;
3. main path   llc_kbdm_fit + refine_lines jitted as in bench.py: the 1e-8
               float64-oracle gate on 16 voxels, the production Jacobi
               residual, memory, compile and wall time;
4. entry points llc_kbdm(refine_iters=6), config 2 (brain) kbdm_fit + refine
               against oracle.kbdm, GridRunner with refinement on a 32x32
               grid (config 4).

    python chip_smoke.py             # one card, phases 1-4
    python chip_smoke.py --cards 4   # the sharded grid path on four cards,
                                     # and its one-card comparison, only

The card's name and power limit (nvidia-smi, read before JAX starts) are
printed beside the numbers.  Any failed phase exits non-zero.  The last line
of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
DWELL = 5e-4
N = 512
M_VALUES = tuple(range(120, 257, 4))


def card() -> str:
    """`name, power.limit` of the first card, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    log(f"  ok: {what}")


def max_match_err(got, want) -> float:
    """Greedy nearest matching of two eigenvalue multisets."""
    want, err = list(want), 0.0
    for z in got:
        j = int(np.argmin(np.abs(np.array(want) - z)))
        err = max(err, abs(want[j] - z))
        want.pop(j)
    return err


def wall(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_device(cards: int):
    import jax
    devs = jax.devices()
    log(f"[1 device] platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default platform is "
                         f"{devs[0].platform}")
    check(len(devs) >= cards, f"{len(devs)} >= {cards} cards visible")
    return devs


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def tf32(x):
    """A CArr with re and im rounded to TF32's 10-bit mantissa: the operands
    a default-precision f32 matmul on the card would multiply."""
    from jax import lax
    from llckbdm_tpu.ops.cplx import CArr
    return CArr(*(lax.reduce_precision(p, exponent_bits=8, mantissa_bits=10)
                  for p in x))


def _compare_eig(tag, ut, sweeps, n_sub, rel_tol, exact=None,
                 min_converged=1.0):
    """Kernel vs scan and vs f64 scipy (or the exact spectrum) on a subset
    of the matrices both converged on; errors relative to each matrix's
    Frobenius norm.  Converged: final off-diagonal < 1e-2 |A|_F.

    The kernel has no matrix product, so TF32 cannot enter it.  Its f32
    error (non-unitary rotations) is as large as that of operands rounded
    to TF32, which is printed but not held to the limit."""
    import jax
    import scipy.linalg
    from llckbdm_tpu.ops import jacobi
    from llckbdm_tpu.ops.cplx import to_np
    from llckbdm_tpu.platform import force_platform

    def scan(x):
        with force_platform("cpu"):
            return jacobi.eig_cs_resid(x, sweeps=sweeps)
    kernel = jax.jit(lambda x: jacobi.eig_cs_resid(x, sweeps=sweeps))
    (mu_k, r_k), t_k = wall(kernel, ut)
    (mu_s, r_s), t_s = wall(jax.jit(scan), ut)
    a = to_np(ut).reshape(-1, *ut.re.shape[-2:])
    mu_k = to_np(mu_k).reshape(len(a), -1)
    mu_s = to_np(mu_s).reshape(len(a), -1)
    mu_t = to_np(kernel(tf32(ut))[0]).reshape(len(a), -1)
    fro = np.linalg.norm(a, axis=(-1, -2))
    conv_k = np.asarray(r_k).reshape(-1) / fro < 1e-2
    conv_s = np.asarray(r_s).reshape(-1) / fro < 1e-2
    both = np.flatnonzero(conv_k & conv_s)
    sub = np.random.default_rng(0).choice(both, min(n_sub, len(both)),
                                          replace=False)
    ref = (exact.reshape(len(a), -1)[sub] if exact is not None else
           [scipy.linalg.eigvals(a[i].astype(np.complex128)) for i in sub])
    e_ks = max(max_match_err(mu_k[i], mu_s[i]) / fro[i] for i in sub)
    e_kr = max(max_match_err(mu_k[i], r) / fro[i] for i, r in zip(sub, ref))
    e_sr = max(max_match_err(mu_s[i], r) / fro[i] for i, r in zip(sub, ref))
    e_tr = max(max_match_err(mu_t[i], r) / fro[i] for i, r in zip(sub, ref))
    log(f"  {tag}: {len(a)} matrices {a.shape[-1]}x{a.shape[-1]}, "
        f"first-call wall kernel {t_k:.3f}s scan {t_s:.3f}s; converged "
        f"kernel {conv_k.sum()} scan {conv_s.sum()}; on {len(sub)}: "
        f"|kernel-scan| {e_ks:.2e}, |kernel-ref| {e_kr:.2e}, |scan-ref| "
        f"{e_sr:.2e}, |kernel(TF32 operands)-ref| {e_tr:.2e} (x|A|_F)")
    check(conv_k.mean() >= min_converged,
          f"{tag} kernel converged on >= {min_converged:.1%}")
    check(e_kr < rel_tol, f"{tag} |kernel-ref| < {rel_tol:g} |A|_F")
    check(e_ks < rel_tol, f"{tag} |kernel-scan| < {rel_tol:g} |A|_F")


def _compare_plain(tag, fn, args, err, limits):
    """fn jitted on args and on args rounded to TF32; err(out) gives a
    dict of named errors, each held to its limit in `limits`."""
    import jax
    from llckbdm_tpu.ops.cplx import CArr
    f = jax.jit(fn)
    out, t = wall(f, *args)
    sound = err(out)
    rounded = err(f(*(tf32(a) if isinstance(a, CArr) else a for a in args)))
    log(f"  {tag}: first call {t:.3f}s; " + ", ".join(
        f"{name} {e:.2e} (TF32 operands {et:.2e})"
        for (name, e), et in zip(sound.items(), rounded.values())))
    # the limit must tell f32 from TF32: the f32 reading passes it, the
    # reading on TF32 operands fails it
    for name, lim in limits.items():
        check(sound[name] < lim < rounded[name],
              f"{tag} {name}: f32 {sound[name]:.2e} < {lim:g} < TF32 "
              f"operands {rounded[name]:.2e}")


def phase_kernels(sigs, brain):
    """Sizes follow the voxel batch: 2048 voxels give 71,680 bench reduced
    matrices, 64 brain voxels, 4096 and 512 known-spectrum matrices."""
    import jax
    import jax.numpy as jnp
    import scipy.linalg
    from llckbdm_tpu.ops import linalg
    from llckbdm_tpu.ops.cplx import from_np, to_np
    from llckbdm_tpu.solver.kbdm import KbdmConfig, kbdm_sweep

    log("[2 kernels] eig_cs: Triton kernel (f32, elementwise, no matmul) vs "
        "lax.scan (f32) vs scipy.linalg.eigvals (f64)")
    c32 = from_np(sigs)
    ut = jax.jit(lambda c: kbdm_sweep(c, DWELL, M_VALUES, KbdmConfig(p=16),
                                      _stop="reduced"))(c32)
    _compare_eig("bench reduced", ut, 10, 256, 3e-3)
    bsig, bdwell = brain
    rng = np.random.default_rng(1)
    nb = max(1, len(sigs) // 32)
    bb = bsig[None] + 1e-4 * (rng.standard_normal((nb, bsig.size))
                              + 1j * rng.standard_normal((nb, bsig.size)))
    ut_b = jax.jit(lambda c: kbdm_sweep(c, bdwell, (512,), KbdmConfig(p=24),
                                        _stop="reduced"))(from_np(bb))
    _compare_eig("brain reduced", ut_b, 10, 64, 3e-3)
    # A = Q D Q^T with Q = expm(0.1 K), K random skew: 66-76% of |A|_F is
    # off the diagonal.  Complex-orthogonal Jacobi is not guaranteed to
    # converge on such inputs: a rare near-defective matrix fails in 10
    # sweeps with one rounding and not another, so require 99.5% converged
    # and compare eigenvalues where both solvers converged.
    for n, count in ((16, 2 * len(sigs)), (24, max(1, len(sigs) // 4))):
        grid = (np.arange(n) + rng.uniform(0.1, 0.9, (count, n))) / n * 0.8 \
            - 0.4
        ev = np.exp(2j * np.pi * grid - rng.uniform(0.02, 0.3, (count, n)))
        k = rng.standard_normal((count, n, n))
        q = np.stack([scipy.linalg.expm(0.1 * (x - x.T)) for x in k])
        a = np.einsum("bij,bj,bkj->bik", q, ev, q)
        _compare_eig(f"known spectrum p={n}", from_np(a), 10, 256, 1e-3,
                     exact=ev, min_converged=0.995)

    log("[2 kernels] cuSOLVER eigh / Cholesky (complex64, matmuls HIGHEST) "
        "vs scipy/numpy f64; each limit lies between the f32 reading and the "
        "reading on operands rounded to TF32")
    for k, count in ((24, 2 * len(sigs)), (32, max(1, len(sigs) // 4))):
        # known Takagi factorization M = U diag(s) U^T (U Haar unitary),
        # singular values log-spaced over a decade: eigh(M M^H) in f32
        # errs by ~k eps sigma_max^2 in sigma^2, and near-ties would make
        # the phase fix ill-posed
        z = rng.standard_normal((count, k, k)) \
            + 1j * rng.standard_normal((count, k, k))
        u, _ = np.linalg.qr(z)
        sv = np.logspace(0, -1, k)[None] * rng.uniform(0.9, 1.1, (count, 1))
        m = np.einsum("bij,bj,bkj->bik", u, sv, u)

        def takagi_err(out, m=m, sv=sv):
            w, s = to_np(out[0]), np.asarray(out[1])
            recon = np.einsum("bij,bj,bkj->bik", w, s, w)
            return {"sigma err x sigma_max":
                    np.max(np.abs(s - sv) / sv[:, :1]),
                    "reconstruction x |M|":
                    np.max(np.linalg.norm(recon - m, axis=(1, 2))
                           / np.linalg.norm(m, axis=(1, 2)))}
        _compare_plain(f"takagi k={k} x{count}", linalg.takagi_small,
                       (from_np(m),), takagi_err,
                       {"sigma err x sigma_max": 1.5e-5,
                        "reconstruction x |M|": 1e-4})

        y = rng.standard_normal((count, 3 * k, k)) \
            + 1j * rng.standard_normal((count, 3 * k, k))
        g = np.swapaxes(y.conj(), -1, -2) @ y
        shift = 3e-6 * np.mean(np.abs(np.einsum("bii->bi", g.real)), -1)
        gs = g + shift[:, None, None] * np.eye(k)
        want = np.linalg.inv(np.linalg.cholesky(gs).conj().transpose(0, 2, 1))
        _compare_plain(
            f"cholqr_rinv k={k} x{count}", linalg.cholqr_rinv,
            (from_np(g), jnp.asarray(shift, jnp.float32)),
            lambda r, want=want: {"err x max|R^-1|": np.max(
                np.abs(to_np(r) - want)) / np.max(np.abs(want))},
            {"err x max|R^-1|": 1e-5})

        b = rng.standard_normal((count, k)) + 1j * rng.standard_normal((count, k))
        sh = 1e-7 * np.mean(np.abs(np.einsum("bii->bi", g.real)), -1)
        xe = np.linalg.solve(g + sh[:, None, None] * np.eye(k),
                             b[..., None])[..., 0]
        _compare_plain(
            f"hermitian_solve k={k} x{count}",
            lambda h_, b_: linalg.hermitian_solve(h_, b_, rcond=1e-7),
            (from_np(g), from_np(b)),
            lambda x, xe=xe: {"err x |x|": np.max(
                np.linalg.norm(to_np(x) - xe, axis=1)
                / np.linalg.norm(xe, axis=1))},
            {"err x |x|": 2e-5})


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def phase_main(sigs, truths, name_power):
    import jax
    import jax.numpy as jnp
    from llckbdm_tpu.oracle import reference as oracle
    from llckbdm_tpu.ops.cplx import from_np
    from llckbdm_tpu.pipeline.llckbdm import LlcKbdmConfig, llc_kbdm_fit
    from llckbdm_tpu.signals import line_list_to_np
    from llckbdm_tpu.solver.kbdm import KbdmConfig, kbdm_sweep
    from llckbdm_tpu.solver.refine import (RefineConfig, refine_lines,
                                           refined_to_np)
    from llckbdm_tpu.utils import df as D

    v = len(sigs)
    log(f"[3 main path] llc_kbdm_fit + refine_lines, V={v} N={N} "
        f"m=120..256:4 p=16, 6 GN iterations on 16 clusters")
    cfg = LlcKbdmConfig(m_values=M_VALUES, eps=2e-4, min_samples=20,
                        max_clusters=32, kbdm=KbdmConfig(p=16))
    rcfg = RefineConfig(iters=6)

    def step(c, cdf):
        cons, _pooled, counts, _stats = llc_kbdm_fit(c, DWELL, cfg)
        cons = jax.tree.map(lambda x: x[..., :16], cons)
        return cons, counts, refine_lines(cdf, cons, DWELL, rcfg)
    c32, cdf = from_np(sigs), D.dfc_from_np(sigs)
    t0 = time.perf_counter()
    compiled = jax.jit(step).lower(c32, cdf).compile()
    t_compile = time.perf_counter() - t0
    log(f"  compile {t_compile:.1f}s; memory_analysis: "
        f"{compiled.memory_analysis()}")
    out, t_first = wall(compiled, c32, cdf)
    _, t_wall = wall(compiled, c32, cdf)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  wall first {t_first:.3f}s, second {t_wall:.3f}s "
        f"({v / t_wall:.1f} refined fits/s) on {name_power}; "
        f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    cons, counts, refined = jax.device_get(out)

    errs = []
    for i in range(16):
        init = line_list_to_np(jax.tree.map(lambda x: x[i], cons))
        est = refined_to_np(jax.tree.map(lambda x: x[i], refined), DWELL)
        olines = oracle.refine(init, sigs[i], DWELL, iters=20)
        errs.append(oracle.line_errors(
            est[oracle.match_lines(est, truths[i])],
            olines[oracle.match_lines(olines, truths[i])]).max())
    log(f"  gate vs f64 oracle.refine on 16 voxels: max {max(errs):.2e}")
    check(max(errs) < 1e-8, "1e-8 oracle gate on 16 voxels")

    sub = from_np(sigs[:32])
    _, diag = jax.jit(lambda c: kbdm_sweep(c, DWELL, M_VALUES, cfg.kbdm,
                                           with_diag=True))(sub)
    off = float(jnp.max(diag["eig_offdiag_rel"]))
    log(f"  production Jacobi off-diagonal / |A|_F max on 32 voxels: "
        f"{off:.2e}")
    check(off < 1e-2, "production Jacobi residual < 1e-2")


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def phase_entry_points(brain, brain_params, grid_voxels):
    import jax
    import llckbdm_tpu as lt
    from llckbdm_tpu.oracle import reference as oracle
    from llckbdm_tpu.ops.cplx import from_np
    from llckbdm_tpu.parallel.checkpoint import GridRunner
    from llckbdm_tpu.pipeline.llckbdm import LlcKbdmConfig
    from llckbdm_tpu.solver.refine import RefineConfig
    from llckbdm_tpu.utils import df as D
    from bench import BASE_LINES, make_signals

    log("[4 entry points] llc_kbdm(refine_iters=6) on the config-1 signal")
    sig = oracle.sample_signal(BASE_LINES, N, DWELL)
    cons, pooled, _counts = lt.llc_kbdm(sig, DWELL, range(120, 181, 10),
                                        p=16, eps=2e-4, min_samples=5,
                                        refine_iters=6)
    err = oracle.line_errors(cons[oracle.match_lines(cons, BASE_LINES)],
                             BASE_LINES).max()
    log(f"  {len(cons)} consolidated of {len(pooled)} pooled lines, max err "
        f"vs truth {err:.2e}")
    check(len(cons) >= 5 and err < 1e-8, "llc_kbdm refined within 1e-8")

    log("[4 entry points] config 2 (brain, N=2048, m=512, p=24): kbdm_fit + "
        "refine_lines (10 iterations) vs oracle.kbdm")
    bsig, bdwell = brain
    olines, _ = oracle.kbdm(bsig, bdwell, m=512, p=24)
    olines = olines[oracle.match_lines(olines, brain_params)]
    lines = jax.jit(lambda c: lt.kbdm_fit(c, bdwell, 512, lt.KbdmConfig(p=24)))(
        from_np(bsig))
    ref = jax.jit(lambda s, l: lt.refine_lines(s, l, bdwell,
                                               RefineConfig(iters=10)))(
        D.dfc_from_np(bsig), lines)
    est = lt.refined_to_np(ref, bdwell)
    err = oracle.line_errors(est[oracle.match_lines(est, brain_params)],
                             olines).max()
    log(f"  {len(est)} lines, max err vs oracle.kbdm {err:.2e}")
    check(err < 1e-8, "config 2 matches the oracle within 1e-8")

    log(f"[4 entry points] GridRunner(refine=RefineConfig()) on a "
        f"{grid_voxels}-voxel grid")
    sigs, truths = make_signals(grid_voxels, N, DWELL, seed=2)
    cfg = LlcKbdmConfig(m_values=M_VALUES, eps=2e-4, min_samples=20,
                        max_clusters=32, kbdm=lt.KbdmConfig(p=16))
    with tempfile.TemporaryDirectory() as out_dir:
        runner = GridRunner(out_dir, DWELL, cfg,
                            shard_size=min(256, grid_voxels),
                            refine=RefineConfig())
        _, t = wall(runner.run, sigs)
        grid = runner.gather(grid_voxels)
        n_shards = len(list(pathlib.Path(out_dir).glob("shard_*.npz")))
    z, mask = grid["refined_z"], grid["refined_mask"] > 0.5
    freq = np.angle(z) / (2 * np.pi * DWELL)
    worst = 0.0
    for i in range(grid_voxels):
        f = np.sort(freq[i][mask[i]])
        worst = max(worst, max(np.min(np.abs(f - t)) for t in truths[i, :, 2]))
    log(f"  {n_shards} shards in {t:.1f}s; "
        f"every truth line within {worst:.2e} Hz of a refined line")
    check(np.isfinite(z[mask]).all() and worst < 0.5,
          "grid refined lines finite and at every truth frequency")


# ---------------------------------------------------------------------------
# --cards 4
# ---------------------------------------------------------------------------

def phase_four_cards(voxels: int):
    import jax
    from llckbdm_tpu.ops.cplx import from_np
    from llckbdm_tpu.parallel import grid as G
    from llckbdm_tpu.parallel.mesh import make_mesh
    from llckbdm_tpu.pipeline.llckbdm import LlcKbdmConfig
    from llckbdm_tpu.solver.kbdm import KbdmConfig
    from llckbdm_tpu.solver.refine import RefineConfig
    from llckbdm_tpu.utils import df as D
    from bench import make_signals

    log(f"[5 four cards] fit_and_refine_grid on {voxels} voxels vs one-card "
        f"fit_grid + refine_grid shard by shard")
    cfg = LlcKbdmConfig(m_values=M_VALUES, eps=2e-4, min_samples=20,
                        max_clusters=32, kbdm=KbdmConfig(p=16))
    rcfg = RefineConfig(iters=6)
    sigs, _ = make_signals(voxels, N, DWELL)
    c32 = from_np(sigs)

    def one_card(shard):
        """fit_grid + refine_grid on one card, shard by shard: the same
        per-device batch as a mesh whose 'data' axis has voxels/shard
        devices, so the same compiled program and the same f32 rounding."""
        z, freq, counts = [], [], []
        for s in range(0, voxels, shard):
            part = sigs[s:s + shard]
            cons, _p, cnt, _st = G.fit_grid(from_np(part), DWELL, cfg)
            refined = G.refine_grid(D.dfc_from_np(part), cons, DWELL, rcfg)
            z.append(D.dfc_to_np(refined.z))
            freq.append(np.asarray(cons.frequency))
            counts.append(np.asarray(cnt))
        return np.concatenate(z), np.concatenate(freq), np.concatenate(counts)

    compile_s = []
    jax.monitoring.register_event_duration_secs_listener(
        lambda event, secs, **_: compile_s.append(secs)
        if event == "/jax/core/compile/backend_compile_duration" else None)

    # fit_and_refine_grid takes a ('data', 'time') mesh; time=1 is the
    # data-only layout
    for axes in ({"data": 4, "time": 1}, {"data": 2, "time": 2}):
        ref_z, ref_freq, ref_counts = one_card(voxels // axes["data"])
        mask = ref_z != 0
        mesh = make_mesh(axes)
        del compile_s[:]
        (cons, _p, counts, _st), t_fit = wall(G.fit_grid_sharded, c32, DWELL,
                                              cfg, mesh)
        c_fit = sum(compile_s)
        del compile_s[:]
        # the fit is compiled now: the first call adds the refinement's
        # compilation and the set-up of its collectives
        (refined, counts2), t = wall(G.fit_and_refine_grid, sigs, DWELL, cfg,
                                     mesh, rcfg)
        c_first = sum(compile_s)
        _, t2 = wall(G.fit_and_refine_grid, sigs, DWELL, cfg, mesh, rcfg)
        z = D.dfc_to_np(refined.z)
        d_freq = np.max(np.abs(np.asarray(cons.frequency) - ref_freq))
        rel = np.max(np.abs(z - ref_z)[mask] / np.abs(ref_z[mask]))
        log(f"  mesh {axes}: fit_grid_sharded first call {t_fit:.2f}s "
            f"(XLA compile {c_fit:.2f}s); fit_and_refine_grid first call "
            f"{t:.2f}s (XLA compile {c_first:.2f}s), second {t2:.2f}s; "
            f"counts equal {np.array_equal(np.asarray(counts2), ref_counts)}, "
            f"max |f - f_1card| {d_freq:.2e} Hz, refined poles max rel "
            f"{rel:.2e}")
        check(np.array_equal(np.asarray(counts), ref_counts)
              and np.array_equal(np.asarray(counts2), ref_counts),
              f"{axes} cluster counts equal to one card")
        check(d_freq <= 1e-5 * np.max(np.abs(ref_freq)),
              f"{axes} consolidated lines equal to one card (f32 rounding)")
        check(rel < 1e-10, f"{axes} refined poles within 1e-10 relative")
        if axes["time"] == 1:
            hlo = G._fit_grid_sharded_jit(DWELL, cfg, mesh).lower(
                G._device_put_sharded(c32, mesh)).compile().as_text()
            ncoll = sum(hlo.count(op) for op in (
                "all-reduce", "all-gather", "reduce-scatter",
                "collective-permute", "all-to-all"))
            check(ncoll == 0, f"data-only compiled HLO has {ncoll} collectives")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    ap.add_argument("--voxels", type=int, default=None,
                    help="voxel batch (default 2048; 8192 with --cards 4)")
    args = ap.parse_args(argv)
    name_power = card()
    log(f"# card: {name_power}")

    sys.path.insert(0, str(ROOT))
    from llckbdm_tpu.utils.compile_cache import use_compile_cache
    use_compile_cache()
    devs = phase_device(args.cards)

    if args.cards == 4:
        phase_four_cards(args.voxels or 8192)
    else:
        from llckbdm_tpu.oracle import reference as oracle
        from bench import make_signals
        sigs, truths = make_signals(args.voxels or 2048, N, DWELL)
        brain_params = np.loadtxt(ROOT / "data" / "params_brain_sim.csv",
                                  delimiter=",", skiprows=1,
                                  usecols=(1, 2, 3, 4))
        brain = (oracle.sample_signal(brain_params, 2048, 2.5e-4), 2.5e-4)
        phase_kernels(sigs, brain)
        phase_main(sigs, truths, name_power)
        phase_entry_points(brain, brain_params, len(sigs) // 2)
    log(f"# card: {name_power}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
