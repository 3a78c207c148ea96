"""Tune the Jacobi sweep budget against MEASURED production convergence.

The sequential block of the pipeline is the eig_cs eigensolver
(cfg.eig_sweeps, default 10).  This tool, on the card:

1. measures the production eig_cs off-diagonal counter vs eig_sweeps
   (bench-shaped noisy signals, the matrices that matter);
2. asserts the committed accuracy gates for candidate eig_sweeps:
     - config-1 NOISELESS, m=180, GN iters=3 (the tests/test_gpu.py gate,
       the canary for f32-stage quality);
     - config-1 + 1e-4 noise, GN iters=6, 3 voxels (the in-bench gate);
3. times the V=512 sweep at each candidate.

Run: python tools/tune_sweeps.py
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from llckbdm_tpu.ops.cplx import CArr  # noqa: E402
from llckbdm_tpu.oracle import reference as oracle  # noqa: E402
from llckbdm_tpu.pipeline.llckbdm import (LlcKbdmConfig,  # noqa: E402
                                          llc_kbdm_fit)
from llckbdm_tpu.solver.kbdm import KbdmConfig, kbdm_sweep  # noqa: E402
from llckbdm_tpu.solver.refine import (RefineConfig, refine_lines,  # noqa: E402
                                       refined_to_np)
from llckbdm_tpu.utils import df as D  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from bench_fft_hankel import timeit  # noqa: E402  (shared timing helper)

FIVE_PEAK = np.array([
    [1.0, 0.05, -120.0, 0.1],
    [0.8, 0.08, -40.0, 0.0],
    [1.2, 0.03, 15.0, -0.2],
    [0.5, 0.10, 90.0, 0.3],
    [0.9, 0.06, 200.0, 0.0],
])
N, DWELL = 512, 5e-4


def make_signals(v, noise):
    rng = np.random.default_rng(0)
    sigs = np.empty((v, N), np.complex128)
    truths = np.empty((v, 5, 4))
    for i in range(v):
        p = FIVE_PEAK.copy()
        p[:, 2] += rng.normal(scale=2.0, size=5)
        p[:, 0] *= 1.0 + rng.normal(scale=0.05, size=5)
        sigs[i] = oracle.sample_signal(p, N, DWELL)
        truths[i] = p
    if noise:
        sigs += noise * (rng.standard_normal((v, N))
                         + 1j * rng.standard_normal((v, N)))
    return sigs, truths


def counter_vs_sweeps():
    sigs, _ = make_signals(32, 1e-4)
    c = CArr(jnp.asarray(sigs.real, jnp.float32),
             jnp.asarray(sigs.imag, jnp.float32))
    m_values = tuple(range(120, 257, 4))
    print("eig_sweeps -> production max offdiag_rel (V=32, noisy):")
    for s in (4, 5, 6, 7, 8, 10):
        cfg = KbdmConfig(p=16, eig_sweeps=s)
        _, diag = jax.jit(lambda x: kbdm_sweep(
            x, DWELL, m_values, cfg, with_diag=True))(c)
        r = float(jnp.max(diag["eig_offdiag_rel"]))
        print(f"  eig_sweeps={s:2d}: {r:.3e}", flush=True)


def gate_at(eig_sweeps, refine_jit_cache={}):
    """Returns (noiseless_iters3_err, noisy_iters6_err, sweep_ms_v512)."""
    kb = KbdmConfig(p=16, eig_sweeps=eig_sweeps)

    # gate 1: config-1 noiseless, m=180, GN iters=3 (single-m fit like
    # tests/test_gpu.py::test_gpu_config1_refined_hits_1e8_gate)
    sig = oracle.sample_signal(FIVE_PEAK, N, DWELL)
    c1 = CArr(jnp.asarray(sig.real[None], jnp.float32),
              jnp.asarray(sig.imag[None], jnp.float32))
    cfg1 = LlcKbdmConfig(m_values=(180,), eps=2e-4, min_samples=1,
                         max_clusters=16, kbdm=kb)
    cons, _, _, _ = jax.jit(lambda x: llc_kbdm_fit(x, DWELL, cfg1))(c1)
    if 3 not in refine_jit_cache:
        refine_jit_cache[3] = jax.jit(lambda s, l: refine_lines(
            s, l, DWELL, RefineConfig(iters=3)))
    ref = refine_jit_cache[3](D.dfc_from_np(sig[None]), cons)
    est = refined_to_np(jax.tree.map(lambda x: x[0], ref), DWELL)
    olines = oracle.refine(
        np.asarray(FIVE_PEAK, np.float64), sig, DWELL, iters=20)
    sel_o = oracle.match_lines(olines, FIVE_PEAK)
    sel_e = oracle.match_lines(est, FIVE_PEAK)
    err1 = float(oracle.line_errors(est[sel_e], olines[sel_o]).max())

    # gate 2: bench config — noisy, sweep 120..256:4, GN iters=6, 3 voxels
    sigs, truths = make_signals(3, 1e-4)
    cb = CArr(jnp.asarray(sigs.real, jnp.float32),
              jnp.asarray(sigs.imag, jnp.float32))
    cfgb = LlcKbdmConfig(m_values=tuple(range(120, 257, 4)), eps=2e-4,
                         min_samples=20, max_clusters=32, kbdm=kb)
    consb, _, _, _ = jax.jit(lambda x: llc_kbdm_fit(x, DWELL, cfgb))(cb)
    consb = jax.tree.map(lambda x: x[..., :16], consb)
    if 6 not in refine_jit_cache:
        refine_jit_cache[6] = jax.jit(lambda s, l: refine_lines(
            s, l, DWELL, RefineConfig(iters=6)))
    refb = refine_jit_cache[6](D.dfc_from_np(sigs), consb)
    errs = []
    for i in range(3):
        est = refined_to_np(jax.tree.map(lambda x: x[i], refb), DWELL)
        olines = oracle.refine(
            np.asarray(truths[i], np.float64), sigs[i], DWELL, iters=20)
        sel_o = oracle.match_lines(olines, truths[i])
        sel_e = oracle.match_lines(est, truths[i])
        errs.append(oracle.line_errors(est[sel_e], olines[sel_o]).max())
    err2 = float(np.max(errs))

    # sweep time at V=512
    sigs512, _ = make_signals(512, 1e-4)
    c512 = CArr(jnp.asarray(sigs512.real, jnp.float32),
                jnp.asarray(sigs512.imag, jnp.float32))
    t = timeit(jax.jit(lambda x: kbdm_sweep(
        x, DWELL, cfgb.m_values, kb)), (c512,), 5)
    return err1, err2, t * 1e3


if __name__ == "__main__":
    print(f"# device: {jax.devices()[0].device_kind}")
    counter_vs_sweeps()
    print("\neig_sweeps -> gates + V=512 sweep ms:")
    for es in (10, 8, 6):
        t0 = time.perf_counter()
        e1, e2, ms = gate_at(es)
        ok1 = "PASS" if e1 < 1e-8 else "FAIL"
        ok2 = "PASS" if e2 < 1e-8 else "FAIL"
        print(f"  {es:2d}: noiseless iters=3 {e1:.2e} [{ok1}]  "
              f"noisy iters=6 {e2:.2e} [{ok2}]  sweep {ms:7.1f} ms  "
              f"({time.perf_counter()-t0:.0f}s incl compile)", flush=True)
