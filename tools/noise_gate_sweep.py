"""Gate vs noise: where does device-vs-oracle 1e-8 agreement break?

The 1e-8 oracle gate is proven noiseless and at noise 1e-4 (committed
tests + in-bench assertion); real MRSI sits higher.  This sweeps complex
noise sigma over 1e-4 .. 1e-2 on the config-1 family and at each level
compares the device pipeline's refined lines (f32 fit + double-float GN)
against the f64 oracle GN fixed point OF THE SAME NOISY SIGNAL — both
solve the same estimation problem, so the comparison isolates basin /
conditioning effects from the noise floor itself.

Reported per level: max + median over voxels of the max line-parameter
relative error, and the count of voxels where the device found all 5
lines.  Run: python tools/noise_gate_sweep.py [--voxels 8] [--gn-iters 8]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if "--cpu" in sys.argv:        # must precede first backend use
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from llckbdm_tpu.ops.cplx import CArr  # noqa: E402
from llckbdm_tpu.oracle import reference as oracle  # noqa: E402
from llckbdm_tpu.pipeline.llckbdm import (LlcKbdmConfig,  # noqa: E402
                                          llc_kbdm_fit)
from llckbdm_tpu.solver.kbdm import KbdmConfig  # noqa: E402
from llckbdm_tpu.solver.refine import (RefineConfig, refine_lines,  # noqa: E402
                                       refined_to_np)
from llckbdm_tpu.utils import df as D  # noqa: E402

FIVE_PEAK = np.array([
    [1.0, 0.05, -120.0, 0.1],
    [0.8, 0.08, -40.0, 0.0],
    [1.2, 0.03, 15.0, -0.2],
    [0.5, 0.10, 90.0, 0.3],
    [0.9, 0.06, 200.0, 0.0],
])
N, DWELL = 512, 5e-4


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--voxels", type=int, default=8)
    ap.add_argument("--gn-iters", type=int, default=8)
    ap.add_argument("--levels", type=float, nargs="*",
                    default=(1e-4, 3e-4, 1e-3, 3e-3, 1e-2))
    ap.add_argument("--cpu", action="store_true",
                    help="run on CPU (handled at import; listed here for "
                         "--help only)")
    args = ap.parse_args()
    v = args.voxels

    cfg = LlcKbdmConfig(m_values=tuple(range(120, 257, 4)), eps=2e-4,
                        min_samples=20, max_clusters=32,
                        kbdm=KbdmConfig(p=16))
    fit = jax.jit(lambda x: llc_kbdm_fit(x, DWELL, cfg))
    refine = jax.jit(lambda s, l: refine_lines(
        s, l, DWELL, RefineConfig(iters=args.gn_iters)))

    print(f"# device: {jax.devices()[0].device_kind}; V={v}, "
          f"GN iters={args.gn_iters}")
    print("| noise sigma | max rel err | median rel err | voxels w/ 5 lines |")
    print("|---|---|---|---|")
    rows = []
    for noise in args.levels:
        rng = np.random.default_rng(3)
        sigs = np.empty((v, N), np.complex128)
        truths = np.empty((v, 5, 4))
        for i in range(v):
            p = FIVE_PEAK.copy()
            p[:, 2] += rng.normal(scale=2.0, size=5)
            p[:, 0] *= 1.0 + rng.normal(scale=0.05, size=5)
            sigs[i] = oracle.sample_signal(p, N, DWELL)
            truths[i] = p
        sigs += noise * (rng.standard_normal((v, N))
                         + 1j * rng.standard_normal((v, N)))
        c = CArr(jnp.asarray(sigs.real, jnp.float32),
                 jnp.asarray(sigs.imag, jnp.float32))
        cons, _, _, _ = fit(c)
        cons = jax.tree.map(lambda x: x[..., :16], cons)
        ref = refine(D.dfc_from_np(sigs), cons)
        errs, five = [], 0
        for i in range(v):
            est = refined_to_np(jax.tree.map(lambda x: x[i], ref), DWELL)
            olines = oracle.refine(np.asarray(truths[i], np.float64),
                                   sigs[i], DWELL, iters=30)
            try:
                sel_o = oracle.match_lines(olines, truths[i])
                sel_e = oracle.match_lines(est, truths[i])
            except ValueError:
                errs.append(np.inf)
                continue
            five += 1
            errs.append(oracle.line_errors(est[sel_e], olines[sel_o]).max())
        errs = np.asarray(errs)
        print(f"| {noise:.0e} | {np.max(errs):.2e} | "
              f"{np.median(errs):.2e} | {five}/{v} |", flush=True)
        rows.append((noise, float(np.max(errs)), float(np.median(errs))))

    breakpt = next((nz for nz, mx, _ in rows if mx > 1e-8), None)
    if breakpt is None:
        print("# 1e-8 device-vs-oracle agreement holds at EVERY level")
    else:
        print(f"# first level where max err exceeds 1e-8: {breakpt:.0e}")


if __name__ == "__main__":
    main()
