"""In-context marginal cost of each kbdm_sweep stage on the card.

Isolated per-stage timings lose cross-stage XLA fusion.  This tool instead
jits PREFIXES of the real sweep via kbdm_sweep's
``_stop`` profiling hook (no mirrored code to drift) and reports
consecutive differences — the true in-context marginal cost of every
stage at bench shapes.  Reduces each prefix output to a scalar so
transfer cost is nil.

Usage: python tools/ablate_sweep.py [--voxels 512] [--reps 5]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from llckbdm_tpu.ops.cplx import CArr
from llckbdm_tpu.oracle.reference import sample_signal
from llckbdm_tpu.pipeline.llckbdm import LlcKbdmConfig
from llckbdm_tpu.solver.kbdm import KbdmConfig, kbdm_sweep


def scalarize(tree):
    leaves = [x for x in jax.tree.leaves(tree)
              if isinstance(x, jax.Array)
              and jnp.issubdtype(x.dtype, jnp.floating)]
    return sum(jnp.sum(x.astype(jnp.float32)) for x in leaves)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--voxels", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    n, dwell, v = 512, 5e-4, args.voxels
    cfg = LlcKbdmConfig(m_values=tuple(range(120, 257, 4)),
                        eps=2e-4, min_samples=20, max_clusters=32,
                        kbdm=KbdmConfig(p=16))
    kc = cfg.kbdm

    rng = np.random.default_rng(0)
    base = np.array([
        [1.0, 0.05, -120.0, 0.1], [0.8, 0.08, -40.0, 0.0],
        [1.2, 0.03, 15.0, -0.2], [0.5, 0.10, 90.0, 0.3],
        [0.9, 0.06, 200.0, 0.0]])
    sigs = np.empty((v, n), np.complex128)
    for i in range(v):
        pr = base.copy()
        pr[:, 2] += rng.normal(scale=2.0, size=5)
        sigs[i] = sample_signal(pr, n, dwell)
    c = CArr(jnp.asarray(sigs.real, jnp.float32),
             jnp.asarray(sigs.imag, jnp.float32))

    print(f"# device={jax.devices()[0].device_kind} V={v} "
          f"S={len(cfg.m_values)} p={kc.p} k={kc.p+kc.oversample}")

    stages = ["hankel", "powiter", "basis", "m_small", "takagi", "reduced",
              "eig", None]
    prev = 0.0
    for stop in stages:
        f = jax.jit(lambda x, stop=stop: scalarize(kbdm_sweep(
            x, dwell, cfg.m_values, kc, _stop=stop)))
        t0 = time.perf_counter()
        out = f(c)
        jax.block_until_ready(out)
        np.asarray(jax.device_get(out))
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = f(c)
            jax.block_until_ready(out)
        np.asarray(jax.device_get(out))
        cum = (time.perf_counter() - t0) / args.reps
        name = stop or "lines"
        print(f"{name:10s} cum {cum*1e3:8.2f} ms   marginal "
              f"{(cum-prev)*1e3:8.2f} ms   (compile {compile_s:5.1f}s)",
              flush=True)
        prev = cum


if __name__ == "__main__":
    main()
