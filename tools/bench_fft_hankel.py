"""Head-to-head: implicit FFT Hankel apply vs the materialized matmul apply.

The north star names "Hankel/Toeplitz matrix construction as implicit
FFT-based operators" (BASELINE.json:5); the shipped sweep materializes the
(V, m_max, m_max) operator and runs dense (masked) matmul applies.  This
tool measures, on the card at pipeline shapes, the per-apply marginal cost
of each formulation so the choice is data-backed:

* dense bf16       — a reduced-precision apply (candidate for the power
                     iteration, ROADMAP A4)
* dense f32 HIGHEST — the apply kbdm_sweep runs (apply_op)
* implicit FFT f32 — ops.hankel.hankel_apply_fft (no materialized operator)

Timing: per-apply marginals from jitted apply-chains of depth 1 vs 3
(difference = 2 applies), which cancels the per-launch overhead and the
fixed FFT/spectrum setup.  Accuracy: max abs error vs a
float64 NumPy reference of the same masked apply.

Run: python tools/bench_fft_hankel.py [--voxels 512] [--m 256]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from llckbdm_tpu.ops.cplx import CArr  # noqa: E402
from llckbdm_tpu.ops.hankel import (fft_length, hankel_apply_fft,  # noqa: E402
                                    hankel_fft_spectrum, hankel_matrices)


def timeit(fn, args, reps=10):
    out = fn(*args)
    jax.block_until_ready(out)
    np.asarray(jax.device_get(jax.tree_util.tree_leaves(out)[0].ravel()[:1]))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
        jax.block_until_ready(out)
    np.asarray(jax.device_get(jax.tree_util.tree_leaves(out)[0].ravel()[:1]))
    return (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--voxels", type=int, default=512)
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--cols", type=int, default=840,
                    help="apply width J = S*k (bench: 35 sweeps x 24)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    v, m, j = args.voxels, args.m, args.cols
    n = 2 * m
    rng = np.random.default_rng(0)
    sigs = (rng.standard_normal((v, n)) + 1j * rng.standard_normal((v, n)))
    x_np = (rng.standard_normal((v, m, j)).astype(np.float32)
            + 1j * rng.standard_normal((v, m, j)).astype(np.float32))

    c = CArr(jnp.asarray(sigs.real, jnp.float32),
             jnp.asarray(sigs.imag, jnp.float32))
    x = CArr(jnp.asarray(x_np.real), jnp.asarray(x_np.imag))
    print(f"# device: {jax.devices()[0].device_kind}; V={v} m={m} J={j} "
          f"nfft={fft_length(m)}")

    # f64 reference on a small sample
    vs = min(v, 4)
    h_ref = np.stack([np.asarray(sigs[i])[np.add.outer(np.arange(m),
                                                       np.arange(m))]
                      for i in range(vs)])
    y_ref = np.einsum("vab,vbj->vaj", h_ref,
                      x_np[:vs].astype(np.complex128))
    ref_scale = np.max(np.abs(y_ref))

    def acc(fn):
        y = fn(CArr(c.re[:vs], c.im[:vs]), CArr(x.re[:vs], x.im[:vs]))
        yc = np.asarray(y.re) + 1j * np.asarray(y.im)
        return float(np.max(np.abs(yc - y_ref)) / ref_scale)

    # --- dense, materialized -------------------------------------------
    def chain_dense(cc, xx, depth, bf16):
        h = hankel_matrices(cc, m)
        if bf16:
            h = CArr(h.re.astype(jnp.bfloat16), h.im.astype(jnp.bfloat16))
            mm = lambda a, b: jnp.matmul(a, b,
                                         preferred_element_type=jnp.float32)
        else:
            mm = lambda a, b: jnp.matmul(a, b,
                                         precision=jax.lax.Precision.HIGHEST,
                                         preferred_element_type=jnp.float32)
        y = xx
        for _ in range(depth):
            if bf16:
                y = CArr(y.re.astype(jnp.bfloat16), y.im.astype(jnp.bfloat16))
            y = CArr(mm(h.re, y.re) - mm(h.im, y.im),
                     mm(h.re, y.im) + mm(h.im, y.re))
        return y

    def chain_fft(cc, xx, depth):
        spec = hankel_fft_spectrum(cc, m)
        y = xx
        for _ in range(depth):
            y = hankel_apply_fft(spec, y, m)
        return y

    results = {}
    for name, mk in (
        ("dense_bf16", lambda d: jax.jit(lambda cc, xx:
                                         chain_dense(cc, xx, d, True))),
        ("dense_f32hi", lambda d: jax.jit(lambda cc, xx:
                                          chain_dense(cc, xx, d, False))),
        ("fft_f32", lambda d: jax.jit(lambda cc, xx: chain_fft(cc, xx, d))),
    ):
        t1 = timeit(mk(1), (c, x), args.reps)
        t3 = timeit(mk(3), (c, x), args.reps)
        per_apply = (t3 - t1) / 2.0
        a = acc(lambda cc, xx: mk(1)(cc, xx))
        results[name] = (per_apply, a)
        print(f"{name:12s}: {per_apply*1e3:7.2f} ms/apply "
              f"(chain1 {t1*1e3:.2f}, chain3 {t3*1e3:.2f}); "
              f"max rel err vs f64 = {a:.2e}")

    d_bf, d_hi = results["dense_bf16"][0], results["dense_f32hi"][0]
    f = results["fft_f32"][0]
    print(f"# FFT vs dense-bf16: {f/d_bf:5.2f}x; "
          f"FFT vs dense-f32hi: {f/d_hi:5.2f}x "
          f"(<1 means FFT faster)")


if __name__ == "__main__":
    main()
