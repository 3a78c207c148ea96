"""The parts of the GPU fit path, timed on the card.

Times each part of the fit that once had a hand-written accelerator kernel,
isolated at the pipeline's shapes, and the fit end to end:

  eig     Triton eig_cs kernel | lax.scan Jacobi (the CPU path, kept as
          the kernel's reference)
  takagi  jnp.linalg.eigh of M M^H
  orth    CholeskyQR (cholesky + triangular solve)
  solve   Cholesky with Tikhonov shift
  dbscan  dbscan_1d (sort)
  e2e     llc_kbdm_fit + refine_lines at bench shapes, and kbdm_fit at brain
          shapes, each with the eig kernel and with the scan

The alternatives that lost to these on the card (Jacobi-scan eigh, Lowner
orthonormalization, eigh pseudo-inverse, jnp.linalg.eig, the n x n DBSCAN on
the hot path) are not in the library; their timings are in PERF.md.

Shapes: bench (N=512, m=120..256:4 so S=35, p=16, k=24, V voxels) and
brain (N=2048, m=512, p=24, k=32, V voxels).  Every record names the
device; the card's name and power limit come from nvidia-smi before JAX
starts.

Usage: python tools/bench_gpu_paths.py [--voxels 2048] [--reps 5]
           [--only isolated,e2e] [--out results/gpu_paths.json]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def require_gpu():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs an NVIDIA GPU, JAX found {dev.platform}")
    return dev


def bench_ms(fn, args, reps):
    """Compile (reported), warm, then the median of `reps` timed calls."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3, t_compile


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--voxels", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default="isolated,e2e")
    ap.add_argument("--out", default="results/gpu_paths.json")
    args = ap.parse_args()
    name_power = card()
    print(f"# card: {name_power}", flush=True)

    import jax
    import jax.numpy as jnp
    from llckbdm_tpu.utils.compile_cache import use_compile_cache
    use_compile_cache()
    dev = require_gpu()

    from llckbdm_tpu.ops import eig_kernel, jacobi, linalg
    from llckbdm_tpu.ops.cplx import CArr
    from llckbdm_tpu.ops.dbscan import dbscan_1d
    from llckbdm_tpu.pipeline import llckbdm as pipe
    from llckbdm_tpu.platform import force_platform
    from llckbdm_tpu.solver import kbdm as kb
    from llckbdm_tpu.solver import refine as rf
    from bench import make_signals

    records = []

    def rec(**kw):
        kw.update(device=dev.device_kind, card=name_power)
        print(json.dumps(kw), flush=True)
        records.append(kw)

    def measure(fn, args, **labels):
        """One timed variant; a failure is recorded and the run goes on."""
        try:
            ms, tc = bench_ms(fn, args, reps)
        except Exception:
            rec(**labels, error=traceback.format_exc()[-1500:])
            return None
        rec(**labels, ms=ms, compile_s=tc)
        return ms

    v, reps = args.voxels, args.reps
    rng = np.random.default_rng(0)

    def rand_c(*shape):
        return CArr(jnp.asarray(rng.standard_normal(shape), jnp.float32),
                    jnp.asarray(rng.standard_normal(shape), jnp.float32))

    def symmetric(batch, n):
        a = rand_c(batch, n, n)
        return CArr(0.5 * (a.re + jnp.swapaxes(a.re, -1, -2)),
                    0.5 * (a.im + jnp.swapaxes(a.im, -1, -2)))

    def hpd(batch, k):
        y = rand_c(batch, 3 * k, k)
        yc = jax.lax.complex(y.re, y.im)
        g = jnp.einsum("bmi,bmj->bij", jnp.conj(yc), yc,
                       precision=jax.lax.Precision.HIGHEST)
        return CArr(jnp.real(g), jnp.imag(g))

    shapes = {"bench": dict(n=512, m=tuple(range(120, 257, 4)), p=16,
                            dwell=5e-4),
              "brain": dict(n=2048, m=(512,), p=24, dwell=2.5e-4)}

    def isolated():
        for tag, sh in shapes.items():
            p, s = sh["p"], len(sh["m"])
            k = p + 8
            batch = v * s
            ut = symmetric(batch, p)

            def eig_s(x):
                with force_platform("cpu"):
                    return jacobi.eig_cs_resid(x, sweeps=10)
            for name, fn in (("kernel", lambda x: eig_kernel.eig_cs_resid(
                    x, sweeps=10)), ("scan", eig_s)):
                measure(fn, (ut,), phase="isolated", part="eig", shape=tag,
                        variant=name, batch=batch, p=p)

            measure(linalg.takagi_small, (symmetric(batch, k),),
                    phase="isolated", part="takagi", shape=tag, batch=batch,
                    k=k)

            g = hpd(batch, k)
            shift = 3e-6 * jnp.mean(jnp.abs(jnp.diagonal(
                g.re, axis1=-2, axis2=-1)), axis=-1)
            measure(linalg.cholqr_rinv, (g, shift), phase="isolated",
                    part="orth", shape=tag, batch=batch, k=k)

            for where, bb, kk in (("amplitude", batch, p),
                                  ("refine", v, 32)):
                measure(lambda h_, b_: linalg.hermitian_solve(h_, b_,
                                                              rcond=1e-7),
                        (hpd(bb, kk), rand_c(bb, kk)), phase="isolated",
                        part="solve", shape=tag, where=where, batch=bb, k=kk)

            nl = s * p
            x = jnp.asarray(rng.uniform(-0.1, 0.1, (v, nl)), jnp.float32)
            valid = jnp.asarray(rng.uniform(size=(v, nl)) < 0.7)
            measure(jax.vmap(lambda a, b_: dbscan_1d(a, b_, 2e-4, 20)),
                    (x, valid), phase="isolated", part="dbscan", shape=tag,
                    voxels=v, n=nl)

    def e2e_brain():
        """Config 2 kbdm_fit: the eig kernel against the scan at p=24."""
        import bench
        from llckbdm_tpu.oracle.reference import sample_signal
        from llckbdm_tpu.ops.cplx import from_np
        sh = shapes["brain"]
        params = np.loadtxt(pathlib.Path(bench.__file__).parent / "data"
                            / "params_brain_sim.csv", delimiter=",",
                            skiprows=1, usecols=(1, 2, 3, 4))
        sig = sample_signal(params, sh["n"], sh["dwell"])
        vb = max(1, v // 4)
        c = from_np(sig[None] + 1e-4 * rng.standard_normal((vb, sh["n"])))
        for name, plat in (("kernel", dev.platform), ("eig=scan", "cpu")):
            def fit(x, plat=plat):
                with force_platform(plat):
                    return kb.kbdm_fit(x, sh["dwell"], sh["m"][0],
                                       kb.KbdmConfig(p=sh["p"]))
            measure(fit, (c,), phase="e2e_brain", stage="kbdm_fit",
                    variant=name, voxels=vb)

    def e2e():
        sh = shapes["bench"]
        sigs, _ = make_signals(v, sh["n"], sh["dwell"])
        c32 = CArr(jnp.asarray(sigs.real, jnp.float32),
                   jnp.asarray(sigs.imag, jnp.float32))
        from llckbdm_tpu.utils import df as D
        cdf = D.dfc_from_np(sigs)
        cfg = pipe.LlcKbdmConfig(m_values=sh["m"], eps=2e-4, min_samples=20,
                                 max_clusters=32,
                                 kbdm=kb.KbdmConfig(p=sh["p"]))
        rcfg = rf.RefineConfig(iters=6)
        for name, plat in (("kernel", dev.platform), ("eig=scan", "cpu")):
            def fit(x, plat=plat):
                with force_platform(plat):
                    return pipe.llc_kbdm_fit(x, sh["dwell"], cfg)
            if measure(fit, (c32,), phase="e2e", stage="fit", variant=name,
                       voxels=v) is None:
                continue
            cons = jax.tree.map(lambda x: x[..., :16], jax.jit(fit)(c32)[0])
            measure(lambda s_, l_: rf.refine_lines(s_, l_, sh["dwell"], rcfg),
                    (cdf, cons), phase="e2e", stage="refine", variant=name,
                    voxels=v)

    phases = args.only.split(",")
    if "isolated" in phases:
        isolated()
    if "e2e" in phases:
        e2e()
        e2e_brain()
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(records, indent=1))


if __name__ == "__main__":
    main()
