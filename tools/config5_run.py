"""Config 5 at size: 256x256 = 65,536 voxels through the checkpointed
GridRunner on the local card (BASELINE.json:11).

This executes the code path each host of a multi-host run executes
(GridRunner with process_index/num_processes), at full grid size, on one
card, and records wall time + throughput + resume behavior.

Resume demonstration: kill the process mid-grid (e.g. run under
`timeout 60`) — the O_EXCL/rename shard protocol guarantees every
completed shard survives — then re-run the same command: completed shards
are skipped ("resumed" in the output) and gather() assembles the grid.

Usage: python tools/config5_run.py [--voxels 65536] [--shard 512]
       [--out results/config5]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_grid_signals(v: int, n: int, dwell: float):
    """Vectorized synthesis of v jittered 5-peak voxels (config-1 family,
    matching bench.py's make_signals distribution) + complex noise.
    Returns (signals (v, n) complex128, truth params (v, 5, 4))."""
    base = np.array([
        [1.0, 0.05, -120.0, 0.1],
        [0.8, 0.08, -40.0, 0.0],
        [1.2, 0.03, 15.0, -0.2],
        [0.5, 0.10, 90.0, 0.3],
        [0.9, 0.06, 200.0, 0.0],
    ])
    rng = np.random.default_rng(0)
    amp = base[:, 0] * (1.0 + rng.normal(scale=0.05, size=(v, 5)))
    t2 = np.broadcast_to(base[:, 1], (v, 5))
    freq = base[:, 2] + rng.normal(scale=2.0, size=(v, 5))
    ph = np.broadcast_to(base[:, 3], (v, 5))
    t = np.arange(n) * dwell                           # (n,)
    # c[v, n] = sum_k A e^{i ph} e^{(i 2 pi f - 1/T2) t}
    z = (2j * np.pi * freq[..., None] - 1.0 / t2[..., None]) * t  # (v,5,n)
    sig = np.sum(amp[..., None] * np.exp(1j * ph[..., None] + z), axis=1)
    sig += 1e-4 * (rng.standard_normal((v, n))
                   + 1j * rng.standard_normal((v, n)))
    truths = np.stack([amp, t2, freq, ph], axis=-1)
    return sig, truths


def refined_rows(z: np.ndarray, d: np.ndarray, mask: np.ndarray,
                 dwell: float) -> np.ndarray:
    """One voxel's stored refined poles -> (k, 4) float64 (A, T2, f, phase)
    rows sorted by frequency (matches solver.refine.refined_to_np)."""
    z, d = z[mask > 0.5], d[mask > 0.5]
    freq = np.angle(z) / (2.0 * np.pi * dwell)
    with np.errstate(divide="ignore"):
        t2 = -dwell / np.log(np.abs(z))
    out = np.stack([np.abs(d), t2, freq, np.angle(d)], axis=1)
    return out[np.argsort(out[:, 2])]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--voxels", type=int, default=256 * 256)
    ap.add_argument("--shard", type=int, default=512)
    ap.add_argument("--out", default="results/config5")
    ap.add_argument("--f32-only", action="store_true",
                    help="skip the GN refinement stage (the default "
                         "runs the gate-meeting refined pipeline)")
    ap.add_argument("--gn-iters", type=int, default=6)
    ap.add_argument("--gate-voxels", type=int, default=8,
                    help="random sample of voxels on which the refined "
                         "result is asserted against the f64 oracle GN "
                         "fixed point (< 1e-8 relative; 0 disables)")
    args = ap.parse_args()

    import jax
    from llckbdm_tpu.parallel.checkpoint import GridRunner
    from llckbdm_tpu.pipeline.llckbdm import LlcKbdmConfig
    from llckbdm_tpu.solver.kbdm import KbdmConfig
    from llckbdm_tpu.solver.refine import RefineConfig

    n, dwell = 512, 5e-4
    cfg = LlcKbdmConfig(m_values=tuple(range(120, 257, 4)),
                        eps=2e-4, min_samples=20, max_clusters=32,
                        kbdm=KbdmConfig(p=16))
    rcfg = None if args.f32_only else RefineConfig(iters=args.gn_iters)

    t0 = time.time()
    sigs, truths = make_grid_signals(args.voxels, n, dwell)
    print(f"# synthesized {args.voxels} voxels in {time.time()-t0:.1f}s "
          f"({sigs.nbytes/2**20:.0f} MiB)", flush=True)

    runner = GridRunner(out_dir=args.out, dwell=dwell, cfg=cfg,
                        shard_size=args.shard, refine=rcfg)
    pend0 = len(runner.pending(args.voxels))
    total = (args.voxels + args.shard - 1) // args.shard
    print(f"# device={jax.devices()[0].device_kind} shards: {total} total, "
          f"{pend0} pending ({total-pend0} resumed)", flush=True)

    t0 = time.time()
    nshards = runner.run(sigs)
    wall = time.time() - t0
    fits = nshards * args.shard / wall if wall else float("inf")
    print(f"# computed {nshards} shards ({nshards*args.shard} voxels) "
          f"in {wall:.1f}s -> {fits:.1f} fits/s "
          f"(incl. host transfers + npz writes)", flush=True)

    res = runner.gather(args.voxels)
    found = (res["mask"] > 0.5).sum(axis=1)
    print(f"# gather OK: {res['amplitude'].shape[0]} voxels; "
          f"lines/voxel min={found.min()} median={np.median(found):.0f} "
          f"max={found.max()}", flush=True)

    if rcfg is not None and args.gate_voxels:
        # 1e-8 oracle gate asserted on a random voxel sample of the
        # AT-SIZE refined output (BASELINE.json:5 couples the pod-scale
        # throughput target to the gate)
        from llckbdm_tpu.oracle import reference as oracle
        rng = np.random.default_rng(1)
        sample = rng.choice(args.voxels, size=args.gate_voxels,
                            replace=False)
        errs = []
        for i in sample:
            est = refined_rows(res["refined_z"][i], res["refined_d"][i],
                               res["refined_mask"][i], dwell)
            olines = oracle.refine(np.asarray(truths[i], np.float64),
                                   sigs[i], dwell, iters=20)
            sel_o = oracle.match_lines(olines, truths[i])
            sel_e = oracle.match_lines(est, truths[i])
            errs.append(oracle.line_errors(est[sel_e], olines[sel_o]).max())
        gate = float(np.max(errs))
        if not gate < 1e-8:
            raise RuntimeError(
                f"at-size refined grid missed the 1e-8 oracle gate on "
                f"sampled voxels: max rel err {gate:.3e}")
        print(f"# gate: max rel err vs f64 oracle on {len(errs)} sampled "
              f"voxels = {gate:.2e} (< 1e-8)", flush=True)


if __name__ == "__main__":
    main()
