"""Scaling + collective-overlap measurements (BASELINE.json:5 gates).

Two measurements, printed as a markdown-ready summary:

1. **DP scaling shape** — fit_grid_sharded solves/s on 1/2/4/8 virtual CPU
   devices (the virtual mesh validates the scaling SHAPE — per-device
   efficiency vs the 1-device run.  Interconnect bandwidth does not matter
   here because the DP path has zero collectives: each device owns its
   voxel rows end-to-end; chip_smoke.py --cards 4 runs it on four cards).
2. **Collective overlap probe** — refine_grid_timesharded on a
   ('data' x 'time') mesh versus the identical per-shard compute with the
   psum REMOVED (refine on the local time chunk only).  The difference is
   the un-hidden collective cost; BASELINE.json:5 requires the exchange to
   be overlapped with compute.

Run on CPU: python tools/scaling_bench.py
"""
from __future__ import annotations

import os
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jax import shard_map  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from llckbdm_tpu.oracle.reference import sample_signal  # noqa: E402
from llckbdm_tpu.ops.cplx import CArr  # noqa: E402
from llckbdm_tpu.parallel.grid import (fit_grid_sharded,  # noqa: E402
                                       refine_grid_timesharded)
from llckbdm_tpu.parallel.mesh import make_mesh  # noqa: E402
from llckbdm_tpu.pipeline.llckbdm import LlcKbdmConfig  # noqa: E402
from llckbdm_tpu.signals import LineList  # noqa: E402
from llckbdm_tpu.solver.kbdm import KbdmConfig  # noqa: E402
from llckbdm_tpu.solver.refine import RefineConfig, refine_lines  # noqa: E402
from llckbdm_tpu.utils import df as D  # noqa: E402
from llckbdm_tpu.utils.df import DF, DFC  # noqa: E402


def timeit(fn, *args, reps=3):
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def make_grid(v, n, dwell):
    rng = np.random.default_rng(0)
    base = np.array([[1.0, 0.05, -120.0, 0.1], [0.8, 0.08, -40.0, 0.0],
                     [1.2, 0.03, 15.0, -0.2]])
    sigs = np.empty((v, n), np.complex128)
    for i in range(v):
        p = base.copy()
        p[:, 2] += rng.normal(scale=2.0, size=3)
        sigs[i] = sample_signal(p, n, dwell)
    return sigs


def dp_scaling(v=16, n=256, dwell=5e-4):
    cfg = LlcKbdmConfig(m_values=(64, 80, 96), eps=5e-4,
                        min_samples=4, max_clusters=8,
                        kbdm=KbdmConfig(p=8))
    sigs = make_grid(v, n, dwell)
    c = CArr(jnp.asarray(sigs.real, jnp.float32),
             jnp.asarray(sigs.imag, jnp.float32))
    print("| devices | time (ms) | solves/s | wall vs 1-dev | collectives |")
    print("|---|---|---|---|---|")
    t1 = None
    rows = []
    for nd in (1, 2, 4, 8):
        mesh = make_mesh({"data": nd}, devices=jax.devices()[:nd])
        # collective count in the compiled DP program: the voxel-DP path
        # must be embarrassingly parallel (zero inter-device collectives),
        # which is the property that DOES transfer to real cards — virtual
        # CPU devices share physical cores, so wall-clock here is expected
        # ~flat and says nothing about scaling on cards.  ONE compile per
        # device count: the compiled object is inspected AND timed.
        from llckbdm_tpu.parallel import grid as _grid
        cc = _grid._device_put_sharded(c, mesh)
        compiled = _grid._fit_grid_sharded_jit(dwell, cfg, mesh) \
            .lower(cc).compile()
        hlo = compiled.as_text()
        ncoll = sum(hlo.count(op) for op in
                    ("all-reduce", "all-gather", "reduce-scatter",
                     "collective-permute", "all-to-all"))
        t = timeit(lambda x: compiled(x), cc)
        t1 = t1 or t
        print(f"| {nd} | {t*1e3:8.1f} | {v/t:8.1f} | {t/t1:.2f}x | {ncoll} |",
              flush=True)
        rows.append({"devices": nd, "collectives": ncoll,
                     "virtual_mesh_ms_NOT_TRANSFERABLE": round(t * 1e3, 1)})
    return rows


def overlap_probe(v=16, n=256, dwell=5e-4):
    """Time-sharded refine WITH psum vs identical compute WITHOUT it."""
    cfg = LlcKbdmConfig(m_values=(64, 96, 128), eps=5e-4, min_samples=2,
                        max_clusters=8, kbdm=KbdmConfig(p=8))
    # 2 GN iterations: enough to contain the inter-iteration psum structure
    # being probed, while keeping the (unrolled-loop) CPU compile tractable
    # — a probe at iters=3 did not finish a 10-min budget.
    rcfg = RefineConfig(iters=2)
    sigs = make_grid(v, n, dwell)
    mesh = make_mesh({"data": 4, "time": 2})
    c32 = CArr(jnp.asarray(sigs.real, jnp.float32),
               jnp.asarray(sigs.imag, jnp.float32))
    cons, _, _, _ = fit_grid_sharded(c32, dwell, cfg, mesh)
    cdf = D.dfc_from_np(sigs)
    sh = NamedSharding(mesh, P("data", "time"))
    cdf = jax.tree.map(lambda x: jax.device_put(x, sh), cdf)

    t_psum = timeit(
        lambda s, l: refine_grid_timesharded(s, l, dwell, mesh, rcfg),
        cdf, cons)

    # control: same shard_map, same local shapes/compute, NO psum (the
    # result is numerically meaningless — it only measures compute time)
    chunk = n // mesh.shape["time"]

    def local_nopsum(c_loc, lines_loc):
        t0 = chunk * jax.lax.axis_index("time")
        return refine_lines(c_loc, lines_loc, dwell, rcfg,
                            axis_name=None, t_offset=t0)

    spec_c = DFC(DF(P("data", "time"), P("data", "time")),
                 DF(P("data", "time"), P("data", "time")))
    spec_lines = LineList(*([P("data", None)] * 5))
    out_line = LineList(*([P("data", None)] * 5))
    from llckbdm_tpu.solver.refine import RefinedLines
    out_spec = RefinedLines(
        z=DFC(DF(P("data", None), P("data", None)),
              DF(P("data", None), P("data", None))),
        d=DFC(DF(P("data", None), P("data", None)),
              DF(P("data", None), P("data", None))),
        mask=P("data", None), lines=out_line, gn_step=P("data", None))
    fn = jax.jit(shard_map(local_nopsum, mesh=mesh,
                           in_specs=(spec_c, spec_lines),
                           out_specs=out_spec, check_vma=False))
    t_nopsum = timeit(fn, cdf, cons)

    hidden = max(0.0, 1.0 - (t_psum - t_nopsum) / t_psum)
    print(f"\ntime-sharded refine (4x2 mesh, V={v}, N={n}, "
          f"iters={rcfg.iters}):")
    print(f"  with psum exchange : {t_psum*1e3:8.2f} ms")
    print(f"  compute only       : {t_nopsum*1e3:8.2f} ms")
    print(f"  un-hidden collective cost: {(t_psum-t_nopsum)*1e3:.2f} ms "
          f"({(t_psum-t_nopsum)/t_psum*100:.1f}% of total; "
          f"overlap/hide factor {hidden*100:.1f}%)")
    return {"with_psum_ms": round(t_psum * 1e3, 2),
            "compute_only_ms": round(t_nopsum * 1e3, 2),
            "unhidden_ms": round((t_psum - t_nopsum) * 1e3, 2),
            "hidden_fraction": round(hidden, 3)}


if __name__ == "__main__":
    import json
    print(f"# devices: {len(jax.devices())} x {jax.devices()[0].platform}")
    dp = dp_scaling()
    ov = overlap_probe()
    out = {"backend": jax.devices()[0].platform,
           "n_devices": len(jax.devices()),
           "note": ("VIRTUAL cpu devices share physical cores: only "
                    "the collective counts and overlap STRUCTURE transfer "
                    "to cards; every wall-clock field here is "
                    "virtual-mesh noise and must not be read as scaling"),
           "dp_scaling": dp, "overlap_probe": ov}
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "results", "scaling.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"# wrote {path}")
