"""Sharded MRSI voxel-grid fitting (BASELINE configs 4-5).

Three entry points, increasing in scale:

* :func:`fit_grid`            — single-device, vmapped over the voxel axis
                                (config 4 on one chip).
* :func:`fit_grid_sharded`    — voxel rows partitioned over the mesh 'data'
                                axis with NamedSharding + jit; XLA runs each
                                shard independently (embarrassingly parallel —
                                zero collectives on the hot path).
                                Config 5's 256x256 grid path.
* :func:`refine_grid_timesharded` — the Gauss-Newton refinement with the
                                signal TIME axis additionally split over the
                                'time' mesh axis inside shard_map: the normal
                                matrix / amplitude-RHS partial sums are
                                exchanged via one fused psum (the rhs keeps
                                its double-float (hi, lo) split through the
                                reduction) (BASELINE.json:5 "amplitude
                                right-hand-side halos exchanged via
                                collectives overlapped with the eigensolve"
                                — XLA's latency-hiding scheduler overlaps
                                the psum with the independent per-voxel
                                solves).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.cplx import CArr
from ..platform import force_platform, platform
from ..pipeline.llckbdm import ClusterStats, LlcKbdmConfig, llc_kbdm_fit
from ..signals import LineList
from ..solver.refine import RefineConfig, RefinedLines, refine_lines
from ..utils import df as D
from ..utils.df import DF, DFC


# All jitted entry points below are lru_cached on their static arguments:
# a fresh jax.jit(functools.partial(...)) per call would RETRACE AND
# RECOMPILE on every invocation (jit caches on callable identity) — a
# scaling benchmark once spent >10 min of CPU on exactly that.


@functools.lru_cache(maxsize=64)
def _fit_grid_jit(dwell: float, cfg: LlcKbdmConfig, plat: str):
    # platform in the key + pinned during tracing (see llckbdm_tpu.platform)
    def traced(c):
        with force_platform(plat):
            return llc_kbdm_fit(c, dwell, cfg)
    return jax.jit(traced)


def fit_grid(c: CArr, dwell: float, cfg: LlcKbdmConfig):
    """Jitted LL-KBDM over a voxel batch c (..., N) on the local device."""
    return _fit_grid_jit(dwell, cfg, platform())(c)


@functools.lru_cache(maxsize=64)
def _refine_jit(dwell: float, cfg: RefineConfig, plat: str):
    def traced(c: DFC, lines: LineList) -> RefinedLines:
        with force_platform(plat):
            return refine_lines(c, lines, dwell, cfg)
    return jax.jit(traced)


def refine_grid(c: DFC, lines: LineList, dwell: float,
                cfg: RefineConfig = RefineConfig()) -> RefinedLines:
    """Jitted double-float GN refinement over a voxel batch on the local
    device (the gate-meeting stage; used per-shard by parallel.checkpoint
    when the runner is configured with a RefineConfig)."""
    return _refine_jit(dwell, cfg, platform())(c, lines)


def _mesh_platform(mesh: Mesh) -> str:
    """Trace-time platform for computations placed on this mesh's devices
    (which may differ from the process default — e.g. a CPU mesh in a
    GPU-visible process)."""
    return mesh.devices.flat[0].platform


def _device_put_sharded(c: CArr, mesh: Mesh) -> CArr:
    sh = NamedSharding(mesh, P("data"))
    return CArr(jax.device_put(c.re, sh), jax.device_put(c.im, sh))


@functools.lru_cache(maxsize=64)
def _fit_grid_sharded_jit(dwell: float, cfg: LlcKbdmConfig, mesh: Mesh):
    # shard_map, not jit+out_shardings: under plain jit the SPMD
    # partitioner implemented the per-voxel lax.top_k (cluster compaction)
    # by ALL-GATHERING the whole batch's keys to every device and sorting
    # them replicated — 3 collectives and duplicated work on what must be
    # an embarrassingly parallel path.  shard_map makes every op local to
    # its voxel rows by construction; the compiled program has zero
    # collectives (asserted by tools/scaling_bench.py).
    row = P("data")
    spec_c = CArr(row, row)
    out_spec = (LineList(*([row] * 5)), LineList(*([row] * 5)),
                row, ClusterStats(*([row] * 4)))

    plat = _mesh_platform(mesh)

    def local(c_loc: CArr):
        with force_platform(plat):
            return llc_kbdm_fit(c_loc, dwell, cfg)

    return jax.jit(shard_map(local, mesh=mesh, in_specs=(spec_c,),
                             out_specs=out_spec, check_vma=False))


def fit_grid_sharded(c: CArr, dwell: float, cfg: LlcKbdmConfig, mesh: Mesh):
    """LL-KBDM over a (V, N) voxel batch row-partitioned over mesh['data'].

    V must be divisible by the 'data' axis size.  Returns (consolidated,
    pooled, counts, stats) with the same row partitioning (results stay
    sharded — gather with jax.device_get only what you need).
    """
    v = c.re.shape[0]
    ndata = mesh.shape["data"]
    if v % ndata:
        raise ValueError(f"voxel count {v} not divisible by data={ndata}")
    c = _device_put_sharded(c, mesh)
    return _fit_grid_sharded_jit(dwell, cfg, mesh)(c)


@functools.lru_cache(maxsize=64)
def _refine_timesharded_jit(dwell: float, mesh: Mesh, cfg: RefineConfig,
                            chunk: int):
    plat = _mesh_platform(mesh)

    def local(c_loc: DFC, lines_loc: LineList) -> RefinedLines:
        t0 = chunk * jax.lax.axis_index("time")
        with force_platform(plat):
            return refine_lines(c_loc, lines_loc, dwell, cfg,
                                axis_name="time", t_offset=t0)

    spec_c = DFC(DF(P("data", "time"), P("data", "time")),
                 DF(P("data", "time"), P("data", "time")))
    spec_lines = LineList(*([P("data", None)] * 5))
    out_line = LineList(*([P("data", None)] * 5))
    out_spec = RefinedLines(
        z=DFC(DF(P("data", None), P("data", None)),
              DF(P("data", None), P("data", None))),
        d=DFC(DF(P("data", None), P("data", None)),
              DF(P("data", None), P("data", None))),
        mask=P("data", None),
        lines=out_line,
        gn_step=P("data", None),
    )
    fn = shard_map(local, mesh=mesh, in_specs=(spec_c, spec_lines),
                   out_specs=out_spec, check_vma=False)
    return jax.jit(fn)


def refine_grid_timesharded(c: DFC, lines: LineList, dwell: float,
                            mesh: Mesh,
                            cfg: RefineConfig = RefineConfig()) -> RefinedLines:
    """Refine a sharded grid's line lists with the time axis split over
    mesh['time'] and voxels over mesh['data'].

    c     : DFC (V, N) double-float signals; N divisible by the 'time' axis.
    lines : LineList (V, C) initial values (e.g. fit_grid_sharded output).
    Returns RefinedLines (V, C), row-partitioned over 'data', replicated
    over 'time'.
    """
    v, n = c.re.hi.shape
    ntime = mesh.shape["time"]
    if n % ntime:
        raise ValueError(f"signal length {n} not divisible by time={ntime}")
    chunk = n // ntime
    return _refine_timesharded_jit(dwell, mesh, cfg, chunk)(c, lines)


def fit_and_refine_grid(c_np: np.ndarray, dwell: float,
                        cfg: LlcKbdmConfig, mesh: Mesh,
                        refine_cfg: RefineConfig = RefineConfig()):
    """Full config-5 step: sharded LL-KBDM fit + time-sharded refinement.

    c_np : (V, N) complex128 host array of voxel signals.
    Returns (refined: RefinedLines (V, C), counts (V, C)).
    """
    c32 = CArr(jnp.asarray(c_np.real, jnp.float32),
               jnp.asarray(c_np.imag, jnp.float32))
    cons, _pooled, counts, _stats = fit_grid_sharded(c32, dwell, cfg, mesh)
    c_df = D.dfc_from_np(c_np)
    sh = NamedSharding(mesh, P("data", "time"))
    c_df = jax.tree.map(lambda x: jax.device_put(x, sh), c_df)
    refined = refine_grid_timesharded(c_df, cons, dwell, mesh, refine_cfg)
    return refined, counts
