"""LL-KBDM pipeline: m-sweep -> pool -> cluster -> consolidate (-> refine).

Oracle counterpart: oracle.reference.llc_kbdm.  Fully on-device, fixed
shapes, vmappable over voxel batches (BASELINE configs 3-5).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.cplx import CArr
from ..ops.dbscan import compact_labels, dbscan, dbscan_1d, masked_median
from ..platform import force_platform, platform
from ..signals import LineList
from ..solver.kbdm import KbdmConfig, kbdm_sweep

# f32 HIGHEST: on the GPU a default-precision f32 einsum may run in TF32,
# and E[x^2] - mean^2 cancels.
_es = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


class ClusterStats(NamedTuple):
    """Per-cluster dispersion of the pooled lines (SURVEY.md §2 'cluster
    consolidation ... counts/std').  Shapes (..., C); 0 for empty slots."""

    amplitude: jax.Array   # std of A over cluster members
    t2: jax.Array          # std of T2
    frequency: jax.Array   # std of f
    phase: jax.Array       # CIRCULAR std of phase: sqrt(-2 ln R)


@dataclass(frozen=True)
class LlcKbdmConfig:
    """LL-KBDM configuration (kwargs parity: m_range via `m_values`, eps,
    min_samples — oracle.reference.llc_kbdm)."""

    m_values: tuple = tuple(range(120, 257, 4))
    eps: float = 2e-4
    min_samples: int = 20
    damping_weight: float = 0.0   # weight of the dwell/T2 clustering feature
    max_clusters: int = 32        # consolidated line capacity C
    kbdm: KbdmConfig = field(default_factory=KbdmConfig)


def transform_line_lists(lines: LineList, dwell: float,
                         damping_weight: float = 0.0) -> jax.Array:
    """Clustering feature space — must match oracle transform_line_lists:
    x0 = f * dwell, x1 = damping_weight * dwell / T2."""
    x0 = lines.frequency * np.float32(dwell)
    x1 = np.float32(damping_weight) * np.float32(dwell) / \
        jnp.maximum(lines.t2, 1e-9)
    return jnp.stack([x0, x1], axis=-1)


def _masked_std(values: jax.Array, member: jax.Array) -> jax.Array:
    """Population std of values[i] over member[:, c] > 0, per cluster c."""
    cnt = jnp.sum(member, axis=0)
    safe = jnp.maximum(cnt, 1.0)
    mean = _es("nc,n->c", member, values) / safe
    var = _es("nc,n->c", member, values * values) / safe - mean ** 2
    return jnp.where(cnt > 0, jnp.sqrt(jnp.maximum(var, 0.0)), 0.0)


def _consolidate_one(pool: LineList, member: jax.Array):
    """Median consolidation of one voxel's pooled lines.

    pool   : LineList with flat (n,) fields
    member : (n, C) one-hot cluster membership
    Matches oracle.reference.llc_kbdm consolidation: component-wise medians,
    phase from the medians of Re(d), Im(d), d = A e^{i phase}.  Also returns
    per-cluster dispersion (ClusterStats).
    """
    amp = masked_median(pool.amplitude, member)
    t2 = masked_median(pool.t2, member)
    freq = masked_median(pool.frequency, member)
    d_re = pool.amplitude * jnp.cos(pool.phase)
    d_im = pool.amplitude * jnp.sin(pool.phase)
    med_re = masked_median(d_re, member)
    med_im = masked_median(d_im, member)
    phase = jnp.arctan2(med_im, med_re)
    counts = jnp.sum(member, axis=0)
    mask = (counts > 0).astype(pool.amplitude.dtype)

    safe = jnp.maximum(counts, 1.0)
    cbar = _es("nc,n->c", member, jnp.cos(pool.phase)) / safe
    sbar = _es("nc,n->c", member, jnp.sin(pool.phase)) / safe
    r = jnp.minimum(jnp.hypot(cbar, sbar), 1.0)
    circ_std = jnp.sqrt(jnp.maximum(-2.0 * jnp.log(jnp.maximum(r, 1e-9)),
                                    0.0))
    stats = ClusterStats(amplitude=_masked_std(pool.amplitude, member),
                         t2=_masked_std(pool.t2, member),
                         frequency=_masked_std(pool.frequency, member),
                         phase=jnp.where(counts > 0, circ_std, 0.0))
    lines = LineList(amplitude=amp * mask, t2=jnp.where(mask > 0, t2, 1.0),
                     frequency=freq * mask, phase=phase * mask, mask=mask)
    return lines, stats


def llc_kbdm_fit(c: CArr, dwell: float, cfg: LlcKbdmConfig):
    """Full LL-KBDM fit: c (..., N) -> (consolidated, pooled, counts, stats).

    consolidated : LineList (..., C) sorted deterministically by cluster size
    pooled       : LineList (..., S*p) all sweep lines (mask = validity)
    counts       : (..., C) cluster member counts
    stats        : ClusterStats (..., C) per-cluster std of (A, T2, f) and
                   circular std of phase
    """
    sweep = kbdm_sweep(c, dwell, cfg.m_values, cfg.kbdm)   # (..., S, p)
    flat = LineList(*(x.reshape(*x.shape[:-2], -1) for x in sweep))

    feats = transform_line_lists(flat, dwell, cfg.damping_weight)
    valid = flat.mask > 0.5

    # With the default 1-D feature space (damping_weight == 0) the sorted
    # O(n log n) dbscan_1d replaces the O(n^2) matrix kernel.  Semantics
    # are identical in general position (label-exact, tested); the kernels
    # can only differ on pairs whose distance is EXACTLY eps after rounding
    # (see ops.dbscan.dbscan_1d).
    use_1d = cfg.damping_weight == 0.0

    def one_voxel(feats_v, valid_v, pool_v):
        if use_1d:
            labels = dbscan_1d(feats_v[..., 0], valid_v,
                               cfg.eps, cfg.min_samples)
        else:
            labels = dbscan(feats_v, valid_v, cfg.eps, cfg.min_samples)
        member, counts = compact_labels(labels, cfg.max_clusters)
        cons, stats = _consolidate_one(pool_v, member)
        return cons, counts, stats

    batch_shape = flat.amplitude.shape[:-1]
    fn = one_voxel
    for _ in range(len(batch_shape)):
        fn = jax.vmap(fn)
    cons, counts, stats = fn(feats, valid, flat)
    return cons, flat, counts, stats


@functools.lru_cache(maxsize=64)
def _llc_kbdm_jit(dwell: float, cfg: LlcKbdmConfig, plat: str):
    # the platform is part of the cache key AND pinned during tracing: the
    # trace-time branch (the eigensolver kernel) must match the devices this
    # compiled function runs on even if the process default changes later.
    def traced(c):
        with force_platform(plat):
            return llc_kbdm_fit(c, dwell, cfg)
    return jax.jit(traced)


def llc_kbdm(data: np.ndarray, dwell: float, m_range, p: int = 24,
             eps: float = 2e-4, min_samples: int = 20, *,
             damping_weight: float = 0.0, max_clusters: int = 32,
             refine_iters: int = 0):
    """NumPy-in / NumPy-out convenience entry point — signature parity
    with the reference's ``llc_kbdm(data, dwell, m_range, p, eps,
    min_samples)`` (oracle counterpart: oracle.reference.llc_kbdm).

    data : (N,) or (V, N) complex time-domain signal(s).
    refine_iters > 0 additionally runs the double-float Gauss-Newton
    polish (the stage that meets the 1e-8 oracle gate).

    Returns (consolidated, pooled, counts):
      consolidated : (k, 4) [or list of per-voxel (k_v, 4)] float64 rows of
                     (A, T2, f, phase), valid clusters only, sorted by f;
      pooled       : same layout for ALL pooled sweep lines;
      counts       : (C,) [or (V, C)] member counts per cluster slot.
    """
    from ..ops.cplx import CArr
    from ..signals import line_list_to_np

    data = np.asarray(data, np.complex128)
    single = data.ndim == 1
    batch = data[None] if single else data
    cfg = LlcKbdmConfig(m_values=tuple(int(m) for m in m_range), eps=eps,
                        min_samples=min_samples, max_clusters=max_clusters,
                        damping_weight=damping_weight,
                        kbdm=KbdmConfig(p=p))
    c = CArr(jnp.asarray(batch.real, jnp.float32),
             jnp.asarray(batch.imag, jnp.float32))
    cons, pooled, counts, _stats = _llc_kbdm_jit(dwell, cfg, platform())(c)

    if refine_iters > 0:
        from ..solver.refine import RefineConfig, refine_lines, refined_to_np
        from ..utils import df as D
        ref = refine_lines(D.dfc_from_np(batch), cons, dwell,
                           RefineConfig(iters=refine_iters))
        cons_np = [refined_to_np(jax.tree.map(lambda x: x[i], ref), dwell)
                   for i in range(batch.shape[0])]
    else:
        cons_np = [line_list_to_np(jax.tree.map(lambda x: x[i], cons))
                   for i in range(batch.shape[0])]
    pooled_np = [line_list_to_np(jax.tree.map(lambda x: x[i], pooled))
                 for i in range(batch.shape[0])]
    counts_np = np.asarray(counts)
    if single:
        return cons_np[0], pooled_np[0], counts_np[0]
    return cons_np, pooled_np, counts_np
