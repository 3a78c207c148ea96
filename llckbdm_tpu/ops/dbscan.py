"""Fixed-shape, exact-semantics DBSCAN on device (oracle: sklearn DBSCAN).

SURVEY.md §7 hard part 5: the LL-KBDM consolidation step needs DBSCAN over
the pooled line lists (~S*p points per voxel) *inside* jit, with static
shapes, vmappable over the voxel batch.  The classical algorithm maps to:

  1. pairwise squared distances (O(n^2))
  2. neighbor counts -> core mask (count >= min_samples, self included —
     sklearn semantics)
  3. connected components of the core-core eps-graph via min-label
     propagation with pointer jumping (O(log n) sweeps of an O(n^2)
     masked min + an O(n) gather)
  4. border points adopt the minimum core-neighbor label (sklearn assigns
     the first-discovered core cluster, which is scan-order dependent;
     min-label is the deterministic equivalent — partitions of CORE points
     are identical, border assignment can differ only on genuine ties)
  5. noise -> label -1

Invalid inputs (mask == 0) are never neighbors and always labeled -1.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# plain numpy: a module-level jnp constant would initialize the XLA backend
# at import time (which breaks jax.distributed.initialize in workers that
# import the package before calling it)
_BIG = np.int32(2 ** 30)


def dbscan(feats: jax.Array, valid: jax.Array, eps: float,
           min_samples: int, max_iters: int = 24) -> jax.Array:
    """Label one point set.

    feats : (n, d) float features
    valid : (n,) bool
    Returns (n,) int32 labels: -1 noise / else the root point index of the
    cluster (stable, deterministic).  vmap over leading batch dims.

    max_iters bounds the label-propagation loop (propagation with pointer
    jumping converges in O(log n) rounds; 24 covers n up to ~2^24 — the
    bound exists so a vmapped while_loop can never hang).
    """
    n = feats.shape[0]
    d2 = jnp.sum((feats[:, None, :] - feats[None, :, :]) ** 2, axis=-1)
    pair = valid[:, None] & valid[None, :]
    adj = (d2 <= jnp.float32(eps) ** 2) & pair          # includes self
    ncount = jnp.sum(adj & valid[None, :], axis=1)
    core = valid & (ncount >= min_samples)

    cadj = adj & core[:, None] & core[None, :]
    idx = jnp.arange(n, dtype=jnp.int32)
    lab = jnp.where(core, idx, _BIG)

    def body(state):
        lab, _, it = state
        # min over core neighbors
        neigh = jnp.where(cadj, lab[None, :], _BIG)
        lab1 = jnp.minimum(lab, jnp.min(neigh, axis=1))
        # pointer jumping: follow root twice
        lab2 = jnp.minimum(lab1, lab1[jnp.clip(lab1, 0, n - 1)])
        lab2 = jnp.where(core, lab2, _BIG)
        changed = jnp.any(lab2 != lab)
        return lab2, changed, it + 1

    def cond(state):
        return state[1] & (state[2] < max_iters)

    lab, _, _ = jax.lax.while_loop(
        cond, body, (lab, jnp.bool_(True), jnp.int32(0)))

    # border points: valid, not core, adjacent to >= 1 core point
    border_neigh = jnp.where(adj & core[None, :], lab[None, :], _BIG)
    border_lab = jnp.min(border_neigh, axis=1)
    is_border = valid & (~core) & (border_lab < _BIG)

    out = jnp.where(core, lab, jnp.where(is_border, border_lab, -1))
    return out.astype(jnp.int32)


def dbscan_1d(x: jax.Array, valid: jax.Array, eps: float,
              min_samples: int) -> jax.Array:
    """Exact DBSCAN over 1-D features via sort + range counting — O(n log n).

    Replaces :func:`dbscan` on the pipeline hot path whenever the feature
    space is one-dimensional (damping_weight == 0, the default: the only
    clustering feature is f * dwell).  The O(n^2) adjacency matrix and its
    while_loop label propagation move O(n^2) bytes per voxel; this
    formulation needs one sort and a few O(n) passes.

    Identical semantics to :func:`dbscan` — up to float rounding at EXACT
    eps ties: the range counts here compare ``xs`` against the rounded sums
    ``xs ± eps`` (searchsorted), while :func:`dbscan` compares the rounded
    difference ``|x_i - x_j|`` against ``eps``; a pair whose distance is
    exactly eps can land on different sides of the threshold in the two
    kernels.  In general position (any real data; the tested pipelines) the
    labels are identical — fuzzing only produced divergence on inputs
    quantized so that |x_i - x_j| == eps exactly.
      * neighbor count  = #valid points within eps (self included)
      * core            = valid & count >= min_samples
      * clusters        = connected components of the core-core eps graph
                          (in 1-D: maximal runs of cores with consecutive
                          gaps <= eps)
      * border          = non-core valid point within eps of >= 1 core;
                          adopts the MINIMUM root label among its core
                          neighbors (deterministic min-label rule, see
                          module docstring item 4)
      * labels          = root point index (the cluster's minimum original
                          core index — matching :func:`dbscan`'s min-label
                          propagation fixed point), -1 for noise

    x : (n,) float; valid : (n,) bool.  vmap over leading batch dims.
    """
    n = x.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    big = jnp.float32(3.0e38)
    key = jnp.where(valid, x, big)            # invalid sort to the end
    order = jnp.argsort(key)
    xs = key[order]                           # ascending, invalid = big
    valid_s = valid[order]
    orig = order.astype(jnp.int32)            # sorted pos -> original index

    # neighbor counts within eps (self included): two binary-search passes.
    e = jnp.float32(eps)
    ub = jnp.searchsorted(xs, xs + e, side="right")
    lb = jnp.searchsorted(xs, xs - e, side="left")
    count = (ub - lb).astype(jnp.int32)       # garbage for invalid (masked)
    core_s = valid_s & (count >= min_samples)

    # components: a new segment starts at each core whose gap to the
    # previous core exceeds eps.  prev-core x via running max of core xs
    # (xs ascending, so the last core seen has the max x).
    core_x = jnp.where(core_s, xs, -big)
    prev_core_x = jnp.concatenate(
        [jnp.full((1,), -big, xs.dtype),
         jax.lax.cummax(core_x, axis=0)[:-1]])
    start = core_s & (xs - prev_core_x > e)

    # root label = min ORIGINAL index among the segment's cores (the fixed
    # point of dbscan()'s min-label propagation).  Segment-min via a
    # prefix scan keyed on segment ids.
    seg = jnp.cumsum(start.astype(jnp.int32)) - 1          # valid for cores
    core_orig = jnp.where(core_s, orig, _BIG)
    # prefix-min of core_orig restarting at each segment start:
    #   associative op on (seg_id, min): later element wins if new segment
    def comb(a, b):
        sa, ma = a
        sb, mb = b
        return sb, jnp.where(sa == sb, jnp.minimum(ma, mb), mb)
    _, seg_min_fwd = jax.lax.associative_scan(comb, (seg, core_orig))
    # the segment minimum lives at the segment's LAST core position; the
    # same scan over the reversed sequence propagates it back to every
    # member.
    _, seg_min = jax.lax.associative_scan(
        comb, (seg[::-1], seg_min_fwd[::-1]))
    root_s = seg_min[::-1]                                 # (n,) for cores

    lab_core = jnp.where(core_s, root_s, _BIG)

    # border points: nearest core on each side within eps; adopt the min
    # root among the (<= 2) adjacent core clusters.  (Any further core
    # within eps on a given side is itself within eps of the nearest core
    # on that side, hence in the same cluster — two candidates suffice.)
    pos = jnp.arange(n, dtype=jnp.int32)
    core_pos = jnp.where(core_s, pos, -1)
    left_pos = jax.lax.cummax(core_pos, axis=0)            # last core <= i
    # right side: run the same cummax in the reversed frame (rev index r
    # <-> forward index n-1-r), then map the result back.
    core_pos_rev = jnp.where(core_s[::-1], pos, -1)
    right_rev = jax.lax.cummax(core_pos_rev, axis=0)[::-1]
    right_pos = jnp.where(right_rev >= 0, (n - 1) - right_rev, -1)

    def side_root(p):
        ok = p >= 0
        pc = jnp.clip(p, 0, n - 1)
        near = ok & (jnp.abs(xs - xs[pc]) <= e)
        return jnp.where(near, lab_core[pc], _BIG)
    cand = jnp.minimum(side_root(left_pos), side_root(right_pos))
    is_border = valid_s & (~core_s) & (cand < _BIG)
    lab_s = jnp.where(core_s, lab_core,
                      jnp.where(is_border, cand, jnp.int32(-1)))

    # scatter back to original order
    out = jnp.zeros(n, jnp.int32).at[orig].set(lab_s.astype(jnp.int32))
    return out


def compact_labels(labels: jax.Array, max_clusters: int):
    """Map root-index labels to compact ids [0, C) by descending cluster size.

    labels : (n,) int32 from :func:`dbscan` (-1 = noise).
    Returns (membership, counts):
      membership : (n, C) float one-hot (0 for noise / clusters beyond C)
      counts     : (C,) int32 member counts (0 = unused slot)
    Clusters are ordered by (descending size, ascending root index) so the
    output is deterministic.

    A partial sort (top_k with k = C) picks the C largest clusters.
    """
    n = labels.shape[0]
    is_clustered = labels >= 0
    root_counts = jnp.zeros(n, jnp.int32).at[
        jnp.clip(labels, 0, n - 1)].add(is_clustered.astype(jnp.int32))
    # order roots: size desc, index asc
    order_key = root_counts * n - jnp.arange(n, dtype=jnp.int32)
    _, top_roots = jax.lax.top_k(order_key, max_clusters)
    top_counts = root_counts[top_roots]
    top_roots = jnp.where(top_counts > 0, top_roots, -2)  # never matches
    membership = (labels[:, None] == top_roots[None, :]).astype(jnp.float32)
    return membership, top_counts


def masked_median(values: jax.Array, member: jax.Array) -> jax.Array:
    """Median of values[i] over member[:, c] > 0, per cluster c.

    values : (n,)  member : (n, C) 0/1.  Returns (C,) — numpy-median
    semantics (average of the two middle order statistics for even counts);
    0.0 for empty clusters.

    Rank-selection, not sort: the within-cluster stable rank of every
    element is ONE (n, n) 0/1 matmul against the membership matrix, and
    the two middle order statistics are one-hot selected from it.  Exact:
    0/1 values and counts (<= n << 2^24) are exact in any matmul precision
    with an f32 accumulator.
    """
    n, c = member.shape
    idx = jnp.arange(n, dtype=jnp.int32)
    # "j orders strictly before i" with index tie-break (stable)
    before = ((values[None, :] < values[:, None])
              | ((values[None, :] == values[:, None])
                 & (idx[None, :] < idx[:, None]))).astype(jnp.float32)
    rank = jnp.matmul(before, member,
                      preferred_element_type=jnp.float32)    # (n, C)
    cnt = jnp.sum(member, axis=0)                            # (C,) float
    lo = jnp.floor(0.5 * (cnt - 1.0))
    hi = jnp.floor(0.5 * cnt)
    sel_lo = member * (rank == lo[None, :])
    sel_hi = member * (rank == hi[None, :])
    med = 0.5 * (jnp.einsum("n,nc->c", values, sel_lo,
                            precision=jax.lax.Precision.HIGHEST)
                 + jnp.einsum("n,nc->c", values, sel_hi,
                              precision=jax.lax.Precision.HIGHEST))
    return jnp.where(cnt > 0, med, 0.0)
