"""Multi-device tests on the 8-virtual-device CPU mesh (SURVEY.md §4c).

Covers the T2 layer end-to-end without real pod hardware: sharded-vs-local
equality, time-shard invariance of the refinement collectives, and
GridRunner checkpoint/resume semantics.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from llckbdm_tpu.ops.cplx import CArr
from llckbdm_tpu.oracle import reference as oracle
from llckbdm_tpu.parallel.checkpoint import GridRunner, shard_manifest
from llckbdm_tpu.parallel.grid import (fit_and_refine_grid, fit_grid,
                                       fit_grid_sharded,
                                       refine_grid_timesharded)
from llckbdm_tpu.parallel.mesh import make_mesh
from llckbdm_tpu.pipeline.llckbdm import LlcKbdmConfig
from llckbdm_tpu.signals import LineList
from llckbdm_tpu.solver.kbdm import KbdmConfig
from llckbdm_tpu.solver.refine import RefineConfig, refine_lines
from llckbdm_tpu.utils import df as D


CFG = LlcKbdmConfig(
    m_values=(16, 24, 32), eps=5e-3, min_samples=2, max_clusters=4,
    kbdm=KbdmConfig(p=4, oversample=4, subspace_iters=1,
                    eig_sweeps=6))


@pytest.fixture(scope="module")
def grid_truth():
    """Per-voxel ground-truth line lists: 2 lines with per-voxel jitter."""
    rng = np.random.default_rng(7)
    base = np.array([[1.0, 0.05, -60.0, 0.2], [0.7, 0.08, 45.0, -0.4]])
    truths = []
    for _ in range(8):
        p = base.copy()
        p[:, 2] += rng.normal(scale=1.0, size=2)
        truths.append(p)
    return np.stack(truths)


@pytest.fixture(scope="module")
def grid_signals(grid_truth):
    """8 voxels of 2-line signals sampled from grid_truth."""
    sigs = np.empty((8, 64), np.complex128)
    for i in range(8):
        sigs[i] = oracle.sample_signal(grid_truth[i], 64, 5e-4)
    return sigs


def _to_carr(sigs):
    return CArr(jnp.asarray(sigs.real, jnp.float32),
                jnp.asarray(sigs.imag, jnp.float32))


def test_fit_grid_sharded_matches_local(grid_signals):
    """Row-partitioned DP fit == single-device vmapped fit.

    Not bit-for-bit: the sharded program is a different XLA compilation
    (different fusion/reassociation), so f32 rounding differs at ~1e-6;
    the cluster structure (counts, masks) must agree exactly.
    """
    mesh = make_mesh({"data": 8})
    local_cons, _, local_counts, _ = fit_grid(_to_carr(grid_signals), 5e-4, CFG)
    shard_cons, _, shard_counts, _ = fit_grid_sharded(
        _to_carr(grid_signals), 5e-4, CFG, mesh)
    for a, b in zip(local_cons, shard_cons):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(local_counts),
                                  np.asarray(shard_counts))
    np.testing.assert_array_equal(np.asarray(local_cons.mask),
                                  np.asarray(shard_cons.mask))


def test_refine_timesharded_matches_single_device(grid_signals):
    """Splitting the time axis over the mesh must not change the refined
    poles beyond double-float roundoff (the psum partial sums are f32, so
    allow a tight-but-nonzero tolerance)."""
    mesh = make_mesh({"data": 4, "time": 2})
    cons, _, _, _ = fit_grid(_to_carr(grid_signals), 5e-4, CFG)
    c_df = D.dfc_from_np(grid_signals)
    rcfg = RefineConfig(iters=3)

    single = refine_lines(c_df, cons, 5e-4, rcfg)
    sharded = refine_grid_timesharded(c_df, cons, 5e-4, mesh, rcfg)

    # Fixed points agree to the level set by the f32 psum partial-sum
    # rounding in G / rhs (measured ~4e-10 on z, ~4e-9 on d); the 1e-8
    # relative pole gate needs z to ~1e-8, so 5e-9/5e-8 is a real check.
    np.testing.assert_allclose(D.dfc_to_np(sharded.z), D.dfc_to_np(single.z),
                               rtol=0, atol=5e-9)
    np.testing.assert_allclose(D.dfc_to_np(sharded.d), D.dfc_to_np(single.d),
                               rtol=0, atol=5e-8)


def test_fit_and_refine_grid_full_step(grid_signals):
    """The full config-5 step (the dryrun_multichip path) on the mesh."""
    mesh = make_mesh({"data": 4, "time": 2})
    refined, counts = fit_and_refine_grid(
        grid_signals, 5e-4, CFG, mesh, RefineConfig(iters=2))
    assert refined.lines.amplitude.shape == (8, CFG.max_clusters)
    assert counts.shape == (8, CFG.max_clusters)
    # every voxel recovers its 2 genuine lines
    mask = np.asarray(refined.mask) > 0.5
    assert (mask.sum(axis=1) >= 2).all()


def test_refine_hits_oracle_gate_through_mesh(grid_signals, grid_truth):
    """1e-8 gate THROUGH the sharded path (BASELINE.json:5 couples the
    distributed pipeline with the accuracy gate).  For a noiseless 2-line
    signal the Gauss-Newton fixed point is the exact interpolant, so the
    refined lines must match the per-voxel ground truth itself."""
    mesh = make_mesh({"data": 4, "time": 2})
    refined, _ = fit_and_refine_grid(
        grid_signals, 5e-4, CFG, mesh, RefineConfig(iters=3))
    from llckbdm_tpu.solver.refine import refined_to_np
    for v in range(8):
        one = jax.tree.map(lambda x: x[v], refined)
        est = refined_to_np(one, 5e-4)
        truth = grid_truth[v]
        sel = oracle.match_lines(est, truth)
        err = oracle.line_errors(est[sel], truth)
        assert err.max() < 1e-8, f"voxel {v}: {err.max():.3e}\n{err}"


# ---------------------------------------------------------------------------
# GridRunner checkpoint/resume
# ---------------------------------------------------------------------------

def test_shard_manifest_round_robin():
    all_shards = shard_manifest(10, 3)
    assert all_shards == [(0, 3), (3, 6), (6, 9), (9, 10)]
    p0 = shard_manifest(10, 3, process_index=0, num_processes=2)
    p1 = shard_manifest(10, 3, process_index=1, num_processes=2)
    assert sorted(p0 + p1) == all_shards


def test_gridrunner_resume_skips_completed(grid_signals, tmp_path):
    r1 = GridRunner(tmp_path, 5e-4, CFG, shard_size=4)
    assert r1.run(grid_signals) == 2          # 8 voxels / 4 per shard
    # resume: everything already on disk
    r2 = GridRunner(tmp_path, 5e-4, CFG, shard_size=4)
    assert r2.run(grid_signals) == 0
    out = r2.gather(8)
    assert out["amplitude"].shape == (8, CFG.max_clusters)
    # results match a direct grid fit
    cons, _, _, _ = fit_grid(_to_carr(grid_signals), 5e-4, CFG)
    np.testing.assert_array_equal(out["amplitude"], np.asarray(cons.amplitude))


def test_gridrunner_refined_stores_gate_meeting_lines(grid_signals,
                                                      grid_truth, tmp_path):
    """GridRunner with a RefineConfig runs the gate-meeting pipeline
    per shard and stores the double-float results (round-4 review next #3:
    the at-size config-5 path must be the refined one).  Noiseless 2-line
    voxels: the stored refined lines must match ground truth to 1e-8."""
    r = GridRunner(tmp_path, 5e-4, CFG, shard_size=4,
                   refine=RefineConfig(iters=3), refine_clusters=4)
    assert r.run(grid_signals) == 2
    out = r.gather(8)
    assert out["refined_z"].shape == (8, 4)
    assert out["refined_z"].dtype == np.complex128
    for v in range(8):
        z, d = out["refined_z"][v], out["refined_d"][v]
        keep = out["refined_mask"][v] > 0.5
        z, d = z[keep], d[keep]
        freq = np.angle(z) / (2.0 * np.pi * 5e-4)
        t2 = -5e-4 / np.log(np.abs(z))
        est = np.stack([np.abs(d), t2, freq, np.angle(d)], axis=1)
        est = est[np.argsort(est[:, 2])]
        sel = oracle.match_lines(est, grid_truth[v])
        err = oracle.line_errors(est[sel], grid_truth[v])
        assert err.max() < 1e-8, f"voxel {v}: {err.max():.3e}"
    # a refined runner's fingerprint differs from the f32-only one
    with pytest.raises(ValueError, match="config mismatch"):
        GridRunner(tmp_path, 5e-4, CFG, shard_size=4)


def test_gridrunner_rejects_config_mismatch(grid_signals, tmp_path):
    GridRunner(tmp_path, 5e-4, CFG, shard_size=4)
    import dataclasses
    other = dataclasses.replace(CFG, eps=1e-2)
    with pytest.raises(ValueError, match="config mismatch"):
        GridRunner(tmp_path, 5e-4, other, shard_size=4)
    # changing a NESTED kbdm knob must also be caught (full fingerprint)
    other2 = dataclasses.replace(
        CFG, kbdm=dataclasses.replace(CFG.kbdm, eig_sweeps=99))
    with pytest.raises(ValueError, match="config mismatch"):
        GridRunner(tmp_path, 5e-4, other2, shard_size=4)


def test_gridrunner_rejects_different_data(grid_signals, tmp_path):
    r = GridRunner(tmp_path, 5e-4, CFG, shard_size=4)
    r.run(grid_signals)
    other = grid_signals + 1e-3
    r2 = GridRunner(tmp_path, 5e-4, CFG, shard_size=4)
    with pytest.raises(ValueError, match="data mismatch"):
        r2.run(other)


def test_gridrunner_gather_incomplete_raises(grid_signals, tmp_path):
    r = GridRunner(tmp_path, 5e-4, CFG, shard_size=4,
                   process_index=0, num_processes=2)
    r.run(grid_signals)                        # only process 0's shard
    with pytest.raises(FileNotFoundError, match="missing shards"):
        r.gather(8)
