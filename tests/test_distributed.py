"""Two-process jax.distributed smoke test (SURVEY.md §4c).

Spawns TWO real OS processes that each call
``parallel.mesh.distributed_init`` (jax.distributed.initialize with a
shared coordinator) and then run a concurrent ``GridRunner`` over ONE
out_dir — exercising the multi-process paths that single-process tests
cannot: the coordinator handshake, global process/device counts, and the
O_EXCL manifest/data-fingerprint protocol under genuine inter-process
concurrency.  Process 0's gather() must equal the single-process result.
"""
import pathlib
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import os, sys
sys.path.insert(0, os.getcwd())   # repo root (the script lives in /tmp)
pid, port, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")

from llckbdm_tpu.parallel.mesh import distributed_init
distributed_init(coordinator=f"localhost:{port}", num_processes=2,
                 process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 4, jax.devices()       # 2 local x 2 processes
assert len(jax.local_devices()) == 2

import numpy as np
from llckbdm_tpu.parallel.checkpoint import GridRunner
from llckbdm_tpu.pipeline.llckbdm import LlcKbdmConfig
from llckbdm_tpu.solver.kbdm import KbdmConfig
from llckbdm_tpu.oracle.reference import sample_signal

cfg = LlcKbdmConfig(m_values=(16, 24), eps=5e-3, min_samples=2,
                    max_clusters=4,
                    kbdm=KbdmConfig(p=4, oversample=4, subspace_iters=1,
                                    eig_sweeps=6))
rng = np.random.default_rng(0)
sigs = np.stack([sample_signal(np.array([[1.0, 0.05, -40.0 + v, 0.1],
                                         [0.7, 0.08, 55.0, -0.2]]),
                               64, 1e-3)
                 for v in rng.normal(scale=2.0, size=16)])
runner = GridRunner(out_dir, 1e-3, cfg, shard_size=4,
                    process_index=pid, num_processes=2)
done = runner.run(sigs)
print(f"proc {pid}: {done} shards", flush=True)
"""


PSUM_WORKER = r"""
import os, sys
sys.path.insert(0, os.getcwd())   # repo root (the script lives in /tmp)
pid, port = int(sys.argv[1]), sys.argv[2]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")

from llckbdm_tpu.parallel.mesh import distributed_init
distributed_init(coordinator=f"localhost:{port}", num_processes=2,
                 process_id=pid)
assert jax.process_count() == 2 and jax.device_count() == 4

import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from llckbdm_tpu.ops.cplx import CArr
from llckbdm_tpu.oracle.reference import sample_signal
from llckbdm_tpu.parallel.grid import (_refine_timesharded_jit, fit_grid,
                                       refine_grid_timesharded)
from llckbdm_tpu.pipeline.llckbdm import LlcKbdmConfig
from llckbdm_tpu.solver.kbdm import KbdmConfig
from llckbdm_tpu.solver.refine import RefineConfig, refine_lines
from llckbdm_tpu.utils import df as D

# Mesh with the TIME axis crossing the process boundary: device grid
#   data 0: (proc0 dev, proc1 dev)      <- each time-pair spans processes
#   data 1: (proc0 dev, proc1 dev)
# so the refinement's normal-equation psum MUST run over the inter-process
# (gloo transport) path — the one collective in the framework, exercised
# across a real process boundary.
devs = sorted(jax.devices(), key=lambda d: d.id)
grid = np.array([[devs[0], devs[2]], [devs[1], devs[3]]])
assert all(len({d.process_index for d in row}) == 2 for d_row in [0, 1]
           for row in [grid[d_row]])
mesh = Mesh(grid, ("data", "time"))

dwell, n, v = 1e-3, 64, 8
cfg = LlcKbdmConfig(m_values=(16, 24), eps=5e-3, min_samples=2,
                    max_clusters=4,
                    kbdm=KbdmConfig(p=4, oversample=4, subspace_iters=1,
                                    eig_sweeps=6))
rcfg = RefineConfig(iters=2)
rng = np.random.default_rng(0)
sigs = np.stack([sample_signal(np.array([[1.0, 0.05, -40.0 + dv, 0.1],
                                         [0.7, 0.08, 55.0, -0.2]]),
                               n, dwell)
                 for dv in rng.normal(scale=2.0, size=v)])

# identical deterministic LOCAL fit on both processes seeds the refinement
c32 = CArr(jnp.asarray(sigs.real, jnp.float32),
           jnp.asarray(sigs.imag, jnp.float32))
cons, _, _, _ = fit_grid(c32, dwell, cfg)
cons_np = jax.tree.map(np.asarray, cons)


def mk(x_np, spec):
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x_np.shape, sh,
                                        lambda idx: np.asarray(x_np[idx]))


c_df_np = jax.tree.map(np.asarray, D.dfc_from_np(sigs))
c_glob = jax.tree.map(lambda x: mk(x, P("data", "time")), c_df_np)
lines_glob = jax.tree.map(lambda x: mk(x, P("data", None)), cons_np)

# the compiled program must contain the cross-shard psum (all-reduce)
chunk = n // mesh.shape["time"]
hlo = _refine_timesharded_jit(dwell, mesh, rcfg, chunk) \
    .lower(c_glob, lines_glob).compile().as_text()
assert "all-reduce" in hlo, "no all-reduce in compiled refine program"

refined = refine_grid_timesharded(c_glob, lines_glob, dwell, mesh, rcfg)


def to_np_global(arr):
    out = np.zeros(arr.shape, arr.dtype)
    seen = np.zeros(arr.shape, bool)
    for sh in arr.addressable_shards:
        out[sh.index] = np.asarray(sh.data)
        seen[sh.index] = True
    assert seen.all(), "process cannot address the full refined output"
    return out


z = (to_np_global(refined.z.re.hi).astype(np.float64)
     + to_np_global(refined.z.re.lo)) \
    + 1j * (to_np_global(refined.z.im.hi).astype(np.float64)
            + to_np_global(refined.z.im.lo))
d = (to_np_global(refined.d.re.hi).astype(np.float64)
     + to_np_global(refined.d.re.lo)) \
    + 1j * (to_np_global(refined.d.im.hi).astype(np.float64)
            + to_np_global(refined.d.im.lo))

# reference: single-device refinement of the same lines (no mesh)
single = refine_lines(D.dfc_from_np(sigs), cons, dwell, rcfg)
np.testing.assert_allclose(z, D.dfc_to_np(single.z), rtol=0, atol=5e-9)
np.testing.assert_allclose(d, D.dfc_to_np(single.d), rtol=0, atol=5e-8)
print(f"proc {pid}: PASS", flush=True)
"""


@pytest.mark.slow
def test_two_process_psum_refine(tmp_path):
    """The refinement normal-equation psum ACROSS a real process boundary
    (2 processes x 2 local CPU devices, 'time' split over processes) must
    agree with the single-process fixed point — the only collective in the
    framework, validated over the actual inter-process transport."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    worker = tmp_path / "psum_worker.py"
    worker.write_text(PSUM_WORKER)
    repo = pathlib.Path(__file__).parent.parent
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(port)],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=420)
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err}"
        assert "PASS" in out


@pytest.mark.slow
def test_two_process_distributed_gridrunner(tmp_path):
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    out_dir = tmp_path / "grid"
    repo = pathlib.Path(__file__).parent.parent

    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(port), str(out_dir)],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=420)
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err}"
    # each process computed exactly its round-robin half (4 shards total)
    assert sorted(int(o.split(": ")[1].split()[0])
                  for _, o, _ in outs) == [2, 2]

    # gather equals the single-process in-memory result
    from llckbdm_tpu.oracle.reference import sample_signal
    from llckbdm_tpu.ops.cplx import CArr
    from llckbdm_tpu.parallel.checkpoint import GridRunner
    from llckbdm_tpu.parallel.grid import fit_grid
    from llckbdm_tpu.pipeline.llckbdm import LlcKbdmConfig
    from llckbdm_tpu.solver.kbdm import KbdmConfig
    import jax.numpy as jnp

    cfg = LlcKbdmConfig(m_values=(16, 24), eps=5e-3, min_samples=2,
                        max_clusters=4,
                        kbdm=KbdmConfig(p=4, oversample=4, subspace_iters=1,
                                        eig_sweeps=6))
    rng = np.random.default_rng(0)
    sigs = np.stack([sample_signal(np.array([[1.0, 0.05, -40.0 + v, 0.1],
                                             [0.7, 0.08, 55.0, -0.2]]),
                                   64, 1e-3)
                     for v in rng.normal(scale=2.0, size=16)])
    runner = GridRunner(out_dir, 1e-3, cfg, shard_size=4)
    full = runner.gather(16)
    c = CArr(jnp.asarray(sigs.real, jnp.float32),
             jnp.asarray(sigs.imag, jnp.float32))
    cons, _, counts, _ = fit_grid(c, 1e-3, cfg)
    np.testing.assert_allclose(full["frequency"], np.asarray(cons.frequency),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(full["counts"], np.asarray(counts))
