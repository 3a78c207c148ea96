"""The Triton eigensolver kernel in interpret mode, and the platform decision.

``interpret=True`` runs the kernel program on the CPU, so these tests check
the kernel's logic (masked row extraction, rotation, padding, blocking)
without a card; the compiled kernel is checked on the GPU by
tests/test_gpu.py and chip_smoke.py.  References: the lax.scan formulation
(ops.jacobi) and exactly known spectra.
"""
import threading

import numpy as np
import pytest
import scipy.linalg

import jax

from llckbdm_tpu import platform as plat
from llckbdm_tpu.ops import eig_kernel, jacobi
from llckbdm_tpu.ops.cplx import from_np, to_np


def _cs_matrices(rng, b, n, mix=None):
    """Complex-symmetric A = Q D Q^T (Q real orthogonal) with known,
    well-separated KBDM-like eigenvalues |mu| <~ 1 on a jittered frequency
    grid (near-degenerate pairs would test convergence, not the kernel).

    Q is Haar-random, or expm(mix * K) for a random skew K: complex-
    orthogonal Jacobi is not guaranteed to converge on dense random inputs,
    and at n=24 it does not in 10 sweeps."""
    grid = (np.arange(n) + rng.uniform(0.1, 0.9, (b, n))) / n * 0.8 - 0.4
    evals = np.exp(2j * np.pi * grid - rng.uniform(0.02, 0.3, (b, n)))
    a = np.empty((b, n, n), complex)
    for i in range(b):
        if mix is None:
            q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        else:
            k = rng.standard_normal((n, n))
            q = scipy.linalg.expm(mix * (k - k.T))
        a[i] = q @ np.diag(evals[i]) @ q.T
    return a, evals


def _max_match_err(got, want):
    """Greedy nearest matching of two eigenvalue multisets."""
    want, err = list(want), 0.0
    for z in got:
        j = int(np.argmin(np.abs(np.array(want) - z)))
        err = max(err, abs(want[j] - z))
        want.pop(j)
    return err


def _kernel(a, sweeps=10):
    mu, resid = eig_kernel.eig_cs_resid(from_np(a), sweeps=sweeps,
                                        interpret=True)
    return to_np(mu), np.asarray(resid)


@pytest.mark.parametrize("n", [16, 7])
def test_kernel_known_spectrum(n):
    """p=16 (the bench width) and an odd size padded to 8."""
    a, evals = _cs_matrices(np.random.default_rng(n), 5, n)
    mu, _ = _kernel(a)
    assert mu.shape == (5, n)
    for b in range(5):
        assert _max_match_err(mu[b], evals[b]) < 3e-3


def test_kernel_residual_reports_convergence():
    a, _ = _cs_matrices(np.random.default_rng(1), 4, 16)
    _, resid = _kernel(a)
    assert resid.shape == (4,)
    fro = np.linalg.norm(a, axis=(-1, -2))
    assert (resid / fro < 1e-3).all(), resid / fro
    # one sweep leaves the same matrices far from diagonal
    _, resid1 = _kernel(a, sweeps=1)
    assert (resid1 / fro > 1e-2).all(), resid1 / fro


def test_kernel_matches_scan():
    """Same rotation sequence as the lax.scan reference: the eigenvalues
    agree to the f32 rounding of non-unitary rotations (~1e-3 here, the
    same distance each has from the exact spectrum), and both converge."""
    a, _ = _cs_matrices(np.random.default_rng(2), 4, 8)
    mu_k, resid_k = _kernel(a)
    mu_s, resid_s = jacobi.eig_cs_resid(from_np(a), sweeps=10)
    for got, want in zip(mu_k, to_np(mu_s)):
        assert _max_match_err(got, want) < 2e-3
    fro = np.linalg.norm(a, axis=(-1, -2))
    assert (resid_k / fro < 1e-3).all()
    assert (np.asarray(resid_s) / fro < 1e-3).all()


def test_kernel_p24_padded_to_32():
    """p=24 (the brain width) runs in a 32x32 tile; the 8 padded slots are
    dropped and the 24 eigenvalues match scipy."""
    assert eig_kernel.padded_size(24) == 32
    a, evals = _cs_matrices(np.random.default_rng(3), 2, 24, mix=0.1)
    mu, _ = _kernel(a)
    assert mu.shape == (2, 24)
    for b in range(2):
        assert _max_match_err(mu[b], evals[b]) < 3e-3


@pytest.mark.parametrize("batch_shape", [(11,), (3, 3)])
def test_kernel_batch_not_multiple_of_block(batch_shape):
    """Batches of 11 and 3x3 over blocks of 8 matrices: the zero-padded
    tail is dropped and the batch shape restored."""
    assert eig_kernel.block_size(16) == 8
    count = int(np.prod(batch_shape))
    a, evals = _cs_matrices(np.random.default_rng(count), count, 16)
    mu, resid = _kernel(a.reshape(*batch_shape, 16, 16))
    assert mu.shape == (*batch_shape, 16) and resid.shape == batch_shape
    for got, want in zip(mu.reshape(count, 16), evals):
        assert _max_match_err(got, want) < 3e-3


# ---------------------------------------------------------------------------
# the platform decision
# ---------------------------------------------------------------------------

def _primitives(fn, *args):
    return {str(e.primitive) for e in jax.make_jaxpr(fn)(*args).jaxpr.eqns}


@pytest.mark.parametrize("name,kernel", [("gpu", True), ("cpu", False)])
def test_dispatch_picks_kernel_on_gpu_scan_on_cpu(name, kernel):
    """"gpu" traces the Pallas kernel, "cpu" the lax.scan.  The context
    variable is set directly: force_platform("gpu") refuses a process
    without a GPU (tested below), and tracing does not need one."""
    a = from_np(np.eye(16, dtype=complex)[None])
    token = plat._forced.set(name)
    try:
        prims = _primitives(lambda x: jacobi.eig_cs(x), a)
    finally:
        plat._forced.reset(token)
    assert ("pallas_call" in prims) == kernel
    assert ("scan" in prims) != kernel


def test_platform_is_cpu_here_and_unknown_raises(monkeypatch):
    assert plat.platform() == "cpu"
    with pytest.raises(RuntimeError, match="unsupported"):
        with plat.force_platform("metal"):
            pass
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported"):
        plat.platform()


def test_force_gpu_without_gpu_fails():
    """A fit asked to run on a GPU in a process without one fails; it does
    not carry on on the CPU."""
    with pytest.raises(RuntimeError):
        with plat.force_platform("gpu"):
            pass
    assert plat.platform() == "cpu"


def test_force_platform_is_context_local():
    """The pin is a ContextVar: another thread does not see it."""
    seen = []
    with plat.force_platform("cpu"):
        token = plat._forced.set("gpu")
        t = threading.Thread(target=lambda: seen.append(plat._forced.get()))
        t.start()
        t.join()
        assert plat.platform() == "gpu"
        plat._forced.reset(token)
        assert plat.platform() == "cpu"
    assert seen == [None]


def test_jit_cache_keys_differ_by_platform():
    """The jitted factories key on the platform, so a GPU trace and a CPU
    trace are distinct compiled functions."""
    from llckbdm_tpu.parallel import grid
    from llckbdm_tpu.pipeline import llckbdm
    from llckbdm_tpu.pipeline.llckbdm import LlcKbdmConfig
    from llckbdm_tpu.solver.refine import RefineConfig
    cfg = LlcKbdmConfig(m_values=(8,))
    for factory, c in ((llckbdm._llc_kbdm_jit, cfg), (grid._fit_grid_jit, cfg),
                       (grid._refine_jit, RefineConfig())):
        assert factory(1e-3, c, "gpu") is not factory(1e-3, c, "cpu")
        assert factory(1e-3, c, "cpu") is factory(1e-3, c, "cpu")
