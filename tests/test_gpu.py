"""On-card accuracy assertions — marked ``gpu``; run on an NVIDIA GPU with:

    LLCKBDM_GPU_TESTS=1 python -m pytest tests/ -m gpu -q

The default (CPU-forced) suite skips these.  They assert that the GPU path —
the compiled Triton eigensolver kernel, cuSOLVER's eigh / Cholesky, and the
card's f32 arithmetic under the double-float refinement — meets the same
oracle gates as the CPU path.  chip_smoke.py runs the same checks at full
width in one process.
"""
import numpy as np
import pytest

import jax

import llckbdm_tpu as lt
from llckbdm_tpu.oracle import reference as oracle
from llckbdm_tpu.ops.cplx import from_np, to_np
from llckbdm_tpu.solver.refine import (RefineConfig, refine_lines,
                                       refined_to_np)
from llckbdm_tpu.utils import df as D

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _needs_gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (LLCKBDM_GPU_TESTS=1)")


def test_gpu_config1_refined_hits_1e8_gate(five_peak_signal,
                                           five_peak_params):
    """Config-1 fit + refine ON THE CARD matches the f64 scipy oracle to
    <= 1e-8 relative (BASELINE.json:5)."""
    sig, dwell = five_peak_signal
    olines, _ = oracle.kbdm(sig, dwell, m=180, p=16)
    olines = olines[oracle.match_lines(olines, five_peak_params)]

    lines = jax.jit(
        lambda c: lt.kbdm_fit(c, dwell, 180, lt.KbdmConfig(p=16))
    )(from_np(sig))
    ref = jax.jit(
        lambda s, l: refine_lines(s, l, dwell, RefineConfig(iters=3))
    )(D.dfc_from_np(sig), lines)
    est = refined_to_np(ref, dwell)
    sel = oracle.match_lines(est, five_peak_params)
    err = oracle.line_errors(est[sel], olines)
    assert err.max() < 1e-8, f"max err {err.max():.3e}\n{err}"


def test_gpu_eig_kernel_known_spectrum():
    """The compiled Triton kernel (the path ops.jacobi.eig_cs takes on the
    GPU) recovers exactly known, well-separated eigenvalues."""
    from llckbdm_tpu.ops import jacobi

    rng = np.random.default_rng(0)
    evals = np.exp(2j * np.pi * rng.uniform(-0.4, 0.4, (8, 16))
                   - rng.uniform(0.01, 0.3, (8, 16)))
    a = np.empty((8, 16, 16), complex)
    for b in range(8):
        q, _ = np.linalg.qr(rng.standard_normal((16, 16)))
        a[b] = q @ np.diag(evals[b]) @ q.T
    mu = to_np(jax.jit(lambda x: jacobi.eig_cs(x, sweeps=10))(from_np(a)))
    for b in range(8):
        exp = list(evals[b])
        for z in mu[b]:
            j = int(np.argmin(np.abs(np.array(exp) - z)))
            assert abs(exp[j] - z) < 3e-3, (z, exp)
            exp.pop(j)


def test_gpu_double_float_eft_survives_compilation():
    """The error-free transforms of utils.df keep their lo limb on the card
    (no FMA contraction across the reduce_precision barrier)."""
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(4096), rng.standard_normal(4096)
    got = D.df_to_np(jax.jit(D.df_mul)(D.df_from_np(x), D.df_from_np(y)))
    np.testing.assert_allclose(got, x * y, rtol=1e-13)
    s = D.df_to_np(jax.jit(lambda a: D.df_sum(a, axis=0))(D.df_from_np(x)))
    np.testing.assert_allclose(s, np.sum(x), rtol=1e-12, atol=1e-12)


def test_gpu_llc_kbdm_wrapper_refined(five_peak_signal, five_peak_params):
    """The numpy-convenience llc_kbdm entry point, on the card, with the
    double-float polish: recovers the 5 lines to f64-level accuracy."""
    sig, dwell = five_peak_signal
    cons, pooled, counts = lt.llc_kbdm(sig, dwell, range(120, 181, 10),
                                       p=16, eps=2e-4, min_samples=5,
                                       refine_iters=6)
    assert len(cons) >= 5 and len(pooled) > len(cons)
    sel = oracle.match_lines(cons, five_peak_params)
    err = oracle.line_errors(cons[sel], five_peak_params)
    assert err.max() < 1e-8, f"max err {err.max():.3e}\n{err}"
