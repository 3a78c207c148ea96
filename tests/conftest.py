"""Test configuration: an 8-virtual-device CPU mesh (SURVEY.md §4).

Multi-card hardware is not available in CI; all sharding tests run on a
virtual CPU mesh via --xla_force_host_platform_device_count.  Must be set
before jax is imported anywhere in the test process.

LLCKBDM_GPU_TESTS=1 leaves JAX's platform alone so the ``gpu``-marked
tests (tests/test_gpu.py) can assert the accuracy gates on a card:

    LLCKBDM_GPU_TESTS=1 python -m pytest tests/ -m gpu -q
"""
import os

RUN_ON_GPU = os.environ.get("LLCKBDM_GPU_TESTS") == "1"

if not RUN_ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

from llckbdm_tpu.utils.compile_cache import use_compile_cache  # noqa: E402

# the suite is compile-dominated; cached executables cut repeat runs to
# the numerics
use_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def five_peak_params() -> np.ndarray:
    """Config 1 ground truth: 5-peak synthetic line list (A, T2, f, phase)."""
    return np.array([
        [1.0, 0.05, -120.0, 0.1],
        [0.8, 0.08, -40.0, 0.0],
        [1.2, 0.03, 15.0, -0.2],
        [0.5, 0.10, 90.0, 0.3],
        [0.9, 0.06, 200.0, 0.0],
    ])


@pytest.fixture(scope="session")
def five_peak_signal(five_peak_params):
    """Config 1 signal: N=512, dwell=0.5 ms (BASELINE.json:7)."""
    from llckbdm_tpu.oracle import reference as oracle
    dwell = 5e-4
    sig = oracle.sample_signal(five_peak_params, 512, dwell)
    return sig, dwell


@pytest.fixture(scope="session")
def brain_params() -> np.ndarray:
    """Config 2 ground truth: simulated brain-MRS metabolite lines."""
    import pathlib
    csv = pathlib.Path(__file__).parent.parent / "data" / "params_brain_sim.csv"
    rows = np.loadtxt(csv, delimiter=",", skiprows=1, usecols=(1, 2, 3, 4))
    return rows


@pytest.fixture(scope="session")
def brain_signal(brain_params):
    """Config 2 signal: N=2048 (BASELINE.json:8)."""
    from llckbdm_tpu.oracle import reference as oracle
    dwell = 2.5e-4
    sig = oracle.sample_signal(brain_params, 2048, dwell)
    return sig, dwell
