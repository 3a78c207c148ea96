"""The one platform decision: which code path a trace takes.

The library runs on an NVIDIA GPU (``"gpu"``) or on the host CPU
(``"cpu"``).  The only trace-time branch between them is the
complex-symmetric eigensolver (ops.jacobi.eig_cs): the Pallas Triton kernel
on the GPU, the plain ``lax.scan`` formulation on the CPU.  Everything else
is one plain-JAX formulation on both.

The jitted entry points (pipeline.llckbdm._llc_kbdm_jit,
parallel.grid._fit_grid_jit, ...) key their caches on :func:`platform` and
pin tracing to it with :func:`force_platform`, so a compiled function never
holds the other platform's path, even in a process whose default device
changes between calls.
"""
from __future__ import annotations

import contextlib
import contextvars

import jax

PLATFORMS = ("gpu", "cpu")

_forced: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "llckbdm_platform", default=None)


def _check(name: str) -> str:
    if name not in PLATFORMS:
        raise RuntimeError(f"unsupported JAX platform {name!r}: this library "
                           f"runs on one of {PLATFORMS}")
    return name


def platform() -> str:
    """``"gpu"`` or ``"cpu"``: the platform computations dispatch to.

    Checked per call: honours a :func:`force_platform` context first, then
    ``jax.default_device(...)`` / ``jax_default_device``, then JAX's default
    backend.  Any other platform raises.
    """
    forced = _forced.get()
    if forced is not None:
        return forced
    dev = jax.config.jax_default_device
    if dev is None:
        return _check(jax.default_backend())
    return _check(dev if isinstance(dev, str) else dev.platform)


@contextlib.contextmanager
def force_platform(name: str):
    """Pin :func:`platform`'s answer inside a ``with`` block.

    Context-local (a ``ContextVar``), so concurrent traces in other threads
    are unaffected.  Forcing ``"gpu"`` in a process that has no GPU raises
    instead of tracing a kernel that cannot run.
    """
    _check(name)
    if name == "gpu":
        jax.devices("gpu")       # raises RuntimeError when there is none
    token = _forced.set(name)
    try:
        yield name
    finally:
        _forced.reset(token)
