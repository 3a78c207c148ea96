"""Device-mesh construction and multi-host initialization.

Axis convention (SURVEY.md §2 parallel-axis table):
  'data'  — voxel-batch row partitioning (DP; outermost, so each host
            keeps a contiguous voxel block and collectives along 'time'
            stay within a host)
  'time'  — optional signal/time-axis partitioning used by the refinement
            normal equations (the amplitude-RHS exchange, BASELINE.json:5)
"""
from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def distributed_init(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize multi-host JAX (no-op when single-process).

    For several hosts, pass the coordinator address ('host:port'), the
    process count and this process's id (nothing in the environment
    supplies them).  One process drives all the cards of its host.
    """
    if num_processes is not None and num_processes > 1 or coordinator:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)


def make_mesh(axis_sizes: dict[str, int], devices=None) -> Mesh:
    """Build a named mesh, e.g. make_mesh({'data': 4, 'time': 2}).

    Axis order in the dict is the device-grid order: the LAST axis varies
    fastest.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    shape = tuple(axis_sizes.values())
    n = int(np.prod(shape))
    if devices.size < n:
        raise ValueError(f"mesh {axis_sizes} needs {n} devices, "
                         f"have {devices.size}")
    grid = devices[:n].reshape(shape)
    return Mesh(grid, tuple(axis_sizes.keys()))


def auto_mesh(time_shards: int = 1) -> Mesh:
    """All visible devices: 'data' x optional 'time' mesh."""
    n = len(jax.devices())
    if n % time_shards:
        raise ValueError(f"{n} devices not divisible by time={time_shards}")
    return make_mesh({"data": n // time_shards, "time": time_shards})
