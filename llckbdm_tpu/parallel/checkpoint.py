"""Resumable pod-scale grid sweeps: voxel-range manifests + shard results.

The reference has no checkpointing (runs finish in seconds; SURVEY.md §5).
At pod scale (config 5: 256x256 voxel grids, BASELINE.json:11) a sweep is
long enough that preemption matters, so grid fits are decomposed into
deterministic voxel-range *shards*; each completed shard's consolidated
line list is written atomically (tmp + rename) as an .npz, and a re-run
skips shards whose result file already exists — resume-by-manifest, no
coordinator state.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Sequence

import numpy as np

from ..ops.cplx import CArr
from ..pipeline.llckbdm import LlcKbdmConfig
from ..solver.refine import RefineConfig
from .grid import fit_grid, refine_grid


def shard_manifest(n_voxels: int, shard_size: int,
                   process_index: int = 0,
                   num_processes: int = 1) -> list[tuple[int, int]]:
    """Deterministic [start, stop) voxel ranges owned by this process.

    Shards are dealt round-robin so every process touches the whole grid's
    address space (even load when signal difficulty correlates with voxel
    position).
    """
    if shard_size <= 0:
        raise ValueError("shard_size must be positive")
    starts = range(0, n_voxels, shard_size)
    return [(s, min(s + shard_size, n_voxels))
            for i, s in enumerate(starts)
            if i % num_processes == process_index]


def _shard_path(out_dir: pathlib.Path, start: int, stop: int) -> pathlib.Path:
    return out_dir / f"shard_{start:08d}_{stop:08d}.npz"


@dataclasses.dataclass
class GridRunner:
    """Checkpointed LL-KBDM sweep over a flat voxel batch.

    out_dir   : shard results + manifest.json live here
    dwell     : sample dwell time (s)
    cfg       : pipeline config (must be identical across resume runs; a
                fingerprint is stored in manifest.json and checked)
    shard_size: voxels per shard (one jit launch each)
    process_index, num_processes: deal the shards over several hosts, one
                process per host; one process drives all the cards of its
                host (a JAX process reserves most of every card's memory)
    refine    : when set, each shard additionally runs the double-float
                Gauss-Newton polish (the stage that meets the 1e-8 oracle
                gate, solver.refine) on its top ``refine_clusters``
                consolidated clusters, and the refined double-float poles /
                amplitudes are stored in the shard .npz as complex128
                (``refined_z``, ``refined_d``, + ``refined_mask``,
                ``gn_step``).  None (default) = f32-only pipeline.
    """

    out_dir: str | os.PathLike
    dwell: float
    cfg: LlcKbdmConfig
    shard_size: int = 256
    process_index: int = 0
    num_processes: int = 1
    refine: RefineConfig | None = None
    refine_clusters: int = 16

    def __post_init__(self):
        self.out_dir = pathlib.Path(self.out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self._check_manifest()

    def _fingerprint(self) -> dict:
        # The FULL config (recursing into cfg.kbdm via dataclasses.asdict):
        # resuming after changing ANY solver knob would silently mix shards
        # computed under different configs.
        cfg = dataclasses.asdict(self.cfg)
        cfg["m_values"] = list(map(int, cfg["m_values"]))
        fp = {
            "dwell": float(self.dwell),
            "cfg": cfg,
            "shard_size": int(self.shard_size),
        }
        if self.refine is not None:
            fp["refine"] = dataclasses.asdict(self.refine)
            fp["refine_clusters"] = int(self.refine_clusters)
        return fp

    def _check_manifest(self) -> None:
        """Create-or-validate manifest.json, atomically and from EVERY process.

        Each process attempts an exclusive create (O_CREAT|O_EXCL); exactly
        one wins, the rest re-read and compare — closing the race where a
        process with process_index != 0 started before the manifest existed
        and proceeded unvalidated.
        """
        path = self.out_dir / "manifest.json"
        fp = self._fingerprint()
        # write a private tmp, then publish via hard link: link() fails with
        # FileExistsError if someone else won, and readers can never observe
        # a partially-written manifest.
        tmp = path.with_suffix(f".tmp.{os.getpid()}.{self.process_index}")
        tmp.write_text(json.dumps(fp, indent=1))
        try:
            os.link(tmp, path)
        except FileExistsError:
            pass
        finally:
            tmp.unlink()
        old = json.loads(path.read_text())
        if old != fp:
            raise ValueError(
                f"resume config mismatch in {path}:\n old={old}\n new={fp}")

    @staticmethod
    def _data_fingerprint(signals: np.ndarray) -> dict:
        """Cheap content digest tying shard files to the input grid.

        Full blake2b for small grids; for pod-scale inputs (config 5 can be
        GBs) a deterministic sample: head + tail + strided slice.
        """
        import hashlib

        b = np.ascontiguousarray(signals)
        view = b.view(np.uint8).reshape(-1)
        h = hashlib.blake2b(digest_size=16)
        h.update(str((b.shape, b.dtype.str)).encode())
        if view.nbytes <= (1 << 26):
            h.update(view.tobytes())
        else:
            h.update(view[: 1 << 20].tobytes())
            h.update(view[-(1 << 20):].tobytes())
            h.update(np.ascontiguousarray(
                view[:: max(1, view.nbytes // (1 << 20))]).tobytes())
        return {"n_voxels": int(signals.shape[0]), "digest": h.hexdigest()}

    def _check_data(self, signals: np.ndarray) -> None:
        """Create-or-validate data.json (same atomic protocol as the manifest)."""
        path = self.out_dir / "data.json"
        fp = self._data_fingerprint(signals)
        tmp = path.with_suffix(f".tmp.{os.getpid()}.{self.process_index}")
        tmp.write_text(json.dumps(fp, indent=1))
        try:
            os.link(tmp, path)
        except FileExistsError:
            pass
        finally:
            tmp.unlink()
        old = json.loads(path.read_text())
        if old != fp:
            raise ValueError(
                f"input data mismatch in {path} (resuming in this out_dir "
                f"with different signals):\n old={old}\n new={fp}")

    def pending(self, n_voxels: int) -> list[tuple[int, int]]:
        """Manifest shards owned by this process that have no result yet."""
        return [(s, e)
                for s, e in shard_manifest(n_voxels, self.shard_size,
                                           self.process_index,
                                           self.num_processes)
                if not _shard_path(self.out_dir, s, e).exists()]

    def run(self, signals: np.ndarray, queue_depth: int = 16) -> int:
        """Fit every pending shard of `signals` ((V, N) complex); return the
        number of shards computed this call (0 = everything was resumed).

        Shard launches are ASYNC-DISPATCHED up to `queue_depth` ahead of
        the fetch+write loop, so host transfers and .npz writes overlap
        device compute (JAX queues the launches; results are fetched in
        completion order), hiding the host round-trip of each shard behind
        the next shards' compute.  Each shard's result file is
        still written atomically (tmp + rename), so a kill mid-run loses
        at most the in-flight shards.
        """
        import jax
        import jax.numpy as jnp

        from ..utils import df as D

        signals = np.asarray(signals)
        self._check_data(signals)

        def launch(s, e):
            seg = signals[s:e]
            # pad the tail shard so every launch shares one compiled shape
            pad = self.shard_size - seg.shape[0]
            if pad:
                seg = np.concatenate([seg, np.zeros((pad, seg.shape[1]),
                                                    seg.dtype)])
            c = CArr(jnp.asarray(seg.real, jnp.float32),
                     jnp.asarray(seg.imag, jnp.float32))
            cons, _pooled, counts, _stats = fit_grid(c, self.dwell, self.cfg)
            if self.refine is None:
                return cons, counts, None
            # gate-meeting stage: consolidated slots are count-sorted, so
            # the top refine_clusters slice keeps every genuine line
            rc = min(self.refine_clusters, self.cfg.max_clusters)
            cons_r = jax.tree.map(lambda x: x[..., :rc], cons)
            refined = refine_grid(D.dfc_from_np(seg), cons_r, self.dwell,
                                  self.refine)
            return cons, counts, refined

        def drain(item):
            # ONE device_get for the whole result tree: jax.device_get
            # prefetches every leaf async then gathers, so the fetch costs
            # one device-to-host round trip instead of one per leaf.
            (s, e), dev = item
            cons, counts, refined = jax.device_get(dev)
            out = {
                "amplitude": cons.amplitude[:e - s],
                "t2": cons.t2[:e - s],
                "frequency": cons.frequency[:e - s],
                "phase": cons.phase[:e - s],
                "mask": cons.mask[:e - s],
                "counts": counts[:e - s],
            }
            if refined is not None:
                out["refined_z"] = D.dfc_to_np(refined.z)[:e - s]
                out["refined_d"] = D.dfc_to_np(refined.d)[:e - s]
                out["refined_mask"] = refined.mask[:e - s]
                out["gn_step"] = refined.gn_step[:e - s]
            path = _shard_path(self.out_dir, s, e)
            tmp = path.with_suffix(".tmp.npz")
            np.savez(tmp, **out)
            tmp.replace(path)

        done = 0
        inflight: list = []
        for s, e in self.pending(signals.shape[0]):
            inflight.append(((s, e), launch(s, e)))
            if len(inflight) >= queue_depth:
                drain(inflight.pop(0))
                done += 1
        while inflight:
            drain(inflight.pop(0))
            done += 1
        return done

    def gather(self, n_voxels: int) -> dict[str, np.ndarray]:
        """Assemble the full-grid result from ALL processes' shard files.

        Raises FileNotFoundError listing missing shards if incomplete.
        """
        data_path = self.out_dir / "data.json"
        if data_path.exists():
            rec = json.loads(data_path.read_text())
            if rec["n_voxels"] != n_voxels:
                raise ValueError(
                    f"gather(n_voxels={n_voxels}) does not match the grid "
                    f"these shards were computed from (n_voxels="
                    f"{rec['n_voxels']}, {data_path})")
        shards = shard_manifest(n_voxels, self.shard_size, 0, 1)
        missing = [f"[{s},{e})" for s, e in shards
                   if not _shard_path(self.out_dir, s, e).exists()]
        if missing:
            raise FileNotFoundError(
                f"grid incomplete: missing shards {', '.join(missing)}")
        # keys come from the first shard file: refined runners carry the
        # extra refined_z/refined_d/refined_mask/gn_step arrays
        with np.load(_shard_path(self.out_dir, *shards[0])) as z0:
            keys = tuple(z0.files)
        parts = {k: [] for k in keys}
        for s, e in shards:
            with np.load(_shard_path(self.out_dir, s, e)) as z:
                for k in keys:
                    parts[k].append(z[k])
        return {k: np.concatenate(v, axis=0) for k, v in parts.items()}
