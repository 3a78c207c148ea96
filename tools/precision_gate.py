"""Gate-pinned experiment: Precision.HIGH vs HIGHEST for the sweep's f32
matmul stages (KbdmConfig.mxu_precision).

Whether the reduced-precision matmul rounding still clears the committed
accuracy gates is an empirical question — this runs the same gate battery
as tools/tune_sweeps.py for both settings and times the sweep.
Run: python tools/precision_gate.py
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

from tune_sweeps import gate_at  # noqa: E402
import tune_sweeps  # noqa: E402

if __name__ == "__main__":
    print(f"# device: {jax.devices()[0].device_kind}")
    base_kb = None
    for precision in ("highest", "high"):
        # monkey-patch the config constructor used by gate_at
        orig = tune_sweeps.KbdmConfig

        def make(p=16, eig_sweeps=10, _prec=precision):
            return orig(p=p, eig_sweeps=eig_sweeps, mxu_precision=_prec)

        tune_sweeps.KbdmConfig = make
        t0 = time.perf_counter()
        e1, e2, ms = gate_at(10, refine_jit_cache={})
        tune_sweeps.KbdmConfig = orig
        ok1 = "PASS" if e1 < 1e-8 else "FAIL"
        ok2 = "PASS" if e2 < 1e-8 else "FAIL"
        print(f"  {precision:8s}: noiseless iters=3 {e1:.2e} [{ok1}]  "
              f"noisy iters=6 {e2:.2e} [{ok2}]  sweep {ms:7.1f} ms  "
              f"({time.perf_counter()-t0:.0f}s incl compile)", flush=True)
