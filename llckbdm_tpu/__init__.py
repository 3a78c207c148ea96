"""llckbdm_tpu — KBDM / LL-KBDM structured linear-algebra library for GPUs.

A from-scratch JAX/XLA rebuild of the capabilities of
``danilomendesdias/llckbdm`` (see SURVEY.md): quantification of MRS
time-domain signals as sums of exponentially damped complex sinusoids via the
Krylov Basis Diagonalization Method, with the LL-KBDM multi-m sweep +
density-clustering consolidation — batched for an accelerator
(complex-as-real-pairs arithmetic, randomized Takagi SVD of Hankel operators,
a Jacobi eigensolver kernel, closed-form Vandermonde least squares, masked
fixed-shape batching, mesh sharding for MRSI voxel grids).

Public API (L3 layer, SURVEY.md §1):

    from llckbdm_tpu import (
        sample_signal, LineList, line_list_from_np, line_list_to_np,
        kbdm_fit, kbdm_sweep, KbdmConfig,
        llc_kbdm_fit, LlcKbdmConfig,
        refine_lines, refined_to_np, RefineConfig,
    )

Distributed layer (mesh, sharded grids, resumable sweeps):
``llckbdm_tpu.parallel``.  CPU float64 oracle (ground truth for every
kernel): ``llckbdm_tpu.oracle``.
"""

from .signals import (LineList, line_list_from_np, line_list_to_np,
                      sample_signal)
from .ops.cplx import CArr, from_np, to_np
from .solver.kbdm import KbdmConfig, kbdm_fit, kbdm_sweep
from .solver.refine import (RefineConfig, RefinedLines, refine_lines,
                            refined_to_np)
from .pipeline.llckbdm import (ClusterStats, LlcKbdmConfig, llc_kbdm,
                               llc_kbdm_fit)
from . import parallel

__version__ = "0.2.0"

__all__ = [
    "CArr", "from_np", "to_np",
    "LineList", "line_list_from_np", "line_list_to_np", "sample_signal",
    "KbdmConfig", "kbdm_fit", "kbdm_sweep",
    "ClusterStats", "LlcKbdmConfig", "llc_kbdm", "llc_kbdm_fit",
    "RefineConfig", "RefinedLines", "refine_lines", "refined_to_np",
    "parallel",
    "__version__",
]
