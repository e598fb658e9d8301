"""tpufluid_torch: the PyTorch + CUDA port of tpufluid for NVIDIA Hopper.

A package beside ``tpufluid`` with its module names. Every engine runs
end to end, with obstacles, checkpoints and the offline render mode:
``FluidApp(neighbor_mode="resident", device=...)`` drives
``ops.resident.make_grid_step``, whose three kernels (rebin, density,
forces + integrate) are hand-written CUDA in ``csrc/``; the per-step
engines of ``step.make_step`` (grid, naive, dense, pallas) rebuild their
neighbours every step, and pallas runs its density and forces as two more
CUDA kernels (``csrc/sph_*.cu``), as the frame renderer runs its metaball
coarse fields. All kernels are built for ``sm_90a`` at first use. On the
CPU the same functions run their plain PyTorch versions. Imports no JAX.
"""

from .params import EPSILON, MAX_SPEED, KernelNorms, SimSettings, TickParams
from .state import ParticleState, init_state
from .step import make_multi_step, make_step, predict_positions

__all__ = [
    "EPSILON",
    "MAX_SPEED",
    "KernelNorms",
    "SimSettings",
    "TickParams",
    "ParticleState",
    "init_state",
    "make_step",
    "make_multi_step",
    "predict_positions",
]

__version__ = "0.1.0"
