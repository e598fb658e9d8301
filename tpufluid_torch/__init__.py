"""tpufluid_torch: the PyTorch + CUDA port of tpufluid for NVIDIA Hopper.

A package beside ``tpufluid`` with its module names. The grid-resident
engine runs end to end, with obstacles, checkpoints and the offline render
mode: ``FluidApp(neighbor_mode="resident", device=...)`` drives
``ops.resident.make_grid_step``, whose three kernels (rebin, density,
forces + integrate) are hand-written CUDA in ``csrc/``, as is the frame
renderer's metaball coarse-field kernel; all are built for ``sm_90a`` at
first use. On the CPU the same functions run their plain PyTorch versions.
Imports no JAX.
"""

from .params import EPSILON, MAX_SPEED, KernelNorms, SimSettings, TickParams
from .state import ParticleState, init_state

__all__ = [
    "EPSILON",
    "MAX_SPEED",
    "KernelNorms",
    "SimSettings",
    "TickParams",
    "ParticleState",
    "init_state",
]

__version__ = "0.1.0"
