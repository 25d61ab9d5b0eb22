"""Model layer: high-level APIs over the sweeps + exchange schedules.

The reference has one "model": the Green-Gauss gradient benchmark kernel
driven by `solver.c` (SURVEY.md §2 L6), plus a secondary PSD-flux kernel
(`flux.c` [M]).  Here each is a model class bundling preprocessing, device
metadata, and jitted per-schedule step functions.
"""

from cfd_proxy.models.gradients import GreenGaussModel
from cfd_proxy.models.gradients_sweep import GreenGaussSweep, PSDFluxModel

__all__ = ["GreenGaussModel", "GreenGaussSweep", "PSDFluxModel"]
