"""L3/L5: preprocessing (rangelist analogue) + compute kernels.

Reference equivalents: `rangelist.c` (per-thread staged face ranges),
`gradients.c` (`compute_gradients_gg` — THE hot loop) and `flux.c`
(SURVEY.md §2 L3/L5, §4.3).
"""

from cfd_proxy.ops.golden import compute_gradients_gg, scale_gradients
from cfd_proxy.ops.flux import compute_psd_flux, flux_residual_scale
from cfd_proxy.ops.prep import SweepPlan, build_sweep_plan
from cfd_proxy.ops.sweep import SlotTable, build_slot_table, sweep

__all__ = [
    "compute_gradients_gg",
    "scale_gradients",
    "compute_psd_flux",
    "flux_residual_scale",
    "SweepPlan",
    "build_sweep_plan",
    "SlotTable",
    "build_slot_table",
    "sweep",
]
