"""The three exchange schedules as shard-local step functions.

The reference's comm-variant enum (bulk-sync / early-recv / full-overlap ×
{MPI, MPI-RMA, GASPI}; SURVEY.md §3, §5.8) collapses to a schedule axis
over one transport (collective permutes).  Each function below is the body run per shard under
shard_map; all three produce BIT-IDENTICAL f64 results (same per-point
summation order — the rebuild's strengthened version of the reference's
cross-variant verification):

  bulk : full sweep → scale → exchange            (compute/comm serialized)
  early: boundary sweep → ppermutes fired → interior sweep (independent of
         the in-flight collectives → XLA overlaps) → scale → scatter
  overlap: same dataflow as `early` — collectives run outside the compute,
         so XLA's asynchronous collective-permutes are what can hide the
         transfer under the interior sweep.

Pack-time scaling: ghost receivers get volume-scaled gradients, so senders
scale at pack (gather × inv_volume) — boundary-sweep rows at send points are
already final (all faces incident to a send point are boundary faces by
construction, see ops/prep.py), which is exactly the reference's
finish-counter guarantee (SURVEY.md §4.3).
"""

from __future__ import annotations

import jax

from cfd_proxy.ops.sweep_jax import (
    DeviceSweep,
    scale_owned,
    sweep_boundary,
    sweep_bulk,
    sweep_interior,
)
from cfd_proxy.parallel.halo import (
    DeviceHalo,
    exchange,
    exchange_finish,
    exchange_start,
)

SCHEDULES = ("bulk", "early", "overlap")


def step_bulk(
    var: jax.Array, ds: DeviceSweep, halo: DeviceHalo, axis_name: str,
    *, exact: bool = False,
) -> jax.Array:
    g = sweep_bulk(var, ds, exact=exact)
    g = scale_owned(g, ds)
    return exchange(g, halo, axis_name)


def step_early(
    var: jax.Array, ds: DeviceSweep, halo: DeviceHalo, axis_name: str,
    *, exact: bool = False,
) -> jax.Array:
    gb = sweep_boundary(var, ds, exact=exact)
    bufs = exchange_start(gb, halo, axis_name, scale=ds.inv_volume)
    g = sweep_interior(var, ds, gb, exact=exact)
    g = scale_owned(g, ds)
    return exchange_finish(g, bufs, halo)


def step_overlap(
    var: jax.Array, ds: DeviceSweep, halo: DeviceHalo, axis_name: str,
    *, exact: bool = False,
) -> jax.Array:
    # XLA-scheduled overlap: the same graph as early
    return step_early(var, ds, halo, axis_name, exact=exact)


def step_nocomm(
    var: jax.Array, ds: DeviceSweep, halo: DeviceHalo, axis_name: str,
    *, exact: bool = False,
) -> jax.Array:
    # measurement aid, not a reference variant: sweep without the exchange —
    # the compute-only floor used to compute overlap efficiency (SURVEY.md §6)
    g = sweep_bulk(var, ds, exact=exact)
    return scale_owned(g, ds)


STEP_FNS = {
    "bulk": step_bulk,
    "early": step_early,
    "overlap": step_overlap,
    "nocomm": step_nocomm,
}
