"""GreenGaussModel — the flagship model: distributed Green-Gauss gradients.

Bundles, for a partitioned mesh: sweep preprocessing (uniform pad targets
across shards), device metadata upload, the halo phase schedule, and jitted
`shard_map` step functions for every exchange schedule.  This is the
user-facing equivalent of the reference's benchmark core: one `step` call ==
one timed iteration {gradient sweep + gradient halo exchange} (SURVEY.md
§4.2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cfd_proxy.mesh.model import MeshPartition
from cfd_proxy.mesh.partition import send_point_set
from cfd_proxy.ops.prep import SweepPads, build_sweep_plan
from cfd_proxy.ops.sweep_jax import device_sweep, set_volume
from cfd_proxy.parallel.halo import device_halo, exchange
from cfd_proxy.parallel.schedules import STEP_FNS
from cfd_proxy.parallel.topology import build_halo_topology
from cfd_proxy.utils.errors import check

AXIS = "shard"


def _shard_map(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)


class GreenGaussModel:
    """Distributed Green-Gauss gradient sweep over P mesh shards.

    One shard per device on a 1-D `jax.sharding.Mesh` (the realisation of
    the reference's one-partition-per-rank domain decomposition; SURVEY.md §3
    "Parallelism strategies").
    """

    def __init__(
        self,
        parts: list[MeshPartition],
        nvar: int,
        *,
        dtype=jnp.float32,
        devices: list | None = None,
    ):
        check(len(parts) >= 1, "need at least one partition")
        self.parts = parts
        self.nvar = int(nvar)
        self.dtype = dtype
        P_ = len(parts)

        if devices is None:
            devices = jax.devices()[:P_]
        check(len(devices) >= P_, "need %d devices, have %d", P_, len(devices))
        self.mesh = Mesh(np.array(devices[:P_]), (AXIS,))

        # two-pass plan build → uniform shapes across shards
        raw = [
            build_sweep_plan(p.faces, p.normals, p.npoint, p.nowned, send_point_set(p))
            for p in parts
        ]
        pads = SweepPads.max_of(raw)
        self.plans = [
            build_sweep_plan(
                p.faces, p.normals, p.npoint, p.nowned, send_point_set(p), pads=pads
            )
            for p in parts
        ]
        self.npoint_pad = pads.npoint_pad

        dsweeps = []
        for p, plan in zip(parts, self.plans):
            ds = device_sweep(plan, dtype=dtype)
            ds = set_volume(ds, p.volume, p.nowned)
            dsweeps.append(ds)
        topo = build_halo_topology(parts, self.npoint_pad)
        self.topology = topo
        halos = [device_halo(topo, i) for i in range(P_)]

        # stack per-shard metadata along a leading device axis and place it
        self._sharding = NamedSharding(self.mesh, P(AXIS))
        def stack(*xs):
            # host-side stack; single explicit placement onto the mesh
            return jax.device_put(np.stack([np.asarray(x) for x in xs]),
                                  self._sharding)

        self.dsweep = jax.tree_util.tree_map(stack, *dsweeps)
        self.halo = jax.tree_util.tree_map(stack, *halos)
        self._step_cache: dict = {}

    # ---------------------------------------------------------------- state

    def distribute_state(self, gvar: np.ndarray) -> jax.Array:
        """Scatter a global state array (N, nvar) to owned rows per shard and
        fill ghosts with a device-side var exchange."""
        vs = []
        for p in self.parts:
            v = np.zeros((self.npoint_pad, self.nvar), dtype=np.float64)
            v[: p.nowned] = gvar[p.global_ids[: p.nowned]]
            vs.append(v.astype(self.dtype))
        var = jax.device_put(np.stack(vs), self._sharding)
        return self.exchange_var(var)

    def exchange_var(self, var: jax.Array) -> jax.Array:
        """Fill ghost rows of a stacked state array from their owners."""
        if "var_exchange" not in self._step_cache:

            def body(v, halo):
                return exchange(
                    v[0], jax.tree_util.tree_map(lambda a: a[0], halo), AXIS)[None]

            fn = _shard_map(body, self.mesh, in_specs=(P(AXIS), P(AXIS)),
                            out_specs=P(AXIS))
            self._step_cache["var_exchange"] = jax.jit(fn)
        return self._step_cache["var_exchange"](var, self.halo)

    # ---------------------------------------------------------------- step

    def step_fn(self, schedule: str = "overlap", *, exact: bool = False):
        """Jitted stacked-step: var (P, npoint_pad, nvar) → grad (P, npoint_pad, nvar*3)."""
        check(schedule in STEP_FNS, "unknown schedule %r", schedule)
        key = (schedule, exact)
        if key not in self._step_cache:
            step = STEP_FNS[schedule]

            def body(var, dsw, halo):
                dsw1 = jax.tree_util.tree_map(lambda a: a[0], dsw)
                halo1 = jax.tree_util.tree_map(lambda a: a[0], halo)
                return step(var[0], dsw1, halo1, AXIS, exact=exact)[None]

            fn = _shard_map(
                body, self.mesh,
                in_specs=(P(AXIS), P(AXIS), P(AXIS)),
                out_specs=P(AXIS),
            )
            self._step_cache[key] = jax.jit(fn)
        return self._step_cache[key]

    def step(self, var: jax.Array, schedule: str = "overlap", *, exact: bool = False):
        return self.step_fn(schedule, exact=exact)(var, self.dsweep, self.halo)

    def iter_args(self, state) -> tuple:
        return (state, self.dsweep, self.halo)

    def iterate_fn(self, schedule: str, n: int, *, exact: bool = False):
        """Jitted n-iteration chained runner for benchmarking.

        Feeds a vanishing fraction of each iteration's gradient back into the
        state (pseudo-time-stepping shape) so iterations are data-dependent —
        XLA cannot hoist the sweep out of the loop, and ONE dispatch times n
        real iterations (so per-dispatch overhead drops out of the timing).
        """
        key = ("iterate", schedule, exact)
        if key not in self._step_cache:
            step = self.step_fn(schedule, exact=exact)
            nvar = self.nvar

            @jax.jit
            def run_n(n, var, dsw, halo):
                def body(_i, v):
                    g = step(v, dsw, halo)
                    # python literal: stays weakly typed inside the trace
                    return v + 1e-30 * g[..., :nvar]

                return jax.lax.fori_loop(0, n, body, var)

            self._step_cache[key] = run_n
        runner = self._step_cache[key]
        return lambda *args: runner(n, *args)

    # ------------------------------------------------------------- gather

    def gather_global(self, stacked: jax.Array) -> np.ndarray:
        """Collect a stacked per-shard array back to global numbering (host)."""
        arr = np.asarray(stacked)
        ncol = arr.shape[-1]
        N = sum(p.nowned for p in self.parts)
        out = np.zeros((N, ncol), dtype=arr.dtype)
        for i, p in enumerate(self.parts):
            out[p.global_ids[: p.nowned]] = arr[i, : p.nowned]
        return out
