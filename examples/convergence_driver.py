"""Example: a convergence-monitored steady-state solve on the framework.

`pseudo_time_stepping.py` shows the refresh_state dataflow; this example
shows the full driver a real solver needs on top of it: a residual monitor,
a convergence criterion, and a divergence guard.

The "physics": explicit pseudo-time iteration of the heat equation
∂q/∂t = ∇²q to steady state (a Laplace solve with Dirichlet boundary).
The Laplacian is built from two chained Green-Gauss sweeps — the classic
gradient-of-gradient construction the reference's multi-round ghost layers
exist for (SURVEY.md §3 "Multi-round ghost layers"):

    grad  = GG(q)            # model1: nvar=1 scalar → (gx, gy, gz)
    hess  = GG(gx, gy, gz)   # model2: nvar=3 → ∂d(gv)
    ∇²q   = ∂x gx + ∂y gy + ∂z gz   (trace of the Hessian)
    q    += dt·∇²q  at INTERIOR points;  residual = RMS(∇²q) there

Boundary points (open dual cells: the ± face normals do not close, so GG is
one-sided there) are held fixed — the Dirichlet data — and excluded from
the residual; without this the boundary's O(1) closure defect puts a floor
under the residual and the "steady state" never registers as converged.

Each outer step calls `refresh_state` on BOTH models — the solver-mode API
(the var halo exchange) — so ghosts stay consistent
across shards at every step.  The residual must decay monotonically (up to
explicit-scheme ripple); the driver stops at the target reduction, the step
cap, or on divergence (NaN / growth), and reports which.

Run:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/convergence_driver.py
"""

import numpy as np

import jax
import jax.numpy as jnp

from cfd_proxy.mesh.generator import generate_mesh, make_state
from cfd_proxy.mesh.partition import partition_mesh
from cfd_proxy.models import GreenGaussSweep
from cfd_proxy.ops.sweep import NV


def drive(nx=10, ny=10, nz=8, nparts=None, dt=0.1, target=0.1,
          max_steps=80, check_every=5, schedule="overlap", verbose=True):
    """Iterate q ← q + dt·∇²q to the target residual reduction.

    Returns (status, residuals): status is "converged" | "max_steps" |
    "diverged"; residuals the monitored RMS(∇²q) history."""
    nparts = nparts or min(4, jax.device_count())
    mesh = generate_mesh(nx, ny, nz, jitter=0.05, diag_frac=0.2, seed=0)
    parts = partition_mesh(mesh, nparts)
    grad_model = GreenGaussSweep(parts, nvar=1)
    div_model = GreenGaussSweep(parts, nvar=3)
    ndev = grad_model.layout.ndev

    # interior = closed dual cell: the ± face normals of a point sum to ~0.
    # Boundary points (open cells) are the Dirichlet set — held fixed,
    # excluded from the residual.
    defect = np.zeros((mesh.npoint, 3))
    np.add.at(defect, mesh.faces[:, 0], mesh.normals)
    np.add.at(defect, mesh.faces[:, 1], -mesh.normals)
    scale = np.median(np.linalg.norm(mesh.normals, axis=1))
    closed = np.linalg.norm(defect, axis=1) < 1e-6 * scale

    # device mask: owned AND interior columns (residual/update set)
    upd = np.zeros((nparts, 1, ndev), np.float32)
    for i, p in enumerate(grad_model.parts):
        upd[i, 0, : p.nowned] = closed[p.global_ids[: p.nowned]]
    n_upd = int(upd.sum())
    upd = jax.device_put(jnp.asarray(upd), grad_model._sharding)
    if verbose:
        print(f"{mesh.npoint} points, {mesh.nface} faces on {nparts} "
              f"shard(s); dt={dt} schedule={schedule}")

    q = make_state(mesh.npoint, 1, seed=1)
    state1 = grad_model.distribute_state(q)

    def laplacian(state1):
        grad = grad_model.step(state1, schedule)        # (P, 3·NV, ndev)
        # rows d·NV+0 = (gx, gy, gz); pad to the NV-row state layout
        g3 = grad[:, ::NV, :]                           # (P, 3, ndev)
        var2 = jnp.concatenate(
            [g3, jnp.zeros((nparts, NV - 3, ndev), jnp.float32)], axis=1)
        state2 = div_model.refresh_state(var2)
        hess = div_model.step(state2, schedule)
        # trace: ∂x gx + ∂y gy + ∂z gz  (row d·NV+v of the second sweep)
        return hess[:, 0 * NV + 0] + hess[:, 1 * NV + 1] + hess[:, 2 * NV + 2]

    def rms(lap):
        return jnp.sqrt(jnp.sum((lap * upd[:, 0]) ** 2) / n_upd)

    residuals = []
    status = "max_steps"
    step = -1
    for step in range(max_steps):
        lap = laplacian(state1)                         # (P, ndev)
        if step % check_every == 0 or step == max_steps - 1:
            r = float(rms(lap))
            residuals.append(r)
            if verbose:
                print(f"step {step:3d}: residual {r:.6f}")
            if not np.isfinite(r) or (len(residuals) >= 2
                                      and r > 4 * residuals[0]):
                status = "diverged"
                break
            if r < target * residuals[0]:
                status = "converged"
                break
        # Dirichlet: update interior points only; boundary q stays fixed.
        # Row 0 only — the padded state rows 1..NV-1 must STAY zero (the
        # layout invariant other ops rely on), so pad the update like the
        # var2 construction above instead of broadcasting into all rows
        updv = jnp.float32(dt) * (lap * upd[:, 0])
        upd_rows = jnp.concatenate(
            [updv[:, None, :],
             jnp.zeros((nparts, NV - 1, ndev), jnp.float32)], axis=1)
        state1 = grad_model.refresh_state(state1["var_T"] + upd_rows)
    if verbose and residuals:
        print(f"{status} after {step + 1} steps "
              f"(residual {residuals[0]:.4f} -> {residuals[-1]:.4f})")
    return status, residuals


if __name__ == "__main__":
    status, _ = drive()
    raise SystemExit(0 if status == "converged" else 1)
