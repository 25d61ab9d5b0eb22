"""Golden-file dump / bit-match harness.

The reference is stateless (no checkpointing; SURVEY.md §5.4) — its
correctness artifact is the gradient field itself.  This tool freezes that:
`dump` writes the f64 golden gradients of a generated mesh to a netCDF file;
`check` recomputes (golden, or any backend/schedule through the models) and
compares against the file — bitwise for the f64 golden path, ULP-bounded for
the f32 device paths (BASELINE.json's bit-match gate, realised as documented
in SURVEY.md §7 hard part 2).

    python -m cfd_proxy.tools.golden dump  --nx 12 --out golden.nc
    python -m cfd_proxy.tools.golden check --nx 12 --ref golden.nc \
        --backend sweep --parts 4 --schedule overlap
"""

from __future__ import annotations

import argparse

import numpy as np

from cfd_proxy.mesh import netcdf3
from cfd_proxy.mesh.generator import generate_mesh, make_state
from cfd_proxy.ops.golden import compute_gradients_gg, scale_gradients


def _mesh_and_state(args):
    ny = args.ny or args.nx
    nz = args.nz or args.nx
    mesh = generate_mesh(args.nx, ny, nz, jitter=args.jitter,
                         diag_frac=args.diag_frac, seed=args.seed)
    var = make_state(mesh.npoint, args.nvar, seed=args.seed + 1)
    return mesh, var


def _golden(mesh, var, model="gg"):
    if model == "flux":
        from cfd_proxy.ops.flux import compute_psd_flux, flux_residual_scale

        r = compute_psd_flux(var.astype(np.float64), mesh.faces, mesh.normals)
        return flux_residual_scale(r, mesh.volume, mesh.npoint)
    g = compute_gradients_gg(var.astype(np.float64), mesh.faces, mesh.normals)
    return scale_gradients(g, mesh.volume, mesh.npoint).reshape(mesh.npoint, -1)


def cmd_dump(args) -> int:
    mesh, var = _mesh_and_state(args)
    grad = _golden(mesh, var, args.model)
    ds = netcdf3.Dataset()
    ds.attrs = {
        "nx": args.nx, "ny": args.ny or args.nx, "nz": args.nz or args.nx,
        "nvar": args.nvar, "seed": args.seed, "jitter": args.jitter,
        "diag_frac": args.diag_frac, "model": args.model,
    }
    ds.add("gradients", ("points", "cols"), grad)
    netcdf3.write(args.out, ds)
    print(f"wrote {args.out}: {args.model} field {grad.shape} (f64 golden)")
    return 0


def cmd_check(args) -> int:
    mesh, var = _mesh_and_state(args)
    ds = netcdf3.read(args.ref)
    ref_model = ds.attrs.get("model", "gg")   # pre-flux dumps are gg
    if ref_model != args.model:
        raise SystemExit(
            f"{args.ref} was dumped with --model {ref_model}; rerun check "
            f"with --model {ref_model} (got {args.model})")
    # the dump stores its generation config; a check run with different
    # parameters compares DIFFERENT fields by construction — report that
    # distinctly (still exit 1: the harness's perturbed-config gate) rather
    # than misattributing it to a backend numerical bug, or crashing on a
    # shape mismatch when nx differs
    drift = {}
    for key in ("nx", "ny", "nz", "nvar", "seed", "jitter", "diag_frac"):
        stored = ds.attrs.get(key)
        ours = {"ny": args.ny or args.nx, "nz": args.nz or args.nx}.get(
            key, getattr(args, key))
        if stored is not None and stored != ours:
            drift[key] = (stored, ours)
    if drift:
        print(f"config MISMATCH vs {args.ref}: " + ", ".join(
            f"{k} dumped={a} check={b}" for k, (a, b) in drift.items())
            + " — the fields differ by construction")
        return 1
    ref = ds["gradients"]
    if args.backend == "golden":
        got = _golden(mesh, var, args.model)
        exact = bool((got == ref).all())
        print(f"golden vs {args.ref}: bitwise {'MATCH' if exact else 'MISMATCH'}")
        return 0 if exact else 1
    from cfd_proxy.mesh.partition import partition_mesh

    parts = partition_mesh(mesh, args.parts, ghost_layers=args.ghost_layers)
    if args.backend == "sweep":
        from cfd_proxy.models import GreenGaussSweep

        model = GreenGaussSweep(parts, args.nvar, op=args.model)
    elif args.model == "flux":
        raise SystemExit("--model flux requires --backend sweep")
    else:
        import jax

        jax.config.update("jax_enable_x64", True)  # real f64, not truncated
        import jax.numpy as jnp

        from cfd_proxy.models import GreenGaussModel

        model = GreenGaussModel(parts, args.nvar, dtype=jnp.float64)
    state = model.distribute_state(var)
    got = model.gather_global(model.step(state, args.schedule))
    denom = max(1.0, float(np.abs(ref).max()))
    rel = float(np.abs(got - ref).max()) / denom
    # documented f32 bound: rounding over ~K reordered f32 accumulations
    # (the sweep's bulk table sums boundary faces first) ≈ K·2^-24 relative
    bound = 1e-12 if got.dtype == np.float64 else 1e-5
    ok = rel < bound
    print(f"{args.backend}/{args.schedule} vs {args.ref}: rel max err "
          f"{rel:.3e} (bound {bound:.0e}) -> {'OK' if ok else 'FAIL'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cfd_proxy.tools.golden")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("dump", "check"):
        p = sub.add_parser(name)
        p.add_argument("--nx", type=int, default=12)
        p.add_argument("--ny", type=int, default=0)
        p.add_argument("--nz", type=int, default=0)
        p.add_argument("--nvar", type=int, default=7)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--jitter", type=float, default=0.05)
        p.add_argument("--diag-frac", type=float, default=0.2)
        p.add_argument("--model", default="gg", choices=["gg", "flux"])
        if name == "dump":
            p.add_argument("--out", required=True)
        else:
            p.add_argument("--ref", required=True)
            p.add_argument("--backend", default="golden",
                           choices=["golden", "sweep", "xla"])
            p.add_argument("--schedule", default="bulk")
            p.add_argument("--parts", type=int, default=1)
            p.add_argument("--ghost-layers", type=int, default=1)
    args = ap.parse_args(argv)
    return cmd_dump(args) if args.cmd == "dump" else cmd_check(args)


if __name__ == "__main__":
    raise SystemExit(main())
