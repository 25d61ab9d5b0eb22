"""Benchmark driver CLI — the `solver.c` / `cfd_proxy.c` `main` analogue.

Mirrors the reference driver's structure (SURVEY.md §4.1/§4.2): obtain a
partitioned mesh (read netCDF files, or generate+partition in-process), set up
comm metadata and sweep plans, loop over comm variants × iterations, time
each, verify variants against the bulk-sync reference result, and print a
min/median/max table with speedups.

Usage examples:
    python -m cfd_proxy.solver --nx 40 --ny 40 --nz 40 --parts 4 \
        --schedule all --iters 20
    python -m cfd_proxy.solver --mesh data/m --parts 8 --schedule overlap
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass

import numpy as np

from cfd_proxy.mesh.generator import generate_mesh, make_state
from cfd_proxy.mesh.partition import partition_mesh
from cfd_proxy.mesh.reader import partition_path, read_partition
from cfd_proxy.parallel.schedules import SCHEDULES
from cfd_proxy.utils.cache import enable_compile_cache
from cfd_proxy.utils.timing import (IterationStats, format_stats_table,
                                        two_point_sampler)


@dataclass
class SolverConfig:
    nx: int = 24
    ny: int = 24
    nz: int = 24
    mesh_prefix: str | None = None
    parts: int = 1
    ghost_layers: int = 1
    nvar: int = 7          # TAU-like variable count (SURVEY.md §4.3 [M])
    iters: int = 20
    warmup: int = 3
    schedule: str = "all"
    backend: str = "sweep"      # sweep (production) | xla (reference)
    model: str = "gg"           # gg (Green-Gauss gradients) | flux (PSD flux)
    meta_dtype: str = "float32"     # bfloat16 halves the slot-weight stream
                                    # (~1e-3 rel error bound)
    halo_dtype: str = "float32"     # bfloat16 halves the exchanged gradient
                                    # payloads on the wire (pack-time cast,
                                    # unpack upcast); ghost gradients carry
                                    # a ~4e-3 rel bound, owned untouched
    grad_dtype: str = "float32"     # bfloat16 stores the gradient planes in
                                    # bf16; results carry a ~4e-3 field-norm
                                    # bound
    dtype: str = "float32"
    diag_frac: float = 0.2
    jitter: float = 0.05
    stretch: float = 1.0    # geometric z-spacing growth (boundary-layer
                            # anisotropy, the F6-like mesh family)
    hub_frac: float = 0.0   # high-valence tail stress: fraction of points
                            # gaining hub_extra second-shell edges (real
                            # TAU meshes carry K up to ~16-20 near singular
                            # vertices; the base generator tops out at 8)
    hub_extra: int = 12
    seed: int = 0
    platform: str | None = None     # force a jax platform (e.g. cpu) before
                                    # backend init
    solver_mode: bool = False   # time the per-time-step dataflow (sweep +
                                # state update + var halo exchange) instead
                                # of the proxy's static-state iteration;
                                # sweep backend only
    sweeps_per_step: int = 1    # solver-mode only: gradient evaluations per
                                # var halo exchange (a multi-stage solver's
                                # RK stages / smoothing sweeps)
    verify: bool = True
    json_out: bool = False
    profile_dir: str | None = None   # jax.profiler trace output (optional)


def build_model(cfg: SolverConfig):
    import jax.numpy as jnp

    from cfd_proxy.models import GreenGaussModel

    if cfg.mesh_prefix:
        try:
            parts = [
                read_partition(partition_path(cfg.mesh_prefix, i, cfg.parts))
                for i in range(cfg.parts)
            ]
        except FileNotFoundError as e:
            raise SystemExit(
                f"mesh partition file not found: {e.filename} — expected "
                f"<prefix>.<parts>p.<i>.nc; generate with "
                f"`python -m cfd_proxy.tools.partition --parts {cfg.parts} "
                f"--out {cfg.mesh_prefix}` (plus your --nx/--ny/--nz/"
                f"--ghost-layers/--seed — the tool's defaults are a 24^3 mesh)"
            )
        gmesh = None
    else:
        gmesh = generate_mesh(
            cfg.nx, cfg.ny, cfg.nz, jitter=cfg.jitter, diag_frac=cfg.diag_frac,
            seed=cfg.seed, stretch=cfg.stretch,
            hub_frac=cfg.hub_frac, hub_extra=cfg.hub_extra,
        )
        parts = partition_mesh(gmesh, cfg.parts, ghost_layers=cfg.ghost_layers)
    if cfg.backend == "sweep":
        from cfd_proxy.models import GreenGaussSweep

        if cfg.dtype != "float32":
            raise SystemExit("sweep backend is float32; use --backend xla for f64")
        model = GreenGaussSweep(parts, cfg.nvar, op=cfg.model,
                                meta_dtype=cfg.meta_dtype,
                                halo_dtype=cfg.halo_dtype,
                                grad_dtype=cfg.grad_dtype)
    else:
        if cfg.model != "gg":
            raise SystemExit("--model flux requires --backend sweep")
        if cfg.dtype == "float64":
            # without this, jax silently truncates to f32 and the f64
            # verification anchor quietly degrades
            import jax

            jax.config.update("jax_enable_x64", True)
        dtype = {"float32": jnp.float32, "float64": jnp.float64}[cfg.dtype]
        model = GreenGaussModel(parts, cfg.nvar, dtype=dtype)
    return model, gmesh


def time_schedule(
    model, var, schedule: str, iters: int, warmup: int, repeats: int = 3,
    solver_mode: bool = False, sweeps_per_step: int = 1,
) -> IterationStats:
    """Two-point timing: run chained loops of n0 and n0+iters iterations in
    single dispatches; the difference isolates per-iteration time from the
    per-dispatch overhead."""
    n0 = max(1, iters // 10)
    kw = ({"solver_mode": True, "sweeps_per_step": sweeps_per_step}
          if solver_mode else {})
    small = model.iterate_fn(schedule, n0, **kw)
    big = model.iterate_fn(schedule, n0 + iters, **kw)
    args = model.iter_args(var)

    def run_small():
        small(*args).block_until_ready()

    def run_big():
        big(*args).block_until_ready()

    run_small()  # compile
    run_big()    # compile
    for _ in range(max(0, warmup)):
        # untimed settling runs of BOTH runners: the two-point diff is
        # big − small, so a still-cold small runner biases every sample low
        run_small()
        run_big()
    stats = IterationStats(schedule)
    sample = two_point_sampler(run_small, run_big, iters)
    for _ in range(repeats):
        v = sample()
        if v is not None:
            stats.add(v)
    if stats.n == 0:
        # every repeat was below the dispatch-noise floor: the two-point
        # difference no longer measures the iteration — report NaN rather
        # than a fantastical faces/sec (tiny meshes)
        stats.add(float("nan"))
    return stats


def run(cfg: SolverConfig) -> tuple[dict, list[IterationStats]]:
    import jax

    if cfg.platform:
        # jax silently IGNORES jax_platforms updates once the backend is
        # initialised — verify the request actually took effect rather than
        # proceeding on the wrong platform
        jax.config.update("jax_platforms", cfg.platform)
        got = jax.default_backend()
        if got != cfg.platform:
            raise SystemExit(
                f"--platform {cfg.platform} did not take effect (backend is "
                f"{got!r} — jax was already initialised in this process; "
                f"set the platform before any jax use)")
    if cfg.solver_mode and cfg.backend != "sweep":
        raise SystemExit("--solver-mode requires the sweep backend")
    if cfg.sweeps_per_step > 1 and not cfg.solver_mode:
        raise SystemExit("--sweeps-per-step requires --solver-mode (the "
                         "static iteration never refreshes the state)")
    model, gmesh = build_model(cfg)
    nface_total = sum(p.nface for p in model.parts)
    npoint_total = sum(p.nowned for p in model.parts)

    rng_state = make_state(npoint_total, cfg.nvar, seed=cfg.seed + 1)
    var = model.distribute_state(rng_state)

    schedules = list(SCHEDULES) if cfg.schedule == "all" else [cfg.schedule]
    all_stats: list[IterationStats] = []
    dev0 = model.mesh.devices.flatten()[0]
    results: dict = {
        "device": str(dev0),
        "platform": dev0.platform,
        "device_kind": dev0.device_kind,
        "npart": len(model.parts),
        "npoint": npoint_total,
        "nface": nface_total,
        "nvar": cfg.nvar,
        "dtype": cfg.dtype,
        "grad_dtype": cfg.grad_dtype,
        "solver_mode": cfg.solver_mode,
        "sweeps_per_step": cfg.sweeps_per_step if cfg.solver_mode else None,
        "backend": cfg.backend,
        "model": cfg.model,
        "iters": cfg.iters,
        "schedules": {},
    }

    profiler_cm = None
    if cfg.profile_dir:
        # device traces on request (SURVEY.md §5.1: the reference has only
        # self-timing); a requested trace that cannot start fails the run
        import jax.profiler

        profiler_cm = jax.profiler.trace(cfg.profile_dir)
        profiler_cm.__enter__()

    try:
        # compute-only floor, for overlap efficiency (only worth a compile
        # when several schedules are being compared)
        nocomm = None
        if len(schedules) > 1:
            nocomm = time_schedule(model, var, "nocomm", cfg.iters, cfg.warmup,
                                   solver_mode=cfg.solver_mode,
                                   sweeps_per_step=cfg.sweeps_per_step)
        bulk_med = None
        for s in schedules:
            st = time_schedule(model, var, s, cfg.iters, cfg.warmup,
                               solver_mode=cfg.solver_mode,
                               sweeps_per_step=cfg.sweeps_per_step)
            all_stats.append(st)
            if s == "bulk":
                bulk_med = st.median
            entry = st.summary()
            # solver mode with N>1 sweeps/step evaluates gradients over
            # nface N times per timed iteration — faces/sec counts SWEPT
            # faces so the per-evaluation rate stays comparable
            sweeps = cfg.sweeps_per_step if cfg.solver_mode else 1
            entry["faces_per_sec"] = nface_total * sweeps / st.median
            results["schedules"][s] = entry
        if nocomm is not None:
            all_stats.append(nocomm)
            results["nocomm"] = nocomm.summary()
            comm_cost = (bulk_med - nocomm.median) if bulk_med else None
            for s in schedules:
                if s == "bulk":
                    continue
                # noise gate: a comm cost under 5% of the bulk median is
                # indistinguishable from two-point timing noise — a ratio of
                # two noise terms is not a measurement
                if (comm_cost and comm_cost > 0 and bulk_med
                        and comm_cost >= 0.05 * bulk_med):
                    exposed = results["schedules"][s]["median_s"] - nocomm.median
                    results["schedules"][s]["overlap_efficiency"] = float(
                        np.clip(1.0 - exposed / comm_cost, 0.0, 1.0)
                    )
                else:
                    # reported as null with the reason attached
                    if cfg.parts <= 1:
                        why = ("at P=1 the exchange is pack/unpack only — "
                               "overlap efficiency needs several devices")
                    else:
                        why = (f"at P={cfg.parts} the measured comm cost is "
                               f"below the 5% noise gate — overlap has "
                               f"nothing measurable to hide here")
                    results["schedules"][s]["overlap_efficiency"] = None
                    results["schedules"][s]["overlap_efficiency_note"] = (
                        "comm cost unmeasurable (bulk - nocomm below the "
                        "two-point noise floor; " + why + ")")
    finally:
        if profiler_cm is not None:
            profiler_cm.__exit__(None, None, None)

    if cfg.verify:
        results["verification"] = verify_model(model, var, schedules, gmesh, rng_state)

    return results, all_stats


def golden_reference(model, gmesh, gvar) -> np.ndarray:
    """The NumPy f64 golden for the model's op, in the layout gather_global
    returns: (N, nvar*3) gradients or (N, nvar) fluxes."""
    if getattr(model, "op", "gg") == "flux":
        from cfd_proxy.ops.flux import compute_psd_flux, flux_residual_scale

        return flux_residual_scale(
            compute_psd_flux(gvar.astype(np.float64), gmesh.faces,
                             gmesh.normals),
            gmesh.volume, gmesh.npoint)
    from cfd_proxy.ops.golden import compute_gradients_gg, scale_gradients

    return scale_gradients(
        compute_gradients_gg(gvar.astype(np.float64), gmesh.faces,
                             gmesh.normals),
        gmesh.volume, gmesh.npoint,
    ).reshape(gmesh.npoint, -1)


def verify_model(model, var, schedules, gmesh, gvar) -> dict:
    """Cross-variant verification — every schedule vs bulk-sync reference
    (reference semantics: SURVEY.md §4b), plus vs the NumPy golden when the
    global mesh is available in-process."""
    import jax.numpy as jnp

    out = {}
    if all(s == "bulk" for s in schedules) and gmesh is None:
        # nothing to compare: no non-bulk schedule and no in-process golden
        return out
    ref = model.step(var, "bulk")
    scale = max(1.0, float(jnp.abs(ref).max()))
    outs = {"bulk": ref}
    for s in schedules:
        if s == "bulk":
            continue
        outs[s] = g = model.step(var, s)
        # reduce on device, pull one scalar
        maxabs = float(jnp.abs(g - ref).max())
        out[f"{s}_vs_bulk_maxabs"] = maxabs
        out[f"{s}_vs_bulk_rel"] = maxabs / scale
    if gmesh is not None and ref.size < 100_000_000:
        gg = golden_reference(model, gmesh, gvar)
        denom = max(1.0, float(np.abs(gg).max()))
        for s, g in outs.items():
            err = np.abs(model.gather_global(g) - gg).max() / denom
            out[f"{s}_vs_golden_relmax"] = float(err)
    return out


def _finite_or_none(obj):
    """NaN/inf → None recursively: time_schedule reports NaN when every repeat
    sat below the dispatch-noise floor, and bare NaN is not valid strict JSON
    for downstream consumers of --json / bench.py output."""
    if isinstance(obj, dict):
        return {k: _finite_or_none(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite_or_none(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="cfd_proxy.solver",
        description="CFD-Proxy halo-exchange benchmark driver (JAX)",
    )
    ap.add_argument("--nx", type=int, default=24)
    ap.add_argument("--ny", type=int, default=24)
    ap.add_argument("--nz", type=int, default=24)
    ap.add_argument("--mesh", dest="mesh_prefix", default=None,
                    help="read pre-partitioned netCDF files <prefix>.<P>p.<i>.nc")
    ap.add_argument("--parts", type=int, default=1)
    ap.add_argument("--ghost-layers", type=int, default=1)
    ap.add_argument("--nvar", type=int, default=7)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3,
                    help="untimed settling dispatches of BOTH runners "
                         "after compilation, before the timed repeats "
                         "(solver.time_schedule)")
    ap.add_argument("--schedule", default="all", choices=["all", *SCHEDULES])
    ap.add_argument("--backend", default="sweep", choices=["sweep", "xla"])
    ap.add_argument("--model", default="gg", choices=["gg", "flux"])
    ap.add_argument("--meta-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="slot-weight precision (bfloat16: ~1e-3 rel bound)")
    ap.add_argument("--halo-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="wire precision of exchanged gradient halo payloads "
                         "(bfloat16: comm bytes halve; ghost gradients carry "
                         "a ~4e-3 rel bound)")
    ap.add_argument("--grad-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="stored gradient precision (bfloat16: the output "
                         "planes halve; ~4e-3 field-norm bound, schedules "
                         "agree to the same bound instead of 1e-6)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    ap.add_argument("--diag-frac", type=float, default=0.2)
    ap.add_argument("--stretch", type=float, default=1.0,
                    help="geometric z-spacing growth ratio (boundary-layer "
                         "anisotropy)")
    ap.add_argument("--hub-frac", type=float, default=0.0,
                    help="high-valence tail stress: fraction of points "
                         "gaining --hub-extra second-shell edges (K tail "
                         "to ~16-20, like real TAU meshes)")
    ap.add_argument("--hub-extra", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--solver-mode", action="store_true",
                    help="time the per-time-step dataflow (sweep + state "
                         "update + var halo exchange) instead of the proxy's "
                         "static-state iteration (sweep backend)")
    ap.add_argument("--sweeps-per-step", type=int, default=1,
                    help="solver-mode only: gradient evaluations (sweep + "
                         "gradient exchange + toy update) per var halo "
                         "exchange")
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--json", action="store_true", help="emit one JSON line")
    ap.add_argument("--profile", dest="profile_dir", default=None,
                    help="write a jax.profiler trace to this directory")
    ap.add_argument("--platform", default=None,
                    help="force a jax platform before backend init (e.g. "
                         "cpu with XLA_FLAGS=--xla_force_host_platform_"
                         "device_count=8 for a virtual multi-device mesh)")
    args = ap.parse_args(argv)

    enable_compile_cache()
    cfg = SolverConfig(
        nx=args.nx, ny=args.ny, nz=args.nz, mesh_prefix=args.mesh_prefix,
        parts=args.parts, ghost_layers=args.ghost_layers, nvar=args.nvar,
        iters=args.iters, warmup=args.warmup, schedule=args.schedule,
        backend=args.backend, model=args.model,
        meta_dtype=args.meta_dtype, halo_dtype=args.halo_dtype,
        grad_dtype=args.grad_dtype, dtype=args.dtype,
        diag_frac=args.diag_frac, stretch=args.stretch,
        hub_frac=args.hub_frac, hub_extra=args.hub_extra, seed=args.seed,
        platform=args.platform,
        solver_mode=args.solver_mode,
        sweeps_per_step=args.sweeps_per_step,
        verify=not args.no_verify, json_out=args.json,
        profile_dir=args.profile_dir,
    )
    results, stats = run(cfg)
    if cfg.json_out:
        print(json.dumps(_finite_or_none(results)))
    else:
        print(f"device={results['device']} kind={results.get('device_kind')} "
              f"parts={results['npart']} points={results['npoint']} "
              f"faces={results['nface']} nvar={results['nvar']} "
              f"dtype={results['dtype']}")
        print(format_stats_table(stats, ref="bulk"))
        for s, e in results["schedules"].items():
            # overlap_efficiency is None (with a _note) when comm cost is
            # unmeasurable (P=1) — print the reason, don't %-format None
            if e.get("overlap_efficiency") is not None:
                extra = f"  overlap_eff={e['overlap_efficiency']:.1%}"
            elif "overlap_efficiency_note" in e:
                extra = f"  overlap_eff=n/a ({e['overlap_efficiency_note']})"
            else:
                extra = ""
            print(f"{s:<10} {e['faces_per_sec'] / 1e6:9.2f} Mfaces/s{extra}")
        if "verification" in results:
            for k, v in results["verification"].items():
                print(f"verify {k} = {v:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
