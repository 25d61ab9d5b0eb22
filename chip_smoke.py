#!/usr/bin/env python
"""One-process smoke test of the main path on the GPU.

    python chip_smoke.py            # one card: the phases below
    python chip_smoke.py --cards 4  # four cards: the P=4 halo-exchange path

One card (nx=96: 884,736 points, 2,798,223 faces, nvar 7, f32):
  device    jax.devices(), device_kind, the card's name and power limit
  headline  solver.run, schedule all (+ the nocomm floor), verified: bulk vs
            the f64 golden <= 1e-5, early/overlap vs bulk <= 1e-6 relative
  flux      the PSD flux model's bulk sweep vs compute_psd_flux <= 1e-5
  solver    solver mode at sweeps_per_step 1 and 4; one fused step vs the
            manual refresh_state + step composition <= 1e-6
  f64       the XLA reference backend in float64 vs the golden <= 1e-12;
            reports whether the exact-order schedules agree bitwise
Four cards: the same mesh partitioned 4 ways with one ghost layer; every
schedule vs the golden (gathered through gather_global) and vs bulk.

Any failed check exits non-zero.  The last stdout line is one JSON object
{"ok": true, "device": {...}} and is printed only when every check passed.
Needs a GPU: without one it exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

NX = 96
NVAR = 7
FAILED: list[str] = []


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, value: float, bound: float) -> None:
    ok = value <= bound
    log(f"  {'PASS' if ok else 'FAIL'} {name} = {value:.3e} (bound {bound:g})")
    if not ok:
        FAILED.append(name)


def headline(run, SolverConfig, card: str, parts: int) -> dict:
    cfg = SolverConfig(nx=NX, ny=NX, nz=NX, parts=parts, nvar=NVAR,
                       schedule="all", iters=200, verify=True)
    t0 = time.time()
    res, _ = run(cfg)
    log(f"mesh nx={NX} points={res['npoint']} faces={res['nface']} "
        f"parts={res['npart']} ({time.time() - t0:.1f}s incl. compile)")
    ver = res["verification"]
    for s in ("bulk", "early", "overlap"):
        check(f"{s}_vs_golden_relmax", ver[f"{s}_vs_golden_relmax"], 1e-5)
    for s in ("early", "overlap"):
        check(f"{s}_vs_bulk_rel", ver[f"{s}_vs_bulk_rel"], 1e-6)
    rows = {**res["schedules"], "nocomm": res["nocomm"]}
    for s, e in rows.items():
        fps = res["nface"] / e["median_s"]
        log(f"  {s:<8} {e['median_s'] * 1e6:9.1f} us/iter "
            f"{fps / 1e9:7.3f} Gfaces/s  [{card}]")
    return res


def solver_mode_phase(card: str) -> None:
    import jax.numpy as jnp
    import numpy as np

    from cfd_proxy.mesh.generator import generate_mesh, make_state
    from cfd_proxy.mesh.partition import partition_mesh
    from cfd_proxy.models import GreenGaussSweep
    from cfd_proxy.solver import time_schedule

    m = generate_mesh(NX, NX, NX, jitter=0.05, diag_frac=0.2, seed=0)
    model = GreenGaussSweep(partition_mesh(m, 1), NVAR)
    state = model.distribute_state(make_state(m.npoint, NVAR, seed=1))
    got = model.iterate_fn("bulk", 1, solver_mode=True)(
        *model.iter_args(state))
    g = model.step(state, "bulk")
    want = model.refresh_state(state["var_T"] + 1e-30 * g[:, :8, :])["var_T"]
    scale = max(1.0, float(jnp.abs(want).max()))
    check("solver_step_vs_manual_rel",
          float(jnp.abs(got - want).max()) / scale, 1e-6)
    for n in (1, 4):
        st = time_schedule(model, state, "bulk", 50, 2, solver_mode=True,
                           sweeps_per_step=n)
        log(f"  solver mode sweeps_per_step={n}: {st.median * 1e6:.1f} "
            f"us/step ({st.median * 1e6 / n:.1f} us/sweep)  [{card}]")
        check(f"solver_mode_{n}_finite", 0.0 if np.isfinite(st.median)
              else 1.0, 0.0)


def f64_phase(run, SolverConfig) -> None:
    import jax
    import numpy as np

    res, _ = run(SolverConfig(nx=NX, ny=NX, nz=NX, parts=1, nvar=NVAR,
                              schedule="bulk", iters=20, backend="xla",
                              dtype="float64", verify=True))
    err = res["verification"]["bulk_vs_golden_relmax"]
    check("xla_f64_bulk_vs_golden_relmax", err, 1e-12)
    log(f"  f64 vs golden: {err / np.finfo(np.float64).eps:.1f} ulp of "
        f"max|golden| (bitwise={err == 0.0})")

    from cfd_proxy.mesh.generator import generate_mesh, make_state
    from cfd_proxy.mesh.partition import partition_mesh
    from cfd_proxy.models import GreenGaussModel
    from cfd_proxy.solver import golden_reference

    m = generate_mesh(NX, NX, NX, jitter=0.05, diag_frac=0.2, seed=0)
    model = GreenGaussModel(partition_mesh(m, 1), NVAR,
                            dtype=jax.numpy.float64)
    var = model.distribute_state(make_state(m.npoint, NVAR, seed=1))
    g = {s: np.asarray(model.step(var, s, exact=True))
         for s in ("bulk", "early", "overlap")}
    gold = golden_reference(model, m, make_state(m.npoint, NVAR, seed=1))
    err = float(np.abs(model.gather_global(g["bulk"]) - gold).max()
                / max(1.0, float(np.abs(gold).max())))
    check("xla_f64_exact_bulk_vs_golden_relmax", err, 1e-12)
    log(f"  f64 exact-order bulk vs golden: "
        f"{err / np.finfo(np.float64).eps:.1f} ulp of max|golden| "
        f"(bitwise={err == 0.0})")
    for s in ("early", "overlap"):
        diff = float(np.abs(g[s] - g["bulk"]).max())
        log(f"  f64 exact {s} vs bulk: max abs diff {diff:.3e} "
            f"(bitwise={diff == 0.0})")
        check(f"xla_f64_exact_{s}_vs_bulk", diff
              / max(1.0, float(np.abs(g["bulk"]).max())), 1e-12)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=[1, 4],
                    help="4: run only the four-card halo-exchange path")
    args = ap.parse_args(argv)
    FAILED.clear()

    import jax

    from cfd_proxy.utils.cache import enable_compile_cache
    from cfd_proxy.utils.device import card_info, require_gpu

    require_gpu()
    enable_compile_cache()
    devs = jax.devices()
    if len(devs) < args.cards:
        raise SystemExit(f"--cards {args.cards} needs {args.cards} GPUs, "
                         f"found {len(devs)}")
    card = card_info()
    cards = card.splitlines()
    tag = cards[0] + (f" ×{len(cards)}" if len(cards) > 1 else "")
    log(f"devices: {devs}")
    log(f"device_kind: {devs[0].device_kind}")
    log(f"card: {card}")

    from cfd_proxy.solver import SolverConfig, run

    if args.cards == 4:
        log(f"== four cards: nx={NX}, 4 parts, 1 ghost layer ==")
        headline(run, SolverConfig, tag, parts=4)
    else:
        log(f"== headline: nx={NX}, P=1, schedules bulk/early/overlap ==")
        headline(run, SolverConfig, tag, parts=1)
        log("== flux model ==")
        res, _ = run(SolverConfig(nx=NX, ny=NX, nz=NX, parts=1, nvar=NVAR,
                                  model="flux", schedule="bulk", iters=100,
                                  verify=True))
        check("flux_bulk_vs_golden_relmax",
              res["verification"]["bulk_vs_golden_relmax"], 1e-5)
        e = res["schedules"]["bulk"]
        log(f"  flux bulk {e['median_s'] * 1e6:.1f} us/iter "
            f"{e['faces_per_sec'] / 1e9:.3f} Gfaces/s  [{tag}]")
        log("== solver mode ==")
        solver_mode_phase(tag)
        log("== f64 XLA path ==")
        f64_phase(run, SolverConfig)

    if FAILED:
        log(f"FAILED: {', '.join(FAILED)}")
        return 1
    log(f"card: {card}")
    n = args.cards
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": n}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
