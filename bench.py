#!/usr/bin/env python
"""Headline benchmark: faces/sec on one GPU for the Green-Gauss sweep.

Prints ONE compact JSON line on stdout (full detail goes to stderr as a
FULL_JSON line):
  {"metric": "faces_per_sec_per_chip", "value": N, "unit": "faces/s",
   "vs_baseline": N, "platform": "gpu", ...}

vs_baseline is measured against this host's 1-core C golden (native/
golden.cc — the reference's language; the NumPy golden if the native lib is
absent).  vs_baseline_numpy keeps the NumPy-denominator figure.

Runs on a GPU; refuses to run elsewhere unless JAX_PLATFORMS=cpu is set
explicitly (a small CPU rehearsal, not a measurement).

Env knobs: BENCH_NX (grid edge, default 96 on GPU / 16 on CPU), BENCH_ITERS
(default 300), BENCH_SCHEDULE (default: all on GPU, else bulk),
BENCH_BACKEND (default sweep), BENCH_SECONDARY (default 1 on GPU: the
reduced-precision, flux and solver-mode rows; 0 skips them),
BENCH_SOLVER_SWEEPS (default 4: the multi-sweep solver-mode row).
"""

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _finite_or_none(obj):
    """NaN/inf → None recursively (bare NaN is invalid strict JSON)."""
    if isinstance(obj, dict):
        return {k: _finite_or_none(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite_or_none(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def _compact(o: dict) -> dict:
    """The final stdout line: the headline and one number per row."""
    c = {k: o.get(k) for k in ("metric", "value", "unit", "vs_baseline",
                               "platform", "device_kind", "device_count",
                               "card", "nface", "schedule", "median_ms")}
    if "schedules" in o:
        c["sched_ms"] = {s: e.get("median_ms")
                         for s, e in o["schedules"].items()}
        c["overlap_efficiency"] = o.get("overlap_efficiency")
    for row in ("reduced_precision", "flux"):
        if o.get(row):
            c[row + "_faces_per_sec"] = o[row]["faces_per_sec"]
    if o.get("solver_mode"):
        c["solver_ms_per_step"] = {
            n: e["ms_per_step"] for n, e in o["solver_mode"].items()}
    return c


def measure_cpu_golden(nx: int = 32) -> dict:
    """CPU-denominator measurements: the NumPy golden and the C golden
    (native/golden.cc, the reference's language) on one core — on a small
    cache-resident mesh, and on a BENCH_CPU_DRAM_NX mesh whose ~200 MB
    working set forces the DRAM-bound rate a node core sustains."""
    from cfd_proxy.mesh.generator import generate_mesh, make_state
    from cfd_proxy.native import golden_gg_c, lib
    from cfd_proxy.ops.golden import compute_gradients_gg

    def best(fn, nface, reps=3):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return nface / min(ts)

    m = generate_mesh(nx, nx, nx, jitter=0.05, diag_frac=0.2, seed=0)
    var = make_state(m.npoint, 7, seed=1).astype("float64")
    out = {"cpu_nface": m.nface, "host_cores": os.cpu_count() or 1}
    out["numpy_fps"] = best(
        lambda: compute_gradients_gg(var, m.faces, m.normals), m.nface)
    if lib() is not None:
        # validate=False: the timed lambdas measure only the sweep
        out["c1_fps"] = best(
            lambda: golden_gg_c(var, m.faces, m.normals, nthreads=1,
                                validate=False), m.nface)
        nx_d = int(os.environ.get("BENCH_CPU_DRAM_NX", "64"))
        md = generate_mesh(nx_d, nx_d, nx_d, jitter=0.05, diag_frac=0.2,
                           seed=0)
        vard = make_state(md.npoint, 7, seed=1).astype("float64")
        out["cpu_dram_nface"] = md.nface
        out["c1_dram_fps"] = best(
            lambda: golden_gg_c(vard, md.faces, md.normals, nthreads=1,
                                validate=False), md.nface)
    log(f"cpu golden: {m.nface} faces, numpy {out['numpy_fps']/1e6:.2f} "
        f"Mf/s, C 1-core {out.get('c1_fps', 0)/1e6:.2f} Mf/s, "
        f"C 1-core DRAM-bound ({out.get('cpu_dram_nface', 0)} faces) "
        f"{out.get('c1_dram_fps', 0)/1e6:.2f} Mf/s")
    return out


def _node_estimate(c1_dram_fps: float, gbps: float = 500.0,
                   cores: int = 64, bytes_per_face: float = 816.0):
    """Physical 2-socket-node throughput estimate for the memory-bound C
    loop: linear core scaling CAPPED by the node's DRAM bus — min(linear,
    wall).  Returns (node, linear, wall) faces/sec.  The C loop moves ~816
    B/face of DRAM traffic (faces 8 + normals 24 + 2 var rows 112 + grad
    read+write 672); the node bandwidth is the stated assumption whose
    sensitivity vs_node_at_gbps reports."""
    lin = cores * c1_dram_fps
    wall = gbps * 1e9 / bytes_per_face
    return min(lin, wall), lin, wall


def _row(results: dict, s: str = "bulk") -> dict:
    e = results["schedules"][s]
    return {"faces_per_sec": e["faces_per_sec"],
            "median_ms": e["median_s"] * 1e3}


def main() -> int:
    import jax

    from cfd_proxy.utils.cache import enable_compile_cache
    from cfd_proxy.utils.device import card_info, require_gpu

    platform = require_gpu(allow_explicit_cpu=True)
    enable_compile_cache()
    on_gpu = platform == "gpu"
    nx = int(os.environ.get("BENCH_NX", "96" if on_gpu else "16"))
    iters = int(os.environ.get("BENCH_ITERS", "300"))
    schedule = os.environ.get("BENCH_SCHEDULE", "all" if on_gpu else "bulk")
    backend = os.environ.get("BENCH_BACKEND", "sweep")
    secondary = os.environ.get("BENCH_SECONDARY",
                               "1" if on_gpu else "0") != "0"
    dev = jax.devices()[0]
    card = card_info() if on_gpu else None
    log(f"platform={platform} devices={jax.devices()} card={card} nx={nx} "
        f"iters={iters} backend={backend}")

    cpu = measure_cpu_golden(32 if on_gpu else 16)
    cpu_fps = cpu["numpy_fps"]

    from dataclasses import replace

    from cfd_proxy.solver import SolverConfig, run

    cfg = SolverConfig(nx=nx, ny=nx, nz=nx, parts=1, nvar=7, iters=iters,
                       warmup=3, schedule=schedule, backend=backend,
                       dtype="float32", verify=False)
    t0 = time.perf_counter()
    results, _stats = run(cfg)
    log(f"run wall {time.perf_counter() - t0:.1f}s")

    head = "bulk" if schedule == "all" else schedule
    fps = results["schedules"][head]["faces_per_sec"]
    base_fps = cpu.get("c1_fps", cpu_fps)
    out = {
        "metric": "faces_per_sec_per_chip",
        "value": float(fps),
        "unit": "faces/s",
        "vs_baseline": float(fps / base_fps),
        "vs_baseline_numpy": float(fps / cpu_fps),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
        "backend": backend,
        "nface": results["nface"],
        "schedule": head,
        "median_ms": results["schedules"][head]["median_s"] * 1e3,
        "cpu_golden_faces_per_sec": float(cpu_fps),
    }
    if schedule == "all":
        out["schedules"] = {
            s: {**_row(results, s),
                **{k: e[k] for k in ("overlap_efficiency",
                                     "overlap_efficiency_note") if k in e}}
            for s, e in results["schedules"].items()
        }
        out["nocomm_ms"] = results["nocomm"]["median_s"] * 1e3
        ov = results["schedules"].get("overlap", {})
        out["overlap_efficiency"] = ov.get("overlap_efficiency")
        if out["overlap_efficiency"] is None:
            out["overlap_efficiency_note"] = ov.get(
                "overlap_efficiency_note", "overlap schedule not timed")
    if secondary and backend == "sweep":
        # secondary rows, never the headline: bf16 slot weights + bf16
        # gradient stores (~4e-3 bound), the PSD flux model, and the
        # solver-mode per-time-step dataflow
        res, _ = run(replace(cfg, schedule="bulk", meta_dtype="bfloat16",
                             grad_dtype="bfloat16"))
        out["reduced_precision"] = {"meta_dtype": "bfloat16",
                                    "grad_dtype": "bfloat16",
                                    **_row(res)}
        res, _ = run(replace(cfg, schedule="bulk", model="flux"))
        out["flux"] = _row(res)
        out["solver_mode"] = {}
        sweeps = [1] + [int(x) for x in os.environ.get(
            "BENCH_SOLVER_SWEEPS", "4").split(",") if x]
        for n in sweeps:
            res, _ = run(replace(cfg, schedule="bulk", solver_mode=True,
                                 sweeps_per_step=n,
                                 iters=max(50, iters // 6)))
            r = _row(res)
            out["solver_mode"][str(n)] = {
                "ms_per_step": r["median_ms"],
                "ms_per_sweep": r["median_ms"] / n,
                "effective_faces_per_sec": r["faces_per_sec"]}
        log("secondary rows: " + json.dumps(
            {k: out[k] for k in ("reduced_precision", "flux", "solver_mode")}))
    if "c1_fps" in cpu:
        out["cpu_golden_c_faces_per_sec"] = float(cpu["c1_fps"])
        c1d = cpu["c1_dram_fps"]
        node, _lin, _wall = _node_estimate(
            c1d, float(os.environ.get("BENCH_NODE_GBPS", "500")))
        out["cpu_golden_c_dram_faces_per_sec"] = float(c1d)
        out["node_est_faces_per_sec"] = float(node)
        out["vs_2socket_node_est"] = float(fps / node)
        out["vs_node_at_gbps"] = {
            str(g): float(fps / _node_estimate(c1d, g)[0])
            for g in (300, 500, 800)
        }
    out = _finite_or_none(out)
    log("FULL_JSON " + json.dumps(out))
    print(json.dumps(_compact(out)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
