"""Multi-device dry run: `__graft_entry__.dryrun_multichip` at a chosen
virtual-CPU device count, reported as one JSON line (optionally a file):

    python -m cfd_proxy.tools.dryrun --n 64 --out dryrun_64.json

Sets XLA_FLAGS' host device count and JAX_PLATFORMS=cpu itself.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cfd_proxy.tools.dryrun")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--out", default=None, help="write a JSON artifact here")
    args = ap.parse_args(argv)

    # replace any existing device-count flag with an exact token (a naive
    # substring test lets count=6 match a pre-set count=64 and the artifact
    # would record a device count the run never used)
    flag = f"--xla_force_host_platform_device_count={args.n}"
    toks = [t for t in os.environ.get("XLA_FLAGS", "").split()
            if not t.startswith("--xla_force_host_platform_device_count=")]
    os.environ["XLA_FLAGS"] = " ".join(toks + [flag])
    os.environ["JAX_PLATFORMS"] = "cpu"

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import __graft_entry__ as ge

    t0 = time.perf_counter()
    ok, err, legs = True, None, None
    try:
        legs = ge.dryrun_multichip(args.n)
    except Exception as e:  # noqa: BLE001 — artifact records the failure
        ok, err = False, f"{type(e).__name__}: {e}"
    wall = time.perf_counter() - t0
    rec = {
        "n_devices": args.n,
        "ok": ok,
        "error": err,
        "wall_s": round(wall, 1),
        "date": time.strftime("%Y-%m-%d"),
        "legs": legs,
    }
    line = json.dumps(rec)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
