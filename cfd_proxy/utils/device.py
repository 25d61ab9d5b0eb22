"""Which device a measurement ran on, and refusing to measure without one."""

from __future__ import annotations

import os
import subprocess


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them ("name,
    power.limit" per card), or a note when nvidia-smi is unavailable."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def require_gpu(*, allow_explicit_cpu: bool = False) -> str:
    """Exit non-zero unless JAX's default backend is a GPU.

    allow_explicit_cpu: also accept the CPU when the user asked for it by
    setting JAX_PLATFORMS=cpu (a deliberate small-size CPU run).  Returns
    the backend name."""
    import jax

    backend = jax.default_backend()
    if backend == "gpu":
        return backend
    explicit = os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu"
    if allow_explicit_cpu and explicit and backend == "cpu":
        return backend
    raise SystemExit(
        f"no GPU: JAX's default backend is {backend!r}"
        + ("; set JAX_PLATFORMS=cpu to run on the CPU deliberately"
           if allow_explicit_cpu else ""))
