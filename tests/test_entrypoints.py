"""Entry points: bench.py main(), chip_smoke.py, the compile cache and the
multi-device dry run (CPU, tiny shapes)."""

import json
import sys

import pytest


def test_bench_main_cpu(monkeypatch, capsys):
    """An explicit JAX_PLATFORMS=cpu run (conftest sets it) is a small CPU
    rehearsal: one strict-JSON line naming the platform it ran on."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("BENCH_NX", "8")
    monkeypatch.setenv("BENCH_ITERS", "3")
    monkeypatch.setenv("BENCH_SCHEDULE", "bulk")
    sys.path.insert(0, ".")
    import bench

    assert bench.main() == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    d = json.loads(line)   # strict JSON (NaNs must have been nulled)
    assert d["metric"] == "faces_per_sec_per_chip"
    assert d["nface"] > 0
    assert d["platform"] == "cpu" and d["device_count"] >= 1
    # value may be null on tiny meshes (below dispatch-noise floor) — it
    # must still be present and JSON-clean
    assert "value" in d and "vs_baseline" in d


@pytest.mark.parametrize("allow", [False, True])
def test_bench_refuses_without_gpu(monkeypatch, allow):
    """No GPU and no explicit JAX_PLATFORMS=cpu: the measurement entry
    points exit non-zero instead of timing the CPU."""
    from cfd_proxy.utils.device import require_gpu

    monkeypatch.setenv("JAX_PLATFORMS", "")
    with pytest.raises(SystemExit, match="no GPU"):
        require_gpu(allow_explicit_cpu=allow)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    if allow:
        assert require_gpu(allow_explicit_cpu=True) == "cpu"
    else:
        with pytest.raises(SystemExit, match="no GPU"):
            require_gpu()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result line on the CPU —
    and also as a lone file outside the repo (nothing to import)."""
    import os
    import shutil
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(root, "chip_smoke.py")
    cwd = root
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_compile_cache_dir(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins untouched; otherwise the cache sits
    at the fixed <checkout>/.jax_cache, which git ignores."""
    import os

    import jax

    from cfd_proxy.utils import cache

    old = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
        jax.config.update("jax_compilation_cache_dir", None)
        assert cache.enable_compile_cache() == "/elsewhere"
        assert jax.config.jax_compilation_cache_dir is None
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        path = cache.enable_compile_cache()
        assert path == os.path.join(cache.CHECKOUT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert os.path.isfile(os.path.join(cache.CHECKOUT, "chip_smoke.py"))
        with open(os.path.join(cache.CHECKOUT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_node_estimate_physical():
    """The 2-socket-node estimate is min(linear-64, bus wall): a high
    per-core DRAM rate makes linear-64 imply more traffic than the assumed
    node bus, so the wall binds; a low rate stays below the wall and linear
    scaling binds."""
    sys.path.insert(0, ".")
    import bench

    node, lin, wall = bench._node_estimate(14.9e6, 500.0)
    assert node == wall < lin                    # bus-capped
    node2, lin2, wall2 = bench._node_estimate(5.3e6, 500.0)
    assert node2 == lin2 < wall2                 # core-capped
    assert wall == wall2 == pytest.approx(500e9 / 816)


@pytest.mark.parametrize("n", [8])
def test_dryrun_multichip(n):
    """The multi-device validation path at the conftest device count: the
    XLA and sweep models, all schedules, plus the bf16 and solver legs."""
    sys.path.insert(0, ".")
    import __graft_entry__ as ge

    ge.dryrun_multichip(n)


def test_entry_compiles():
    import jax

    sys.path.insert(0, ".")
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape[0] > 0
