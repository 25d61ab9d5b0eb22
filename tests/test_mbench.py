"""Tests for tools/mbench.py — the model-level paired A/B harness."""

import dataclasses

import pytest

from cfd_proxy.solver import SolverConfig
from cfd_proxy.tools.mbench import _MODEL_FIELDS, main, parse_overrides
from cfd_proxy.utils.errors import CheckError


def test_parse_overrides_types():
    base = SolverConfig()
    got = parse_overrides(
        base, "meta_dtype=bfloat16,nvar=5,solver_mode=1,sweeps_per_step=3")
    assert got.meta_dtype == "bfloat16"
    assert got.nvar == 5 and isinstance(got.nvar, int)
    assert got.solver_mode is True
    assert got.sweeps_per_step == 3
    # base is untouched (replace, not mutation)
    assert base.meta_dtype == "float32" and base.nvar == 7


def test_parse_overrides_rejects_unknown():
    with pytest.raises(CheckError, match="unknown SolverConfig field"):
        parse_overrides(SolverConfig(), "not_a_field=1")
    with pytest.raises(CheckError, match="field=value"):
        parse_overrides(SolverConfig(), "oops")


def test_parse_overrides_rejects_shared_mesh_fields():
    """Mesh-shaping fields (nx/parts/...) are built from the SHARED base —
    a per-side override would be silently ignored and record a false ~1.00
    'no difference' verdict; they must be rejected up front."""
    for spec in ("nx=64", "parts=2", "ghost_layers=2", "iters=5"):
        with pytest.raises(CheckError, match="cannot differ"):
            parse_overrides(SolverConfig(), spec)


def test_model_fields_exist():
    names = {f.name for f in dataclasses.fields(SolverConfig)}
    assert set(_MODEL_FIELDS) <= names


def test_build_consumes_every_model_field():
    """Every _MODEL_FIELDS entry must be forwarded by _build — a field that
    parse_overrides accepts but _build drops makes both sides build the SAME
    model and records a false ~1.00 verdict."""
    import inspect

    from cfd_proxy.tools import mbench

    src = inspect.getsource(mbench._build)
    missing = [f for f in _MODEL_FIELDS if f"cfg.{f}" not in src]
    assert not missing, f"_build drops model fields: {missing}"


def test_build_honors_dtypes():
    from cfd_proxy.mesh.generator import generate_mesh
    from cfd_proxy.mesh.partition import partition_mesh
    from cfd_proxy.tools.mbench import _build

    m = generate_mesh(10, 9, 8, jitter=0.05, diag_frac=0.2, seed=0)
    parts = partition_mesh(m, 1, ghost_layers=1)
    cfg = SolverConfig(meta_dtype="bfloat16", halo_dtype="bfloat16",
                       grad_dtype="bfloat16", model="flux")
    model = _build(cfg, parts)
    assert (model.meta_dtype, model.halo_dtype, model.grad_dtype) == (
        "bfloat16",) * 3
    assert model.op == "flux"


def test_mbench_shared_model_schedule_ab(capsys):
    """Schedule A/B on equal configs shares one model and emits the paired
    ratio line.  Tiny mesh on the CPU: ratios are mechanics-only."""
    rc = main(["--nx", "10", "--ny", "9", "--nz", "8", "--parts", "1",
               "--iters", "20", "--repeats", "2", "--warmup", "0",
               "--a", "schedule=bulk", "--b", "schedule=early", "--json"])
    assert rc == 0
    out = capsys.readouterr()
    assert '"ratio_a_over_b"' in out.out
    assert "share one model" in out.err


def test_mbench_two_models(capsys):
    rc = main(["--nx", "10", "--ny", "9", "--nz", "8", "--parts", "1",
               "--iters", "20", "--repeats", "2", "--warmup", "0",
               "--b", "grad_dtype=bfloat16", "--json"])
    assert rc == 0
    assert '"pairs": 2' in capsys.readouterr().out
