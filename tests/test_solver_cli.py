"""Solver CLI surface: happy path, JSON output, error paths."""

import json

import pytest

from cfd_proxy.solver import main


def test_cli_json_all_schedules(capsys):
    rc = main(["--nx", "9", "--ny", "8", "--nz", "7", "--parts", "2",
               "--iters", "3", "--schedule", "all", "--json"])
    assert rc == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(d["schedules"]) == ["bulk", "early", "overlap"]
    assert d["npart"] == 2 and d["backend"] == "sweep"
    assert d["verification"]["bulk_vs_golden_relmax"] < 1e-5
    assert d["verification"]["early_vs_bulk_maxabs"] < 1e-5
    for sched in ("bulk", "early", "overlap"):
        assert d["verification"][f"{sched}_vs_golden_relmax"] < 1e-5
    assert d["platform"] == "cpu" and d["device_kind"]


def test_cli_table_output(capsys):
    rc = main(["--nx", "8", "--parts", "1", "--iters", "2",
               "--schedule", "bulk", "--no-verify"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "variant" in out and "Mfaces/s" in out


def test_cli_table_printer_handles_null_overlap_eff(capsys, monkeypatch):
    """Regression: when comm cost is unmeasurable the schedules carry
    overlap_efficiency=None + a _note (null-with-reason) — the pretty
    printer must print the reason, not crash %-formatting None (found by
    the round-3 verify drive; whether the None path triggers in a real run
    depends on the noise floor, so the results dict is pinned here)."""
    import cfd_proxy.solver as sv

    results = {
        "device": "x", "npart": 1, "npoint": 1, "nface": 1, "nvar": 7,
        "dtype": "float32",
        "schedules": {
            "bulk": {"faces_per_sec": 1e6},
            "overlap": {"faces_per_sec": 1e6, "overlap_efficiency": None,
                        "overlap_efficiency_note": "comm cost unmeasurable"},
            "early": {"faces_per_sec": 1e6, "overlap_efficiency": 0.5},
        },
    }
    monkeypatch.setattr(sv, "run", lambda cfg: (results, []))
    monkeypatch.setattr(sv, "format_stats_table", lambda s, ref: "")
    rc = sv.main(["--nx", "8", "--parts", "1", "--no-verify"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "overlap_eff=n/a (comm cost unmeasurable)" in out
    assert "overlap_eff=50.0%" in out


def test_cli_solver_mode(capsys):
    rc = main(["--nx", "8", "--ny", "8", "--nz", "7", "--parts", "2",
               "--iters", "2", "--schedule", "bulk", "--solver-mode",
               "--no-verify", "--json"])
    assert rc == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d["solver_mode"] is True
    assert "bulk" in d["schedules"]
    assert d["backend"] == "sweep" and d["sweeps_per_step"] == 1


def test_cli_solver_mode_sweeps(capsys):
    """--sweeps-per-step N: the multi-stage amortization axis — recorded in
    the JSON, and faces/sec counts SWEPT faces (N gradient evaluations per
    timed step)."""
    rc = main(["--nx", "8", "--ny", "8", "--nz", "7", "--parts", "2",
               "--iters", "2", "--schedule", "bulk", "--solver-mode",
               "--sweeps-per-step", "3", "--no-verify", "--json"])
    assert rc == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d["sweeps_per_step"] == 3
    e = d["schedules"]["bulk"]
    if e["median_s"] is not None:   # tiny meshes can sit below noise floor
        assert e["faces_per_sec"] == pytest.approx(
            3 * d["nface"] / e["median_s"])


def test_cli_sweeps_requires_solver_mode():
    with pytest.raises(SystemExit, match="solver-mode"):
        main(["--nx", "8", "--parts", "1", "--sweeps-per-step", "2"])


def test_cli_profile_failure_fails_the_run(monkeypatch):
    """A requested --profile that cannot start fails the run instead of
    silently timing without a trace."""
    import jax.profiler

    def broken(_dir):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(jax.profiler, "trace", broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        main(["--nx", "8", "--parts", "1", "--iters", "2",
              "--schedule", "bulk", "--no-verify", "--profile", "/tmp/x"])


def test_cli_solver_mode_requires_pallas():
    with pytest.raises(SystemExit, match="sweep"):
        main(["--nx", "8", "--parts", "1", "--backend", "xla",
              "--solver-mode"])


def test_cli_missing_mesh_files():
    with pytest.raises(SystemExit) as e:
        main(["--mesh", "/nonexistent/prefix", "--parts", "2"])
    assert "tools.partition" in str(e.value)


def test_cli_flux_requires_pallas():
    with pytest.raises(SystemExit) as e:
        main(["--model", "flux", "--backend", "xla", "--nx", "8"])
    assert "sweep" in str(e.value)


def test_platform_flag_cpu_multi_part():
    """--platform cpu (checked to take effect) on a multi-part run over the
    virtual CPU devices."""
    from cfd_proxy.solver import SolverConfig, run

    cfg = SolverConfig(nx=6, ny=6, nz=6, parts=4, iters=1, warmup=0,
                       schedule="early", platform="cpu", verify=True)
    results, _ = run(cfg)
    assert results["verification"]["early_vs_bulk_maxabs"] < 1e-4
