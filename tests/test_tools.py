"""CLI tools: offline partitioner files + golden dump/check round-trip."""

import numpy as np

from cfd_proxy.mesh.reader import partition_path, read_partition
from cfd_proxy.tools.golden import main as golden_main
from cfd_proxy.tools.partition import main as partition_main


def test_partition_tool_and_solver_mesh_input(tmp_path):
    prefix = str(tmp_path / "m")
    rc = partition_main(["--nx", "10", "--ny", "9", "--nz", "8",
                         "--parts", "4", "--out", prefix])
    assert rc == 0
    parts = [read_partition(partition_path(prefix, i, 4)) for i in range(4)]
    assert sum(p.nowned for p in parts) == 10 * 9 * 8

    # solver reads the files (sweep backend)
    from cfd_proxy.solver import SolverConfig, run

    cfg = SolverConfig(mesh_prefix=prefix, parts=4, iters=2, warmup=1,
                       schedule="early", verify=True)
    results, _ = run(cfg)
    assert results["schedules"]["early"]["faces_per_sec"] > 0
    assert results["verification"]["early_vs_bulk_maxabs"] < 1e-4


def test_golden_dump_check_roundtrip(tmp_path):
    ref = str(tmp_path / "golden.nc")
    assert golden_main(["dump", "--nx", "8", "--out", ref]) == 0
    # golden recompute is bitwise
    assert golden_main(["check", "--nx", "8", "--ref", ref]) == 0
    # device path within documented f32 bound, distributed
    assert golden_main(["check", "--nx", "8", "--ref", ref,
                        "--backend", "sweep", "--parts", "2",
                        "--schedule", "overlap"]) == 0
    # perturbed config must FAIL
    assert golden_main(["check", "--nx", "8", "--ref", ref, "--seed", "1"]) == 1


def _model_layout(npart):
    from cfd_proxy.mesh.generator import generate_mesh
    from cfd_proxy.mesh.partition import partition_mesh
    from cfd_proxy.models import GreenGaussSweep

    m = generate_mesh(24, 24, 24, jitter=0.05, diag_frac=0.2, seed=0)
    return GreenGaussSweep(partition_mesh(m, npart), 7)


def test_shard_geometry_uses_production_layout():
    """The model's comm-first, phase-signature relabel makes every real
    phase's send list a few interval slices in the transposed layout: on a
    mesh whose shard boundary is one big signature group, every phase is
    segmented, no gather tail remains, and the pack lowers to slices."""
    model = _model_layout(2)
    lay = model.layout
    for k, perm in enumerate(lay.perms):
        if not perm:
            continue
        assert lay.seg_offs[k] is not None, k
        assert lay.tail_offs[k] is None, k
        assert model._pack_modes[k] in ("slice", "segs"), model._pack_modes


def test_shard_geometry_interval_elimination_p8():
    """At P=8 every shard's pack is pure interval slices: no phase falls
    back to the column gather and no phase carries a gather tail."""
    model = _model_layout(8)
    lay = model.layout
    real = [k for k, perm in enumerate(lay.perms) if perm]
    assert real, "an 8-way partition must exchange"
    assert all(lay.tail_offs[k] is None for k in real)
    assert all(model._pack_modes[k] != "gather" for k in real), \
        model._pack_modes


def test_fixture_generate_and_verify_roundtrip(tmp_path, monkeypatch):
    """fixture tool: generate writes files + manifest; verify regenerates
    byte-identically FROM THE MANIFEST'S STORED RECIPE (so source-recipe
    drift cannot masquerade as hash corruption); a tampered hash must
    MISMATCH (tiny recipe so the test stays fast)."""
    import json as _json

    import cfd_proxy.tools.fixture as fx

    tiny = dict(fx.RECIPE, nx=6, ny=6, nz=5, parts=[2])
    monkeypatch.setattr(fx, "RECIPE", tiny)
    manifest = str(tmp_path / "manifest.json")
    assert fx.main(["generate", "--dir", str(tmp_path / "a"),
                    "--manifest", manifest]) == 0
    assert fx.main(["verify", "--dir", str(tmp_path / "b"),
                    "--manifest", manifest]) == 0
    # source RECIPE drift does NOT break verification of the committed claim
    # — verify rebuilds from the recipe STORED in the manifest
    monkeypatch.setattr(fx, "RECIPE", dict(tiny, seed=tiny["seed"] + 1))
    assert fx.main(["verify", "--dir", str(tmp_path / "c"),
                    "--manifest", manifest]) == 0
    # a tampered hash must be caught
    m = _json.load(open(manifest))
    key = next(k for k in m["sha256"] if k != "_mesh")
    m["sha256"][key] = "0" * 64
    _json.dump(m, open(manifest, "w"))
    assert fx.main(["verify", "--dir", str(tmp_path / "d"),
                    "--manifest", manifest]) == 1


def test_golden_flux_model_roundtrip(tmp_path):
    ref = str(tmp_path / "flux.nc")
    assert golden_main(["dump", "--nx", "8", "--model", "flux",
                        "--out", ref]) == 0
    assert golden_main(["check", "--nx", "8", "--model", "flux",
                        "--ref", ref]) == 0
    assert golden_main(["check", "--nx", "8", "--model", "flux", "--ref", ref,
                        "--backend", "sweep", "--parts", "2",
                        "--schedule", "overlap"]) == 0
