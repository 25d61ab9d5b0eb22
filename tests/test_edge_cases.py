"""Edge cases across the stack: extreme nvar, minimal meshes, no-comm parts."""

import numpy as np
import pytest

from cfd_proxy.mesh.generator import generate_mesh, make_state
from cfd_proxy.mesh.partition import partition_mesh
from cfd_proxy.models import GreenGaussSweep, PSDFluxModel
from cfd_proxy.ops.golden import compute_gradients_gg, scale_gradients
from cfd_proxy.ops.flux import compute_psd_flux, flux_residual_scale
from cfd_proxy.utils.errors import CheckError


def _check_gg(mesh, gvar, model, schedule="overlap"):
    state = model.distribute_state(gvar)
    got = model.gather_global(model.step(state, schedule))
    want = scale_gradients(
        compute_gradients_gg(gvar.astype(np.float64), mesh.faces, mesh.normals),
        mesh.volume, mesh.npoint).reshape(mesh.npoint, -1)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err < 1e-5, err


@pytest.mark.parametrize("nvar", [1, 3, 8])
def test_nvar_extremes(nvar):
    mesh = generate_mesh(6, 5, 4, jitter=0.05, diag_frac=0.2, seed=71)
    gvar = make_state(mesh.npoint, nvar, seed=1)
    _check_gg(mesh, gvar, GreenGaussSweep(partition_mesh(mesh, 2), nvar))


def test_nvar_too_big():
    mesh = generate_mesh(4, 4, 4)
    with pytest.raises(CheckError):
        GreenGaussSweep(partition_mesh(mesh, 1), 9)


def test_minimal_mesh():
    mesh = generate_mesh(2, 2, 2, seed=3)   # 8 points, 12 faces
    gvar = make_state(mesh.npoint, 4, seed=2)
    _check_gg(mesh, gvar, GreenGaussSweep(partition_mesh(mesh, 1), 4),
              schedule="bulk")


def test_flux_min_velocity_rows():
    # nvar == 3: all rows are velocity AND transported quantities
    mesh = generate_mesh(5, 5, 4, jitter=0.05, seed=5)
    gvar = make_state(mesh.npoint, 3, seed=4)
    model = PSDFluxModel(partition_mesh(mesh, 2), 3)
    state = model.distribute_state(gvar)
    got = model.gather_global(model.step(state, "early"))
    want = flux_residual_scale(
        compute_psd_flux(gvar.astype(np.float64), mesh.faces, mesh.normals),
        mesh.volume, mesh.npoint)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err < 1e-5, err


def test_isolated_partition_no_comm():
    # npart where one shard may have few/no neighbors still works
    mesh = generate_mesh(8, 3, 3, jitter=0.0, seed=6)   # elongated: chain cuts
    parts = partition_mesh(mesh, 8)
    model = GreenGaussSweep(parts, 4)
    gvar = make_state(mesh.npoint, 4, seed=7)
    _check_gg(mesh, gvar, model)


def test_two_layer_ghosts_cover_two_hops():
    mesh = generate_mesh(8, 6, 5, jitter=0.05, seed=8)
    parts = partition_mesh(mesh, 4, ghost_layers=2)
    # every point within graph distance 2 of an owned point is present
    import scipy.sparse as sp

    N = mesh.npoint
    A = sp.coo_matrix((np.ones(mesh.nface), (mesh.faces[:, 0], mesh.faces[:, 1])),
                      shape=(N, N))
    A = ((A + A.T) > 0).astype(np.int8)
    for p in parts:
        owned = np.zeros(N, bool)
        owned[p.global_ids[: p.nowned]] = True
        hop1 = (A @ owned) > 0
        hop2 = (A @ (owned | hop1)) > 0
        want = np.flatnonzero(owned | hop1 | hop2)
        assert np.isin(want, p.global_ids).all()


def test_three_layer_ghosts_and_model():
    """Depth-3 halo closure (BFS property at 3 hops) + distributed model
    correctness on it — multi-round ghost layers beyond the depth-2 gate
    (BASELINE config 5 class)."""
    import scipy.sparse as sp

    mesh = generate_mesh(8, 6, 5, jitter=0.05, seed=8)
    parts = partition_mesh(mesh, 4, ghost_layers=3)
    N = mesh.npoint
    A = sp.coo_matrix((np.ones(mesh.nface), (mesh.faces[:, 0], mesh.faces[:, 1])),
                      shape=(N, N))
    A = ((A + A.T) > 0).astype(np.int8)
    for p in parts:
        owned = np.zeros(N, bool)
        owned[p.global_ids[: p.nowned]] = True
        cover = owned
        for _ in range(3):
            cover = cover | ((A @ cover) > 0)
        assert np.isin(np.flatnonzero(cover), p.global_ids).all()
    gvar = make_state(mesh.npoint, 4, seed=9)
    _check_gg(mesh, gvar, GreenGaussSweep(parts, 4))


def test_eight_way_overlap():
    """8 shards of a small mesh (several exchange phases per shard): the
    overlap schedule stays correct."""
    mesh = generate_mesh(7, 6, 5, jitter=0.05, seed=21)
    parts = partition_mesh(mesh, 8)
    model = GreenGaussSweep(parts, 4)
    assert model.layout.nphases > 1
    gvar = make_state(mesh.npoint, 4, seed=22)
    _check_gg(mesh, gvar, model, schedule="overlap")


def test_flux_multislice_bf16_corner():
    """Combinatorial corner: flux op at 8 shards + full reduced precision
    in one model; bounded vs the plain f32 flux result."""
    mesh = generate_mesh(7, 6, 5, jitter=0.05, seed=23)
    parts = partition_mesh(mesh, 8)
    gvar = make_state(mesh.npoint, 4, seed=24)
    outs = {}
    for tag, kw in (("plain", {}),
                    ("corner", dict(meta_dtype="bfloat16",
                                    halo_dtype="bfloat16",
                                    grad_dtype="bfloat16"))):
        m = GreenGaussSweep(parts, 4, op="flux", **kw)
        outs[tag] = m.gather_global(
            np.asarray(m.step(m.distribute_state(gvar), "overlap")))
    scale = max(1.0, np.abs(outs["plain"]).max())
    err = np.abs(outs["corner"] - outs["plain"]).max() / scale
    # the nonlinear upwind dissipation (|u·w| of two approximations) sees
    # every bf16 rounding; the stores round once more
    assert 0 < err < 2e-2, err
