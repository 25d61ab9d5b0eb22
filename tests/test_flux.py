"""Secondary flux kernel: golden semantics + the distributed flux model."""

import numpy as np
import pytest

from cfd_proxy.mesh.generator import generate_mesh, make_state
from cfd_proxy.mesh.partition import partition_mesh
from cfd_proxy.models import PSDFluxModel
from cfd_proxy.ops.flux import compute_psd_flux, flux_residual_scale

NVAR = 5


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(8, 8, 7, jitter=0.05, diag_frac=0.25, shuffle=True, seed=51)


def test_flux_conservation(mesh):
    var = make_state(mesh.npoint, NVAR, seed=3)
    res = compute_psd_flux(var, mesh.faces, mesh.normals)
    # conservative: contributions cancel in the global sum
    np.testing.assert_allclose(res.sum(axis=0), np.zeros(NVAR), atol=1e-10)


def test_flux_upwind_limit(mesh):
    # constant q, velocity field: F = (uLn+uRn)/2 * q; grad of constant -> the
    # central term survives, dissipation term vanishes
    var = np.ones((mesh.npoint, NVAR))
    res = compute_psd_flux(var, mesh.faces, mesh.normals)
    # dissipation term is zero when qL == qR: recompute central only
    p0, p1 = mesh.faces[:, 0], mesh.faces[:, 1]
    uLn = np.einsum("fd,fd->f", var[p0][:, :3], mesh.normals)
    uRn = np.einsum("fd,fd->f", var[p1][:, :3], mesh.normals)
    F = 0.5 * (uLn + uRn)[:, None] * np.ones((1, NVAR))
    want = np.zeros_like(res)
    np.add.at(want, p0, F)
    np.subtract.at(want, p1, F)
    # accumulation order differs → roundoff-level absolute differences on
    # near-cancelling sums
    np.testing.assert_allclose(res, want, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("ghost_layers", [1, 2])
@pytest.mark.parametrize("npart", [1, 4])
def test_flux_model_matches_golden(mesh, npart, ghost_layers):
    gvar = make_state(mesh.npoint, NVAR, seed=7)
    gref = flux_residual_scale(
        compute_psd_flux(gvar.astype(np.float64), mesh.faces, mesh.normals),
        mesh.volume, mesh.npoint)
    parts = partition_mesh(mesh, npart, ghost_layers=ghost_layers)
    model = PSDFluxModel(parts, NVAR)
    state = model.distribute_state(gvar)
    denom = max(1.0, np.abs(gref).max())
    outs = {}
    for s in ("bulk", "early", "overlap"):
        outs[s] = np.asarray(model.step(state, s))
        got = model.gather_global(outs[s])
        err = np.abs(got - gref).max() / denom
        assert err < 1e-5, f"{s}: rel err {err}"
    # identical order/scale by construction; ≤ULPs of compiler contraction
    scale_ref = max(1.0, np.abs(outs["bulk"]).max())
    assert np.abs(outs["early"] - outs["bulk"]).max() / scale_ref < 1e-6
    assert np.abs(outs["overlap"] - outs["early"]).max() / scale_ref < 1e-6
