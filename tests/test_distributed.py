"""Distributed schedules on a virtual 8-device CPU mesh.

The rebuild's analogue of the reference's cross-variant verification run
(SURVEY.md §4b): every schedule must agree — here strengthened to BIT-equality
in f64 — and P-shard results must match the 1-shard/global result.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cfd_proxy.mesh.generator import generate_mesh, make_state
from cfd_proxy.mesh.partition import partition_mesh
from cfd_proxy.models import GreenGaussModel
from cfd_proxy.ops.golden import compute_gradients_gg, scale_gradients

NVAR = 5


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(10, 9, 8, jitter=0.05, diag_frac=0.25, shuffle=True, seed=31)


@pytest.fixture(scope="module")
def gvar(mesh):
    return make_state(mesh.npoint, NVAR, seed=13)


@pytest.fixture(scope="module")
def gref(mesh, gvar):
    g = compute_gradients_gg(gvar, mesh.faces, mesh.normals)
    g = scale_gradients(g, mesh.volume, mesh.npoint)
    return g.reshape(mesh.npoint, -1)


@pytest.mark.parametrize("npart,ghost_layers", [(2, 1), (4, 1), (8, 1), (4, 2)])
def test_schedules_bitwise_equal_and_correct(mesh, gvar, gref, npart, ghost_layers):
    parts = partition_mesh(mesh, npart, ghost_layers=ghost_layers)
    model = GreenGaussModel(parts, NVAR, dtype=jnp.float64)
    var = model.distribute_state(gvar)
    # state distribution: every local row (owned + ghosts) matches global
    v = np.asarray(var)
    for i, p in enumerate(parts):
        np.testing.assert_array_equal(v[i, : p.npoint], gvar[p.global_ids])

    grads = {s: np.asarray(model.step(var, s, exact=True)) for s in ("bulk", "early", "overlap")}
    # all schedules bit-identical (f64)
    np.testing.assert_array_equal(grads["early"], grads["bulk"])
    np.testing.assert_array_equal(grads["overlap"], grads["bulk"])
    g = grads["bulk"]
    for i, p in enumerate(parts):
        # owned rows match the global golden (scaled)
        np.testing.assert_allclose(
            g[i, : p.nowned], gref[p.global_ids[: p.nowned]], rtol=1e-12, atol=1e-12
        )
        # ghost rows were filled by the exchange with owners' scaled values
        np.testing.assert_allclose(
            g[i, p.nowned : p.npoint], gref[p.global_ids[p.nowned : p.npoint]],
            rtol=1e-12, atol=1e-12,
        )
        # ghost rows bitwise-equal owner's owned rows
        gid = p.global_ids[p.nowned : p.npoint]
        for j, q in enumerate(parts):
            sel = np.isin(gid, q.global_ids[: q.nowned])
            if sel.sum() == 0:
                continue
            ql = np.searchsorted(q.global_ids[: q.nowned], gid[sel])
            np.testing.assert_array_equal(g[i, p.nowned : p.npoint][sel], g[j, ql])


def test_p_shard_matches_single_shard(mesh, gvar, gref):
    parts1 = partition_mesh(mesh, 1)
    m1 = GreenGaussModel(parts1, NVAR, dtype=jnp.float64)
    g1 = m1.gather_global(m1.step(m1.distribute_state(gvar), "bulk", exact=True))
    np.testing.assert_allclose(g1, gref, rtol=1e-12, atol=1e-12)

    parts4 = partition_mesh(mesh, 4)
    m4 = GreenGaussModel(parts4, NVAR, dtype=jnp.float64)
    g4 = m4.gather_global(m4.step(m4.distribute_state(gvar), "early", exact=True))
    np.testing.assert_allclose(g4, g1, rtol=1e-12, atol=1e-12)


def test_f32_path_close(mesh, gvar, gref):
    parts = partition_mesh(mesh, 4)
    model = GreenGaussModel(parts, NVAR, dtype=jnp.float32)
    var = model.distribute_state(gvar)
    g = model.gather_global(model.step(var, "overlap"))
    np.testing.assert_allclose(g, gref, rtol=2e-4, atol=2e-4)
