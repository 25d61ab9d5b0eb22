"""Preprocessing invariants + single-shard JAX sweep vs golden (bit-match)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cfd_proxy.mesh.generator import generate_mesh, make_state
from cfd_proxy.ops.golden import compute_gradients_gg
from cfd_proxy.ops.prep import SweepPads, build_sweep_plan
from cfd_proxy.ops.sweep_jax import (
    device_sweep,
    sweep_boundary,
    sweep_bulk,
    sweep_interior,
    sweep_rows_segment,
)

NVAR = 5


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(7, 6, 5, jitter=0.1, diag_frac=0.25, shuffle=True, seed=11)


@pytest.fixture(scope="module")
def send_points(mesh):
    rng = np.random.default_rng(5)
    return np.unique(rng.integers(0, mesh.npoint, size=30))


@pytest.fixture(scope="module")
def plan(mesh, send_points):
    return build_sweep_plan(
        mesh.faces, mesh.normals, mesh.npoint, mesh.npoint, send_points
    )


def test_plan_invariants(mesh, plan, send_points):
    # every real face appears exactly once, with its original normal
    assert plan.nface == mesh.nface
    assert sorted(plan.face_perm.tolist()) == list(range(mesh.nface))
    np.testing.assert_array_equal(plan.faces[: plan.nface_b], mesh.faces[plan.face_perm[: plan.nface_b]])
    # boundary faces touch a send point; interior faces touch none
    is_send = np.zeros(mesh.npoint, bool)
    is_send[send_points] = True
    b_orig = plan.face_perm[: plan.nface_b]
    i_orig = plan.face_perm[plan.nface_b :]
    assert is_send[mesh.faces[b_orig]].any(axis=1).all()
    assert not is_send[mesh.faces[i_orig]].any(axis=1).any()
    # padding rows are inert
    assert (plan.normals[plan.nface_b : plan.nface_b_pad] == 0).all()
    nface_i = plan.nface - plan.nface_b
    assert (plan.normals[plan.nface_b_pad + nface_i :] == 0).all()
    # ELL full: each face id appears once with +1 and once with -1
    f = plan.ell_full.inc_face.ravel()
    s = plan.ell_full.inc_sign.ravel()
    for sign in (1, -1):
        ids = np.sort(f[s == sign])
        expect_b = plan.face_perm[: plan.nface_b]
        expect = np.sort(
            np.concatenate([
                np.arange(plan.nface_b),
                plan.nface_b_pad + np.arange(nface_i),
            ])
        )
        np.testing.assert_array_equal(ids, expect)
    # sorted rows cover every incidence once
    real = plan.row_sign != 0
    assert real.sum() == 2 * plan.nface
    assert (np.diff(plan.row_point) >= 0).all()


def _golden_padded(var_pad, plan):
    g = compute_gradients_gg(var_pad, plan.faces, plan.normals)
    return g.reshape(g.shape[0], -1)


def test_bulk_exact_bitmatch(mesh, plan):
    var = make_state(mesh.npoint, NVAR, seed=2)
    var_pad = np.zeros((plan.npoint_pad, NVAR))
    var_pad[: mesh.npoint] = var
    ds = device_sweep(plan, dtype=jnp.float64)
    got = np.asarray(sweep_bulk(jnp.asarray(var_pad), ds, exact=True))
    want = _golden_padded(var_pad, plan)
    np.testing.assert_array_equal(got, want)  # bit-for-bit in f64


def test_schedule_split_bitmatches_bulk(mesh, plan):
    var = make_state(mesh.npoint, NVAR, seed=3)
    var_pad = np.zeros((plan.npoint_pad, NVAR))
    var_pad[: mesh.npoint] = var
    ds = device_sweep(plan, dtype=jnp.float64)
    v = jnp.asarray(var_pad)
    bulk = np.asarray(sweep_bulk(v, ds, exact=True))
    gb = sweep_boundary(v, ds, exact=True)
    split = np.asarray(sweep_interior(v, ds, gb, exact=True))
    np.testing.assert_array_equal(split, bulk)


def test_tree_and_segment_backends_close(mesh, plan):
    var = make_state(mesh.npoint, NVAR, seed=4)
    var_pad = np.zeros((plan.npoint_pad, NVAR))
    var_pad[: mesh.npoint] = var
    ds = device_sweep(plan, dtype=jnp.float64)
    v = jnp.asarray(var_pad)
    want = _golden_padded(var_pad, plan)
    np.testing.assert_allclose(np.asarray(sweep_bulk(v, ds, exact=False)), want, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(sweep_rows_segment(v, ds)), want, rtol=1e-12)


def test_golden_orig_vs_reordered_tolerance(mesh, plan):
    # reordering changes f64 bits but not values beyond roundoff
    var = make_state(mesh.npoint, NVAR, seed=6)
    var_pad = np.zeros((plan.npoint_pad, NVAR))
    var_pad[: mesh.npoint] = var
    orig = compute_gradients_gg(var, mesh.faces, mesh.normals).reshape(mesh.npoint, -1)
    reord = _golden_padded(var_pad, plan)[: mesh.npoint]
    np.testing.assert_allclose(reord, orig, rtol=1e-11, atol=1e-11)


def test_pads_produce_uniform_shapes(mesh, send_points):
    p1 = build_sweep_plan(mesh.faces, mesh.normals, mesh.npoint, mesh.npoint, send_points)
    half = mesh.nface // 2
    p2 = build_sweep_plan(
        mesh.faces[:half], mesh.normals[:half], mesh.npoint, mesh.npoint, send_points[:5]
    )
    pads = SweepPads.max_of([p1, p2])
    q1 = build_sweep_plan(mesh.faces, mesh.normals, mesh.npoint, mesh.npoint,
                          send_points, pads=pads)
    q2 = build_sweep_plan(mesh.faces[:half], mesh.normals[:half], mesh.npoint,
                          mesh.npoint, send_points[:5], pads=pads)
    assert q1.faces.shape == q2.faces.shape
    assert q1.ell_full.inc_face.shape == q2.ell_full.inc_face.shape
    assert q1.ell_boundary.inc_face.shape == q2.ell_boundary.inc_face.shape
    assert q1.ell_interior.inc_face.shape == q2.ell_interior.inc_face.shape
    assert q1.row_face.shape == q2.row_face.shape
    # padded plan still computes the right answer
    var = make_state(mesh.npoint, NVAR, seed=7)
    var_pad = np.zeros((q1.npoint_pad, NVAR))
    var_pad[: mesh.npoint] = var
    ds = device_sweep(q1, dtype=jnp.float64)
    got = np.asarray(sweep_bulk(jnp.asarray(var_pad), ds, exact=True))[: mesh.npoint]
    want = compute_gradients_gg(var, mesh.faces, mesh.normals).reshape(mesh.npoint, -1)
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11)
