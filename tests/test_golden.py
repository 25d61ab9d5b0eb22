"""Stage-0 golden semantics: hand-computed gradients + linear exactness."""

import numpy as np

from cfd_proxy.mesh.generator import generate_mesh, make_state
from cfd_proxy.ops.golden import compute_gradients_gg, scale_gradients


def test_two_face_mesh_by_hand():
    # 3 points, 2 faces: (0,1) with n=(1,0,0); (1,2) with n=(0,2,0); nvar=1
    var = np.array([[1.0], [3.0], [5.0]])
    faces = np.array([[0, 1], [1, 2]], dtype=np.int32)
    normals = np.array([[1.0, 0, 0], [0, 2.0, 0]])
    grad = compute_gradients_gg(var, faces, normals)
    # face0: avg=2 -> +2*(1,0,0) to p0, -2*(1,0,0) to p1
    # face1: avg=4 -> +4*(0,2,0) to p1, -4*(0,2,0) to p2
    np.testing.assert_array_equal(grad[0, 0], [2.0, 0.0, 0.0])
    np.testing.assert_array_equal(grad[1, 0], [-2.0, 8.0, 0.0])
    np.testing.assert_array_equal(grad[2, 0], [0.0, -8.0, 0.0])


def test_accumulation_order_is_sequential():
    # same point hit by + and − across faces: order must interleave per face
    var = np.array([[1.0], [1.0]])
    faces = np.array([[0, 1], [0, 1], [1, 0]], dtype=np.int32)
    normals = np.random.default_rng(1).standard_normal((3, 3))
    grad = compute_gradients_gg(var, faces, normals)
    ref = np.zeros((2, 1, 3))
    for f in range(3):
        p0, p1 = faces[f]
        avg = 0.5 * (var[p0, 0] + var[p1, 0])
        ref[p0, 0] += avg * normals[f]
        ref[p1, 0] -= avg * normals[f]
    np.testing.assert_array_equal(grad, ref)  # bitwise


def test_linear_field_exact_on_uniform_grid():
    m = generate_mesh(6, 5, 4, jitter=0.0, diag_frac=0.0, shuffle=True, seed=3)
    a = np.array([[1.5, -2.0, 0.25]])  # gradient coefficients, nvar=1
    var = (m.coords @ a.T)  # linear field
    grad = compute_gradients_gg(var, m.faces, m.normals)
    grad = scale_gradients(grad, m.volume, m.npoint)
    # interior points (full dual closure): gradient must equal `a`
    deg = np.bincount(m.faces.ravel(), minlength=m.npoint)
    interior = deg == 6
    assert interior.sum() > 10
    np.testing.assert_allclose(grad[interior, 0, :], np.tile(a, (interior.sum(), 1)),
                               rtol=1e-12, atol=1e-12)


def test_generator_valence_skew_and_determinism():
    m1 = generate_mesh(8, 8, 8, diag_frac=0.3, shuffle=True, seed=7)
    m2 = generate_mesh(8, 8, 8, diag_frac=0.3, shuffle=True, seed=7)
    np.testing.assert_array_equal(m1.faces, m2.faces)
    np.testing.assert_array_equal(m1.coords, m2.coords)
    deg = np.bincount(m1.faces.ravel(), minlength=m1.npoint)
    assert deg.max() > deg.min()  # skewed valence
    assert (m1.faces[:, 0] < m1.faces[:, 1]).all()
    v = make_state(m1.npoint, 5, seed=0)
    assert v.shape == (m1.npoint, 5)


def test_linear_field_exact_on_stretched_grid():
    """Boundary-layer anisotropy (the F6-like mesh family): geometric z
    stretching with consistent dual areas/volumes keeps the Green-Gauss
    linear-field anchor exact at interior points, across a ~1e3 volume
    dynamic range."""
    m = generate_mesh(6, 5, 26, jitter=0.0, diag_frac=0.0, shuffle=True,
                      seed=3, stretch=1.35)
    ratio = m.volume.max() / m.volume.min()
    assert ratio > 1e3, ratio
    a = np.array([[1.5, -2.0, 0.25]])
    var = (m.coords @ a.T)
    grad = compute_gradients_gg(var, m.faces, m.normals)
    grad = scale_gradients(grad, m.volume, m.npoint)
    deg = np.bincount(m.faces.ravel(), minlength=m.npoint)
    interior = deg == 6
    assert interior.sum() > 10
    np.testing.assert_allclose(grad[interior, 0, :],
                               np.tile(a, (interior.sum(), 1)),
                               rtol=1e-9, atol=1e-9)


def test_hub_mesh_valence_tail_and_pallas():
    """The high-valence stress mode: hubs reach K ~16-20 (real
    TAU median-dual meshes carry such a tail near singular vertices; the
    base generator tops out at 8).  The full sweep path — slot tables with
    kslots at the tail max, all schedules — must agree with the f64 golden
    on the hub mesh."""
    from cfd_proxy.mesh.partition import partition_mesh
    from cfd_proxy.models import GreenGaussSweep

    m = generate_mesh(10, 9, 8, jitter=0.05, diag_frac=0.2, shuffle=True,
                      seed=4, hub_frac=0.03, hub_extra=12)
    deg = np.bincount(m.faces.ravel(), minlength=m.npoint)
    assert deg.max() >= 14, deg.max()            # the tail exists
    assert np.median(deg) <= 8                   # ...and IS a tail
    # canonical pairs are unique (hub dedupe) and oriented
    assert (m.faces[:, 0] < m.faces[:, 1]).all()
    assert len(np.unique(m.faces, axis=0)) == m.nface
    var = make_state(m.npoint, 5, seed=6)
    gref = scale_gradients(
        compute_gradients_gg(var.astype(np.float64), m.faces, m.normals),
        m.volume, m.npoint).reshape(m.npoint, -1)
    parts = partition_mesh(m, 4)
    model = GreenGaussSweep(parts, 5)
    assert model.kslots["bulk"] >= 14  # kslots tracks K
    state = model.distribute_state(var)
    denom = max(1.0, np.abs(gref).max())
    for s in ("bulk", "early", "overlap"):
        got = model.gather_global(np.asarray(model.step(state, s)))
        assert np.abs(got - gref).max() / denom < 1e-5, s


def test_stretched_mesh_pallas_f32_stress():
    """The f32 sweep path on the anisotropic family: volume scaling spans
    orders of magnitude; results stay within the documented f32 bound."""
    from cfd_proxy.mesh.partition import partition_mesh
    from cfd_proxy.models import GreenGaussSweep

    m = generate_mesh(8, 7, 20, jitter=0.03, diag_frac=0.2, shuffle=True,
                      seed=5, stretch=1.3)
    var = make_state(m.npoint, 5, seed=6)
    gref = scale_gradients(
        compute_gradients_gg(var.astype(np.float64), m.faces, m.normals),
        m.volume, m.npoint).reshape(m.npoint, -1)
    parts = partition_mesh(m, 4)
    model = GreenGaussSweep(parts, 5)
    got = model.gather_global(
        np.asarray(model.step(model.distribute_state(var), "overlap")))
    # entry-wise RELATIVE error with a sane floor: absolute max alone is
    # meaningless across the volume dynamic range, and near-zero entries
    # carry only f32 noise (measured: 3e-6 at this floor, 7e-8 vs global max)
    denom = np.maximum(np.abs(gref), np.abs(gref).max() * 1e-2)
    assert (np.abs(got - gref) / denom).max() < 1e-4
