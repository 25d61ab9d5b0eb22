"""The point-centric slot-table sweep (ops/sweep.py) on one shard."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cfd_proxy.mesh.generator import generate_mesh, make_state
from cfd_proxy.ops.flux import compute_psd_flux
from cfd_proxy.ops.golden import compute_gradients_gg
from cfd_proxy.ops.sweep import (
    NV,
    build_slot_table,
    out_rows,
    pad_slot_table,
    sweep,
)
from cfd_proxy.utils.errors import CheckError

NVAR = 5


@pytest.fixture(scope="module")
def setup():
    m = generate_mesh(8, 7, 6, jitter=0.05, diag_frac=0.25, shuffle=True,
                      seed=11)
    ndev = ((m.npoint + 255) // 256) * 256 + 256
    var = make_state(m.npoint, NVAR, seed=3)
    var_T = np.zeros((NV, ndev), np.float32)
    var_T[:NVAR, : m.npoint] = var.T
    return m, ndev, var, jnp.asarray(var_T)


def _dev(t):
    d = {"cols": jnp.asarray(t.cols), "w": jnp.asarray(t.w),
         "scale": jnp.asarray(t.scale)}
    if t.points is not None:
        d["points"] = jnp.asarray(t.points)
    return d


def _brute(faces, normals, ndev, sel, dst_lt):
    """Per destination point: [(inc_id, other, ±normal)] in golden order."""
    slots = {}
    for f in np.flatnonzero(sel):
        p0, p1 = faces[f]
        for side, (d, o, s) in enumerate(((p0, p1, 1.0), (p1, p0, -1.0))):
            if dst_lt is None or d < dst_lt:
                slots.setdefault(int(d), []).append(
                    (2 * f + side, int(o), s * normals[f]))
    return {d: sorted(v, key=lambda x: x[0]) for d, v in slots.items()}


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("dst_lt", [None, 300])
@pytest.mark.parametrize("subset", [False, True])
def test_slot_table_matches_brute_force(setup, subset, dst_lt, compact):
    m, ndev, _, _ = setup
    sel = np.ones(m.nface, bool)
    if subset:
        sel[::3] = False
    t = build_slot_table(m.faces, m.normals, ndev, np.ones(ndev),
                         face_sel=None if not subset else sel,
                         dst_lt=dst_lt, compact=compact)
    want = _brute(m.faces, m.normals, ndev, sel, dst_lt)
    assert t.kslots == max(len(v) for v in want.values())
    pts = t.points if compact else np.arange(ndev)
    if compact:
        np.testing.assert_array_equal(t.points, sorted(want))
    for j, d in enumerate(pts):
        got = want.get(int(d), [])
        for k in range(t.kslots):
            if k < len(got):
                assert t.cols[k, j] == got[k][1]
                np.testing.assert_array_equal(t.w[k, :, j],
                                              got[k][2].astype(np.float32))
            else:   # padding: own column, zero weight
                assert t.cols[k, j] == d
                assert not t.w[k, :, j].any()


@pytest.mark.parametrize("op", ["gg", "flux"])
def test_sweep_matches_golden(setup, op):
    m, ndev, var, var_T = setup
    t = build_slot_table(m.faces, m.normals, ndev, np.ones(ndev))
    out = np.asarray(sweep(var_T, _dev(t), op=op))
    assert out.shape == (out_rows(op), ndev)
    if op == "gg":
        ref = compute_gradients_gg(var.astype(np.float64), m.faces,
                                   m.normals)                 # (N, nvar, 3)
        got = out.reshape(3, NV, ndev)[:, :NVAR, : m.npoint].transpose(2, 1, 0)
    else:
        ref = compute_psd_flux(var.astype(np.float64), m.faces, m.normals)
        got = out[:NVAR, : m.npoint].T
    assert np.abs(got - ref).max() / max(1.0, np.abs(ref).max()) < 1e-5


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("op", ["gg", "flux"])
def test_boundary_then_interior_equals_bulk(setup, op, compact):
    """Seeded accumulation: a class sweep on top of another class's sums
    adds each point's slots in the bulk order, so the composition equals
    the bulk sweep over [class A | class B] faces bitwise."""
    m, ndev, _, var_T = setup
    rng = np.random.default_rng(0)
    sel = rng.random(m.nface) < 0.3
    order = np.concatenate([np.flatnonzero(sel), np.flatnonzero(~sel)])
    inv = np.zeros(ndev)
    inv[: m.npoint] = 1.0 / m.volume
    bulk = build_slot_table(m.faces[order], m.normals[order], ndev, inv)
    tb = build_slot_table(m.faces, m.normals, ndev, np.ones(ndev),
                          face_sel=sel, compact=compact)
    ti = build_slot_table(m.faces, m.normals, ndev, inv, face_sel=~sel)
    gb = sweep(var_T, _dev(tb), op=op)
    got = np.asarray(sweep(var_T, _dev(ti), init=gb, op=op))
    want = np.asarray(sweep(var_T, _dev(bulk), op=op))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["gg", "flux"])
def test_padding_is_inert(setup, op):
    """Uniform-shape padding (extra zero-weight slots, extra points on the
    trash column) leaves every real column bitwise unchanged."""
    m, ndev, _, var_T = setup
    sel = np.zeros(m.nface, bool)
    sel[::5] = True
    t = build_slot_table(m.faces, m.normals, ndev, np.ones(ndev),
                         face_sel=sel, compact=True)
    tp = pad_slot_table(t, t.kslots + 3, t.npts + 100, ndev - 1)
    assert tp.points[-1] == ndev - 1 and tp.npts == t.npts + 100
    a = np.asarray(sweep(var_T, _dev(t), op=op))
    b = np.asarray(sweep(var_T, _dev(tp), op=op))
    np.testing.assert_array_equal(a[:, : ndev - 1], b[:, : ndev - 1])
    full = build_slot_table(m.faces, m.normals, ndev, np.ones(ndev))
    fp = pad_slot_table(full, full.kslots + 2, ndev, ndev - 1)
    np.testing.assert_array_equal(np.asarray(sweep(var_T, _dev(full), op=op)),
                                  np.asarray(sweep(var_T, _dev(fp), op=op)))
    with pytest.raises(CheckError, match="compact"):
        pad_slot_table(full, full.kslots, ndev + 256, ndev - 1)


@pytest.mark.parametrize("what", ["meta", "grad"])
def test_bf16_storage_bounded(setup, what):
    """bf16 weights (--meta-dtype) or bf16 stores (--grad-dtype): the
    accumulation stays f32, so the error stays within ~1e-2 relative."""
    m, ndev, _, var_T = setup
    t = build_slot_table(m.faces, m.normals, ndev, np.ones(ndev))
    ref = np.asarray(sweep(var_T, _dev(t)))
    d = _dev(t)
    kw = {}
    if what == "meta":
        d["w"] = d["w"].astype(jnp.bfloat16)
    else:
        kw["out_dtype"] = jnp.bfloat16
    got = np.asarray(sweep(var_T, d, **kw)).astype(np.float32)
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert 0 < err < 1e-2, err


def test_slot_table_rejects_corrupt_faces():
    faces = np.array([[0, 1], [2, 10**6]], np.int32)   # endpoint >= ndev
    with pytest.raises(CheckError, match="out of range"):
        build_slot_table(faces, np.ones((2, 3)), 256, np.ones(256))


def test_empty_compact_class(setup):
    """A class with no faces (the boundary class at P=1): zero points, and
    the sweep returns its init (or zeros) unchanged."""
    m, ndev, _, var_T = setup
    t = build_slot_table(m.faces, m.normals, ndev, np.ones(ndev),
                         face_sel=np.zeros(m.nface, bool), compact=True)
    assert t.npts == 0 and t.kslots == 1
    out = np.asarray(sweep(var_T, _dev(t)))
    assert out.shape == (out_rows("gg"), ndev) and not out.any()


def test_xla_ell_reduce_has_no_matmul():
    """The XLA backend's non-exact ELL reduction must not lower to a dot:
    a float32 contraction may run as a TF32 matrix product on the GPU."""
    from cfd_proxy.ops.sweep_jax import ell_reduce

    c = jnp.ones((10, 6), jnp.float32)
    f = jnp.zeros((4, 3), jnp.int32)
    s = jnp.ones((4, 3), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda c, f, s: ell_reduce(
        c, f, s, jnp.zeros((4, 6)), exact=False))(c, f, s)
    assert "dot_general" not in str(jaxpr)
