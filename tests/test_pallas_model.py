"""Distributed sweep-backend model on the virtual CPU mesh.

Validates the production path end-to-end: RCB relabel → transposed device
layout → point-centric slot-table sweeps → pack/ppermute/contiguous-unpack
exchange — against the NumPy golden and across schedules (SURVEY.md §4b).
"""

import numpy as np
import pytest

from cfd_proxy.mesh.generator import generate_mesh, make_state
from cfd_proxy.mesh.partition import partition_mesh
from cfd_proxy.models import GreenGaussSweep
from cfd_proxy.ops.golden import compute_gradients_gg, scale_gradients

NVAR = 5


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(9, 8, 7, jitter=0.05, diag_frac=0.25, shuffle=True, seed=41)


@pytest.fixture(scope="module")
def gvar(mesh):
    return make_state(mesh.npoint, NVAR, seed=17)


@pytest.fixture(scope="module")
def gref(mesh, gvar):
    g = compute_gradients_gg(gvar.astype(np.float64), mesh.faces, mesh.normals)
    return scale_gradients(g, mesh.volume, mesh.npoint).reshape(mesh.npoint, -1)

@pytest.fixture(scope="module")
def fref(mesh, gvar):
    from cfd_proxy.ops.flux import compute_psd_flux, flux_residual_scale

    return flux_residual_scale(
        compute_psd_flux(gvar.astype(np.float64), mesh.faces, mesh.normals),
        mesh.volume, mesh.npoint)


_MODELS: dict = {}


def _stepped(mesh, gvar, npart, ghost_layers, op):
    """One model + its per-schedule results per (npart, ghost_layers, op),
    shared by the schedule cases."""
    key = (npart, ghost_layers, op)
    if key not in _MODELS:
        parts = partition_mesh(mesh, npart, ghost_layers=ghost_layers)
        model = GreenGaussSweep(parts, NVAR, op=op)
        state = model.distribute_state(gvar)
        _MODELS[key] = (model, {s: np.asarray(model.step(state, s))
                                for s in ("bulk", "early", "overlap",
                                          "nocomm")})
    return _MODELS[key]


@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("schedule", ["bulk", "early", "overlap"])
@pytest.mark.parametrize("ghost_layers", [1, 2])
@pytest.mark.parametrize("npart", [1, 2, 4, 8])
def test_pallas_schedules_match_golden(mesh, gvar, gref, fref, npart,
                                       ghost_layers, schedule, op):
    """Every schedule vs the f64 golden (gg: compute_gradients_gg, flux:
    compute_psd_flux), and vs bulk: summation order and scale distribution
    are IDENTICAL by construction (boundary-first bulk slot order, seeded
    accumulation, pack-time scaling); separately compiled graphs may still
    contract multiply-adds differently → a few ULPs."""
    model, outs = _stepped(mesh, gvar, npart, ghost_layers, op)
    ref = gref if op == "gg" else fref
    denom = max(1.0, np.abs(ref).max())
    got = model.gather_global(outs[schedule])
    err = np.abs(got - ref).max() / denom
    assert err < 1e-5, f"{schedule}: rel err {err}"
    scale_ref = max(1.0, np.abs(outs["bulk"]).max())
    assert np.abs(outs[schedule] - outs["bulk"]).max() / scale_ref < 1e-6
    # nocomm = the bulk sweep without the exchange: owned columns agree
    for i, p in enumerate(model.parts):
        np.testing.assert_array_equal(outs["nocomm"][i, :, : p.nowned],
                                      outs["bulk"][i, :, : p.nowned])
    assert np.isfinite(outs[schedule]).all()



def test_bf16_halo_dtype_bounded(mesh, gvar):
    """--halo-dtype bfloat16 rounds ONLY the exchanged ghost gradients:
    owned rows stay bit-identical to the f32-halo model; ghost rows carry
    the bf16 wire rounding, bounded ~4e-3 relative vs their owners."""
    parts = partition_mesh(mesh, 4, ghost_layers=1)
    m32 = GreenGaussSweep(parts, NVAR)
    mbf = GreenGaussSweep(parts, NVAR,
                           halo_dtype="bfloat16")
    s32 = m32.distribute_state(gvar)
    sbf = mbf.distribute_state(gvar)
    for s in ("bulk", "early", "overlap"):
        g32 = np.asarray(m32.step(s32, s))
        gbf = np.asarray(mbf.step(sbf, s))
        for i, p in enumerate(mbf.parts):
            # owned columns never ride the wire — bit-identical
            np.testing.assert_array_equal(gbf[i, :, : p.nowned],
                                          g32[i, :, : p.nowned],
                                          err_msg=f"{s} owned")
        # ghost regions: bf16 rounding of the f32 payload, relative bound
        denom = max(1.0, np.abs(g32).max())
        err = np.abs(gbf - g32).max() / denom
        assert err < 4e-3, f"{s}: halo rounding {err}"
        assert err > 0 or mbf.layout.nphases == 0  # the cast really happened


def test_bf16_meta_dtype_bounded(mesh, gvar, gref):
    """--meta-dtype bfloat16 halves the slot-weight stream; the ±normal
    weights lose ~8 mantissa bits → documented ~1e-3 relative bound vs
    golden."""
    parts = partition_mesh(mesh, 4)
    model = GreenGaussSweep(parts, NVAR,
                             meta_dtype="bfloat16")
    state = model.distribute_state(gvar)
    got = model.gather_global(np.asarray(model.step(state, "bulk")))
    denom = max(1.0, np.abs(gref).max())
    err = np.abs(got - gref).max() / denom
    assert 1e-7 < err < 1e-3, err   # must differ from f32 yet stay bounded


def test_bf16_grad_dtype_flux(mesh, gvar):
    """--grad-dtype bfloat16 on the flux op: the (NV, npts) flux planes
    store bf16 through the same store cast as gg; bounded vs the f32 flux
    model across all schedules."""
    parts = partition_mesh(mesh, 2)
    outs = {}
    for gd in ("float32", "bfloat16"):
        m = GreenGaussSweep(parts, NVAR, op="flux", grad_dtype=gd)
        st = m.distribute_state(gvar)
        outs[gd] = {s: np.asarray(m.step(st, s), dtype=np.float32)
                    for s in ("bulk", "early", "overlap")}
    scale = max(1.0, np.abs(outs["float32"]["bulk"]).max())
    for s in ("bulk", "early", "overlap"):
        err = np.abs(outs["bfloat16"][s] - outs["float32"][s]).max() / scale
        assert 0 < err < 5e-3, f"{s}: {err}"


def test_reduced_precision_combined(mesh, gvar, gref):
    """--meta-dtype bfloat16 --grad-dtype bfloat16 together (the bench.py
    reduced_precision row): still bounded vs golden."""
    parts = partition_mesh(mesh, 4)
    model = GreenGaussSweep(parts, NVAR, meta_dtype="bfloat16",
                            grad_dtype="bfloat16")
    state = model.distribute_state(gvar)
    got = model.gather_global(np.asarray(model.step(state, "bulk")))
    denom = max(1.0, np.abs(gref).max())
    err = np.abs(got - gref).max() / denom
    assert 1e-7 < err < 5e-3, err


def test_bf16_grad_dtype_bounded(mesh, gvar, gref):
    """--grad-dtype bfloat16 stores the gradient planes in bf16.
    Accumulation stays f32; only stores round.  Bounded ~5e-3 vs golden;
    schedules agree to the same bf16 bound (bulk rounds once at its store, early/overlap also round the boundary
    partial) instead of the f32 modes' 1e-6."""
    parts = partition_mesh(mesh, 4)
    model = GreenGaussSweep(parts, NVAR, grad_dtype="bfloat16")
    import jax.numpy as jnp

    assert model._grad_jnp == jnp.bfloat16  # dtype plumbing took effect
    state = model.distribute_state(gvar)
    outs = {s: np.asarray(model.step(state, s), dtype=np.float32)
            for s in ("bulk", "early", "overlap")}
    got = model.gather_global(model.step(state, "bulk"))
    assert got.dtype == np.float32          # gather widens for comparisons
    denom = max(1.0, np.abs(gref).max())
    err = np.abs(got - gref).max() / denom
    assert 1e-5 < err < 5e-3, err           # really rounded, still bounded
    scale = max(1.0, np.abs(outs["bulk"]).max())
    assert np.abs(outs["early"] - outs["bulk"]).max() / scale < 1e-2
    assert np.abs(outs["overlap"] - outs["early"]).max() / scale < 1e-2


def test_bf16_grad_dtype_full_stack(mesh, gvar, gref):
    """The full bf16 stack — weights, grads, halo all bf16 — stays bounded
    vs golden (every rounding is one bf16 unit on a different stream; they
    do not compound multiplicatively)."""
    parts = partition_mesh(mesh, 4)
    model = GreenGaussSweep(parts, NVAR, meta_dtype="bfloat16",
                            grad_dtype="bfloat16", halo_dtype="bfloat16")
    state = model.distribute_state(gvar)
    denom = max(1.0, np.abs(gref).max())
    for s in ("bulk", "early", "overlap"):
        got = model.gather_global(model.step(state, s))
        err = np.abs(got - gref).max() / denom
        assert 1e-5 < err < 2e-2, f"{s}: {err}"


def test_pallas_ghosts_match_owner(mesh, gvar):
    parts = partition_mesh(mesh, 4)
    model = GreenGaussSweep(parts, NVAR)
    state = model.distribute_state(gvar)
    g = np.asarray(model.step(state, "early"))
    lay = model.layout
    # every ghost column equals the owner's owned column bitwise
    for i, p in enumerate(model.parts):
        lm = lay.locmap[i]
        for e in p.comm:
            q = e.partner
            qpart = model.parts[q]
            back = [x for x in qpart.comm if x.partner == p.part_id and x.round == e.round]
            send_cols = lay.locmap[q][back[0].sendidx]
            recv_cols = lm[e.recvidx]
            if len(send_cols) == 0:
                continue
            np.testing.assert_array_equal(
                g[i][:, recv_cols], g[q][:, send_cols]
            )


def test_iterate_fn_runs(mesh, gvar):
    parts = partition_mesh(mesh, 2)
    model = GreenGaussSweep(parts, NVAR)
    state = model.distribute_state(gvar)
    out = model.iterate_fn("early", 3)(*model.iter_args(state))
    assert out.shape == state["var_T"].shape
    assert np.isfinite(np.asarray(out)).all()


@pytest.mark.parametrize("op", ["gg", "flux"])
@pytest.mark.parametrize("schedule", ["bulk", "early", "overlap"])
def test_solver_iterate_matches_manual_composition(mesh, gvar, schedule, op):
    """The fused solver-mode runner (sweep → toy update → var exchange in
    ONE jit) equals the same chain composed through the public
    step/refresh_state API, bitwise on var_T."""
    parts = partition_mesh(mesh, 4)
    model = GreenGaussSweep(parts, NVAR, op=op)
    state = model.distribute_state(gvar)
    got = np.asarray(model.iterate_fn(schedule, 1, solver_mode=True)(
        *model.iter_args(state)))
    g = model.step(state, schedule)
    v2 = state["var_T"] + 1e-30 * g[:, :8, :]
    want = np.asarray(model.refresh_state(v2)["var_T"])
    np.testing.assert_array_equal(got, want)


def test_solver_iterate_sweeps_matches_manual(mesh, gvar):
    """sweeps_per_step=2 (a multi-stage solver step): two sweep+update
    stages whose ghost state goes stale by the toy update — exactly what a
    stage-loop solver accepts — then one var exchange.  Must equal the
    manual composition bitwise on var_T."""
    parts = partition_mesh(mesh, 4)
    model = GreenGaussSweep(parts, NVAR)
    state = model.distribute_state(gvar)
    got = np.asarray(model.iterate_fn(
        "bulk", 1, solver_mode=True, sweeps_per_step=2)(
        *model.iter_args(state)))
    v = state["var_T"]
    for _ in range(2):
        g = model.step({**state, "var_T": v}, "bulk")
        v = v + 1e-30 * g[:, :8, :]
    want = np.asarray(model.refresh_state(v)["var_T"])
    np.testing.assert_array_equal(got, want)


def test_sweeps_per_step_requires_solver_mode(mesh, gvar):
    from cfd_proxy.utils.errors import CheckError

    parts = partition_mesh(mesh, 2)
    model = GreenGaussSweep(parts, NVAR)
    with pytest.raises(CheckError):
        model.iterate_fn("bulk", 1, sweeps_per_step=2)


def test_solver_mode_flux_runs(mesh, gvar):
    """Solver mode is model-agnostic: the flux op's per-step dataflow
    (sweep + update + var exchange) runs fused and stays finite."""
    parts = partition_mesh(mesh, 2)
    model = GreenGaussSweep(parts, NVAR, op="flux")
    state = model.distribute_state(gvar)
    out = model.iterate_fn("bulk", 2, solver_mode=True)(
        *model.iter_args(state))
    assert out.shape == state["var_T"].shape
    assert np.isfinite(np.asarray(out)).all()


def test_refresh_state_solver_mode(mesh, gvar):
    """Device-side state update → var ghost exchange → the next sweep reads
    the refreshed ghosts."""
    import jax.numpy as jnp

    from cfd_proxy.ops.golden import compute_gradients_gg, scale_gradients

    parts = partition_mesh(mesh, 4)
    model = GreenGaussSweep(parts, NVAR)
    state = model.distribute_state(gvar)
    # perturb OWNED columns on device (ghosts left stale), then refresh
    var2 = state["var_T"] * jnp.float32(1.5)
    lay = model.layout
    owned_only = np.zeros((1, 1, lay.ndev), np.float32)
    for p in model.parts:
        owned_only[0, 0, : p.nowned] = 1.0
    mixed = jnp.where(jnp.asarray(owned_only) > 0, var2, state["var_T"])
    state2 = model.refresh_state(mixed)
    got = model.gather_global(model.step(state2, "overlap"))
    gref2 = scale_gradients(
        compute_gradients_gg((1.5 * gvar).astype(np.float64), mesh.faces,
                             mesh.normals), mesh.volume, mesh.npoint
    ).reshape(mesh.npoint, -1)
    err = np.abs(got - gref2).max() / max(1.0, np.abs(gref2).max())
    assert err < 1e-5, err


def test_pack_mode_dispatch_matches_gather(mesh, gvar):
    """The host-decided per-phase pack lowering (zero/slice/segs/gather) is
    value-identical to the uniform take: forcing every phase to "gather"
    must reproduce the dispatched step bitwise, for every schedule."""
    parts = partition_mesh(mesh, 4, ghost_layers=1)
    model = GreenGaussSweep(parts, NVAR)
    # real comm phases classify "segs" (the tlayout segmented lanes from the
    # comm-first grouped relabel); forcing "gather" below exercises the
    # equivalence of both lowerings
    assert "segs" in model._pack_modes
    state = model.distribute_state(gvar)
    ref = {s: np.asarray(model.step(state, s)) for s in ("bulk", "early",
                                                         "overlap")}
    forced = GreenGaussSweep(parts, NVAR)
    forced._pack_modes = tuple("gather" for _ in forced._pack_modes)
    fstate = forced.distribute_state(gvar)
    for s, r in ref.items():
        np.testing.assert_array_equal(np.asarray(forced.step(fstate, s)), r)


def test_segmented_pack_layout(mesh, gvar):
    """The tlayout segmented lanes under the INTERVAL layout: the
    model's canonical phase-signature relabel lays each shard's comm region
    group-after-group in the order tlayout enumerates signatures, so every
    phase's lanes are interval slices at STATIC offsets shared by all
    shards (descending length, at most SEG_MAX_PER_PHASE) — and at model-
    built P=4/P=8 topologies the intervals absorb ALL groups: NO gather
    tail remains.  Each shard's active lanes within a slice are one
    contiguous ascending column run (what the segs pack mode's
    dynamic slices rely on)."""
    from cfd_proxy.parallel.tlayout import SEG_MAX_PER_PHASE

    parts = partition_mesh(mesh, 4, ghost_layers=1)
    model = GreenGaussSweep(parts, NVAR)
    lay = model.layout
    sidx = np.asarray(lay.send_idx)
    mask = np.asarray(lay.send_mask)
    for k in range(lay.nphases):
        segs = lay.seg_offs[k]
        assert segs is not None
        assert len(segs) <= SEG_MAX_PER_PHASE
        lens = [L for _o, L in segs]
        assert lens == sorted(lens, reverse=True)     # big first
        width = sum(lens)
        # interval absorption: this topology needs no tail
        assert lay.tail_offs[k] is None
        assert width <= lay.s_max
        for p in range(len(parts)):
            # no active lane outside the slice layout
            assert not (mask[p, k, width:] > 0).any()
            for off, L in segs:
                act = mask[p, k, off:off + L] > 0
                n = int(act.sum())
                assert act[:n].all()          # actives are a segment prefix
                run = sidx[p, k, off:off + n]
                if n > 1:
                    np.testing.assert_array_equal(np.diff(run), 1)


def test_segmented_width_gating(mesh):
    """seg_slack caps the segmented layout's lane inflation: tail pads ride
    the wire (every ppermute buffer is (rows, s_max)) and widen every ghost
    region.  A slack of 0 must force
    every phase back to the legacy prefix-packed lanes at the legacy width;
    the default keeps segments only within budget."""
    from cfd_proxy.mesh.partition import relabel_owned, rcb_owned_order
    from cfd_proxy.parallel.tlayout import LANE, build_tlayout
    from cfd_proxy.parallel.topology import build_halo_topology

    parts = partition_mesh(mesh, 4, ghost_layers=1)
    parts = [relabel_owned(p, rcb_owned_order(p, block=128))
             for p in parts]
    topo = build_halo_topology(parts, max(p.npoint for p in parts) + 1)
    w_legacy = -(-max(topo.max_phase_size(), 1) // LANE) * LANE
    tight = build_tlayout(parts, topo, seg_slack=0.0)
    # budget floors at LANE (a <=128-lane segmented phase cannot inflate
    # past the 128-rounded legacy width): wider phases must all fall back
    for off in tight.seg_offs[:topo.nphases]:
        assert off is None or sum(L for _o, L in off) <= 128
    assert tight.s_max == w_legacy
    wide = build_tlayout(parts, topo, seg_slack=1e9)
    assert all(off is not None for off in wide.seg_offs[:topo.nphases])
    dflt = build_tlayout(parts, topo)
    for k in range(topo.nphases):
        if dflt.seg_offs[k] is not None:
            assert sum(L for _o, L in dflt.seg_offs[k]) <= dflt.s_max
    assert dflt.s_max <= max(w_legacy, -(-int(1.25 * w_legacy) // LANE) * LANE)
