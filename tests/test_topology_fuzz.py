"""Randomized topology fuzz.

Random owner maps (including adversarial non-RCB assignments that scatter
each shard across the whole domain), P in 2..8, ghost depth K in 1..3,
random nvar — asserting the layout invariants:

- every exchange phase is a partial matching (one send and one receive per
  shard at most);
- comm lists are position-matched and recv-contiguous per entry; every
  ghost column is covered by exactly one static phase region;
- the segs-gating fallback is VALUE-correct: whatever mix of segs / slice /
  gather / zero pack modes the layout produces, forcing every phase to the
  windowed gather reproduces the step bitwise;
- cross-schedule agreement: all three schedules agree within the f32 bound
  on the sweep backend, and BIT-exactly on the f64 XLA backend.
"""

import numpy as np
import pytest

from cfd_proxy.mesh.generator import generate_mesh, make_state
from cfd_proxy.mesh.partition import partition_mesh
from cfd_proxy.models import GreenGaussSweep
from cfd_proxy.ops.golden import compute_gradients_gg, scale_gradients


def _random_case(seed):
    rng = np.random.default_rng(seed)
    nx, ny, nz = rng.integers(4, 9, size=3)
    m = generate_mesh(int(nx), int(ny), int(nz), jitter=0.05,
                      diag_frac=float(rng.uniform(0, 0.4)),
                      hub_frac=float(rng.choice([0.0, 0.05])),
                      hub_extra=8, seed=int(seed))
    P = int(rng.integers(2, 9))
    K = int(rng.integers(1, 4))
    style = rng.choice(["rcb", "random", "striped"])
    if style == "rcb":
        owner = None                       # the production RCB assignment
    elif style == "random":
        # adversarial: every point owned independently at random — shards
        # are scattered dust, nearly every face is a boundary face, and the
        # comm graph is near-complete
        owner = rng.integers(0, P, size=m.npoint).astype(np.int32)
    else:
        # striped by global id: long thin shards, maximal neighbor count
        owner = (np.arange(m.npoint) * P // m.npoint).astype(np.int32)
    # every part must own >= 1 point (partition contract)
    if owner is not None:
        owner[: P] = np.arange(P, dtype=np.int32)
    nvar = int(rng.integers(1, 8))
    return m, P, K, owner, nvar, style


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_topology_invariants(seed):
    m, P, K, owner, nvar, style = _random_case(seed)
    parts = partition_mesh(m, P, ghost_layers=K, owner=owner)
    model = GreenGaussSweep(parts, nvar)
    lay = model.layout

    # --- each phase is a partial matching ---
    for k, perm in enumerate(lay.perms):
        assert len({s for s, _ in perm}) == len(perm), (style, k)
        assert len({d for _, d in perm}) == len(perm), (style, k)

    # --- position-matched comm lists; contiguous recv per entry ---
    for p in model.parts:
        for e in p.comm:
            q = model.parts[e.partner]
            back = [x for x in q.comm
                    if x.partner == p.part_id and x.round == e.round]
            assert len(back) == 1
            assert len(back[0].sendidx) == len(e.recvidx)
            if len(e.recvidx) > 1:
                assert (np.diff(np.sort(e.recvidx)) == 1).all()

    # --- ghost coverage: every ghost point maps to exactly one device
    # column inside exactly one phase region ---
    for d, p in enumerate(model.parts):
        lm = lay.locmap[d]
        assert int(lm.min()) >= 0
        ghost_cols = lm[p.nowned:]
        assert (ghost_cols >= lay.ghost_start).all()
        assert len(np.unique(ghost_cols)) == len(ghost_cols)

    # --- segs-gating fallback is value-correct: force the windowed gather
    # and the step must reproduce bitwise, whatever the mode mix was ---
    gvar = make_state(sum(p.nowned for p in model.parts), nvar, seed=seed)
    state = model.distribute_state(gvar)
    forced = GreenGaussSweep(parts, nvar)
    forced._pack_modes = tuple(md if md == "zero" else "gather"
                               for md in forced._pack_modes)
    fstate = forced.distribute_state(gvar)
    gref64 = scale_gradients(
        compute_gradients_gg(gvar.astype(np.float64), m.faces, m.normals),
        m.volume, m.npoint).reshape(m.npoint, -1)
    denom = max(1.0, np.abs(gref64).max())
    outs = {}
    for s in ("bulk", "early", "overlap"):
        outs[s] = np.asarray(model.step(state, s))
        np.testing.assert_array_equal(
            np.asarray(forced.step(fstate, s)), outs[s], err_msg=(style, s))
        # golden agreement (f32 bound)
        got = model.gather_global(outs[s])
        assert np.abs(got - gref64).max() / denom < 1e-5, (style, s)
    # cross-schedule agreement at the documented f32 bound
    for s in ("early", "overlap"):
        assert np.abs(outs[s] - outs["bulk"]).max() / denom < 1e-6, (style, s)


@pytest.mark.parametrize("seed", [1, 4])
def test_fuzz_xla_f64_bit_equality(seed):
    """The strongest cross-schedule invariant on random topologies: the f64
    XLA backend's three schedules are BIT-identical."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from cfd_proxy.models import GreenGaussModel

    m, P, K, owner, nvar, style = _random_case(seed)
    parts = partition_mesh(m, P, ghost_layers=K, owner=owner)
    model = GreenGaussModel(parts, nvar, dtype=jnp.float64)
    gvar = make_state(m.npoint, nvar, seed=seed)
    state = model.distribute_state(gvar)
    ref = np.asarray(model.step(state, "bulk"))
    for s in ("early", "overlap"):
        np.testing.assert_array_equal(
            np.asarray(model.step(state, s)), ref, err_msg=(style, s))
