"""Halo topology / device layout invariants."""

import numpy as np
import pytest

from cfd_proxy.mesh.generator import generate_mesh
from cfd_proxy.mesh.partition import partition_mesh
from cfd_proxy.parallel.tlayout import build_tlayout
from cfd_proxy.parallel.topology import build_halo_topology


@pytest.fixture(scope="module", params=[(4, 1), (8, 2), (5, 1)])
def setup(request):
    npart, gl = request.param
    mesh = generate_mesh(9, 8, 7, jitter=0.05, diag_frac=0.25, seed=61)
    parts = partition_mesh(mesh, npart, ghost_layers=gl)
    npoint_pad = max(p.npoint for p in parts) + 1
    topo = build_halo_topology(parts, npoint_pad)
    return parts, topo


def test_phases_are_partial_matchings(setup):
    parts, topo = setup
    for ph in topo.phases:
        srcs = [s for s, _ in ph.perm]
        dsts = [d for _, d in ph.perm]
        assert len(set(srcs)) == len(srcs), "duplicate sender in a phase"
        assert len(set(dsts)) == len(dsts), "duplicate receiver in a phase"
    # rounds are ordered
    rounds = [ph.round for ph in topo.phases]
    assert rounds == sorted(rounds)


def test_every_edge_scheduled_once(setup):
    parts, topo = setup
    want = set()
    for p in parts:
        for e in p.comm:
            if e.sendidx.size:
                want.add((p.part_id, e.partner, e.round))
    got = set()
    for ph in topo.phases:
        for (s, d) in ph.perm:
            key = (s, d, ph.round)
            assert key not in got, "edge scheduled twice"
            got.add(key)
    assert got == want


def test_asymmetric_comm_entry_raises():
    """An EMPTY sendidx paired with a nonempty partner recvidx must raise,
    not silently drop the edge (review find: the edge loop skipped empty
    senders BEFORE the size check, so the receiver's ghosts were never
    filled on the XLA path and no error fired)."""
    import dataclasses

    mesh = generate_mesh(9, 8, 7, jitter=0.05, diag_frac=0.25, seed=61)
    parts = partition_mesh(mesh, 4, ghost_layers=1)
    # find a directed edge and empty the SENDER side only
    src = next(p for p in parts if p.comm and p.comm[0].sendidx.size)
    e = src.comm[0]
    bad = dataclasses.replace(e, sendidx=e.sendidx[:0])
    src.comm[src.comm.index(e)] = bad
    from cfd_proxy.utils.errors import CheckError

    with pytest.raises(CheckError, match="size mismatch"):
        build_halo_topology(parts, max(p.npoint for p in parts) + 1)


def test_tlayout_permutation_completion(setup):
    parts, topo = setup
    lay = build_tlayout(parts, topo)
    P = len(parts)
    assert lay.nphases == max(topo.nphases, 1)
    for k, perm in enumerate(lay.perms):
        # each phase is a partial matching over the P shards
        assert len({s for s, _ in perm}) == len(perm) <= P
        assert len({d for _, d in perm}) == len(perm)
    # every local point has a unique device column
    for lm in lay.locmap:
        assert np.unique(lm).size == lm.size
        assert lm.max() < lay.ndev
    # ghost columns land inside their phase region
    for d, p in enumerate(parts):
        for e in p.comm:
            cols = lay.locmap[d][e.recvidx]
            if cols.size == 0:
                continue
            k = (cols.min() - lay.ghost_start) // lay.s_max
            assert (cols >= lay.ghost_start + k * lay.s_max).all()
            assert (cols < lay.ghost_start + (k + 1) * lay.s_max).all()


@pytest.mark.parametrize("ghost_layers", [1, 2])
@pytest.mark.parametrize("npart", [4, 8])
def test_greedy_coloring_phase_bound(npart, ghost_layers):
    """Greedy edge coloring of each round's comm multigraph needs at most
    2·maxdeg−1 phases (maxdeg = the most sends or receives of one shard in
    that round), and the coloring is deterministic."""
    mesh = generate_mesh(10, 9, 8, jitter=0.05, diag_frac=0.2, seed=0)
    parts = partition_mesh(mesh, npart, ghost_layers=ghost_layers)
    npoint_pad = max(p.npoint for p in parts) + 1
    topo = build_halo_topology(parts, npoint_pad)
    for r in range(topo.nrounds):
        edges = [(s, d) for ph in topo.phases if ph.round == r
                 for (s, d) in ph.perm]
        deg = max(max(sum(1 for s, _ in edges if s == i),
                      sum(1 for _, d in edges if d == i))
                  for i in range(npart))
        nph = sum(1 for ph in topo.phases if ph.round == r)
        assert nph <= 2 * deg - 1, (r, nph, deg)
    again = build_halo_topology(parts, npoint_pad)
    assert [ph.perm for ph in again.phases] == [ph.perm for ph in topo.phases]


def test_entry_phases_helper():
    """topology.entry_phases — the ONE entry→phase rule the model's relabel
    uses: every sending entry maps to the phase whose perm
    carries its (shard, partner) edge at its round; recv-only entries
    default to 0 (inert — empty membership rows)."""
    from cfd_proxy.mesh.generator import generate_mesh
    from cfd_proxy.mesh.partition import partition_mesh
    from cfd_proxy.parallel.topology import (build_halo_topology,
                                                 entry_phases)

    m = generate_mesh(8, 7, 6, jitter=0.05, diag_frac=0.2, seed=0)
    parts = partition_mesh(m, 4, ghost_layers=2)
    topo = build_halo_topology(parts, max(p.npoint for p in parts) + 1)
    eph = entry_phases(parts, topo)
    assert len(eph) == len(parts)
    for d, p in enumerate(parts):
        assert len(eph[d]) == len(p.comm)
        for i, e in enumerate(p.comm):
            k = int(eph[d][i])
            ph = topo.phases[k]
            if e.sendidx.size:
                assert ph.round == e.round
                assert (d, e.partner) in ph.perm
                # the phase's send lanes for this shard are exactly this
                # entry's (sorted) send list
                cnt = int((ph.recv_idx[e.partner] < topo.npoint_pad).sum())
                np.testing.assert_array_equal(
                    ph.send_idx[d, :cnt], np.sort(e.sendidx))
            else:
                assert k == 0      # recv-only: inert default
