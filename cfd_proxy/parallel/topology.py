"""Halo-exchange topology: comm lists → ppermute phase schedule.

The reference's `setup_comm` + queue management (SURVEY.md §4.4) builds
per-neighbor buffers; ranks then talk pairwise in whatever order the network
serves.  `lax.ppermute` instead moves ONE buffer per device per call, so a
device with several partners needs several calls ("phases").  Scheduling the
directed sends into phases is edge coloring of the communication multigraph
(the same structure used for conflict-free face scheduling in unstructured
CFD codes — cf. PAPERS.md, "Edge coloring in unstructured CFD codes"):
within a phase every device sends to at most one partner and receives from at
most one partner.  Greedy coloring on the (round-ordered) edge list gives at
most 2·maxdeg−1 phases; exchange rounds (= ghost depth, BASELINE config 5's
multi-round ghost layers) are kept sequential.

All per-device metadata is padded to uniform shapes (shard_map traces one
program): send gather lists pad with 0 (harmless gather), recv scatter lists
pad with an out-of-bounds index that XLA scatter `mode='drop'` discards.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cfd_proxy.mesh.model import MeshPartition
from cfd_proxy.utils.errors import check


@dataclass
class PhaseSpec:
    """One ppermute call: static (src→dst) pairs + per-device index lists."""

    round: int
    perm: list[tuple[int, int]]          # static (src, dst) pairs
    send_idx: np.ndarray                 # (P, S_max) i32; pad = 0
    recv_idx: np.ndarray                 # (P, S_max) i32; pad = npoint_pad (OOB)


@dataclass
class HaloTopology:
    """Full phase schedule for one partitioned mesh."""

    npart: int
    npoint_pad: int                      # uniform padded point count
    nrounds: int
    phases: list[PhaseSpec]

    @property
    def nphases(self) -> int:
        return len(self.phases)

    def max_phase_size(self) -> int:
        return max((p.send_idx.shape[1] for p in self.phases), default=0)


def entry_phases(parts: list[MeshPartition],
                 topo: HaloTopology) -> list[np.ndarray]:
    """Per shard: phase id of each comm entry (aligned with part.comm).

    The ONE definition of entry→phase matching (GreenGaussSweep.__init__
    relabels send points by phase signature with it).  Recv-only entries (empty sendidx) are carried by no send phase of
    their shard and default to 0, which is inert downstream (their
    signature-membership rows are empty)."""
    out = []
    for d, p in enumerate(parts):
        out.append(np.array([
            next((k for k, ph in enumerate(topo.phases)
                  if ph.round == e.round and (d, e.partner) in ph.perm), 0)
            for e in p.comm], dtype=np.int64))
    return out


def build_halo_topology(
    parts: list[MeshPartition], npoint_pad: int
) -> HaloTopology:
    """Edge-color the comm graph into ppermute phases, round by round."""
    P = len(parts)
    check(P >= 1, "need at least one partition")
    for pt in parts:
        check(pt.npoint <= npoint_pad, "npoint_pad %d < npoint %d", npoint_pad, pt.npoint)

    nrounds = max((pt.nrounds for pt in parts), default=0)
    phases: list[PhaseSpec] = []
    # positional identity: parts[i] must BE partition i — partner lookups
    # below are positional, and a reordered/renamed shard-file list would
    # otherwise pair the wrong recvidx silently
    for i, pt in enumerate(parts):
        check(pt.part_id == i,
              "parts out of order: index %d holds part_id %d", i, pt.part_id)
    # reverse lookup (owner, partner, round) → comm entry, built ONCE — the
    # per-edge rescan of partner.comm was O(edges × entries); duplicate
    # entries (previously caught by the len==1 scan) error at insert
    rev: dict[tuple[int, int, int], object] = {}
    for pt in parts:
        for e in pt.comm:
            key = (pt.part_id, e.partner, e.round)
            check(key not in rev, "duplicate comm entry %d->%d round %d", *key)
            rev[key] = e
    for r in range(nrounds):
        # directed edges with payload: (src, dst, sendidx, recvidx)
        edges = []
        for pt in parts:
            for e in pt.comm:
                if e.round != r:
                    continue
                # pairing is validated for EVERY entry, including empty
                # senders: an empty sendidx paired with a nonempty partner
                # recvidx was previously skipped before the size check ran,
                # leaving those ghosts silently unfilled on the XLA path
                # (the sweep path caught it later in build_tlayout)
                back = rev.get((e.partner, pt.part_id, r))
                check(back is not None, "unpaired comm entry %d->%d round %d",
                      pt.part_id, e.partner, r)
                check(back.recvidx.size == e.sendidx.size,
                      "send/recv size mismatch %d->%d", pt.part_id, e.partner)
                if e.sendidx.size:
                    # sort pairs by SENDER index: receiver ghost columns are
                    # assigned positionally (tlayout) and the XLA unpack
                    # scatters at recvidx values, so jointly permuting the
                    # pair order is free — and a monotone send list lets the
                    # pack gather carry truthful indices_are_sorted/
                    # unique_indices hints (and keeps it chunk-monotone for
                    # any future staged pack kernel)
                    o = np.argsort(e.sendidx, kind="stable")
                    edges.append((pt.part_id, e.partner, e.sendidx[o],
                                  back.recvidx[o]))

        # greedy edge coloring, deterministic order: sort by (src, dst)
        edges.sort(key=lambda t: (t[0], t[1]))
        phase_of = []
        used_src: list[set] = []
        used_dst: list[set] = []
        for (s, d, _si, _ri) in edges:
            k = 0
            while k < len(used_src) and (s in used_src[k] or d in used_dst[k]):
                k += 1
            if k == len(used_src):
                used_src.append(set())
                used_dst.append(set())
            used_src[k].add(s)
            used_dst[k].add(d)
            phase_of.append(k)

        for k in range(len(used_src)):
            sel = [e for e, ph in zip(edges, phase_of) if ph == k]
            smax = max(e[2].size for e in sel)
            send_idx = np.zeros((P, smax), dtype=np.int32)
            recv_idx = np.full((P, smax), npoint_pad, dtype=np.int32)  # OOB→drop
            perm = []
            for (s, d, si, ri) in sel:
                perm.append((s, d))
                send_idx[s, : si.size] = si
                recv_idx[d, : ri.size] = ri
            phases.append(PhaseSpec(round=r, perm=perm, send_idx=send_idx,
                                    recv_idx=recv_idx))

    return HaloTopology(npart=P, npoint_pad=npoint_pad, nrounds=nrounds,
                        phases=phases)
