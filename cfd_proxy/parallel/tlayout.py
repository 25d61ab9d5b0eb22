"""Transposed device layout: point-column mapping + halo for the sweep path.

Device state layout (per shard, uniform across shards):

    [ owned cols 0..nowned | pad to owned_pad | phase-0 ghost region (s_max) |
      phase-1 ghost region (s_max) | ... | pad to multiple of bp ]

Every comm entry is one edge of one ppermute phase (parallel/topology.py), and
each phase owns a RESERVED s_max-column ghost region at a STATIC offset — so
halo unpack is one `dynamic_update_slice` per phase at a compile-time
position, on every device, with padding lanes landing in reserved trash
columns.  This removes every scatter from the exchange: pack is a few
static slices or a column gather, transfer is ppermute, unpack is a
contiguous store.  Reference counterpart: the recvidx ghost scatter of
`exchange_dbl_*` unpack (SURVEY.md §4.5) — made contiguous by construction.

Ghost column positions mirror the SENDER's pack order (position-matched
buffers, like the reference's paired send/recv lists), so no index translation
happens at runtime at all.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cfd_proxy.mesh.model import MeshPartition
from cfd_proxy.parallel.topology import HaloTopology
from cfd_proxy.utils.errors import check
from cfd_proxy.utils import round_up

LANE = 128

# A segmented phase lowers to one dynamic_slice per SLICE segment plus one
# small windowed gather over the TAIL region.  Only segments this long earn
# a slice (below it the gather is cheaper per lane), and at most
# SEG_MAX_PER_PHASE of them (graph-size bound) — the rest join the tail.
# Measured structure of the real P=8 headline topology: 1-4 big single-
# partner segments (~2.3k lanes) + 10-20 tiny multi-phase-corner segments
# (1-50 lanes, ~2% of sends); 64-way small shards fragment into 100+
# one-lane segments, where the tail absorbs everything.
SEG_MIN_LANES = 64
SEG_MAX_PER_PHASE = 8




@dataclass
class TLayout:
    """Host-side transposed device layout for P shards."""

    bp: int
    owned_pad: int
    s_max: int
    nphases: int
    ndev: int
    perms: list            # perms[k] = tuple of (src, dst) pairs (static)
    locmap: list           # per part: (npoint,) local id -> device column
    send_idx: np.ndarray   # (P, nphases, s_max) i32 device columns, pad 0
    send_mask: np.ndarray  # (P, nphases, s_max) f32 1.0 on real lanes, 0 pad
    # per-phase SEGMENTED lane layout, or None per phase when unavailable:
    # seg_offs[k] = ((lane_off, L), ...) — static, identical across shards.
    # Lane [off, off+L) of phase k holds one signature group's send pairs
    # (a contiguous ascending column run on every shard, by the comm-first
    # grouped relabel), so the pack is a concat of static-length dynamic
    # slices instead of a gather.  None for a
    # phase ⇒ legacy prefix-packed lanes (gather-mode pack).
    #
    # Only segments >= SEG_MIN_LANES long (at most SEG_MAX_PER_PHASE, big
    # first) get slices; the remaining small segments form the phase's TAIL
    # — tail_offs[k] = (lane_off, L) or None — packed by ONE windowed
    # gather of those lanes' columns (the ~2% multi-phase corner points
    # fragment into tens of tiny signature groups; a slice each would blow
    # up the graph, measured 13x dryrun wall at 64-way).  Lane layout per
    # phase: slice segments first (descending length), then the tail.
    seg_offs: tuple = ()
    tail_offs: tuple = ()

    @property
    def ghost_start(self) -> int:
        return self.owned_pad


def build_tlayout(
    parts: list[MeshPartition], topo: HaloTopology, *, bp: int = 256,
    seg_slack: float = 1.25,
) -> TLayout:
    """seg_slack: lane-width budget for the SEGMENTED layout, as a multiple of
    the legacy prefix-packed phase width.  A phase's segmented width is
    Σ_sig max-over-shards group size — tail pads that ride the wire (every
    ppermute buffer is (rows, s_max)) and widen every ghost region.  At
    P=8 on the headline mesh the inflation is ~1.1-1.2× (worth it: the
    pack drops from ~1.7 ns/col to a few dynamic slices), but at 64-way
    small shards it measured 6× — worse than the pack saving.  Phases
    whose segmented width exceeds seg_slack × the legacy s_max fall back
    to prefix-packed lanes + gather pack, per phase."""
    P = len(parts)
    # positional identity, mirrored from build_halo_topology: locmap,
    # send_idx rows and ph.recv_idx are all indexed by position, so a list
    # reordered between the two calls would pair shard d's ghost columns
    # with another partition's faces silently
    for i, pt in enumerate(parts):
        check(pt.part_id == i,
              "parts out of order: index %d holds part_id %d", i, pt.part_id)
    owned_pad = round_up(max(p.nowned for p in parts), bp)
    nphases = max(topo.nphases, 1)

    # ---- signature analysis for the SEGMENTED lane layout ----
    # Active pair lists per (shard, phase): send columns ascending (the
    # topology pair sort), recv ghost ids aligned positionally.
    act: dict[tuple[int, int], tuple] = {}
    for k, ph in enumerate(topo.phases):
        for (src, dst) in ph.perm:
            cnt = int((ph.recv_idx[dst] < topo.npoint_pad).sum())
            act[(src, k)] = (ph.send_idx[src, :cnt].astype(np.int64),
                             ph.recv_idx[dst, :cnt].astype(np.int64))
    # per-shard signature (set of phases) of every send column
    sig_cols: list[dict] = [dict() for _ in range(P)]   # sig -> cols list
    col_sig: list[dict] = [dict() for _ in range(P)]
    for p in range(P):
        phase_of: dict[int, list] = {}
        for k in range(topo.nphases):
            si_ri = act.get((p, k))
            if si_ri is None:
                continue
            for c in si_ri[0]:
                phase_of.setdefault(int(c), []).append(k)
        for c, ks in phase_of.items():
            sig = tuple(ks)         # ascending (k loop order)
            col_sig[p][c] = sig
            sig_cols[p].setdefault(sig, []).append(c)
    sigs = sorted({s for d in sig_cols for s in d},
                  key=lambda s: (len(s), s))
    # segmented layout requires every (shard, signature) group to be one
    # contiguous ascending column run — the comm-first grouped relabel
    # guarantees it; un-relabeled callers (e.g. raw partitions) fall back
    # to the legacy prefix-packed lanes
    segmented = bool(sigs)
    for sig in sigs:
        for p in range(P):
            cols = np.sort(np.asarray(sig_cols[p].get(sig, ()), np.int64))
            if cols.size > 1 and not (np.diff(cols) == 1).all():
                segmented = False
    # INTERVAL detection (round 5): when the relabel laid each shard's comm
    # region group-after-group in the CANONICAL sig order (rcb_owned_order
    # with entry_phase), consecutive sigs' runs are column-adjacent on
    # every shard — so a phase can cover a run of consecutive sigs that all
    # contain it with ONE dynamic_slice (an interval), instead of one slice
    # per group + a gather tail for the tiny ones.  At P=8 the headline
    # topology needs 1-4 intervals per phase and NO tail.
    aligned = segmented
    if segmented:
        for p in range(P):
            runs = [np.sort(np.asarray(sig_cols[p][s], np.int64))
                    for s in sigs if sig_cols[p].get(s)]
            if runs:
                cat = np.concatenate(runs)
                if cat.size > 1 and not (np.diff(cat) == 1).all():
                    aligned = False
                    break
    # per-phase lane plan over UNITS (interval = tuple of consecutive sigs
    # when aligned; singleton groups otherwise), in DESCENDING length
    # order; the leading >= SEG_MIN_LANES units (at most SEG_MAX_PER_PHASE)
    # become slice segments, everything after them is the gather TAIL
    phase_order: list[list] = []   # per phase: units (tuples of sigs)
    phase_lens: list[list] = []    # per phase: unit max-over-shards lengths
    phase_segs: list[tuple] = []   # per phase: ((off, L), ...) slices
    phase_tail: list = []          # per phase: (off, L) or None
    if segmented:
        for k in range(topo.nphases):
            if aligned:
                units, cur = [], []
                for s in sigs:
                    if k in s:
                        cur.append(s)
                    elif cur:
                        units.append(tuple(cur))
                        cur = []
                if cur:
                    units.append(tuple(cur))
            else:
                units = [(s,) for s in sigs if k in s]
            lens = []
            for u in units:
                n_max = 0
                for p in range(P):
                    n_max = max(n_max, sum(len(sig_cols[p].get(s, ()))
                                           for s in u))
                lens.append(n_max)
            order = sorted(range(len(units)),
                           key=lambda i: (-lens[i], units[i]))
            units = [units[i] for i in order]
            lens = [lens[i] for i in order]
            offs, off = [], 0
            # aligned intervals: ANY unit length earns a slice (P=8 needs
            # <= 4 units/phase; a tail would cost ~0.85+0.55n µs of fixed
            # materialization for nothing).  SEG_MAX_PER_PHASE still caps
            # fragmented topologies (64-way: units beyond the cap tail).
            min_lanes = 1 if aligned else SEG_MIN_LANES
            for L in lens:
                if L < min_lanes or len(offs) >= SEG_MAX_PER_PHASE:
                    break
                offs.append((off, L))
                off += L
            width = sum(lens)
            tail = (off, width - off) if width > off else None
            phase_order.append(units)
            phase_lens.append(lens)
            phase_segs.append(tuple(offs))
            phase_tail.append(tail)
    # per-phase width gating (see seg_slack in the docstring): segmented
    # tail pads ride the wire and widen every ghost region, so a phase
    # keeps the segmented lanes only while its width fits the slack-capped
    # legacy budget; others fall back to prefix-packed lanes + gather pack
    w_legacy = max(topo.max_phase_size(), 1)
    use_segs = [False] * topo.nphases
    if segmented and phase_order:
        budget = max(float(seg_slack) * w_legacy, float(LANE))
        use_segs = [sum(phase_lens[k]) <= budget
                    for k in range(topo.nphases)]
    smax_req = 1
    for k in range(topo.nphases):
        smax_req = max(smax_req, sum(phase_lens[k])
                       if use_segs[k] else w_legacy)
    if topo.nphases == 0:
        smax_req = w_legacy
    s_max = round_up(smax_req, LANE)
    # +bp: a dedicated trailing TRASH block that no real point maps to — the
    # target of the padding points of compact slot tables
    ndev = round_up(owned_pad + nphases * s_max, bp) + bp

    locmap = []
    for p in parts:
        lm = np.full(p.npoint, -1, dtype=np.int64)
        lm[: p.nowned] = np.arange(p.nowned)
        locmap.append(lm)

    send_idx = np.zeros((P, nphases, s_max), dtype=np.int32)
    send_mask = np.zeros((P, nphases, s_max), dtype=np.float32)
    perms = []
    seg_offs: list = []
    tail_offs: list = []
    for k, ph in enumerate(topo.phases):
        perms.append(tuple(ph.perm))
        if use_segs[k]:
            # SEGMENTED lanes: each UNIT (interval of consecutive sigs, or
            # a single group) at its static offset (slice segments first,
            # descending length, then the tail units); per-unit tail pads
            # repeat the unit's last column (send, mask 0) and stay OOB on
            # the recv side
            seg_offs.append(phase_segs[k])
            tail_offs.append(phase_tail[k])
            for (src, dst) in ph.perm:
                si, ri = act[(src, k)]
                lanes_recv = np.full(s_max, topo.npoint_pad, np.int64)
                off = 0
                for u, L in zip(phase_order[k], phase_lens[k]):
                    parts_u = [np.asarray(sig_cols[src][s], np.int64)
                               for s in u if sig_cols[src].get(s)]
                    cols = (np.sort(np.concatenate(parts_u)) if parts_u
                            else np.zeros(0, np.int64))
                    n = cols.size
                    if n:
                        pos = np.searchsorted(si, cols)
                        send_idx[src, k, off:off + n] = cols
                        send_mask[src, k, off:off + n] = 1.0
                        lanes_recv[off:off + n] = ri[pos]
                        if n < L:
                            send_idx[src, k, off + n:off + L] = cols[-1]
                    off += L
                valid = np.flatnonzero(lanes_recv < topo.npoint_pad)
                locmap[dst][lanes_recv[valid]] = (owned_pad + k * s_max
                                                  + valid)
        else:
            seg_offs.append(None)
            tail_offs.append(None)
            s = ph.send_idx.shape[1]
            send_idx[:, k, :s] = ph.send_idx
            for (src, _dst) in ph.perm:
                # real lanes = the entry's actual send count for that src
                cnt = int((ph.recv_idx[_dst] < topo.npoint_pad).sum())
                send_mask[src, k, :cnt] = 1.0
            for d in range(P):
                recv = ph.recv_idx[d]
                valid = recv < topo.npoint_pad        # OOB marker = pad
                pos = np.flatnonzero(valid)
                locmap[d][recv[pos]] = owned_pad + k * s_max + pos
    while len(perms) < nphases:
        # a comm-free mesh keeps one inert phase (an empty ghost region)
        perms.append(())
        seg_offs.append(None)
        tail_offs.append(None)
    # legacy phases: pad send lanes with the last REAL index (not 0) so the
    # pack gather's indices_are_sorted hint stays truthful across padding
    # (prefix-packed lanes only; segmented phases pad per segment above)
    for p_i in range(P):
        for k in range(nphases):
            if seg_offs[k] is not None:
                continue
            n = int((send_mask[p_i, k] > 0).sum())
            if 0 < n < s_max:
                send_idx[p_i, k, n:] = send_idx[p_i, k, n - 1]

    for d in range(len(parts)):
        check(int(locmap[d].min(initial=0)) >= 0,
              "ghost point unmapped on shard %d", d)
    return TLayout(
        bp=bp, owned_pad=owned_pad, s_max=s_max, nphases=nphases, ndev=ndev,
        perms=perms, locmap=locmap, send_idx=send_idx, send_mask=send_mask,
        seg_offs=tuple(seg_offs), tail_offs=tuple(tail_offs),
    )


def device_faces(part: MeshPartition, lay: TLayout) -> tuple[np.ndarray, np.ndarray]:
    """Faces/normals in device-column coordinates for one shard."""
    lm = lay.locmap[part.part_id]
    return lm[part.faces].astype(np.int32), part.normals


def device_inv_scale(part: MeshPartition, lay: TLayout) -> np.ndarray:
    """1/V at owned device columns, 0 at ghosts/padding (ghost grads are
    overwritten by the exchange; zero-scaling keeps them deterministic)."""
    s = np.zeros(lay.ndev, dtype=np.float64)
    s[: part.nowned] = 1.0 / part.volume[: part.nowned]
    return s


def device_state(values: np.ndarray, part: MeshPartition, lay: TLayout,
                 nv_pad: int) -> np.ndarray:
    """(npoint, nvar) host state -> (NV, ndev) transposed device state."""
    nvar = values.shape[1]
    check(nvar <= nv_pad, "nvar %d exceeds padded NV %d", nvar, nv_pad)
    out = np.zeros((nv_pad, lay.ndev), dtype=values.dtype)
    out[:nvar, lay.locmap[part.part_id]] = values.T
    return out
