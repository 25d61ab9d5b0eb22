"""GreenGaussSweep — the production path: point-centric slot-table sweep +
transposed halo pipeline.

Same capabilities as models/gradients.py::GreenGaussModel (all exchange
schedules, multi-round ghosts, P shards under shard_map) but built on:

- the point-centric sweep (ops/sweep.py): one gather-and-reduce per
  destination point, no scatter-add, volume scaling fused;
- the transposed device layout (parallel/tlayout.py) — pack is a few static
  slices or a small column gather, unpack a static-offset contiguous store
  per ppermute phase;
- RCB locality relabeling of owned points (mesh/partition.py), so the
  neighbours a sweep gathers sit close in memory.

Schedule composition (per shard):
    bulk   : bulk sweep → pack+ppermute → unpack
    early  : boundary sweep (compact point list) → pack+ppermute fired →
             interior sweep (independent of the collectives) → unpack
    overlap: the early dataflow; XLA may run the collective-permutes
             asynchronously under the interior sweep
The boundary sweep finishes exactly the send-point gradients first — the
reference's finish-counter guarantee (SURVEY.md §4.3) realised structurally.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cfd_proxy.mesh.model import MeshPartition
from cfd_proxy.mesh.partition import (
    rcb_owned_order,
    relabel_owned,
    send_point_set,
)
from cfd_proxy.ops.sweep import (
    NV,
    SlotTable,
    build_slot_table,
    pad_slot_table,
    sweep,
)
from cfd_proxy.parallel.schedules import SCHEDULES
from cfd_proxy.parallel.tlayout import (
    LANE,
    build_tlayout,
    device_faces,
    device_inv_scale,
    device_state,
)
from cfd_proxy.parallel.topology import build_halo_topology, entry_phases
from cfd_proxy.utils import round_up
from cfd_proxy.utils.errors import check

AXIS = "shard"
BLOCK = 256     # column granularity of the device layout and compact tables
CLASSES = ("bulk", "boundary", "interior")


def _shard_map(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def _sq(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


class GreenGaussSweep:
    """Distributed Green-Gauss sweep on the point-centric fast path."""

    def __init__(
        self,
        parts: list[MeshPartition],
        nvar: int,
        *,
        devices: list | None = None,
        op: str = "gg",
        meta_dtype: str = "float32",
        halo_dtype: str = "float32",
        grad_dtype: str = "float32",
    ):
        check(op in ("gg", "flux"), "unknown sweep op %r", op)
        self.op = op
        # bf16 slot weights halve the weight stream; the ±face-normal
        # weights lose ~8 mantissa bits → results carry a ~1e-3 RELATIVE
        # error bound vs golden instead of ~1e-7 (gated in
        # tests/test_pallas_model.py).  State and accumulation stay f32.
        check(meta_dtype in ("float32", "bfloat16"),
              "meta_dtype must be float32|bfloat16, got %r", meta_dtype)
        self.meta_dtype = meta_dtype
        # bf16 HALO payloads: a pack-time cast halves the exchanged gradient
        # bytes and the unpack upcasts back to f32.  Only ghost-point
        # gradients carry the ~8-bit rounding (~4e-3 rel bound, gated in
        # tests); owned gradients are untouched.  The solver-mode VAR
        # exchange stays f32 — state feeds every downstream sweep.
        check(halo_dtype in ("float32", "bfloat16"),
              "halo_dtype must be float32|bfloat16, got %r", halo_dtype)
        self.halo_dtype = halo_dtype
        self._halo_jnp = (jnp.bfloat16 if halo_dtype == "bfloat16"
                          else jnp.float32)
        # bf16 GRADIENT stores: the (3·NV, npts) output planes halve.
        # Accumulation stays f32; every STORED grad buffer (boundary
        # partials, init chains, final planes) carries the dtype.  Results
        # round to ~8 mantissa bits (~4e-3 field-norm bound), and
        # cross-schedule agreement loosens to the same bound (bulk rounds
        # once; early/overlap round the boundary partial too).
        check(grad_dtype in ("float32", "bfloat16"),
              "grad_dtype must be float32|bfloat16, got %r", grad_dtype)
        self.grad_dtype = grad_dtype
        self._grad_jnp = (jnp.bfloat16 if grad_dtype == "bfloat16"
                          else jnp.float32)
        check(nvar <= NV, "nvar %d > padded NV %d", nvar, NV)
        # the flux sweep reads var[:3] as the velocity vector; with fewer
        # vars the padded zero rows would silently stand in for velocity
        # components while the golden compute_psd_flux raises
        check(op != "flux" or nvar >= 3,
              "flux model needs nvar >= 3 (velocity components), got %d", nvar)
        self.nvar = int(nvar)
        P_ = len(parts)
        # PRE-topology on the raw parts: phase coloring depends only on the
        # comm graph structure, which the relabel does not change — so the
        # phase ids derived here are exactly the final topology's.  They let
        # rcb_owned_order group each shard's send points by PHASE signature
        # in the canonical order, which makes tlayout's interval slices
        # possible.
        pre_topo = build_halo_topology(parts, max(p.npoint for p in parts) + 1)
        eph = entry_phases(parts, pre_topo)
        self.parts = [
            relabel_owned(p, rcb_owned_order(p, entry_phase=eph[d]))
            for d, p in enumerate(parts)
        ]
        npoint_pad = max(p.npoint for p in self.parts) + 1
        topo = build_halo_topology(self.parts, npoint_pad)
        check(topo.nphases == pre_topo.nphases,
              "phase coloring changed across the relabel (%d -> %d phases)",
              pre_topo.nphases, topo.nphases)
        self.topology = topo
        lay = build_tlayout(self.parts, topo, bp=BLOCK)
        self.layout = lay

        if devices is None:
            devices = jax.devices()[:P_]
        check(len(devices) >= P_, "need %d devices, have %d", P_, len(devices))
        self.mesh = Mesh(np.array(devices[:P_]), (AXIS,))
        self._sharding = NamedSharding(self.mesh, P(AXIS))

        # slot tables per class, padded to uniform shapes across shards.
        # Bit-equality construction (matches the XLA backend's, SURVEY.md §4b):
        # - the BULK table sees faces REORDERED [boundary | interior], so each
        #   point's slots sum boundary first, exactly like the composed
        #   boundary∘interior chain (sweeps seed accumulation from init);
        # - the BOUNDARY sweep emits UNSCALED sums (scale = 1); volume
        #   scaling is applied once, by the interior/bulk sweep, and at PACK
        #   time for the halo payload — so scale distributes identically.
        # dst_lt = nowned drops ghost-DESTINATION slots: their sums are dead
        # (zero-scaled for bulk/interior; the unscaled boundary sums at
        # ghosts are never read — every ghost column is overwritten by the
        # halo unpack or zero-padded).
        ones = np.ones(lay.ndev, dtype=np.float64)
        raw: dict[str, list[SlotTable]] = {c: [] for c in CLASSES}
        pack_scale = np.zeros_like(lay.send_mask)
        for d, p in enumerate(self.parts):
            fd, nd = device_faces(p, lay)
            inv = device_inv_scale(p, lay)
            is_send = np.zeros(lay.ndev, bool)
            is_send[send_point_set(p)] = True   # send points are owned
            bsel = is_send[fd[:, 0]] | is_send[fd[:, 1]]
            order = np.concatenate([np.flatnonzero(bsel),
                                    np.flatnonzero(~bsel)])
            pack_scale[d] = lay.send_mask[d] * inv[lay.send_idx[d]]
            raw["bulk"].append(build_slot_table(
                fd[order], nd[order], lay.ndev, inv, dst_lt=p.nowned))
            raw["boundary"].append(build_slot_table(
                fd, nd, lay.ndev, ones, face_sel=bsel, dst_lt=p.nowned,
                compact=True))
            raw["interior"].append(build_slot_table(
                fd, nd, lay.ndev, inv, face_sel=~bsel, dst_lt=p.nowned))

        w_dtype = jnp.bfloat16 if meta_dtype == "bfloat16" else np.float32
        self.kslots: dict[str, int] = {}
        self._tables: dict[str, dict] = {}
        for c in CLASSES:
            ks = max(t.kslots for t in raw[c])
            m = round_up(max(t.npts for t in raw[c]), BLOCK)
            tabs = [pad_slot_table(t, ks, m if t.points is not None
                                   else t.npts, lay.ndev - 1)
                    for t in raw[c]]
            self.kslots[c] = ks
            dev = {
                "cols": self._put(np.stack([t.cols for t in tabs])),
                "w": self._put(np.stack([t.w for t in tabs]).astype(w_dtype)),
                "scale": self._put(np.stack([t.scale for t in tabs])),
            }
            if tabs[0].points is not None:
                dev["points"] = self._put(np.stack([t.points for t in tabs]))
            self._tables[c] = dev
        del raw

        self._send_idx = self._put(lay.send_idx)
        self._send_mask = self._put(lay.send_mask)
        # pack-time volume scaling for the UNSCALED boundary sums (f32 cast
        # matches the bulk sweep's scale multiply operand bit-for-bit)
        self._pack_scale = self._put(pack_scale.astype(np.float32))
        # Per-phase HOST-decided pack lowering:
        #   "zero"   — every shard's mask is empty: the payload is exact
        #              zeros; emit the constant, skip the gather entirely
        #   "slice"  — every active shard's send list is a contiguous
        #              ascending run occupying a prefix of the lanes:
        #              dynamic_slice at sidx[k][0] (masked tail lanes
        #              read neighboring columns, zeroed by the scale)
        #   "segs"   — segmented lanes (tlayout): a concatenation of
        #              signature-group runs at static offsets, packed by a
        #              few static-length dynamic slices (+ one gather tail)
        #   "gather" — general case: a column take
        sidx_h, mask_h = lay.send_idx, lay.send_mask
        modes = []
        for k in range(lay.nphases):
            if mask_h[:, k].sum() == 0:
                modes.append("zero")
                continue
            ok = True
            for p in range(P_):
                act = mask_h[p, k] > 0
                n = int(act.sum())
                if n == 0:
                    continue            # idle shard: any slice, scale 0
                run = sidx_h[p, k, :n]
                if (not act[:n].all() or not (np.diff(run) == 1).all()
                        or int(run[0]) + lay.s_max > lay.ndev):
                    ok = False
                    break
            if ok:
                modes.append("slice")
            elif lay.seg_offs and lay.seg_offs[k] is not None:
                modes.append("segs")
            else:
                modes.append("gather")
        self._pack_modes = tuple(modes)
        # truthful gather hints: real phases' send lists are ascending and
        # tlayout pads repeat the last index — if every shard's full lane
        # vector is non-decreasing, the pack gather may carry
        # indices_are_sorted (the repeated padding isn't unique, so
        # unique_indices stays False)
        self._pack_sorted = tuple(
            bool((np.diff(sidx_h[:, k].astype(np.int64), axis=1) >= 0).all())
            for k in range(lay.nphases))
        # static gather window: the comm-first relabel (rcb_owned_order)
        # packs send points at the FRONT of the owned order, so every
        # gather-mode pack can read a small [0, W_c) slice instead of the
        # full (rows, ndev) array.  Uniform across shards (SPMD-clean)
        act = lay.send_mask > 0
        self._pack_window = (int(-(-(int(lay.send_idx[act].max()) + 1)
                                   // LANE) * LANE)
                             if act.any() else 0)
        self._step_cache: dict = {}

    def _put(self, arr) -> jax.Array:
        # host numpy → sharded device arrays in ONE placement; an eager
        # jnp.asarray hop would first commit the full P-stacked array to
        # device 0 (double transfer + a P× memory spike there)
        return jax.device_put(np.ascontiguousarray(arr), self._sharding)

    # ---------------------------------------------------------------- state

    def distribute_state(self, gvar: np.ndarray) -> dict:
        """Global (N, nvar) state → stacked transposed var_T.

        Ghost var values are filled host-side (state is static across the
        benchmark loop; the timed exchange moves gradients — SURVEY.md
        §4.2)."""
        vts = [device_state(gvar[p.global_ids].astype(np.float32), p,
                            self.layout, NV) for p in self.parts]
        # np.stack, NOT jnp.stack: an eager jnp.stack would commit the full
        # P-stacked state to device 0 before resharding
        return {"var_T": self._put(np.stack(vts))}

    def _var_exchange_fn(self):
        """Cached jitted var halo exchange (ghost columns refreshed from
        owners): (var_T, send_idx, send_mask) → var_T."""
        if "var_exchange" not in self._step_cache:
            def body(v, send_idx, send_mask):
                bufs = self._exchange_start(v[0], send_idx[0], send_mask[0])
                return self._exchange_finish(v[0], bufs)[None]

            fn = _shard_map(body, self.mesh, in_specs=(P(AXIS),) * 3,
                            out_specs=P(AXIS))
            self._step_cache["var_exchange"] = jax.jit(fn)
        return self._step_cache["var_exchange"]

    def refresh_state(self, var_T: jax.Array) -> dict:
        """Solver-mode state update: given a stacked var_T whose OWNED columns
        were updated on device (e.g. pseudo-time stepping), redo the var halo
        exchange so the ghost columns match their owners.

        The benchmark loop itself never needs this (the reference's timed
        iteration exchanges gradients over a static state; SURVEY.md §4.2) —
        it is the API a real solver built on this framework would call once
        per time step."""
        return {"var_T": self._var_exchange_fn()(
            var_T, self._send_idx, self._send_mask)}

    # ---------------------------------------------------------------- steps

    def _sweep(self, cls: str, var_T, tbl, init=None):
        return sweep(var_T, tbl, init=init, op=self.op,
                     out_dtype=self._grad_jnp)

    def _shared_tails(self, g, sidx) -> dict:
        """ONE combined gather for every segs-phase tail: per-phase pieces
        are static slices of the result (bitwise-identical values — same
        indices, same gather).  Returns {phase: (rows, t_len) piece}."""
        lay = self.layout
        ks = [k for k in range(lay.nphases)
              if (self._pack_modes[k] == "segs" and lay.tail_offs
                  and lay.tail_offs[k] is not None)]
        if len(ks) < 2:
            return {}       # a single tail gains nothing from combining
        idx_all = jnp.concatenate([
            jax.lax.slice(sidx[k], (lay.tail_offs[k][0],),
                          (lay.tail_offs[k][0] + lay.tail_offs[k][1],))
            for k in ks])
        all_t = jnp.take(self._window(g), idx_all, axis=1)
        out, off = {}, 0
        for k in ks:
            L = lay.tail_offs[k][1]
            out[k] = jax.lax.slice(all_t, (0, off), (g.shape[0], off + L))
            off += L
        return out

    def _window(self, g):
        """The front [0, W) column slice holding every send point (the
        comm-first relabel), or g itself when that is not smaller."""
        W = self._pack_window
        if 0 < W <= g.shape[1] // 2:
            return jax.lax.slice(g, (0, 0), (g.shape[0], W))
        return g

    def _segs_pieces(self, k, g, idx_k, tail_piece=None) -> list:
        """Phase k's UNSCALED segs-mode buffer pieces, padded to s_max:
        one static-length dynamic slice per signature-group segment
        (per-shard starts from the send_idx lanes at the STATIC segment
        offsets), the small-group tail (one windowed gather, or the
        phase's slice of the step's combined tail — see _shared_tails),
        and a zero pad."""
        lay = self.layout
        rows_ = g.shape[0]
        pieces = [
            jax.lax.dynamic_slice(
                g, (jnp.int32(0), idx_k[off].astype(jnp.int32)),
                (rows_, L))
            for off, L in lay.seg_offs[k]]
        width = sum(L for _o, L in lay.seg_offs[k])
        tail = lay.tail_offs[k] if lay.tail_offs else None
        if tail is not None:
            t_off, t_len = tail
            if tail_piece is None:
                tail_piece = jnp.take(
                    self._window(g),
                    jax.lax.slice(idx_k, (t_off,), (t_off + t_len,)), axis=1)
            pieces.append(tail_piece)
            width += t_len
        if width < lay.s_max:
            pieces.append(jnp.zeros((rows_, lay.s_max - width), g.dtype))
        return pieces

    def _pack_buf(self, k, g, idx_k, scale_k, dtype=None, tail_piece=None):
        """Phase k's packed send payload under the host-decided pack mode
        (see _pack_modes in __init__).  scale_k carries the mask (zeros on
        pad lanes), so the slice mode's over-read tail lanes and the zero
        mode's constant are exact.  dtype: wire precision (None = keep the
        multiply's dtype)."""
        lay = self.layout
        mode = self._pack_modes[k]
        if mode == "zero":
            out_dt = dtype if dtype is not None else jnp.promote_types(
                g.dtype, scale_k.dtype)
            return jnp.zeros((g.shape[0], lay.s_max), out_dt)
        if mode == "slice":
            buf = jax.lax.dynamic_slice(
                g, (jnp.int32(0), idx_k[0].astype(jnp.int32)),
                (g.shape[0], lay.s_max))
        elif mode == "segs":
            buf = jnp.concatenate(
                self._segs_pieces(k, g, idx_k, tail_piece), axis=1)
        else:
            buf = jnp.take(self._window(g), idx_k, axis=1,
                           indices_are_sorted=self._pack_sorted[k])
        buf = buf * scale_k[None, :]
        if dtype is not None and buf.dtype != dtype:
            buf = buf.astype(dtype)     # pack-time cast: bytes halve on the
                                        # wire, unpack upcasts
        return buf

    def _exchange_start(self, g, send_idx, send_mask, dtype=None):
        """dtype: wire precision of the payload (None = carrier dtype).  The
        GRADIENT exchange passes self._halo_jnp (--halo-dtype); the VAR
        exchange leaves it None — state stays full precision."""
        bufs = []
        tails = self._shared_tails(g, send_idx)
        for k, perm in enumerate(self.layout.perms):
            if not perm:
                bufs.append(None)
                continue
            buf = self._pack_buf(k, g, send_idx[k], send_mask[k],
                                 dtype=dtype, tail_piece=tails.get(k))
            bufs.append(jax.lax.ppermute(buf, AXIS, list(perm)))
        return bufs

    def _exchange_finish(self, g, bufs):
        lay = self.layout
        for k, buf in enumerate(bufs):
            if buf is None:
                continue
            g = jax.lax.dynamic_update_slice(
                g, buf.astype(g.dtype), (0, lay.ghost_start + k * lay.s_max))
        return g

    def step_fn(self, schedule: str = "overlap"):
        check(schedule in (*SCHEDULES, "nocomm"), "unknown schedule %r",
              schedule)
        if schedule not in self._step_cache:

            def body(var_T, send_idx, send_mask, pack_scale, tb, tbd, ti):
                v = var_T[0]
                sidx = send_idx[0]
                if schedule in ("bulk", "nocomm"):
                    g = self._sweep("bulk", v, _sq(tb))
                    if schedule == "bulk":
                        # bulk grads are already volume-scaled: mask only
                        bufs = self._exchange_start(g, sidx, send_mask[0],
                                                    dtype=self._halo_jnp)
                        g = self._exchange_finish(g, bufs)
                else:
                    # early / overlap: boundary sums are UNSCALED; 1/V is
                    # applied at pack time (then the --halo-dtype cast)
                    gb = self._sweep("boundary", v, _sq(tbd))
                    bufs = self._exchange_start(gb, sidx, pack_scale[0],
                                                dtype=self._halo_jnp)
                    g = self._sweep("interior", v, _sq(ti), init=gb)
                    g = self._exchange_finish(g, bufs)
                return g[None]

            fn = _shard_map(body, self.mesh, in_specs=(P(AXIS),) * 7,
                            out_specs=P(AXIS))
            self._step_cache[schedule] = jax.jit(fn)
        return self._step_cache[schedule]

    def iter_args(self, state: dict) -> tuple:
        return (state["var_T"], self._send_idx, self._send_mask,
                self._pack_scale, self._tables["bulk"],
                self._tables["boundary"], self._tables["interior"])

    def step(self, state: dict, schedule: str = "overlap", **_kw):
        # this backend has no f64 'exact' mode (that is the XLA
        # GreenGaussModel's contract) — silently returning f32 to a caller
        # who asked for the bit-gated semantics would be a wrong result
        check(not _kw.get("exact"),
              "exact mode is the XLA backend's; use GreenGaussModel "
              "(--backend xla --dtype float64) for the bit-gated path")
        return self.step_fn(schedule)(*self.iter_args(state))

    def iterate_fn(self, schedule: str, n: int, solver_mode: bool = False,
                   sweeps_per_step: int = 1, **_kw):
        """Chained n-iteration runner (see GreenGaussModel.iterate_fn).

        n is passed as a RUNTIME loop bound (fori_loop), so every n shares
        one compiled executable.

        solver_mode=True times the per-time-step dataflow of a real solver
        built on this framework: sweeps_per_step × (sweep incl. gradient
        exchange + toy state update), then one var halo exchange — the
        refresh_state path folded into the loop.  The proxy benchmark itself
        never does this (its timed iteration exchanges gradients over static
        state — SURVEY.md §4.2), so it is reported as a separate row."""
        check(not _kw.get("exact"),
              "exact mode is the XLA backend's; use GreenGaussModel")
        check(sweeps_per_step >= 1, "sweeps_per_step must be >= 1, got %d",
              sweeps_per_step)
        check(sweeps_per_step == 1 or solver_mode,
              "sweeps_per_step only applies to solver_mode (static "
              "iteration never refreshes the state)")
        key = ("iterate", schedule, solver_mode, int(sweeps_per_step))
        if key not in self._step_cache:
            step = self.step_fn(schedule)
            exch = self._var_exchange_fn()

            @jax.jit
            def run_n(n, var_T, send_idx, send_mask, *rest):
                def stage(_j, v):
                    g = step(v, send_idx, send_mask, *rest)
                    return v + 1e-30 * g[:, :NV, :]

                def body(_i, v):
                    if not solver_mode:
                        return stage(0, v)
                    v2 = (stage(0, v) if sweeps_per_step == 1 else
                          jax.lax.fori_loop(0, sweeps_per_step, stage, v))
                    return exch(v2, send_idx, send_mask)

                return jax.lax.fori_loop(0, n, body, var_T)

            self._step_cache[key] = run_n
        runner = self._step_cache[key]
        return lambda *args: runner(n, *args)

    # ------------------------------------------------------------- gather

    def gather_global(self, stacked: jax.Array) -> np.ndarray:
        """Stacked result (P, rows, ndev) → global host array.

        gg: (N, nvar*3), column v*3+d (matches the XLA backend convention);
        flux: (N, nvar)."""
        arr = np.asarray(stacked)
        if arr.dtype not in (np.float32, np.float64):
            # bf16 grads (--grad-dtype) arrive as ml_dtypes arrays — widen
            # so downstream numpy comparisons behave
            arr = arr.astype(np.float32)
        N = sum(p.nowned for p in self.parts)
        if self.op == "flux":
            out = np.zeros((N, self.nvar), dtype=arr.dtype)
            for i, p in enumerate(self.parts):
                out[p.global_ids[: p.nowned]] = arr[i, : self.nvar,
                                                    : p.nowned].T
            return out
        out = np.zeros((N, self.nvar * 3), dtype=arr.dtype)
        for i, p in enumerate(self.parts):
            gids = p.global_ids[: p.nowned]
            for v in range(self.nvar):
                for d in range(3):
                    out[gids, v * 3 + d] = arr[i, d * NV + v, : p.nowned]
        return out


class PSDFluxModel(GreenGaussSweep):
    """Secondary model family: the upwind PSD-style flux sweep
    (`compute_psd_flux` / `flux.c` analogue; see ops/flux.py for the spec)."""

    def __init__(self, parts, nvar, **kw):
        super().__init__(parts, nvar, op="flux", **kw)
