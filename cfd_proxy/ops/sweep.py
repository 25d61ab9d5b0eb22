"""Point-centric Green-Gauss sweep over slot tables (transposed layout).

The hot loop of the reference (`compute_gradients_gg` in `gradients.c`,
SURVEY.md §4.3) written as a gather-and-reduce per destination point, with no
scatter-add:

    var_T  (NV, ndev)   — state, NV = nvar padded to 8 rows
    out    (rows, ndev) — gradients (rows = 3*NV, row d*NV+v) or fluxes (NV)

Preprocessing (host, this module) turns the 2F directed incidences (slot =
one face endpoint) of a face class into a slot table:

    cols   (K, M) i32    device column of each slot's OTHER endpoint
    w      (K, 3, M)     sign × face normal (±n_f), zero on padding slots
    scale  (M,)          1/V at owned points (volume scaling fused), 0 on pad
    points (M,) i32      destination columns of a COMPACT table (a class that
                         touches few points); absent = every column, M = ndev

Each point's slots are ordered by incidence id (the golden summation order),
and padding slots read the point's own column with a zero weight, so they add
exact zeros.  The sweep seeds its accumulator from `init`, which makes
boundary-sweep ∘ interior-sweep add slots in exactly the bulk order — the
schedule-equivalence property (SURVEY.md §5.8).

`sweep` is plain jnp: XLA's GPU emitter fuses the per-slot gathers into the
reduction loop, and var_T (NV × ndev × 4 B) stays L2-resident at the headline
size.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from cfd_proxy.utils.errors import check

NV = 8          # padded variable count


@dataclass
class SlotTable:
    """Host-side slot table for one face class on one shard."""

    cols: np.ndarray               # (K, M) i32
    w: np.ndarray                  # (K, 3, M) f32
    scale: np.ndarray              # (M,) f32
    points: np.ndarray | None = None   # (M,) i32 — compact tables only

    @property
    def kslots(self) -> int:
        return self.cols.shape[0]

    @property
    def npts(self) -> int:
        return self.cols.shape[1]


def build_slot_table(
    faces: np.ndarray,         # (F, 2) device point columns
    normals: np.ndarray,       # (F, 3)
    ndev: int,                 # device column count
    inv_scale: np.ndarray,     # (ndev,) — 1/V at owned, 0 elsewhere
    *,
    face_sel: np.ndarray | None = None,   # bool (F,) — restrict to a class
    dst_lt: int | None = None,  # drop slots whose destination is >= this
                               # column (ghost destinations: their sums are
                               # zero-scaled or overwritten by the unpack)
    compact: bool = False,     # keep only the points that have a slot
) -> SlotTable:
    fsel = (np.arange(faces.shape[0]) if face_sel is None
            else np.flatnonzero(face_sel))
    f = np.asarray(faces)[fsel].astype(np.int64)
    n = np.asarray(normals, np.float64)[fsel]
    check(f.size == 0 or (f.min() >= 0 and f.max() < ndev),
          "face columns out of range [0, %d)", ndev)

    # directed incidences: destination, other endpoint, ±normal, golden order
    dst = np.concatenate([f[:, 0], f[:, 1]])
    oth = np.concatenate([f[:, 1], f[:, 0]])
    w = np.concatenate([n, -n], axis=0)
    inc_id = np.concatenate([2 * fsel, 2 * fsel + 1])
    if dst_lt is not None:
        keep = dst < dst_lt
        dst, oth, w, inc_id = dst[keep], oth[keep], w[keep], inc_id[keep]

    order = np.lexsort((inc_id, dst))
    dst, oth, w = dst[order], oth[order], w[order]
    counts = np.bincount(dst, minlength=ndev)
    kslots = max(int(counts.max()) if counts.size else 0, 1)
    starts = np.zeros(ndev + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(dst.size) - starts[dst]

    if compact:
        points = np.flatnonzero(counts)
        pos = np.full(ndev, -1, np.int64)
        pos[points] = np.arange(points.size)
        m_of, own = pos[dst], points
    else:
        points, m_of, own = None, dst, np.arange(ndev)
    cols = np.broadcast_to(own.astype(np.int32), (kslots, own.size)).copy()
    wt = np.zeros((kslots, 3, own.size), np.float32)
    cols[slot, m_of] = oth
    wt[slot, :, m_of] = w
    return SlotTable(
        cols=cols, w=wt, scale=np.asarray(inv_scale, np.float32)[own],
        points=None if points is None else points.astype(np.int32))


def pad_slot_table(t: SlotTable, kslots: int, npts: int,
                   trash: int) -> SlotTable:
    """Pad to uniform (kslots, npts) across shards with inert entries.

    Extra slots read the point's own column with zero weight; extra points
    (compact tables) target the `trash` column — a column no real point
    maps to — with zero weights and zero scale."""
    check(kslots >= t.kslots, "kslots %d < %d", kslots, t.kslots)
    check(t.points is not None or npts == t.npts,
          "only compact tables can grow their point count")
    grow = npts - t.npts
    if t.points is not None:
        points = np.concatenate([t.points, np.full(grow, trash, np.int32)])
        own = points
    else:
        points, own = None, np.arange(npts, dtype=np.int32)
    cols = np.broadcast_to(own, (kslots, npts)).copy()
    cols[: t.kslots, : t.npts] = t.cols
    w = np.zeros((kslots, 3, npts), np.float32)
    w[: t.kslots, :, : t.npts] = t.w
    scale = np.concatenate([t.scale, np.zeros(grow, np.float32)])
    return dataclasses.replace(t, cols=cols, w=w, scale=scale, points=points)


def out_rows(op: str) -> int:
    """Output row count: gradients are (3, NV) planes, fluxes (NV,)."""
    return 3 * NV if op == "gg" else NV


def _cols(a: jax.Array, idx: jax.Array) -> jax.Array:
    return jnp.take(a, idx, axis=1, mode="clip")


def sweep(
    var_T: jax.Array,            # (NV, ndev) f32
    tbl: dict,                   # device arrays of a SlotTable
    *,
    init: jax.Array | None = None,   # (rows, ndev) to accumulate onto
    op: str = "gg",                  # "gg" gradients | "flux" upwind flux
    out_dtype=jnp.float32,           # stored dtype (--grad-dtype)
) -> jax.Array:
    """One class sweep; returns (out_rows(op), ndev).

    Accumulation is f32 in slot order, seeded from `init` (upcast when it is
    stored in bf16); the scale multiply and the store cast come last.  A
    compact table writes its points into `init` (or zeros) and leaves every
    other column as it was."""
    rows = out_rows(op)
    cols, w, scale = tbl["cols"], tbl["w"], tbl["scale"]
    points = tbl.get("points")
    own = var_T if points is None else _cols(var_T, points)
    if init is None:
        acc = jnp.zeros((rows, cols.shape[1]), jnp.float32)
    else:
        acc = (init if points is None else _cols(init, points)).astype(
            jnp.float32)
    for k in range(cols.shape[0]):
        src = _cols(var_T, cols[k])                               # (NV, M)
        wk = w[k].astype(jnp.float32)                             # (3, M)
        if op == "gg":
            avg = 0.5 * (own + src)
            acc = acc + (wk[:, None, :] * avg[None, :, :]).reshape(rows, -1)
        else:  # upwind flux (ops/flux.py directed-slot form)
            udw = jnp.sum(own[:3] * wk, axis=0)
            uow = jnp.sum(src[:3] * wk, axis=0)
            a = jnp.maximum(jnp.abs(udw), jnp.abs(uow))
            acc = acc + 0.5 * (udw[None, :] * own + uow[None, :] * src) \
                - 0.5 * a[None, :] * (src - own)
    out = (acc * scale[None, :]).astype(out_dtype)
    if points is None:
        return out
    base = (init if init is not None
            else jnp.zeros((rows, var_T.shape[1]), out_dtype))
    # padding points all hit the trash column with the same (zero) value
    return base.at[:, points].set(out, mode="promise_in_bounds")
