"""Device-side halo exchange: gather-pack → ppermute → scatter-unpack.

The realisation of the reference's pack/send/unpack cycle (`exchange_dbl_*`
families; SURVEY.md §4.5): `pack` is a static gather via sendidx, the
transfer is `lax.ppermute` (a collective permute; NCCL on GPUs), `unpack` is
a static scatter via recvidx with XLA `mode='drop'` discarding padding
lanes.

`exchange_start`/`exchange_finish` split the exchange so a compute kernel can
be scheduled between the ppermutes and the scatters: gathers read only OWNED
rows and scatters write only GHOST rows, so the started collectives are
independent of any compute that writes owned rows — XLA's async collectives
can then hide the transfer (the early-recv / overlap schedules, SURVEY.md
§5.8).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from cfd_proxy.parallel.topology import HaloTopology


@dataclass(frozen=True)
class DeviceHalo:
    """Per-device exchange metadata (leading device axis when stacked)."""

    send_idx: jax.Array                        # (nphase, S) i32
    recv_idx: jax.Array                        # (nphase, S) i32; OOB = drop
    perms: tuple = field(metadata=dict(static=True), default=())
    # perms[k] = tuple of (src, dst) pairs for phase k — static schedule

jax.tree_util.register_dataclass(
    DeviceHalo, data_fields=["send_idx", "recv_idx"], meta_fields=["perms"]
)


def device_halo(topo: HaloTopology, part_id: int) -> DeviceHalo:
    """Materialise one device's phase metadata, padded to uniform S_max."""
    smax = max(topo.max_phase_size(), 1)
    nph = max(topo.nphases, 1)
    send = np.zeros((nph, smax), dtype=np.int32)
    recv = np.full((nph, smax), topo.npoint_pad, dtype=np.int32)
    perms = []
    for k, ph in enumerate(topo.phases):
        s = ph.send_idx.shape[1]
        send[k, :s] = ph.send_idx[part_id]
        recv[k, :s] = ph.recv_idx[part_id]
        # re-pad: entries beyond this phase's own smax stay inert
        perms.append(tuple(ph.perm))
    # host numpy: placement happens once via the model's sharded device_put
    return DeviceHalo(
        send_idx=send,
        recv_idx=recv,
        perms=tuple(perms),
    )


def exchange_start(
    x: jax.Array,                # (npoint_pad, C) — owned rows must be final
    halo: DeviceHalo,
    axis_name: str,
    *,
    scale: jax.Array | None = None,   # (npoint_pad, 1) pack-time scaling
) -> list[jax.Array]:
    """Pack and fire every phase's ppermute; returns received buffers."""
    bufs = []
    for k, perm in enumerate(halo.perms):
        idx = halo.send_idx[k]
        buf = jnp.take(x, idx, axis=0)
        if scale is not None:
            buf = buf * jnp.take(scale, idx, axis=0)
        bufs.append(jax.lax.ppermute(buf, axis_name, list(perm)))
    return bufs


def exchange_finish(
    x: jax.Array, bufs: list[jax.Array], halo: DeviceHalo
) -> jax.Array:
    """Scatter received buffers into ghost rows (padding lanes dropped).

    ONE fused scatter for all phases: per-phase recv sets are disjoint by
    construction (each ghost is filled by exactly one comm entry —
    MeshPartition.validate pins GLOBAL recvidx uniqueness) and padding lanes
    are OOB indices dropped by mode='drop', so concatenating is equivalent
    to the per-phase chain — and pays one scatter instead of nphases.

    Correctness therefore DEPENDS on validate() having run: duplicate recv
    indices would make this single .at[].set XLA-nondeterministic where the
    old per-phase chain was last-write-wins.  Every partition constructor in
    this repo validates (mesh/partition.py::partition_mesh + relabel_owned,
    mesh/reader.py::read_partition); hand-built MeshPartitions must call
    .validate() themselves or duplicate ghosts fail silently here."""
    if not bufs:
        return x
    idx = halo.recv_idx[: len(bufs)].reshape(-1)
    return x.at[idx].set(jnp.concatenate(bufs, axis=0), mode="drop")


def exchange(
    x: jax.Array,
    halo: DeviceHalo,
    axis_name: str,
) -> jax.Array:
    """Bulk-synchronous exchange: start + finish back-to-back.  (Pack-time
    scaling is an exchange_start concern; no caller composes it through
    this bulk wrapper.)"""
    return exchange_finish(x, exchange_start(x, halo, axis_name), halo)
