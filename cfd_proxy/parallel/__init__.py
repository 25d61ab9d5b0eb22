"""L4: the exchange layer — XLA collectives via shard_map + ppermute.

Reference equivalents: `exchange_data_mpi.c` (two-sided), `exchange_data_mpidma.c`
(MPI RMA), `exchange_data_gaspi.c` (GPI-2 write_notify) — SURVEY.md §2 L4,
§4.5, §5.8.  The reference's three transports collapse into ONE transport
(collective permutes, which XLA hands to NCCL on GPUs) and the
transport×schedule matrix survives as a *schedule* axis:

  bulk    — full sweep → exchange (barrier semantics; `Isend/Irecv/Waitall`
            after compute);
  early   — boundary sweep → exchange started → interior sweep independent of
            the exchange → merge (the early-posted-receive / async-collective
            analogue; XLA may overlap the ppermute with the interior sweep);
  overlap — the full-overlap slot: the same dataflow as early, the form the
            GASPI write_notify pattern takes when collectives run outside the
            compute kernel.
"""

from cfd_proxy.parallel.topology import HaloTopology, build_halo_topology
from cfd_proxy.parallel.halo import DeviceHalo, device_halo, exchange

__all__ = [
    "HaloTopology",
    "build_halo_topology",
    "DeviceHalo",
    "device_halo",
    "exchange",
]
