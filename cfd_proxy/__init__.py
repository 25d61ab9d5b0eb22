"""cfd_proxy — a JAX rebuild of PGAS-community-benchmarks/CFD-Proxy.

CFD-Proxy is a C (MPI/GASPI/pthreads/netCDF) communication proxy benchmark
built around a face-based Green-Gauss gradient sweep over a partitioned
unstructured mesh, followed by (or overlapped with) a halo exchange of
ghost-point data (see SURVEY.md §1; reference layout `src/gradients.c`,
`src/exchange_data_*.c`, `src/rangelist.c`, `src/reader.c`).

This package is NOT a port.  It keeps the reference's capabilities —
partitioned netCDF mesh input, points/faces/ghost-cells state API, the
`compute_gradients_gg` sweep semantics, and the selectable bulk-sync /
early-recv / full-overlap exchange strategies — and runs them on GPUs:

- the irregular face gather/scatter loop becomes a point-centric
  gather-and-reduce over padded slot tables (`ops/`), which XLA fuses;
- MPI two-sided / MPI RMA / GASPI one-sided transports collapse into a single
  transport (XLA collectives via `shard_map` + `ppermute`) where the
  reference's transport×schedule matrix survives as a *schedule* axis
  (`parallel/`);
- pthread rangelists become offline coloring/partitioning preprocessing
  (`ops/prep.py`, `mesh/partition.py`).

Layer map (mirrors SURVEY.md §2):
  utils/    ← L0 error/timing substrate (`util.c`, `error_handling.h`)
  mesh/     ← L1 mesh I/O + L2 comm metadata (`reader.c`, `comm_data.h`)
  ops/      ← L3 rangelists + L5 compute kernels (`rangelist.c`, `gradients.c`)
  parallel/ ← L4 exchange backends (`exchange_data_{mpi,mpidma,gaspi}.c`)
  models/   ← high-level model API over the kernels
  solver.py ← L6 benchmark driver (`solver.c` / `cfd_proxy.c` `main`)
"""

__version__ = "0.1.0"
