"""The bundled small mesh: readable, consistent, and bit-matched to its golden."""

import os

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), "..", "data")

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(DATA, "small_golden.nc")),
    reason="bundled data not present",
)


def test_shipped_partitions_read_and_run():
    from cfd_proxy.mesh.reader import partition_path, read_partition
    from cfd_proxy.models import GreenGaussSweep
    from cfd_proxy.mesh.generator import make_state
    from cfd_proxy.mesh import netcdf3

    prefix = os.path.join(DATA, "small")
    parts = [read_partition(partition_path(prefix, i, 4)) for i in range(4)]
    assert sum(p.nowned for p in parts) == 960
    assert max(p.nrounds for p in parts) == 2
    model = GreenGaussSweep(parts, 7)
    gvar = make_state(960, 7, seed=1)
    state = model.distribute_state(gvar)
    g = model.gather_global(model.step(state, "overlap"))
    # compare against the single-partition shipped mesh
    (p1,) = [read_partition(partition_path(prefix, 0, 1))]
    m1 = GreenGaussSweep([p1], 7)
    g1 = m1.gather_global(m1.step(m1.distribute_state(gvar), "bulk"))
    assert np.abs(g - g1).max() / max(1.0, np.abs(g1).max()) < 1e-5


def test_shipped_golden_bitmatch():
    from cfd_proxy.tools.golden import main

    ref = os.path.join(DATA, "small_golden.nc")
    rc = main(["check", "--nx", "12", "--ny", "10", "--nz", "8", "--ref", ref])
    assert rc == 0  # bitwise MATCH of the recomputed f64 golden
