"""Card-only checks: the compiled GPU path against the f64 golden.

Marked `gpu`: they skip wherever JAX finds no GPU.  On the card:
    CFD_TEST_GPU=1 python -m pytest -m gpu tests/
chip_smoke.py runs the same checks at the headline size.
"""

import numpy as np
import pytest

from cfd_proxy.mesh.generator import generate_mesh, make_state
from cfd_proxy.mesh.partition import partition_mesh
from cfd_proxy.solver import golden_reference

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("op", ["gg", "flux"])
def test_gpu_sweep_matches_golden(op):
    from cfd_proxy.models import GreenGaussSweep

    m = generate_mesh(24, 24, 24, jitter=0.05, diag_frac=0.2, seed=0)
    gvar = make_state(m.npoint, 7, seed=1)
    model = GreenGaussSweep(partition_mesh(m, 1), 7, op=op)
    assert model.mesh.devices.flat[0].platform == "gpu"
    state = model.distribute_state(gvar)
    ref = golden_reference(model, m, gvar)
    denom = max(1.0, np.abs(ref).max())
    outs = {s: np.asarray(model.step(state, s))
            for s in ("bulk", "early", "overlap")}
    for s, g in outs.items():
        assert np.abs(model.gather_global(g) - ref).max() / denom < 1e-5, s
        scale = max(1.0, np.abs(outs["bulk"]).max())
        assert np.abs(g - outs["bulk"]).max() / scale < 1e-6, s


def test_gpu_f64_xla_matches_golden():
    import jax.numpy as jnp

    from cfd_proxy.models import GreenGaussModel

    m = generate_mesh(16, 16, 16, jitter=0.05, diag_frac=0.2, seed=0)
    gvar = make_state(m.npoint, 7, seed=1)
    model = GreenGaussModel(partition_mesh(m, 1), 7, dtype=jnp.float64)
    var = model.distribute_state(gvar)
    ref = golden_reference(model, m, gvar)
    g = {s: np.asarray(model.step(var, s, exact=True))
         for s in ("bulk", "early", "overlap")}
    got = model.gather_global(g["bulk"])
    assert np.abs(got - ref).max() / max(1.0, np.abs(ref).max()) < 1e-12
    scale = max(1.0, np.abs(g["bulk"]).max())
    for s in ("early", "overlap"):
        assert np.abs(g[s] - g["bulk"]).max() / scale < 1e-12, s
