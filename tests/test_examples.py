"""Guard tests for the examples/ drivers (run on the virtual CPU mesh)."""

import os
import sys

import numpy as np

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def test_convergence_driver_converges():
    sys.path.insert(0, EXAMPLES)
    try:
        from convergence_driver import drive
    finally:
        sys.path.remove(EXAMPLES)
    status, res = drive(nx=8, ny=8, nz=6, nparts=2, max_steps=60,
                        verbose=False)
    assert status == "converged", (status, res)
    assert res[-1] < 0.1 * res[0]
    # monotone decay up to explicit-scheme ripple
    assert all(b < 1.05 * a for a, b in zip(res, res[1:])), res


def test_convergence_driver_schedules_agree():
    """The driver's residual history does not depend on the exchange
    schedule: bulk and overlap compute the same gradients."""
    sys.path.insert(0, EXAMPLES)
    try:
        from convergence_driver import drive
    finally:
        sys.path.remove(EXAMPLES)
    runs = {s: drive(nx=8, ny=8, nz=6, nparts=2, max_steps=10,
                     schedule=s, verbose=False)[1]
            for s in ("bulk", "overlap")}
    np.testing.assert_allclose(runs["bulk"], runs["overlap"], rtol=1e-5)


def test_pseudo_time_stepping_runs(capsys):
    sys.path.insert(0, EXAMPLES)
    try:
        import pseudo_time_stepping
    finally:
        sys.path.remove(EXAMPLES)
    pseudo_time_stepping.main()
    out = capsys.readouterr().out
    assert "done" in out
    norms = [float(l.split("=")[1]) for l in out.splitlines() if "||q||" in l]
    assert len(norms) == 5 and all(np.isfinite(norms))
