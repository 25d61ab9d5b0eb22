"""Native (C++) library: the C golden sweep and the loader's safety checks.

The native library is optional (`make -C native`); tests skip when absent.
"""

import numpy as np
import pytest

from cfd_proxy.mesh.generator import generate_mesh, make_state
from cfd_proxy.native import lib


pytestmark = pytest.mark.skipif(lib() is None, reason="native lib not built")


def test_c_golden_bit_matches_numpy_golden():
    """native/golden.cc nthreads==1 is bit-identical to ops/golden.py — the
    honest CPU-baseline denominator (-ffp-contract=off)."""
    from cfd_proxy.native import golden_gg_c
    from cfd_proxy.ops.golden import compute_gradients_gg

    m = generate_mesh(9, 8, 7, jitter=0.05, diag_frac=0.25, shuffle=True,
                      seed=3)
    var = make_state(m.npoint, 7, seed=5).astype(np.float64)
    got = golden_gg_c(var, m.faces, m.normals, nthreads=1)
    if got is None:
        pytest.skip("native library unavailable")
    ref = compute_gradients_gg(var, m.faces, m.normals)
    np.testing.assert_array_equal(got, ref)
    # threaded mode: perf denominator only — f64-roundoff-level agreement
    got4 = golden_gg_c(var, m.faces, m.normals, nthreads=4)
    np.testing.assert_allclose(got4, ref, rtol=1e-12, atol=1e-12)


def test_stale_so_missing_symbols_returns_none(tmp_path):
    """A shared object from an older checkout (missing newer symbols) must
    bind to None so callers fall back to NumPy instead of crashing."""
    import subprocess

    from cfd_proxy.native import _bind

    src = tmp_path / "dummy.cc"
    src.write_text('extern "C" int cfd_rcb_assign() { return 0; }\n')
    so = tmp_path / "dummy.so"
    subprocess.run(["g++", "-shared", "-fPIC", str(src), "-o", str(so)],
                   check=True)
    assert _bind(str(so)) is None


def test_stale_so_wrong_abi_version_returns_none(monkeypatch):
    """A library whose exported signatures changed (same symbol names) is
    only detectable via the cfd_abi_version handshake; _bind must refuse it
    so the loader rebuilds instead of calling a mismatched argument list."""
    import cfd_proxy.native as nat

    assert nat._bind(nat._SO) is not None          # current build matches
    monkeypatch.setattr(nat, "_ABI_VERSION", nat._ABI_VERSION + 1)
    assert nat._bind(nat._SO) is None              # version skew → refused


def test_native_ghosts_reject_corrupt_faces():
    """Out-of-range face endpoints must fail cleanly (None), not corrupt the
    CSR heap."""
    from cfd_proxy.native import ghost_closure_c

    faces = np.array([[0, 1], [2, 99]], np.int32)   # endpoint 99 >= N
    owner = np.zeros(4, np.int32)
    assert ghost_closure_c(faces, owner, 1, 1) is None


def test_native_golden_rejects_corrupt_faces():
    """golden_gg_c returns None on out-of-range endpoints (np.add.at would
    raise) instead of silently skipping faces and inflating faces/sec."""
    import pytest

    from cfd_proxy.native import golden_gg_c, lib

    if lib() is None:
        pytest.skip("native library unavailable")
    var = np.ones((4, 2))
    faces = np.array([[0, 1], [2, 99]], np.int32)
    normals = np.ones((2, 3))
    assert golden_gg_c(var, faces, normals) is None
