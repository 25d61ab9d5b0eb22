"""ctypes loader for the native preprocessing library (native/prep.cc).

Falls back gracefully: `lib()` returns None if the shared object has not been
built (`make -C native`), and callers keep using the NumPy path.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache

_SO = os.path.join(os.path.dirname(__file__), "libcfdprep.so")

# Must match native/prep.cc::cfd_abi_version().  Bumped on every exported-
# signature change so a stale .so fails the handshake in _bind (and is then
# rebuilt) instead of being called with a mismatched argument list — missing-
# symbol detection alone cannot catch a signature CHANGE to an existing
# export (advisor finding, round 2).
_ABI_VERSION = 5


def _make():
    """Best-effort build (the .so is not committed); callers fall back."""
    import subprocess

    mk = os.path.join(os.path.dirname(__file__), "..", "..", "native")
    try:
        subprocess.run(["make", "-C", mk], capture_output=True, timeout=120)
    except Exception:
        pass


@lru_cache(maxsize=1)
def lib():
    if os.environ.get("CFD_NATIVE", "1") == "0":
        return None
    if not os.path.exists(_SO):
        _make()
    if not os.path.exists(_SO):
        return None
    L = _bind(_SO)
    if L is None:
        # stale .so from an older checkout (missing newer symbols): rebuild
        # once, then give up gracefully — the NumPy paths are equivalent.
        # dlopen dedups by pathname/inode and ctypes never dlcloses, so the
        # rebuilt library must be loaded through a FRESH temp copy
        _make()
        try:
            import shutil
            import tempfile

            tmp = tempfile.NamedTemporaryFile(
                prefix="libcfdprep-", suffix=".so", delete=False)
            tmp.close()
            shutil.copy2(_SO, tmp.name)
            L = _bind(tmp.name)
            # the mapping stays valid after unlink on Linux; clean the temp
            # copy up at exit so repeated stale-path hits don't litter /tmp
            import atexit

            atexit.register(lambda p=tmp.name: _quiet_unlink(p))
        except OSError:
            L = None
    return L


def _quiet_unlink(path):
    try:
        os.unlink(path)
    except OSError:
        pass


def _bind(path):
    try:
        L = ctypes.CDLL(path)
    except OSError:
        return None
    try:
        _declare(L)
    except AttributeError:
        return None
    if L.cfd_abi_version() != _ABI_VERSION:
        return None  # stale build: caller rebuilds and retries
    return L


def _declare(L):
    L.cfd_abi_version.restype = ctypes.c_int
    L.cfd_abi_version.argtypes = []
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    L.cfd_golden_gg.restype = ctypes.c_int
    L.cfd_golden_gg.argtypes = [
        f64p, ctypes.c_int64, ctypes.c_int32, i32p, ctypes.c_int64, f64p,
        f64p, ctypes.c_int32,
    ]
    i64p = ctypes.POINTER(ctypes.c_int64)
    i8p = ctypes.POINTER(ctypes.c_int8)
    L.cfd_rcb_assign.restype = ctypes.c_int
    L.cfd_rcb_assign.argtypes = [f64p, ctypes.c_int64, ctypes.c_int32, i32p]
    L.cfd_ghosts_run.restype = ctypes.c_void_p
    L.cfd_ghosts_run.argtypes = [
        i32p, ctypes.c_int64, i32p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, i64p, i64p,
    ]
    L.cfd_ghosts_take.restype = ctypes.c_int
    L.cfd_ghosts_take.argtypes = [
        ctypes.c_void_p, i64p, i64p, i32p, i8p, i32p,
    ]


def rcb_assign_c(coords, npart: int):
    """Native recursive coordinate bisection, or None if unavailable.

    Same membership as the NumPy path for tie-free coordinates; ties at a
    cut are broken by (value, global id) — see native/partition.cc."""
    import numpy as np

    L = lib()
    if L is None:
        return None
    coords_c = np.ascontiguousarray(coords, np.float64)
    owner = np.zeros(coords_c.shape[0], np.int32)
    rc = L.cfd_rcb_assign(ptr(coords_c, ctypes.c_double), coords_c.shape[0],
                          int(npart), ptr(owner, ctypes.c_int32))
    return owner if rc == 0 else None


def ghost_closure_c(faces, owner, npart: int, ghost_layers: int):
    """Native sparse ghost closure (native/partition.cc) or None.

    Returns (ghost_gid, ghost_depth, goff, face_ids, foff): per-partition
    ghost points in BFS order + kept-face ids ascending, with prefix offsets.
    """
    import numpy as np

    L = lib()
    if L is None:
        return None
    faces_c = np.ascontiguousarray(faces, np.int32)
    owner_c = np.ascontiguousarray(owner, np.int32)
    F, N = faces_c.shape[0], owner_c.shape[0]
    ng = ctypes.c_int64(0)
    nf = ctypes.c_int64(0)
    handle = L.cfd_ghosts_run(
        ptr(faces_c, ctypes.c_int32), F, ptr(owner_c, ctypes.c_int32), N,
        npart, ghost_layers, ctypes.byref(ng), ctypes.byref(nf),
    )
    if not handle:
        return None
    goff = np.zeros(npart + 1, np.int64)
    foff = np.zeros(npart + 1, np.int64)
    ghost_gid = np.zeros(ng.value, np.int32)
    ghost_depth = np.zeros(ng.value, np.int8)
    face_ids = np.zeros(nf.value, np.int32)
    rc = L.cfd_ghosts_take(
        handle, ptr(goff, ctypes.c_int64), ptr(foff, ctypes.c_int64),
        ptr(ghost_gid, ctypes.c_int32), ptr(ghost_depth, ctypes.c_int8),
        ptr(face_ids, ctypes.c_int32),
    )
    if rc != 0:
        return None
    return ghost_gid, ghost_depth, goff, face_ids, foff


def golden_gg_c(var, faces, normals, nthreads: int = 1,
                validate: bool = True):
    """C golden sweep (native/golden.cc) or None if the library is absent.

    nthreads==1 is bit-identical to ops/golden.py::compute_gradients_gg;
    threaded mode is the multi-core CPU-baseline denominator (not bit-gated).

    validate=True (default) checks face endpoints in [0, npoint) here,
    vectorised, and returns None on a bad mesh (np.add.at would raise); the C
    function itself no longer scans — benchmark timing loops validate once
    up front and pass validate=False so the denominator times only the sweep.
    """
    import numpy as np

    L = lib()
    if L is None:
        return None
    var_c = np.ascontiguousarray(var, np.float64)
    faces_c = np.ascontiguousarray(faces, np.int32)
    normals_c = np.ascontiguousarray(normals, np.float64)
    npoint, nvar = var_c.shape
    if validate and faces_c.size and (
            faces_c.min() < 0 or faces_c.max() >= npoint):
        return None
    grad = np.zeros((npoint, nvar, 3), np.float64)
    rc = L.cfd_golden_gg(
        ptr(var_c, ctypes.c_double), npoint, nvar,
        ptr(faces_c, ctypes.c_int32), faces_c.shape[0],
        ptr(normals_c, ctypes.c_double), ptr(grad, ctypes.c_double),
        int(nthreads),
    )
    if rc != 0:
        return None
    return grad


def ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))
