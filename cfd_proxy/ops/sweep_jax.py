"""XLA-native Green-Gauss sweep backends (single shard).

The hot loop of the reference (`compute_gradients_gg` in `gradients.c`;
SURVEY.md §4.3) lowered to dense gather/reduce primitives over the metadata of
`ops/prep.py`:

- `face_contrib`: per-face contribution C[f] = 0.5*(var[p0]+var[p1]) ⊗ n[f]
  — two row gathers + FMA, pure VPU work, no scatter.
- `ell_reduce`: per-point reduction over the padded ELL incidence table.
  `exact=True` sums slots sequentially (lax.scan over slot columns) in
  incidence-id order → f64 results are bit-identical to the golden C loop.
  `exact=False` lets XLA tree-reduce (faster; used for f32 perf paths).
- `sweep_*`: boundary / interior / bulk compositions such that
  bulk == boundary ∘ interior bit-for-bit (same per-point order), the
  property the schedule-equivalence tests rely on (SURVEY.md §4b).

All shapes are static; everything here is shard-local and jit/shard_map safe.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from cfd_proxy.ops.prep import SweepPlan


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DeviceSweep:
    """Device-resident sweep metadata (contents of a SweepPlan).

    Under shard_map these arrays carry a leading device axis; shard-varying
    sizes are encoded in contents (inert padding), never in shapes.
    """

    faces_b: jax.Array      # (B_pad, 2) i32
    normals_b: jax.Array    # (B_pad, 3) dtype
    faces_i: jax.Array      # (I_pad, 2) i32
    normals_i: jax.Array    # (I_pad, 3) dtype
    b_points: jax.Array     # (nbp_pad,) i32
    binc_face: jax.Array    # (nbp_pad, maxdeg_b) i32  (into boundary slice)
    binc_sign: jax.Array    # (nbp_pad, maxdeg_b) dtype
    iinc_face: jax.Array    # (npoint_pad, maxdeg_i) i32 (into interior slice)
    iinc_sign: jax.Array    # (npoint_pad, maxdeg_i) dtype
    finc_face: jax.Array    # (npoint_pad, maxdeg_f) i32 (into concat [B|I])
    finc_sign: jax.Array    # (npoint_pad, maxdeg_f) dtype
    row_face: jax.Array     # (nrow_pad,) i32 (into concat [B|I])
    row_sign: jax.Array     # (nrow_pad,) dtype
    row_point: jax.Array    # (nrow_pad,) i32 sorted
    owned_mask: jax.Array   # (npoint_pad, 1) dtype — 1.0 at owned points
    inv_volume: jax.Array   # (npoint_pad, 1) dtype — 1/volume at owned, 1 elsewhere


def device_sweep(plan: SweepPlan, dtype=jnp.float32) -> DeviceSweep:
    """Materialise a SweepPlan in the compute dtype.

    Arrays are HOST numpy, uploaded by the caller via an explicit sharded
    device_put — an eager jnp.asarray here would first place them on the
    default device."""
    bp = plan.nface_b_pad
    owned = np.zeros((plan.npoint_pad, 1), dtype=np.float64)
    owned[: plan.nowned] = 1.0
    invvol = np.ones((plan.npoint_pad, 1), dtype=np.float64)
    return DeviceSweep(
        faces_b=np.asarray(plan.faces[:bp], dtype=jnp.int32),
        normals_b=np.asarray(plan.normals[:bp], dtype=dtype),
        faces_i=np.asarray(plan.faces[bp:], dtype=jnp.int32),
        normals_i=np.asarray(plan.normals[bp:], dtype=dtype),
        b_points=np.asarray(plan.ell_boundary.points, dtype=jnp.int32),
        binc_face=np.asarray(plan.ell_boundary.inc_face, dtype=jnp.int32),
        binc_sign=np.asarray(plan.ell_boundary.inc_sign, dtype=dtype),
        iinc_face=np.asarray(plan.ell_interior.inc_face, dtype=jnp.int32),
        iinc_sign=np.asarray(plan.ell_interior.inc_sign, dtype=dtype),
        finc_face=np.asarray(plan.ell_full.inc_face, dtype=jnp.int32),
        finc_sign=np.asarray(plan.ell_full.inc_sign, dtype=dtype),
        row_face=np.asarray(plan.row_face, dtype=jnp.int32),
        row_sign=np.asarray(plan.row_sign, dtype=dtype),
        row_point=np.asarray(plan.row_point, dtype=jnp.int32),
        owned_mask=np.asarray(owned, dtype=dtype),
        inv_volume=np.asarray(invvol, dtype=dtype),
    )


def set_volume(ds: DeviceSweep, volume: np.ndarray, nowned: int) -> DeviceSweep:
    """Fill inv_volume from a host volume array (owned points only)."""
    import dataclasses

    invvol = np.ones((ds.inv_volume.shape[0], 1), dtype=np.float64)
    invvol[:nowned, 0] = 1.0 / volume[:nowned]
    return dataclasses.replace(
        ds, inv_volume=np.asarray(invvol, dtype=ds.inv_volume.dtype)
    )


def face_contrib(var: jax.Array, faces: jax.Array, normals: jax.Array) -> jax.Array:
    """C[f, v*3+d] = 0.5*(var[p0,v]+var[p1,v]) * n[f,d]; (F, nvar*3)."""
    nvar = var.shape[1]
    avg = 0.5 * (jnp.take(var, faces[:, 0], axis=0) + jnp.take(var, faces[:, 1], axis=0))
    c = avg[:, :, None] * normals[:, None, :]
    return c.reshape(faces.shape[0], nvar * 3)


def ell_reduce(
    contrib: jax.Array,    # (F, nv3)
    inc_face: jax.Array,   # (R, K)
    inc_sign: jax.Array,   # (R, K)
    init: jax.Array,       # (R, nv3)
    *,
    exact: bool,
) -> jax.Array:
    if exact:
        # unrolled sequential accumulation in slot order (maxdeg is small);
        # a python loop also sidesteps shard_map's scan carry vma typing
        g = init
        for k in range(inc_face.shape[1]):
            g = g + inc_sign[:, k : k + 1] * jnp.take(contrib, inc_face[:, k], axis=0)
        return g
    gathered = jnp.take(contrib, inc_face.reshape(-1), axis=0)
    gathered = gathered.reshape(*inc_face.shape, contrib.shape[1])
    # multiply-and-sum, not einsum: a float32 contraction may run as a TF32
    # matrix product on the GPU
    return init + jnp.sum(inc_sign[:, :, None] * gathered, axis=1)


def sweep_bulk(var: jax.Array, ds: DeviceSweep, *, exact: bool = False) -> jax.Array:
    """One full sweep over all faces → raw grad (npoint_pad, nvar*3)."""
    c_b = face_contrib(var, ds.faces_b, ds.normals_b)
    c_i = face_contrib(var, ds.faces_i, ds.normals_i)
    contrib = jnp.concatenate([c_b, c_i], axis=0)
    init = jnp.zeros((ds.finc_face.shape[0], contrib.shape[1]), contrib.dtype)
    return ell_reduce(contrib, ds.finc_face, ds.finc_sign, init, exact=exact)


def sweep_boundary(var: jax.Array, ds: DeviceSweep, *, exact: bool = False) -> jax.Array:
    """Boundary-face sweep → raw grad (npoint_pad, nvar*3), nonzero only at
    boundary-adjacent points.  After this, grads at send points are FINAL —
    the property the overlap schedules exploit (reference: the finish-counter
    send trigger, SURVEY.md §4.3)."""
    contrib = face_contrib(var, ds.faces_b, ds.normals_b)
    init = jnp.zeros((ds.binc_face.shape[0], contrib.shape[1]), contrib.dtype)
    rows = ell_reduce(contrib, ds.binc_face, ds.binc_sign, init, exact=exact)
    grad = jnp.zeros((ds.finc_face.shape[0], contrib.shape[1]), contrib.dtype)
    # b_points are unique (padding repeats the trash row; adds zeros there)
    return grad.at[ds.b_points].add(rows, indices_are_sorted=True)


def sweep_interior(
    var: jax.Array, ds: DeviceSweep, init: jax.Array, *, exact: bool = False
) -> jax.Array:
    """Interior-face sweep accumulated on top of `init` (the boundary grads).

    Chaining from init keeps per-point summation order identical to
    sweep_bulk → bit-equal results in f64."""
    contrib = face_contrib(var, ds.faces_i, ds.normals_i)
    return ell_reduce(contrib, ds.iinc_face, ds.iinc_sign, init, exact=exact)


def sweep_rows_segment(var: jax.Array, ds: DeviceSweep) -> jax.Array:
    """Sorted-segment-sum backend over incidence rows (not bit-exact)."""
    c_b = face_contrib(var, ds.faces_b, ds.normals_b)
    c_i = face_contrib(var, ds.faces_i, ds.normals_i)
    contrib = jnp.concatenate([c_b, c_i], axis=0)
    data = ds.row_sign[:, None] * jnp.take(contrib, ds.row_face, axis=0)
    return jax.ops.segment_sum(
        data,
        ds.row_point,
        num_segments=ds.finc_face.shape[0],
        indices_are_sorted=True,
    )


def scale_owned(grad: jax.Array, ds: DeviceSweep) -> jax.Array:
    """Divide by dual volume at owned points (identity at ghosts/padding)."""
    return grad * jnp.where(ds.owned_mask > 0, ds.inv_volume, 1.0)
