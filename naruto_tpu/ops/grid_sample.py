"""Trilinear sampling of 3D voxel grids (torch.grid_sample equivalents).

Two conventions appear in the reference and both are provided:
  * align_corners=False — the learnable uncertainty grid is sampled this way
    (src/slam/coslam/model/scene_rep.py:62). Normalized coord g in [-1,1]
    maps to voxel coordinate ((g+1)*size - 1)/2.
  * align_corners=True — the planner's unused GPU SDF query
    (src/planner/rrt_naruto.py:275). g maps to (g+1)/2*(size-1).

Out-of-range coordinates are clamped to the border (torch default is zero
padding; inputs here are normalized points inside the AABB, so only the
half-voxel fringe differs — the learned grid adapts to whichever operator
trains it, so border clamping is the behavior-preserving choice that also
avoids masking work).

The volume gradient uses a custom VJP through the scatter-free segment sum
(ops/segment.py) instead of the natural scatter-add backward.

Also provides `trilinear_interp_volume`, the unnormalized voxel-coordinate
interpolation used by the planner's collision checks
(src/planner/rrt.py:12-74), vectorized (the reference loops per point in
Python).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def _corner_data(shape, coords):
    """coords [N,3] voxel units -> (cell idx [N], weights [N,8],
    frac [N,3]). Cell id indexes the (X-1)(Y-1)(Z-1) cell-packed view."""
    X, Y, Z = shape
    limit = jnp.asarray([X - 1.0, Y - 1.0, Z - 1.0], coords.dtype)
    c = jnp.clip(coords, 0.0, limit)
    i0 = jnp.clip(jnp.floor(c).astype(jnp.int32), 0,
                  jnp.asarray([X - 2, Y - 2, Z - 2], jnp.int32))
    frac = c - i0.astype(coords.dtype)
    cell = (i0[:, 0] * ((Y - 1) * (Z - 1)) + i0[:, 1] * (Z - 1) + i0[:, 2])
    cf = jnp.asarray(_CORNERS, dtype=coords.dtype)            # [8, 3]
    w = jnp.prod(jnp.where(cf[None] > 0.5, frac[:, None, :],
                           1.0 - frac[:, None, :]), axis=-1)  # [N, 8]
    return cell, w, frac


def _cell_pack(vol, shape):
    """[X,Y,Z] -> [(X-1)(Y-1)(Z-1), 8]: row c holds the 8 corner values of
    cell c in _CORNERS order: ONE 8-wide row gather per point replaces 8
    scalar gathers."""
    X, Y, Z = shape
    slices = [vol[dx:dx + X - 1, dy:dy + Y - 1, dz:dz + Z - 1]
              for dx, dy, dz in _CORNERS]
    return jnp.stack(slices, axis=-1).reshape(-1, 8)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _trilerp(vol: jnp.ndarray, coords: jnp.ndarray, shape) -> jnp.ndarray:
    cell, w, _ = _corner_data(shape, coords)
    vals = jnp.take(_cell_pack(vol, shape), cell, axis=0)     # [N, 8]
    return jnp.sum(vals * w, axis=-1)


def _trilerp_fwd(vol, coords, shape):
    cell, w, frac = _corner_data(shape, coords)
    vals = jnp.take(_cell_pack(vol, shape), cell, axis=0)
    return jnp.sum(vals * w, axis=-1), (vol, cell, w, frac, vals)


def _trilerp_bwd(shape, res, g):
    from naruto_tpu.ops.segment import dense_segment_sum

    vol, cell, w, frac, vals = res
    X, Y, Z = shape
    n_cells = (X - 1) * (Y - 1) * (Z - 1)
    # exact f32 payloads — this sort is small (N points, not N*8) so the
    # bf16 packing isn't needed for speed here
    d_cell = dense_segment_sum(cell, g[:, None] * w, n_cells,
                               pack_bf16=False)                # [cells, 8]
    d_cell = d_cell.reshape(X - 1, Y - 1, Z - 1, 8)
    # unpack cell-corner grads back to the vertex grid: sum of 8 corner-
    # shifted pads (the exact transpose of _cell_pack; no scatter). Pads
    # fuse into one elementwise pass instead of a chain of `.at[slice].add`
    # dynamic-update-slices.
    d_vol = None
    for k, (dx, dy, dz) in enumerate(_CORNERS):
        p = jnp.pad(d_cell[..., k],
                    ((dx, 1 - dx), (dy, 1 - dy), (dz, 1 - dz)))
        d_vol = p if d_vol is None else d_vol + p
    d_vol = d_vol.astype(vol.dtype)

    corners = jnp.asarray(_CORNERS, dtype=frac.dtype)         # [8, 3]
    t = jnp.where(corners[None] > 0.5, frac[:, None, :],
                  1.0 - frac[:, None, :])                     # [N, 8, 3]
    sign = jnp.where(corners > 0.5, 1.0, -1.0)
    p = jnp.stack([t[..., 1] * t[..., 2], t[..., 0] * t[..., 2],
                   t[..., 0] * t[..., 1]], axis=-1)           # [N, 8, 3]
    d_coords = jnp.einsum("n,nc,ca,nca->na", g, vals, sign, p)
    return d_vol, d_coords.astype(frac.dtype)


_trilerp.defvjp(_trilerp_fwd, _trilerp_bwd)


def trilinear_sample(vol: jnp.ndarray, pts01: jnp.ndarray,
                     align_corners: bool = False) -> jnp.ndarray:
    """Sample vol [X,Y,Z] at normalized points pts01 [N,3] in [0,1]^3."""
    shape = jnp.asarray(vol.shape, dtype=pts01.dtype)
    g = pts01 * 2.0 - 1.0
    if align_corners:
        coords = (g + 1.0) / 2.0 * (shape - 1.0)
    else:
        coords = ((g + 1.0) * shape - 1.0) / 2.0
    return _trilerp(vol, coords, vol.shape)


def trilinear_interp_volume(vol: jnp.ndarray, coords: jnp.ndarray) -> jnp.ndarray:
    """Interpolate at raw voxel coordinates [N,3] (planner convention)."""
    return _trilerp(vol, coords, vol.shape)
