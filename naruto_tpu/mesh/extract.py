"""Mesh extraction from the neural field.

Behavioral contract from coslam_utils.extract_mesh (coslam_utils.py:100-226):
chunked dense SDF query over the marching-cubes bound at the requested voxel
size -> truncation isosurfacing -> vertex rescale to metric coordinates ->
vertex coloring (field color query, or jet-colormapped uncertainty for the
uncertainty mesh) -> PLY export.
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from naruto_tpu.geometry.voxel import voxel_axes
from naruto_tpu.mesh.marching import marching_cubes
from naruto_tpu.mesh.ply import write_ply

MC_TRUNCATION = 3.0   # ref: coslam_utils.py:145 marching_cubes(..., 3.0)


# Chunk size for the dense extraction queries. Large on purpose: every
# chunk is an upload + dispatch + download round trip, and 128k chunks
# turned an MP3D-scale snapshot (7.6M grid points) into ~58 serial round
# trips. 1M points keep peak device memory modest (~hundreds of MB
# through the field) while cutting the round-trip count ~8x. The tail
# chunk is zero-padded to a power-of-two family of static shapes, so the
# query executables come from a log-size family.
EXTRACT_CHUNK = 1 << 20


def _pad_rows(a: np.ndarray, chunk: int) -> np.ndarray:
    """Pad rows up to the next power of two (capped at chunk) so the
    query executables come from a log-size family instead of one per
    distinct remainder size."""
    n = a.shape[0]
    tgt = 1 << max(int(np.ceil(np.log2(max(n, 1)))), 10)
    tgt = min(tgt, chunk)
    if n >= tgt:
        return a
    return np.concatenate([a, np.zeros((tgt - n,) + a.shape[1:], a.dtype)])


def _dense_sdf(mapper, bound: np.ndarray, voxel_size: float,
               chunk: int = EXTRACT_CHUNK):
    tx, ty, tz = voxel_axes(bound, voxel_size)
    shape = (len(tx), len(ty), len(tz))
    gx, gy, gz = np.meshgrid(tx, ty, tz, indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)

    field_bound = mapper.spec.bound_np
    x01 = (pts - field_bound[:, 0]) / (field_bound[:, 1] - field_bound[:, 0])
    n = pts.shape[0]
    sdf = np.empty(n, dtype=np.float32)
    uncert = np.empty(n, dtype=np.float32)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        sd, un = mapper._sdf_query_jit(
            mapper.state.params, jnp.asarray(_pad_rows(x01[s:s + m], chunk)))
        sdf[s:s + m] = np.asarray(sd)[:m]
        uncert[s:s + m] = np.asarray(un)[:m]
    return sdf.reshape(shape), uncert.reshape(shape), (tx, ty, tz)


def _query_colors(mapper, verts_metric: np.ndarray,
                  chunk: int = EXTRACT_CHUNK) -> np.ndarray:
    n = verts_metric.shape[0]
    out = np.empty((n, 3), dtype=np.float32)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        rgb = mapper._color_query_jit(
            mapper.state.params,
            jnp.asarray(_pad_rows(
                verts_metric[s:s + m].astype(np.float32), chunk)))
        out[s:s + m] = np.asarray(rgb)[:m]
    return out


def extract_mesh(mapper, voxel_size: float = 0.05,
                 bound: Optional[np.ndarray] = None,
                 isolevel: float = 0.0,
                 color_mode: str = "color"):
    """Returns (verts [N,3] metric, faces [M,3], colors [N,3] float or None).

    color_mode: 'color' (field RGB), 'uncert' (jet-colormapped uncertainty),
    'none'.
    """
    bound = (np.asarray(bound, dtype=np.float32) if bound is not None
             else np.asarray(mapper.cfg.mapper.marching_cubes_bound,
                             dtype=np.float32))
    sdf, uncert, (tx, ty, tz) = _dense_sdf(mapper, bound, voxel_size)
    verts_vox, faces = marching_cubes(sdf, isolevel, MC_TRUNCATION)
    if len(verts_vox) == 0:
        return verts_vox, faces, None
    # voxel -> metric: the grid axes are uniform linspaces
    steps = np.array([tx[1] - tx[0] if len(tx) > 1 else 1.0,
                      ty[1] - ty[0] if len(ty) > 1 else 1.0,
                      tz[1] - tz[0] if len(tz) > 1 else 1.0])
    origin = np.array([tx[0], ty[0], tz[0]])
    verts = (verts_vox * steps + origin).astype(np.float32)

    colors = None
    if color_mode == "color":
        colors = _query_colors(mapper, verts)
    elif color_mode == "uncert":
        import matplotlib.cm as cm

        # softplus + floor, jet colormap — ref coslam_utils.py:186-205
        uv = _sample_volume(np.log1p(np.exp(uncert)) + 0.01, verts_vox)
        lo, hi = uv.min(), uv.max()
        norm = (uv - lo) / (hi - lo + 1e-9)
        colors = cm.jet(norm)[:, :3].astype(np.float32)
    return verts, faces, colors


def _sample_volume(vol: np.ndarray, pts_vox: np.ndarray) -> np.ndarray:
    from naruto_tpu.planner.collision import trilinear_interpolation_np

    return trilinear_interpolation_np(vol, pts_vox).astype(np.float32)


def save_mesh(mapper, path: str, voxel_size: float = 0.05,
              color_mode: str = "color",
              bound: Optional[np.ndarray] = None) -> str:
    verts, faces, colors = extract_mesh(mapper, voxel_size, bound,
                                        color_mode=color_mode)
    write_ply(path, verts, faces, colors)
    return path
