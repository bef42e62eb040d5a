"""Equirectangular (ERP) geometry: ray dirs, warps, depth<->distance.

JAX redesign of the reference ERP pipeline (src/layers/
erp_conversions.py, erp_utils.py, c2e.py, c2e_utils.py — C23-C27 in
SURVEY.md). The reference uses these for collision sensing: the simulator's
ERP *plane* depth is converted to *radial distance* by warping to 6 skybox
faces (90 deg FoV), converting each face's plane depth to distance, and
stitching back to ERP (ERPDepth2Dist, erp_conversions.py:288-354). Invalid
depths (<= 0) become 1e8 (habitat_simulator.py:142).

Conventions (RDF camera frame: +x right, +y down, +z forward):
  * ERP pixel (v, u) in an [H, W] image maps to latitude
    theta = pi*(0.5 - (v+0.5)/H)  (top row ~ +pi/2, up)
    and longitude phi = 2*pi*((u+0.5)/W - 0.5)  (center column = forward).
  * direction = (cos(t)*sin(p), -sin(t), cos(t)*cos(p)).
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnums=(0, 1))
def erp_ray_dirs(H: int, W: int) -> jnp.ndarray:
    """[H, W, 3] unit ray directions in the RDF camera frame.

    Jitted with static (H, W): eagerly this is ~15 tiny op dispatches;
    under an outer trace the jit simply inlines."""
    v = (jnp.arange(H, dtype=jnp.float32) + 0.5) / H
    u = (jnp.arange(W, dtype=jnp.float32) + 0.5) / W
    theta = jnp.pi * (0.5 - v)              # latitude, +pi/2 at top
    phi = 2 * jnp.pi * (u - 0.5)            # longitude, 0 = forward
    ct, st = jnp.cos(theta), jnp.sin(theta)
    cp, sp = jnp.cos(phi), jnp.sin(phi)
    x = ct[:, None] * sp[None, :]
    y = -st[:, None] * jnp.ones_like(cp)[None, :]
    z = ct[:, None] * cp[None, :]
    return jnp.stack([x, y, z], axis=-1)


def dirs_to_erp_uv(dirs: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Unit dirs [...,3] -> continuous ERP pixel coords (v, u) for an
    [H, W] image in [0, 1] normalized units."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    theta = jnp.arcsin(jnp.clip(-y, -1.0, 1.0))
    phi = jnp.arctan2(x, z)
    v = 0.5 - theta / jnp.pi
    u = phi / (2 * jnp.pi) + 0.5
    return v, u


def bilinear_sample_2d(img: jnp.ndarray, v: jnp.ndarray, u: jnp.ndarray,
                       wrap_u: bool = False) -> jnp.ndarray:
    """Sample img [H, W(, C)] at continuous pixel coords (v, u) in pixels.
    Border clamp in v; optional horizontal wrap (ERP longitude)."""
    H, W = img.shape[0], img.shape[1]
    v = jnp.clip(v, 0.0, H - 1.0)
    v0 = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, H - 2)
    fv = v - v0
    if wrap_u:
        u = jnp.remainder(u, W)
        u0 = jnp.floor(u).astype(jnp.int32)
        fu = u - u0
        u0 = jnp.remainder(u0, W)
        u1 = jnp.remainder(u0 + 1, W)
    else:
        u = jnp.clip(u, 0.0, W - 1.0)
        u0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, W - 2)
        fu = u - u0
        u1 = u0 + 1
    if img.ndim == 2:
        imgc = img[..., None]
    else:
        imgc = img
    a = imgc[v0, u0] * (1 - fu[..., None]) + imgc[v0, u1] * fu[..., None]
    b = imgc[v0 + 1, u0] * (1 - fu[..., None]) + imgc[v0 + 1, u1] * fu[..., None]
    out = a * (1 - fv[..., None]) + b * fv[..., None]
    return out[..., 0] if img.ndim == 2 else out


def pinhole_dirs(H: int, W: int, fov_deg: float = 90.0) -> jnp.ndarray:
    """[H, W, 3] RDF unit dirs for a square-pixel pinhole with given FoV."""
    f = (W / 2.0) / np.tan(np.radians(fov_deg) / 2.0)
    u = jnp.arange(W, dtype=jnp.float32) - (W / 2.0 - 0.5)
    v = jnp.arange(H, dtype=jnp.float32) - (H / 2.0 - 0.5)
    x = u[None, :] / f * jnp.ones((H, 1))
    y = v[:, None] / f * jnp.ones((1, W))
    z = jnp.ones((H, W))
    d = jnp.stack([x, y, z], axis=-1)
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def depth2dist(depth: jnp.ndarray, fx: float, fy: float, cx: float,
               cy: float) -> jnp.ndarray:
    """Pinhole plane depth [H,W] -> radial distance (ref depth2dist,
    erp_conversions.py:269-285: backprojection norm)."""
    H, W = depth.shape
    u = jnp.arange(W, dtype=jnp.float32)
    v = jnp.arange(H, dtype=jnp.float32)
    x = (u[None, :] - cx) / fx
    y = (v[:, None] - cy) / fy
    scale = jnp.sqrt(x ** 2 + y ** 2 + 1.0)
    return depth * scale


# 6 skybox faces (FRBLUD): rotations mapping face-local RDF dirs to camera
def _face_rotations() -> np.ndarray:
    def rot_y(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def rot_x(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    return np.stack([
        np.eye(3),                      # Front  (+z)
        rot_y(np.pi / 2),               # Right  (+x)
        rot_y(np.pi),                   # Back   (-z)
        rot_y(-np.pi / 2),              # Left   (-x)
        rot_x(-np.pi / 2),              # Up     (-y)
        rot_x(np.pi / 2),               # Down   (+y)
    ]).astype(np.float32)


FACE_ROTATIONS = _face_rotations()


def e2p(erp_img: jnp.ndarray, face_rot: np.ndarray, face_hw: int,
        fov_deg: float = 90.0) -> jnp.ndarray:
    """Extract a perspective view from an ERP image (ref E2P,
    erp_conversions.py:38-81): per-pixel dirs rotated into the camera frame,
    converted to ERP coords, bilinearly sampled (longitude wraps)."""
    H, W = erp_img.shape[0], erp_img.shape[1]
    dirs = pinhole_dirs(face_hw, face_hw, fov_deg)
    dirs_cam = dirs @ jnp.asarray(face_rot).T
    v, u = dirs_to_erp_uv(dirs_cam)
    return bilinear_sample_2d(erp_img, v * H - 0.5, u * W - 0.5, wrap_u=True)


def c2e(faces: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Cubemap [6, s, s(, C)] (FRBLUD) -> ERP [out_h, out_w(, C)]
    (ref C2E, c2e.py:69-137): per-ERP-pixel face id + in-face coords, then
    bilinear sample within the face."""
    s = faces.shape[1]
    f = (s / 2.0)
    dirs = erp_ray_dirs(out_h, out_w)                     # [H, W, 3]
    R = jnp.asarray(FACE_ROTATIONS)                       # [6, 3, 3]
    # dir in each face frame: d_face = R_f^T d
    d_face = jnp.einsum("fij,hwi->fhwj", R, dirs)         # [6, H, W, 3]
    z = d_face[..., 2]
    # in-face pinhole coords (FoV 90: focal = s/2)
    x = d_face[..., 0] / jnp.maximum(z, 1e-9) * f + (s / 2.0 - 0.5)
    y = d_face[..., 1] / jnp.maximum(z, 1e-9) * f + (s / 2.0 - 0.5)
    inside = (z > 1e-6) & (x >= -0.5) & (x <= s - 0.5) \
        & (y >= -0.5) & (y <= s - 0.5)
    best = jnp.argmax(jnp.where(inside, z, -jnp.inf), axis=0)  # [H, W]

    sampled = jnp.stack([
        bilinear_sample_2d(faces[i], y[i], x[i]) for i in range(6)
    ])                                                     # [6, H, W(, C)]
    if faces.ndim == 4:
        return jnp.take_along_axis(
            sampled, best[None, ..., None], axis=0)[0]
    return jnp.take_along_axis(sampled, best[None, ...], axis=0)[0]


def p2e_with_pose(persp: jnp.ndarray, R: jnp.ndarray, out_h: int,
                  out_w: int, fx: float, fy: float, cx: float, cy: float,
                  fill: float = 0.0) -> jnp.ndarray:
    """Project a perspective image into an ERP panorama at rotation R
    (ref P2E_w_pose, erp_conversions.py:84-182): for each ERP pixel, rotate
    its ray into the camera frame, project through the pinhole intrinsics,
    and bilinearly sample where it lands inside the image; elsewhere
    `fill`."""
    dirs = erp_ray_dirs(out_h, out_w)                       # [H, W, 3] world
    d_cam = dirs @ jnp.asarray(R)                           # R^T d (R c2w)
    z = d_cam[..., 2]
    u = d_cam[..., 0] / jnp.where(z > 1e-6, z, 1.0) * fx + cx
    v = d_cam[..., 1] / jnp.where(z > 1e-6, z, 1.0) * fy + cy
    H, W = persp.shape[0], persp.shape[1]
    inside = (z > 1e-6) & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    sampled = bilinear_sample_2d(persp, v, u)
    if persp.ndim == 3:
        return jnp.where(inside[..., None], sampled, fill)
    return jnp.where(inside, sampled, fill)


def erp_depth_to_dist(erp_depth: jnp.ndarray, face_hw: int = 256,
                      invalid_value: float = 1e8) -> jnp.ndarray:
    """ERP plane depth -> ERP radial distance via the skybox pipeline
    (ref ERPDepth2Dist, erp_conversions.py:288-354): E2P to 6 faces,
    per-face plane-depth->distance, C2E back. Invalid (<=0) -> 1e8."""
    H, W = erp_depth.shape
    f = face_hw / 2.0
    cx = cy = face_hw / 2.0 - 0.5
    faces = []
    for i in range(6):
        face_depth = e2p(erp_depth, FACE_ROTATIONS[i], face_hw)
        faces.append(depth2dist(face_depth, f, f, cx, cy))
    dist = c2e(jnp.stack(faces), H, W)
    return jnp.where(erp_depth <= 0.0, invalid_value, dist)
