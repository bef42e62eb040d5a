"""Analytic simulator: closed-form SDF scenes rendered by JAX sphere tracing.

Fills the role of the habitat-sim C++ renderer (C5/C7 in SURVEY.md) for CI
and asset-free runs: pinhole RGB-D + equirectangular RGB-distance rendering
of a procedurally-defined scene whose exact SDF (and hence ground-truth
geometry) is known in closed form — the fake-backend seam the reference
lacks but its factory structure invites (SURVEY.md §4).

The scene is a closed box room fitted to the mapping AABB (walls inset by a
margin) plus interior primitives; colors are a smooth procedural field so
the photometric loss has gradient signal. Rendering is jitted sphere
tracing — 64 fixed steps over [H*W] rays, pure elementwise math.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from naruto_tpu.config.schema import MainConfig
from naruto_tpu.geometry.erp import erp_ray_dirs
from naruto_tpu.geometry.rays import get_camera_rays
from naruto_tpu.sim.base import Simulator
from naruto_tpu.utils.printer import InfoPrinter

WALL_MARGIN = 0.15      # meters between mapping AABB and the walls
TRACE_ITERS = 64
HIT_EPS = 2e-3


def make_scene_sdf(bound: np.ndarray, preset: str = "box_room"):
    """Returns sdf(p)->[N] (positive in free space) and color(p)->[N,3].

    preset 'dynamic_room' adds a sphere orbiting the room center with phase
    `t` — the analytic counterpart of habitat's dynamic rigid objects
    (ref habitat_utils.py:342-426)."""
    # scene constants in host numpy (np.float32 = the same IEEE ops the
    # f32 device constants used, so GT numerics are bit-identical): eager
    # jnp constants + float() pulls here would cost ~25 device round trips
    # per engine construction
    lo = np.asarray(bound[:, 0] + WALL_MARGIN, dtype=np.float32)
    hi = np.asarray(bound[:, 1] - WALL_MARGIN, dtype=np.float32)
    center = (lo + hi) / 2.0
    size = hi - lo

    # interior primitives scaled to the room
    s1_c = center + size * np.asarray([0.25, 0.2, -0.25], np.float32)
    s1_r = float(np.min(size)) * 0.12
    s2_c = center + size * np.asarray([-0.25, -0.2, -0.15], np.float32)
    s2_r = float(np.min(size)) * 0.16
    box_c = center + size * np.asarray([0.0, 0.28, -0.3], np.float32)
    box_h = size * np.asarray([0.10, 0.08, 0.12], np.float32)
    orbit_r = float(np.min(size)) * 0.25

    def sdf(p: jnp.ndarray, t: jnp.ndarray = 0.0) -> jnp.ndarray:
        room = jnp.min(jnp.minimum(p - lo, hi - p), axis=-1)
        if preset == "empty_room":
            return room
        s1 = jnp.linalg.norm(p - s1_c, axis=-1) - s1_r
        s2 = jnp.linalg.norm(p - s2_c, axis=-1) - s2_r
        q = jnp.abs(p - box_c) - box_h
        box = (jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
               + jnp.minimum(jnp.max(q, axis=-1), 0.0))
        static = jnp.minimum(jnp.minimum(room, s1), jnp.minimum(s2, box))
        if preset == "dynamic_room":
            dyn_c = center + jnp.stack([
                orbit_r * jnp.cos(t), orbit_r * jnp.sin(t), 0.0])
            dyn = jnp.linalg.norm(p - dyn_c, axis=-1) - s1_r * 0.8
            return jnp.minimum(static, dyn)
        return static

    def color(p: jnp.ndarray) -> jnp.ndarray:
        k = 2.0 * jnp.pi / jnp.maximum(size, 1e-3)
        phase = jnp.asarray([0.0, 2.1, 4.2])
        c = 0.5 + 0.35 * jnp.sin(
            (p - lo) * k * jnp.asarray([3.0, 4.0, 5.0]) + phase)
        return jnp.clip(c, 0.0, 1.0)

    return sdf, color


def _trace(sdf, origins, dirs_unit, max_t: float):
    """Sphere tracing. Returns (t [N], hit [N])."""
    t = jnp.zeros(origins.shape[0])

    def body(_, t):
        p = origins + dirs_unit * t[:, None]
        s = sdf(p)
        return t + jnp.clip(s, 0.0, None) * 0.95

    t = jax.lax.fori_loop(0, TRACE_ITERS, body, t)
    p = origins + dirs_unit * t[:, None]
    hit = (sdf(p) < HIT_EPS) & (t < max_t)
    return t, hit


class AnalyticSimulator(Simulator):
    def __init__(self, cfg: MainConfig,
                 printer: Optional[InfoPrinter] = None):
        super().__init__(cfg, printer)
        bound = cfg.mapper.bound_np
        self.bound = bound
        self.sdf, self.color_fn = make_scene_sdf(bound,
                                                 cfg.sim.analytic_scene)
        self.max_t = float(np.linalg.norm(bound[:, 1] - bound[:, 0])) * 1.5

        H, W = cfg.sim.pinhole_hw
        c = cfg.cam
        dirs = get_camera_rays(H, W, c.fx, c.fy, c.cx, c.cy)
        self._pin_dirs = jnp.asarray(dirs.reshape(-1, 3))
        self._pin_hw = (H, W)
        He, We = cfg.sim.erp_hw
        self._erp_dirs = jnp.asarray(erp_ray_dirs(He, We).reshape(-1, 3))
        self._erp_hw = (He, We)
        self.invalid = cfg.sim.invalid_depth_value

        self._render_pin = jax.jit(self._render_pin_impl)
        self._render_erp = jax.jit(self._render_erp_impl)

    def _render_pin_impl(self, c2w: jnp.ndarray, phase: jnp.ndarray):
        R, tvec = c2w[:3, :3], c2w[:3, 3]
        d_cam = self._pin_dirs                       # unit-z RDF dirs
        norm = jnp.linalg.norm(d_cam, axis=-1, keepdims=True)
        d_unit = (d_cam / norm) @ R.T
        o = jnp.broadcast_to(tvec, d_unit.shape)
        t, hit = _trace(lambda q: self.sdf(q, phase), o, d_unit, self.max_t)
        p = o + d_unit * t[:, None]
        color = self.color_fn(p)
        z_depth = t / norm[:, 0]                     # radial -> z-depth
        z_depth = jnp.where(hit, z_depth, 0.0)       # invalid depth = 0
        H, W = self._pin_hw
        return color.reshape(H, W, 3), z_depth.reshape(H, W)

    def _render_erp_impl(self, c2w: jnp.ndarray, phase: jnp.ndarray):
        R, tvec = c2w[:3, :3], c2w[:3, 3]
        d_unit = self._erp_dirs @ R.T
        o = jnp.broadcast_to(tvec, d_unit.shape)
        t, hit = _trace(lambda q: self.sdf(q, phase), o, d_unit, self.max_t)
        p = o + d_unit * t[:, None]
        color = self.color_fn(p)
        dist = jnp.where(hit, t, self.invalid)       # radial distance
        He, We = self._erp_hw
        return color.reshape(He, We, 3), dist.reshape(He, We)

    def simulate(self, c2w, return_erp: bool = False):
        c2w = jnp.asarray(np.asarray(c2w, dtype=np.float32))
        phase = jnp.float32(self.step * 0.1)  # dynamic-object orbit phase
        color, depth = self._render_pin(c2w, phase)
        if not return_erp:
            return color, depth
        erp_color, erp_dist = self._render_erp(c2w, phase)
        return color, depth, erp_color, erp_dist

    # ------------------------------------------------ ground-truth helpers
    def gt_sdf(self, pts: np.ndarray) -> np.ndarray:
        return np.asarray(self.sdf(jnp.asarray(pts, dtype=jnp.float32)))

    def gt_occupancy_volume(self, voxel_size: float) -> np.ndarray:
        from naruto_tpu.geometry.voxel import world_grid
        grid = world_grid(self.bound, voxel_size)
        sh = grid.shape[:3]
        return np.asarray(
            self.sdf(jnp.asarray(grid.reshape(-1, 3)))).reshape(sh)
