"""Keyframe ray database — fixed-capacity device-resident buffer.

The reference preallocates a [num_kf, rays_per_kf, 7] tensor and fills one
slot per keyframe (upstream KeyFrameDatabase + keyframe.py:38-60): each
stored ray is [direction(3), rgb(3), depth(1)], sampled from the frame with
depth filtering (0 < d <= depth_trunc) and duplicated to fill the quota when
too few pixels are valid. Global sampling draws uniformly over all stored
keyframe rays and returns (rays, kf_ids).

Redesign: everything static-shape on device, and the ray store is kept
FLAT [num_kf * rays_per_kf, 7] — the profiler showed that reshaping a
multi-hundred-MB [kf, rays, 7] buffer to sample from it materialized a copy
every BA iteration.
  * add: one random selection via random scores — each pixel gets
    u ~ U[0,1) plus a +2 penalty if depth-invalid; the rays_per_kf smallest
    scores are the chosen pixels (random valid pixels first; valid picks are
    recycled if the frame has fewer valid pixels than the quota, mirroring
    the reference's duplication rule).
  * sample: uniform integers in [0, kf_count * rays_per_kf) with a traced
    upper bound, so no recompilation as keyframes accrue.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class KeyframeDB(NamedTuple):
    rays: jnp.ndarray       # [num_kf * rays_per_kf, 7] flat ray store
    frame_ids: jnp.ndarray  # [num_kf] int32, -1 for empty slots
    count: jnp.ndarray      # [] int32 — number of filled slots


def rays_per_slot(db: KeyframeDB) -> int:
    return db.rays.shape[0] // db.frame_ids.shape[0]


def init_keyframe_db(num_kf: int, rays_per_kf: int) -> KeyframeDB:
    return KeyframeDB(
        rays=jnp.zeros((num_kf * rays_per_kf, 7), dtype=jnp.float32),
        frame_ids=jnp.full((num_kf,), -1, dtype=jnp.int32),
        count=jnp.zeros((), dtype=jnp.int32),
    )


def add_keyframe(db: KeyframeDB, frame_rays: jnp.ndarray, frame_id,
                 key, depth_trunc: float = 100.0,
                 filter_depth: bool = True) -> KeyframeDB:
    """frame_rays: [H*W, 7]. Fills slot db.count."""
    n_pix = frame_rays.shape[0]
    quota = rays_per_slot(db)
    depth = frame_rays[:, 6]
    if filter_depth:
        valid = (depth > 0.0) & (depth <= depth_trunc)
    else:
        valid = jnp.ones((n_pix,), dtype=bool)

    score = jax.random.uniform(key, (n_pix,)) + jnp.where(valid, 0.0, 2.0)
    _, idx = jax.lax.top_k(-score, quota)          # quota smallest scores
    n_valid = jnp.sum(valid.astype(jnp.int32))
    # recycle valid picks if the frame has fewer valid pixels than the quota
    pos = jnp.arange(quota, dtype=jnp.int32)
    safe_n = jnp.maximum(n_valid, 1)
    pos = jnp.where(pos < n_valid, pos, pos % safe_n)
    chosen = idx[pos]
    slot_rays = frame_rays[chosen]                 # [quota, 7]

    slot = db.count
    return KeyframeDB(
        rays=jax.lax.dynamic_update_slice(
            db.rays, slot_rays, (slot * quota, 0)),
        frame_ids=db.frame_ids.at[slot].set(
            jnp.asarray(frame_id, dtype=jnp.int32)),
        count=db.count + 1,
    )


def sample_global_rays(db: KeyframeDB, key,
                       n: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Uniform over all stored rays of filled slots.
    Returns (rays [n, 7], kf_slot_ids [n])."""
    quota = rays_per_slot(db)
    total = jnp.maximum(db.count * quota, 1)
    idx = jax.random.randint(key, (n,), 0, total)
    return db.rays[idx], (idx // quota).astype(jnp.int32)
