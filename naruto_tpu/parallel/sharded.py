"""Sharded compute paths: data-parallel mapping step and volume queries.

Strategy (SURVEY.md §2.7/§5.7): shard the ray axis and the voxel axis across
devices with `jax.sharding` annotations under one jit; the field params stay
replicated, and XLA inserts the all-reduce (psum) for the gradient
of the mean losses automatically. No hand-written collectives needed at this
model scale — the sharding annotations ARE the parallelism.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from naruto_tpu.mapping.field import FieldSpec, query_sdf
from naruto_tpu.mapping.losses import LossWeights, total_loss
from naruto_tpu.mapping.render import RenderConfig, render_rays


def sharded_grad_step(mesh: Mesh, spec: FieldSpec, rc: RenderConfig,
                      lw: LossWeights):
    """Build a jitted data-parallel (loss, grads) fn over the given mesh.

    Rays are sharded along 'data'; params replicated; returned grads are
    fully replicated (XLA all-reduces them).
    """
    data = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())

    def loss_fn(params, rays_o, rays_d, target_rgb, target_d, ray_mask, key):
        rend = render_rays(params, spec, rc, key, rays_o, rays_d, target_d)
        loss, aux = total_loss(params, spec, rend, target_rgb, target_d,
                               ray_mask, key, lw, with_smooth=False)
        return loss, aux

    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)

    return jax.jit(
        grad_fn,
        in_shardings=(repl, data, data, data, data, data, repl),
        out_shardings=((repl, repl), repl),
    )


def sharded_volume_query(mesh: Mesh, spec: FieldSpec):
    """Dense SDF+uncertainty query with the flattened voxel axis sharded
    across devices (ref behavior: coslam_utils.get_map_volumes)."""
    data = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())

    def q(params, x01):
        sdf, uncert = query_sdf(params, x01, spec, with_uncert=True)
        uncert_map = jax.nn.softplus(uncert) + 0.01
        uncert_map = jnp.where((sdf >= 0.0) & (sdf < 0.5), uncert_map, 0.0)
        return sdf, uncert_map

    return jax.jit(q, in_shardings=(repl, data),
                   out_shardings=(data, data))
