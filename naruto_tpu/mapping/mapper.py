"""The neural mapper: jitted scan-based bundle adjustment on the device.

Re-designs the reference CoSLAMNaruto (src/slam/coslam/coslam.py) as a
functional core: `MapperState` (field params, optimizer states, keyframe ray
buffer, pose table, cached uncertainty volume) is transformed by three jitted
programs —

  * first_frame_map : 200-iteration `lax.scan` of (sample pixels -> render ->
    loss -> Adam) on frame 0 (ref: first_frame_mapping, coslam.py:176-226;
    uncertainty-grid gradients accumulate across all iterations and are
    applied once at the end — the reference zero_grads before the loop and
    steps the lr=1 Adam after it).
  * ba_step : `mapping.iters`-iteration scan of global bundle adjustment
    (ref: global_BA, coslam.py:246-407): sample rays from the keyframe DB +
    depth-filtered current frame, optional uncertainty-guided active
    resampling (ref: active_ray_sampler.py), render, weighted losses, Adam on
    {hash table (eps 1e-15), decoders (wd 1e-6)} every iteration and on the
    uncertainty grid every `uncert_accum_iters` iterations with accumulated
    gradients (ref: coslam.py:397-399,409-419,240-243).
  * map_volumes : dense SDF+uncertainty query of the whole AABB at the
    planner voxel size (ref: coslam_utils.get_map_volumes:59-97), with
    uncertainty zeroed off-surface (keep 0 <= sdf < 0.5).

Static-shape strategy (the reference's ray counts are dynamic): the current-
frame ray block is padded to a small set of power-of-two "buckets"; a mask
carries the true count into mask-aware losses, and the host picks the
compiled bucket from the keyframe count. Steady-state waste is <2%.

Active-ray parity note: the reference selects the K *lowest*-uncertainty
candidates (np.argpartition(...)[:K], active_ray_sampler.py:127) although its
docstring says highest — `active_select_highest` reproduces the observed
behavior by default and can flip it. The volume lookup uses 1/voxel_size
scaling (the reference hardcodes x10 == 1/0.1).
"""
from __future__ import annotations

import functools
import os
from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from naruto_tpu.config.schema import MainConfig
from naruto_tpu.geometry.rays import get_camera_rays
from naruto_tpu.geometry.voxel import volume_shape, world_grid
from naruto_tpu.mapping.field import FieldSpec, init_field_params, query_sdf
from naruto_tpu.mapping.keyframes import (
    KeyframeDB, add_keyframe, init_keyframe_db, sample_global_rays,
)
from naruto_tpu.mapping.losses import LossWeights, total_loss
from naruto_tpu.mapping.render import RenderConfig, render_rays
from naruto_tpu.utils.printer import InfoPrinter

# padded current-ray block sizes; few buckets = few compiled BA variants
# (each one a full compile), small steady-state waste
CUR_BUCKETS = (512, 2048, 8192)


class LazyVolumes:
    """List-like [uncert_vol, sdf_vol] view that materializes numpy on
    first read.

    The mapping step dispatches BA + the dense volume query
    asynchronously and hands the planner this view instead of blocking
    on a device->host pull: planner states that never read the volumes
    this step (the rotating/rotation-planning majority) never block the
    host, and the BA device work overlaps the next simulator renders.
    Values are identical to an eager pull — the dispatched query
    captured this step's params (jax arrays are immutable), so
    SURVEY §5.2's plan-consumes-this-step's-volumes dataflow holds
    bit-for-bit. The wait, when a consumer DOES read, is timed as
    [Mapper] volumes_wait."""

    def __init__(self, u_dev, s_dev, timer=None):
        self._dev = (u_dev, s_dev)
        self._np = None
        self._timer = timer

    def ready(self) -> "LazyVolumes":
        """Block until the DEVICE values exist (no host transfer) —
        bounds the in-flight dispatch queue to one mapping step."""
        if self._np is None:
            jax.block_until_ready(self._dev)
        return self

    def _materialize(self):
        if self._np is None:
            if self._timer is not None:
                with self._timer.time("volumes_wait", "Mapper"):
                    self._np = [np.asarray(a) for a in self._dev]
            else:
                self._np = [np.asarray(a) for a in self._dev]
        return self._np

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())

    def __len__(self):
        return 2

class MapperState(NamedTuple):
    params: Dict
    map_opt_state: Dict      # {'embed': EmbedAdamState, 'decoder': optax}
    uncert_opt_state: optax.OptState
    uncert_accum: jnp.ndarray
    kf: KeyframeDB
    poses: jnp.ndarray          # [num_frames + 1, 4, 4] RDF c2w
    uncert_vol: jnp.ndarray     # cached [X, Y, Z] for active-ray sampling


DECODER_KEYS = ("sdf_mlp", "color_mlp")

EMBED_B1, EMBED_B2, EMBED_EPS = 0.9, 0.99, 1e-15


class EmbedAdamState(NamedTuple):
    """Adam state for the hash-table ("embeddings") parameter group —
    hand-rolled as one fusable elementwise expression instead of optax's
    multi-sweep chain; XLA fuses the whole update into one pass over
    device memory by itself. Math matches Adam(lr_embed, betas=(0.9, 0.99), eps=1e-15) — ref
    create_optimizer, coslam.py:413-417."""
    count: jnp.ndarray
    mu: Dict
    nu: Dict


def _make_decoder_optimizer(cfg: MainConfig):
    """Decoder group — ref create_optimizer (coslam.py:409-412):
    Adam(lr_decoder, wd=1e-6), betas (0.9, 0.99)."""
    return optax.chain(
        optax.add_decayed_weights(1e-6),
        optax.scale_by_adam(b1=0.9, b2=0.99, eps=1e-8),
        optax.scale(-cfg.mapper.lr_decoder),
    )


def _init_embed_state(table) -> EmbedAdamState:
    zeros = jax.tree_util.tree_map(jnp.zeros_like, table)
    return EmbedAdamState(
        count=jnp.zeros((), jnp.int32), mu=zeros,
        nu=jax.tree_util.tree_map(jnp.zeros_like, table))


def _embed_adam_update(table, grads, st: EmbedAdamState, lr: float):
    """One Adam step on the table pytree; XLA fuses it into one pass."""
    count = st.count + 1
    t = count.astype(jnp.float32)
    bc = jnp.stack([1.0 / (1.0 - EMBED_B1 ** t),
                    1.0 / (1.0 - EMBED_B2 ** t)]).reshape(2, 1)

    def leaf(p, m, v, g):
        m2 = EMBED_B1 * m + (1.0 - EMBED_B1) * g
        v2 = EMBED_B2 * v + (1.0 - EMBED_B2) * g * g
        upd = (m2 * bc[0, 0]) / (jnp.sqrt(v2 * bc[1, 0]) + EMBED_EPS)
        return p - lr * upd, m2, v2

    out = jax.tree_util.tree_map(leaf, table, st.mu, st.nu, grads)
    is_t = lambda x: isinstance(x, tuple)          # noqa: E731
    pick = lambda i: jax.tree_util.tree_map(       # noqa: E731
        lambda tup: tup[i], out, is_leaf=is_t)
    return pick(0), EmbedAdamState(count=count, mu=pick(1), nu=pick(2))


def _make_uncert_optimizer(cfg: MainConfig):
    """Adam lr=1 on the uncertainty grid — ref coslam.py:240-243."""
    return optax.chain(
        optax.scale_by_adam(b1=0.9, b2=0.99, eps=1e-8),
        optax.scale(-cfg.mapper.lr_uncert),
    )


def _transform_rays(rays: jnp.ndarray, poses: jnp.ndarray):
    """rays [N,7] cam-frame, poses [N,4,4] -> world (rays_o, rays_d, rgb, d)."""
    d_cam = rays[:, :3]
    rays_d = jnp.einsum("nij,nj->ni", poses[:, :3, :3], d_cam)
    rays_o = poses[:, :3, 3]
    return rays_o, rays_d, rays[:, 3:6], rays[:, 6:7]


class Mapper:
    """Host-facing mapper with the reference's online API
    (online_recon_step / save_ckpt / predict_sdf — coslam.py:537,494,519)."""

    def __init__(self, cfg: MainConfig, printer: Optional[InfoPrinter] = None,
                 timer=None):
        self.cfg = cfg
        self.printer = printer or InfoPrinter(quiet=True)
        # optional utils.timer.Timer: records a per-stage breakdown of the
        # online step (frame transfer / BA dispatch / volume pull / keyframe)
        # under the [Mapper] group of the run's timing report
        self.timer = timer
        m, t, c = cfg.mapper, cfg.training, cfg.cam

        self.spec = FieldSpec(
            bound=tuple(tuple(b) for b in m.bound),
            n_levels=cfg.grid.n_levels,
            n_features=cfg.grid.n_features_per_level,
            log2_hashmap_size=cfg.grid.hash_size,
            base_resolution=cfg.grid.base_resolution,
            table_dtype=cfg.grid.table_dtype,
            table_layout=cfg.grid.layout,
            sort_carry=cfg.grid.sort_carry,
            voxel_sdf=cfg.grid.voxel_sdf,
            pos_n_bins=cfg.grid.pos_n_bins,
            geo_feat_dim=cfg.decoder.geo_feat_dim,
            hidden_dim=cfg.decoder.hidden_dim,
            num_layers=cfg.decoder.num_layers,
            hidden_dim_color=cfg.decoder.hidden_dim_color,
            num_layers_color=cfg.decoder.num_layers_color,
            uncert_grid=cfg.decoder.uncert_grid,
            pred_uncert=cfg.decoder.pred_uncert,
            uncert_voxel_size=m.voxel_size,
            diff_positions=m.tracking_enable,
        )
        self.rc = RenderConfig(
            near=c.near, far=c.far, n_range_d=t.n_range_d, range_d=t.range_d,
            n_samples_d=t.n_samples_d, n_importance=t.n_importance,
            perturb=t.perturb, trunc=t.trunc, sc_factor=t.sc_factor)
        self.lw = LossWeights(
            rgb=t.rgb_weight, depth=t.depth_weight, sdf=t.sdf_weight,
            fs=t.fs_weight, uncert=t.uncert_weight, smooth=t.smooth_weight,
            rgb_missing=t.rgb_missing, trunc=t.trunc, sc_factor=t.sc_factor,
            depth_trunc=c.depth_trunc, smooth_pts=t.smooth_pts,
            smooth_vox=t.smooth_vox, smooth_margin=t.smooth_margin,
            smooth_sample=t.smooth_sample)

        self.H, self.W = c.H // c.downsample, c.W // c.downsample
        self.fx, self.fy = c.fx // c.downsample, c.fy // c.downsample
        self.cx, self.cy = c.cx // c.downsample, c.cy // c.downsample
        self.rays_d_cam = jnp.asarray(
            get_camera_rays(self.H, self.W, self.fx, self.fy, self.cx,
                            self.cy).reshape(-1, 3))

        # buffer capacities round up to coarse quanta so different run
        # lengths share compiled graphs (shapes enter every jitted program)
        num_frames = -(-cfg.general.num_iter // 1000) * 1000
        self.num_kf = -(-(num_frames // m.keyframe_every + 1) // 256) * 256
        self.rays_per_kf = max(int(self.H * self.W * m.n_pixels), 1)

        self.vol_shape = volume_shape(m.bound_np, m.voxel_size)
        grid = world_grid(m.bound_np, m.voxel_size).reshape(-1, 3)
        self.grid01 = jnp.asarray(
            (grid - m.bound_np[:, 0])
            / (m.bound_np[:, 1] - m.bound_np[:, 0]))

        self.decoder_tx = _make_decoder_optimizer(cfg)
        self.uncert_tx = _make_uncert_optimizer(cfg)
        self.track_enabled = m.tracking_enable
        # pose optimizer (axis-angle lr_rot / translation lr_trans) — ref
        # get_pose_param_optim; only used when tracking is enabled
        self.pose_tx = optax.multi_transform(
            {"rot": optax.adam(m.lr_rot, b1=0.9, b2=0.99),
             "trans": optax.adam(m.lr_trans, b1=0.9, b2=0.99)},
            {"rot": "rot", "trans": "trans", "rot_c": "rot",
             "trans_c": "trans"})

        # single jitted init: building the state eagerly dispatches ~40
        # tiny ops (RNG splits, per-group uniforms, zeros_like trees); one
        # compiled program replaces them all (threefry is bit-exact under
        # jit, so seeded tables are unchanged).
        def _init_state(seed):
            key = jax.random.PRNGKey(seed)
            key, k_init = jax.random.split(key)
            params = init_field_params(k_init, self.spec)
            return key, MapperState(
                params=params,
                map_opt_state={
                    "embed": _init_embed_state(params["table"]),
                    "decoder": self.decoder_tx.init(
                        {k: params[k] for k in DECODER_KEYS}),
                },
                uncert_opt_state=self.uncert_tx.init(
                    params.get("uncert_grid", jnp.zeros(()))),
                uncert_accum=jnp.zeros_like(
                    params.get("uncert_grid", jnp.zeros(()))),
                kf=init_keyframe_db(self.num_kf, self.rays_per_kf),
                poses=jnp.tile(jnp.eye(4, dtype=jnp.float32),
                               (num_frames + 1, 1, 1)),
                uncert_vol=jnp.zeros(self.vol_shape, dtype=jnp.float32),
            )

        self._key, self.state = jax.jit(_init_state)(cfg.general.seed)
        self.step = 0
        # host mirror of state.kf.count (adds are host-scheduled, so the
        # mirror is exact); bucket selection reads this instead of pulling
        # the device scalar every mapping step
        self._kf_count = 0
        self._pending_vols: Optional[LazyVolumes] = None
        self.result_dir: Optional[str] = None

        # data-parallel BA: rays sharded over the 'data' mesh axis (the
        # PRODUCTION _ba_impl runs sharded, not a simplified step). Pose optimization keeps the single-device path (tracking is
        # disabled in every shipped config).
        self._ba_mesh = None
        self._ba_ndev = 1
        if cfg.parallel.shard_rays and len(jax.devices()) > 1 \
                and not self.track_enabled:
            from naruto_tpu.parallel import make_mesh
            self._ba_mesh = make_mesh()
            self._ba_ndev = len(self._ba_mesh.devices.flat)

        self._ba_jits: Dict[int, callable] = {}
        self._ff_jit = jax.jit(self._first_frame_impl, donate_argnums=(0,))
        self._track_jit = jax.jit(self._tracking_impl)

        # optional multi-device dense-volume query (rays/voxels sharded on a
        # 'data' mesh axis — SURVEY.md §5.7); volumes pad to the device count
        self._sharded_vol = None
        if cfg.parallel.shard_volumes and len(jax.devices()) > 1:
            from naruto_tpu.parallel import (
                data_sharding, make_mesh, replicated, sharded_volume_query,
            )
            mesh = make_mesh()
            self._vol_mesh = mesh
            self._vol_data = data_sharding(mesh)
            self._vol_repl = replicated(mesh)
            self._sharded_vol = sharded_volume_query(mesh, self.spec)
            n = self.grid01.shape[0]
            pad = (-n) % len(mesh.devices.flat)
            self._grid01_padded = jnp.concatenate(
                [self.grid01, jnp.zeros((pad, 3))]) if pad else self.grid01
        self._vol_jit = jax.jit(self._volumes_impl)
        self._sdf_query_jit = jax.jit(
            lambda params, x01: query_sdf(params, x01, self.spec,
                                          with_uncert=True))
        # mesh-extraction vertex colors in ONE compiled program (metric
        # verts in, clipped sigmoid RGB out) instead of an eager
        # field_query that dispatches every primitive separately
        from naruto_tpu.mapping.field import field_query, normalize_world

        self._color_query_jit = jax.jit(
            lambda params, verts: jnp.clip(jax.nn.sigmoid(field_query(
                params, normalize_world(verts, self.spec),
                self.spec)[:, :3]), 0, 1))

    # ------------------------------------------------------------------ rng
    def _next_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    def update_step(self, step: int) -> None:
        self.step = step

    # ------------------------------------------------------- frame handling
    def frame_to_rays(self, color, depth) -> jnp.ndarray:
        """[H,W,3] color in [0,1] (or uint8 in [0,255]), [H,W] depth ->
        [H*W, 7] ray storage.

        Host-resident float color is quantized to uint8 for the
        host->device hop (2.4 MB vs 9.8 MB at 680x1200) and dequantized on
        device. Lossless vs the reference pipeline: its datasets load
        uint8 images to begin with (datasets/dataset.py cv2.imread / 255).
        Device-resident color (the analytic sim renders straight into
        device memory) is passed through untouched — quantizing it would
        force a device->host pull."""
        if isinstance(color, np.ndarray) and color.dtype != np.uint8:
            color = (np.clip(color, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        color = jnp.asarray(color)
        if color.dtype == jnp.uint8:
            color = color.reshape(-1, 3).astype(jnp.float32) * (1.0 / 255.0)
        else:
            color = color.astype(jnp.float32).reshape(-1, 3)
        depth = jnp.asarray(depth, dtype=jnp.float32).reshape(-1, 1)
        return jnp.concatenate([self.rays_d_cam, color, depth], axis=-1)

    # ------------------------------------------------------- loss + update
    def _loss_fn(self, params, key, rays_o, rays_d, target_rgb, target_d,
                 ray_mask, with_smooth, z_noise=None, axis=None,
                 smooth_scale=1.0):
        k_render, k_smooth = jax.random.split(key)
        lw = (self.lw._replace(smooth=self.lw.smooth * smooth_scale)
              if smooth_scale != 1.0 else self.lw)
        extra = None
        if with_smooth and lw.smooth > 0:
            from naruto_tpu.mapping.losses import smoothness_points
            extra, _ = smoothness_points(self.spec, k_smooth, lw)
        rend = render_rays(params, self.spec, self.rc, k_render,
                           rays_o, rays_d, target_d, extra_pts01=extra,
                           z_noise=z_noise)
        loss, aux = total_loss(params, self.spec, rend, target_rgb, target_d,
                               ray_mask, k_smooth, lw,
                               with_smooth=with_smooth, axis=axis)
        return loss, aux

    def _grad_fn(self, params, key, rays_o, rays_d, target_rgb, target_d,
                 ray_mask, with_smooth, smooth_scale=1.0):
        """Field-parameter gradients for one BA iteration; data-parallel
        over the 'data' mesh axis when cfg.parallel.shard_rays (SURVEY.md
        §2.7 DP row): rays sharded, params replicated, grads all-reduced
        across the devices.

        Gradient recipe (exact vs single-device, verified by
        tests/test_parallel.py): inside shard_map the loss uses psum'd
        global sums/denominators (losses.py axis=...) so every device holds
        the GLOBAL loss; params are cast to 'varying' and the loss divided
        by axis_size — the varying-cast's transpose then performs exactly
        ONE cross-device sum per parameter, uniformly for custom-VJP
        (hash table) and builtin (MLP/uncert-grid) gradient paths, and the
        replicated smoothness rider contributes exactly once. The z
        perturbation is drawn on the unsharded batch so sharded and
        single-device runs see identical randomness."""
        if self._ba_mesh is None or rays_o.shape[0] % self._ba_ndev != 0:
            (_, _), grads = jax.value_and_grad(
                self._loss_fn, has_aux=True)(
                    params, key, rays_o, rays_d, target_rgb, target_d,
                    ray_mask, with_smooth, smooth_scale=smooth_scale)
            return grads

        from jax.sharding import PartitionSpec as P

        n = rays_o.shape[0]
        k_render, _ = jax.random.split(key)
        z_noise = jax.random.uniform(k_render, (n, self.rc.n_samples))

        def _to_varying(x):
            return jax.lax.pcast(x, "data", to="varying")

        def shard_grads(params, key, rays_o, rays_d, t_rgb, t_d, mask,
                        z_noise):
            def lf(p):
                p = jax.tree_util.tree_map(_to_varying, p)
                loss, aux = self._loss_fn(
                    p, key, rays_o, rays_d, t_rgb, t_d, mask,
                    with_smooth, z_noise, "data", smooth_scale)
                return loss / jax.lax.axis_size("data"), aux
            (_, _), g = jax.value_and_grad(lf, has_aux=True)(params)
            return g

        d = P("data")
        return jax.shard_map(
            shard_grads, mesh=self._ba_mesh,
            in_specs=(P(), P(), d, d, d, d, d, d),
            out_specs=P(),
        )(params, key, rays_o, rays_d, target_rgb, target_d, ray_mask,
          z_noise)

    def _apply_map_update(self, state: MapperState, grads):
        params = dict(state.params)
        opt = dict(state.map_opt_state)
        dec_p = {k: params[k] for k in DECODER_KEYS}
        updates, opt["decoder"] = self.decoder_tx.update(
            {k: grads[k] for k in DECODER_KEYS}, opt["decoder"], dec_p)
        params.update(optax.apply_updates(dec_p, updates))
        params["table"], opt["embed"] = _embed_adam_update(
            params["table"], grads["table"], opt["embed"],
            self.cfg.mapper.lr_embed)
        return state._replace(params=params, map_opt_state=opt)

    def _apply_uncert_update(self, state: MapperState):
        if not self.spec.uncert_grid:
            return state
        updates, new_opt = self.uncert_tx.update(
            state.uncert_accum, state.uncert_opt_state,
            state.params["uncert_grid"])
        params = dict(state.params)
        params["uncert_grid"] = optax.apply_updates(
            params["uncert_grid"], updates)
        return state._replace(
            params=params, uncert_opt_state=new_opt,
            uncert_accum=jnp.zeros_like(state.uncert_accum))

    def _cond_uncert_update(self, do, state: MapperState) -> MapperState:
        """Conditionally apply the accumulated uncertainty-grid Adam step.
        The cond carries ONLY the small uncertainty triple — routing the
        whole MapperState (incl. the multi-hundred-MB keyframe buffer)
        through lax.cond can materialize per-iteration copies."""
        if not self.spec.uncert_grid:
            return state

        def apply_fn(args):
            grid, opt, accum = args
            updates, new_opt = self.uncert_tx.update(accum, opt, grid)
            return (optax.apply_updates(grid, updates), new_opt,
                    jnp.zeros_like(accum))

        grid, opt, accum = jax.lax.cond(
            do, apply_fn, lambda a: a,
            (state.params["uncert_grid"], state.uncert_opt_state,
             state.uncert_accum))
        params = dict(state.params)
        params["uncert_grid"] = grid
        return state._replace(params=params, uncert_opt_state=opt,
                              uncert_accum=accum)

    def _accum_uncert(self, state: MapperState, grads):
        if not self.spec.uncert_grid:
            return state
        return state._replace(
            uncert_accum=state.uncert_accum + grads["uncert_grid"])

    # -------------------------------------------------- first-frame mapping
    def _first_frame_impl(self, state: MapperState, frame_rays, c2w,
                          key) -> MapperState:
        n_sample = self.cfg.mapper.sample
        state = state._replace(poses=state.poses.at[0].set(c2w))

        # as in _ba_impl: only the mutable state slices ride the scan
        # carry; the keyframe buffer / poses / uncert volume are invariant
        def body(light, k):
            st = state._replace(
                params=light[0], map_opt_state=light[1],
                uncert_opt_state=light[2], uncert_accum=light[3])
            k1, k2, k3 = jax.random.split(k, 3)
            idx = jax.random.randint(k1, (n_sample,), 0, self.H * self.W)
            rays = frame_rays[idx]
            pose = jnp.broadcast_to(c2w, (n_sample, 4, 4))
            rays_o, rays_d, rgb, d = _transform_rays(rays, pose)
            mask = jnp.ones((n_sample,), dtype=jnp.float32)
            grads = self._grad_fn(st.params, k2, rays_o, rays_d, rgb, d,
                                  mask, False)
            st = self._apply_map_update(st, grads)
            st = self._accum_uncert(st, grads)
            return (st.params, st.map_opt_state, st.uncert_opt_state,
                    st.uncert_accum), None

        keys = jax.random.split(key, self.cfg.mapper.first_iters)
        light, _ = jax.lax.scan(
            body,
            (state.params, state.map_opt_state, state.uncert_opt_state,
             state.uncert_accum),
            keys)
        state = state._replace(
            params=light[0], map_opt_state=light[1],
            uncert_opt_state=light[2], uncert_accum=light[3])
        state = self._apply_uncert_update(state)
        return state

    # ------------------------------------------------------------ global BA
    def _ba_impl(self, cur_cap: int, state: MapperState, frame_rays,
                 c2w, frame_id, key) -> MapperState:
        """One global-BA mapping step (ref global_BA, coslam.py:246-407).

        With tracking enabled, keyframe poses (except the first) and the
        current pose (optim_cur) are optimized as axis-angle+translation
        variables with their own Adam, stepped every pose_accum_step
        iterations on accumulated gradients — matching the reference's
        pose_optimizer cadence. With tracking disabled (every shipped
        config), poses are fixed planner/GT inputs.
        """
        m = self.cfg.mapper
        active = m.active_ray
        n_os = m.sample * (m.act_ray_oversample_mul if active else 1)
        base = m.sample
        k_sel = m.act_ray_num_uncert_sample
        min_cur = m.min_pixels_cur * (m.act_ray_oversample_mul if active else 1)
        kf_every = m.keyframe_every
        opt_poses = self.track_enabled

        state = state._replace(poses=state.poses.at[frame_id].set(c2w))

        # valid current pixels, ordered valid-first (static shape)
        depth = frame_rays[:, 6]
        valid = (depth > 0.0) & (depth <= self.lw.depth_trunc)
        n_valid = jnp.maximum(jnp.sum(valid.astype(jnp.int32)), 1)
        valid_order = jnp.argsort(jnp.logical_not(valid), stable=True)

        num_cur = jnp.clip(
            jnp.maximum(n_os // jnp.maximum(state.kf.count, 1), min_cur),
            0, cur_cap)
        num_cur = jnp.minimum(num_cur, n_valid)

        bound = jnp.asarray(self.spec.bound_np)
        inv_vox = 1.0 / m.voxel_size
        vol_max = jnp.asarray(
            [s - 1 for s in self.vol_shape], dtype=jnp.int32)

        if opt_poses:
            from naruto_tpu.mapping.pose_opt import (
                matrix_from_tensor, pose_to_tensor,
            )
            kf_poses0 = state.poses[
                jnp.arange(self.num_kf, dtype=jnp.int32) * kf_every]
            rot0, trans0 = pose_to_tensor(kf_poses0)       # [num_kf, 3] x2
            rot_c0, trans_c0 = pose_to_tensor(c2w)
            pose_vars0 = {"rot": rot0, "trans": trans0,
                          "rot_c": rot_c0, "trans_c": trans_c0}
            pose_opt0 = self.pose_tx.init(pose_vars0)
            pose_accum0 = jax.tree_util.tree_map(jnp.zeros_like, pose_vars0)
            # slot 0 stays fixed; slots >= count are empty
            slot_mask = jnp.logical_and(
                jnp.arange(self.num_kf) > 0,
                jnp.arange(self.num_kf) < state.kf.count
            ).astype(jnp.float32)[:, None]

            def kf_pose_matrices(pv):
                mats = matrix_from_tensor(pv["rot"], pv["trans"])
                fixed = state.poses[
                    jnp.arange(self.num_kf, dtype=jnp.int32) * kf_every]
                return jnp.where((slot_mask > 0)[..., None], mats, fixed)

            def cur_pose_matrix(pv):
                if m.optim_cur:
                    return matrix_from_tensor(pv["rot_c"][None],
                                              pv["trans_c"][None])[0]
                return c2w
        else:
            pose_vars0 = pose_opt0 = pose_accum0 = None

        keep_cap = cur_cap // 4
        cand_cap = cur_cap - keep_cap
        num_keep = num_cur // 4
        num_cand = num_cur - num_keep

        smooth_every = max(int(self.cfg.training.smooth_every), 1)

        def body(st, pv, k, it):
            ks = jax.random.split(k, 3)
            g_rays, g_slots = sample_global_rays(st.kf, ks[0], n_os)
            j = jax.random.randint(ks[1], (cur_cap,), 0, n_valid)
            c_rays = frame_rays[valid_order[j]]
            c_mask = (jnp.arange(cur_cap) < num_cur).astype(jnp.float32)

            def assemble(pv):
                if opt_poses:
                    g_poses = kf_pose_matrices(pv)[g_slots]
                    cur_mat = cur_pose_matrix(pv)
                else:
                    g_poses = st.poses[g_slots * kf_every]
                    cur_mat = c2w
                g = _transform_rays(g_rays, g_poses)
                c_pose = jnp.broadcast_to(cur_mat, (cur_cap, 4, 4))
                c = _transform_rays(c_rays, c_pose)
                return g, c

            # active-ray selection indices: computed on stop-grad rays
            # (selection is discrete; gradients flow through the selected
            #  rays' re-assembly below)
            if active:
                (g_o, g_d, _, g_depth), (c_o, c_d, _, c_depth) = \
                    jax.lax.stop_gradient(assemble(pv))
                cand_o = jnp.concatenate([g_o[base:], c_o[:cand_cap]])
                cand_d = jnp.concatenate([g_d[base:], c_d[:cand_cap]])
                cand_dep = jnp.concatenate(
                    [g_depth[base:], c_depth[:cand_cap]])
                cand_valid = jnp.concatenate([
                    jnp.ones((n_os - base,), dtype=bool),
                    jnp.arange(cand_cap) < num_cand])
                pts = cand_o + cand_d * cand_dep
                vi = jnp.clip(
                    jnp.round((pts - bound[:, 0]) * inv_vox).astype(jnp.int32),
                    0, vol_max)
                u = st.uncert_vol[vi[:, 0], vi[:, 1], vi[:, 2]]
                score = -u if m.active_select_highest else u
                score = jnp.where(cand_valid, score, jnp.inf)
                if m.approx_topk:
                    # approximate top-k (recall ~0.95): the selection is
                    # a sampling heuristic to begin with (lowest-
                    # uncertainty K of a random 4x oversample), so a
                    # near-miss set is statistically equivalent. Opt-in;
                    # not measured on the GPU.
                    _, sel = jax.lax.approx_max_k(-score, k_sel)
                elif os.environ.get("NARUTO_TOPK_VIA_SORT"):
                    # A/B knob: same selected SET via one full argsort of
                    # the ~8.7k scores instead of lax.top_k's
                    # iterative-partial lowering (roadmap glue item:
                    # "active-ray top-k + KF sampling ~1.5 ms").
                    sel = jnp.argsort(score)[:k_sel]
                else:
                    _, sel = jax.lax.top_k(-score, k_sel)
            else:
                sel = None

            def build_batch(pv):
                (g_o, g_d, g_rgb, g_depth), (c_o, c_d, c_rgb, c_depth) = \
                    assemble(pv)
                if active:
                    cat = lambda ga, ca: jnp.concatenate(
                        [jnp.concatenate([ga[base:], ca[:cand_cap]])[sel],
                         ga[:base - k_sel], ca[cand_cap:]])
                    rays_o = cat(g_o, c_o)
                    rays_d = cat(g_d, c_d)
                    t_rgb = cat(g_rgb, c_rgb)
                    t_d = cat(g_depth, c_depth)
                    mask = jnp.concatenate([
                        jnp.ones((base,), dtype=jnp.float32),
                        (jnp.arange(keep_cap) < num_keep)
                        .astype(jnp.float32)])
                else:
                    rays_o = jnp.concatenate([g_o, c_o])
                    rays_d = jnp.concatenate([g_d, c_d])
                    t_rgb = jnp.concatenate([g_rgb, c_rgb])
                    t_d = jnp.concatenate([g_depth, c_depth])
                    mask = jnp.concatenate(
                        [jnp.ones((n_os,), dtype=jnp.float32), c_mask])
                return rays_o, rays_d, t_rgb, t_d, mask

            if opt_poses:
                def loss_both(params, pv):
                    rays_o, rays_d, t_rgb, t_d, mask = build_batch(pv)
                    return self._loss_fn(params, ks[2], rays_o, rays_d,
                                         t_rgb, t_d, mask, True)
                (_, _), (grads, pose_grads) = jax.value_and_grad(
                    loss_both, argnums=(0, 1), has_aux=True)(st.params, pv)
                pose_grads["rot"] = pose_grads["rot"] * slot_mask
                pose_grads["trans"] = pose_grads["trans"] * slot_mask
            else:
                rays_o, rays_d, t_rgb, t_d, mask = build_batch(pv)
                if smooth_every == 1:
                    grads = self._grad_fn(st.params, ks[2], rays_o, rays_d,
                                          t_rgb, t_d, mask, True)
                else:
                    # smoothness cadence: pay the regularizer's field
                    # fwd+bwd rider (~30% of field points) only every
                    # k-th iteration. The scale is iters/ceil(iters/k) —
                    # the exact number of fired iterations per BA call —
                    # so the TOTAL smoothness weight per call matches the
                    # every-iteration baseline even when k does not divide
                    # iters (k alone over-weights by up to +20% then). The
                    # skipped branch compiles with the SMALLER static
                    # sort/render shapes (extra lattice points absent), so
                    # the device runs the cheap graph on skipped iterations.
                    n_fired = -(-m.iters // smooth_every)
                    ops = (st.params, ks[2], rays_o, rays_d, t_rgb, t_d,
                           mask)
                    grads = jax.lax.cond(
                        it % smooth_every == 0,
                        lambda a: self._grad_fn(
                            *a, True, m.iters / n_fired),
                        lambda a: self._grad_fn(*a, False),
                        ops)
                pose_grads = None

            st = self._apply_map_update(st, grads)
            st = self._accum_uncert(st, grads)
            return st, pose_grads

        # scan carry holds ONLY the mutable slices of MapperState — the
        # multi-hundred-MB keyframe buffer, pose table and uncertainty
        # volume are loop-invariant in BA and stay OUT of the carry
        # (closed over), so the loop body never routes them as loop
        # operands.
        def _pack_light(st):
            return (st.params, st.map_opt_state, st.uncert_opt_state,
                    st.uncert_accum)

        def _unpack_light(light):
            return state._replace(
                params=light[0], map_opt_state=light[1],
                uncert_opt_state=light[2], uncert_accum=light[3])

        def outer(carry, inputs):
            light, pv, p_opt, p_accum = carry
            it, k = inputs
            st, pose_grads = body(_unpack_light(light), pv, k, it)
            if self.spec.uncert_grid:
                st = self._cond_uncert_update(
                    (it + 1) % m.uncert_accum_iters == 0, st)
            if opt_poses:
                p_accum = jax.tree_util.tree_map(
                    lambda a, g: a + g, p_accum, pose_grads)

                def do_step(args):
                    pv, p_opt, p_accum = args
                    updates, p_opt = self.pose_tx.update(p_accum, p_opt, pv)
                    pv = optax.apply_updates(pv, updates)
                    p_accum = jax.tree_util.tree_map(jnp.zeros_like, p_accum)
                    return pv, p_opt, p_accum

                pv, p_opt, p_accum = jax.lax.cond(
                    (it + 1) % m.pose_accum_step == 0,
                    do_step, lambda a: a, (pv, p_opt, p_accum))
            return (_pack_light(st), pv, p_opt, p_accum), None

        iters = m.iters
        keys = jax.random.split(key, iters)
        if opt_poses:
            carry0 = (_pack_light(state), pose_vars0, pose_opt0,
                      pose_accum0)
        else:
            carry0 = (_pack_light(state), None, None, None)
        # NARUTO_SCAN_UNROLL=k replicates the loop body k times per XLA
        # while-iteration — an A/B knob for the "scan carry plumbing"
        # glue item (roadmap): unrolling amortizes the carry
        # routing/DUS per body at the cost of a k-times-larger graph
        # (and compile). Semantics identical for any k (body is indexed
        # by `it`, not by position in the unrolled group).
        (light, pv, _, _), _ = jax.lax.scan(
            outer, carry0, (jnp.arange(iters, dtype=jnp.int32), keys),
            unroll=int(os.environ.get("NARUTO_SCAN_UNROLL", "1")))
        state = _unpack_light(light)

        if opt_poses:
            # write optimized poses back (ref coslam.py:400-407)
            mats = kf_pose_matrices(pv)
            frame_ids = jnp.arange(self.num_kf, dtype=jnp.int32) * kf_every
            upd = jnp.where((slot_mask > 0)[..., None], mats,
                            state.poses[frame_ids])
            poses = state.poses.at[frame_ids].set(upd)
            if m.optim_cur:
                poses = poses.at[frame_id].set(cur_pose_matrix(pv))
            state = state._replace(poses=poses)
        return state

    # -------------------------------------------------------------- tracking
    def _tracking_impl(self, state: MapperState, frame_rays, init_c2w, key):
        """Camera tracking by pose-only optimization against the frozen
        field (ref tracking_render via upstream Co-SLAM; disabled in every
        shipped config). Returns the estimated c2w."""
        from naruto_tpu.mapping.pose_opt import (
            matrix_from_tensor, pose_to_tensor,
        )
        m = self.cfg.mapper
        n = m.track_sample
        iw, ih = m.track_ignore_edge_w, m.track_ignore_edge_h

        rot0, trans0 = pose_to_tensor(init_c2w)
        pv0 = {"rot_c": rot0, "trans_c": trans0}
        track_tx = optax.multi_transform(
            {"rot": optax.adam(m.lr_rot, b1=0.9, b2=0.99),
             "trans": optax.adam(m.lr_trans, b1=0.9, b2=0.99)},
            {"rot_c": "rot", "trans_c": "trans"})
        opt0 = track_tx.init(pv0)

        def body(carry, k):
            pv, opt, best_loss, best_pv = carry
            k1, k2, k3 = jax.random.split(k, 3)
            us = jax.random.randint(k1, (n,), iw, self.W - iw)
            vs = jax.random.randint(k3, (n,), ih, self.H - ih)
            rays = frame_rays[vs * self.W + us]

            def loss_fn(pv):
                c2w = matrix_from_tensor(pv["rot_c"][None],
                                         pv["trans_c"][None])[0]
                pose = jnp.broadcast_to(c2w, (n, 4, 4))
                rays_o, rays_d, rgb, d = _transform_rays(rays, pose)
                mask = jnp.ones((n,), dtype=jnp.float32)
                return self._loss_fn(state.params, k2, rays_o, rays_d, rgb,
                                     d, mask, False)

            (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(pv)
            better = loss < best_loss
            best_pv = jax.tree_util.tree_map(
                lambda b, c: jnp.where(better, c, b), best_pv, pv)
            best_loss = jnp.minimum(best_loss, loss)
            updates, opt = track_tx.update(g, opt, pv)
            pv = optax.apply_updates(pv, updates)
            return (pv, opt, best_loss, best_pv), None

        keys = jax.random.split(key, m.track_iter)
        (pv, _, best_loss, best_pv), _ = jax.lax.scan(
            body, (pv0, opt0, jnp.inf, pv0), keys)
        chosen = best_pv if m.track_best else pv
        return matrix_from_tensor(chosen["rot_c"][None],
                                  chosen["trans_c"][None])[0]

    def _get_ba_jit(self, cur_cap: int):
        if cur_cap not in self._ba_jits:
            self._ba_jits[cur_cap] = jax.jit(
                functools.partial(self._ba_impl, cur_cap),
                donate_argnums=(0,))
        return self._ba_jits[cur_cap]

    def _pick_bucket(self, kf_count: int) -> int:
        m = self.cfg.mapper
        active = m.active_ray
        n_os = m.sample * (m.act_ray_oversample_mul if active else 1)
        min_cur = m.min_pixels_cur * (m.act_ray_oversample_mul if active else 1)
        need = max(n_os // max(kf_count, 1), min_cur)
        for b in CUR_BUCKETS:
            if b >= need:
                return b
        return CUR_BUCKETS[-1]

    # --------------------------------------------------------- map volumes
    def _volumes_impl(self, params):
        sdf, uncert = query_sdf(params, self.grid01, self.spec,
                                with_uncert=True)
        uncert_map = jax.nn.softplus(uncert) + 0.01
        on_surface = (sdf >= 0.0) & (sdf < 0.5)
        uncert_map = jnp.where(on_surface, uncert_map, 0.0)
        return (uncert_map.reshape(self.vol_shape),
                sdf.reshape(self.vol_shape))

    def _volumes_device(self):
        """Dispatch the dense volume query; returns DEVICE arrays (async —
        nothing blocks here) and refreshes state.uncert_vol (device-side
        alias consumed by the active ray sampler)."""
        if self._sharded_vol is not None:
            n = self.grid01.shape[0]
            sdf, um = self._sharded_vol(
                jax.device_put(self.state.params, self._vol_repl),
                jax.device_put(self._grid01_padded, self._vol_data))
            u = jnp.asarray(um)[:n].reshape(self.vol_shape)
            s = jnp.asarray(sdf)[:n].reshape(self.vol_shape)
        else:
            u, s = self._vol_jit(self.state.params)
        self.state = self.state._replace(uncert_vol=jnp.asarray(u))
        return u, s

    def get_map_volumes(self) -> Tuple[np.ndarray, np.ndarray]:
        u, s = self._volumes_device()
        return np.asarray(u), np.asarray(s)

    def get_map_volumes_lazy(self) -> "LazyVolumes":
        u, s = self._volumes_device()
        return LazyVolumes(u, s, self.timer)

    # --------------------------------------------------------------- meshes
    def save_mesh(self, step: int, voxel_size: float = 0.05,
                  suffix: str = "") -> Optional[str]:
        """Periodic mesh snapshot (ref save_mesh, coslam.py:421-458);
        requires result_dir to be set."""
        if self.result_dir is None:
            return None
        import os
        from naruto_tpu.mesh.extract import save_mesh as _save

        path = os.path.join(self.result_dir, "mesh",
                            f"mesh_{step:04d}{suffix}.ply")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return _save(self, path, voxel_size=voxel_size, color_mode="color")

    def save_uncert_mesh(self, step: int, voxel_size: float = 0.05,
                         suffix: str = "") -> Optional[str]:
        """Uncertainty-colored mesh (ref save_uncert_mesh, coslam.py:460)."""
        if self.result_dir is None:
            return None
        import os
        from naruto_tpu.mesh.extract import save_mesh as _save

        path = os.path.join(self.result_dir, "uncert_mesh",
                            f"mesh_{step:04d}{suffix}.ply")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return _save(self, path, voxel_size=voxel_size, color_mode="uncert")

    # ------------------------------------------------------------ online API
    def _t(self, name: str):
        """Timer section under the [Mapper] group (no-op without a timer)."""
        if self.timer is None:
            import contextlib
            return contextlib.nullcontext()
        return self.timer.time(name, "Mapper")

    def needs_frame(self, i: int) -> bool:
        """True when step i consumes the RGB-D frame: first frame, tracking
        enabled, a mapping step, or a keyframe step. Frames where this is
        False are never read — the engine skips both the simulator render
        and the host->device transfer for them (4/5 of steps at
        map_every=keyframe_every=5)."""
        m = self.cfg.mapper
        return (i == 0 or self.track_enabled
                or i % m.map_every == 0 or i % m.keyframe_every == 0)

    def online_recon_step(self, i: int, color, depth, c2w):
        """One mapping step. Returns a list-like [uncert_vol, sdf_vol]
        (LazyVolumes — numpy on first read) on mapping steps, else None —
        same value contract as coslam.py:537-633.

        color/depth may be None when needs_frame(i) is False (the frame is
        not consumed on those steps)."""
        c2w = jnp.asarray(c2w, dtype=jnp.float32)
        m = self.cfg.mapper
        # lazy ray build: frames that neither map, track, nor enter the
        # keyframe DB never need the [H*W, 7] ray storage — skipping it
        # avoids a ~13 MB host->device frame transfer on 4/5 steps at
        # map_every=keyframe_every=5
        if self.needs_frame(i):
            # includes the host->device transfer of the RGB-D frame
            # (asynchronous where the backend overlaps it: then this
            # section times the enqueue)
            with self._t("frame_transfer"):
                frame_rays = self.frame_to_rays(color, depth)
        else:
            frame_rays = None
        vols = None

        # periodic mesh snapshot (ref coslam.py:571-574)
        if self.result_dir is not None and i % self.cfg.mesh.vis_freq == 0:
            with self._t("mesh_snapshot"):
                self.save_mesh(i, voxel_size=self.cfg.mesh.voxel_eval)

        if i == 0:
            self.printer("First frame mapping...", i, "Mapper")
            with self._t("first_frame"):
                self.state = self._ff_jit(self.state, frame_rays, c2w,
                                          self._next_key())
            self.state = self.state._replace(
                kf=add_keyframe(self.state.kf, frame_rays, 0,
                                self._next_key(),
                                depth_trunc=self.lw.depth_trunc,
                                filter_depth=m.filter_depth))
            self._kf_count += 1
            vols = self.get_map_volumes_lazy()
            self._pending_vols = vols
        else:
            if self.track_enabled:
                # constant-speed init, pose-only optimization (ref :597-602)
                from naruto_tpu.mapping.pose_opt import const_speed_init
                prev = self.state.poses[i - 1]
                prev2 = self.state.poses[max(i - 2, 0)]
                init = (const_speed_init(prev, prev2)
                        if (m.track_const_speed and i >= 2) else prev)
                c2w = self._track_jit(self.state, frame_rays, init,
                                      self._next_key())
            # with tracking disabled the pose is the planner/GT (ref :595)
            self.state = self.state._replace(
                poses=self.state.poses.at[i].set(c2w))
            if i % m.map_every == 0:
                # host mirror of kf.count: exact (adds are host-scheduled),
                # and avoids a blocking device pull mid-step
                bucket = self._pick_bucket(self._kf_count)
                self.printer(f"Global BA (bucket={bucket})", i, "Mapper")
                # async pipeline: "ba_dispatch" is enqueue time only; the
                # BA + volume-query device work overlaps the engine's
                # next sim/planner steps and is only waited on when the
                # planner reads the volumes ([Mapper] volumes_wait) —
                # "ba_drain" first bounds the in-flight queue to ONE
                # mapping step (device readiness of the previous query,
                # no host transfer), so un-consumed steps can't pile up
                # param versions on the device
                if self._pending_vols is not None:
                    with self._t("ba_drain"):
                        self._pending_vols.ready()
                with self._t("ba_dispatch"):
                    self.state = self._get_ba_jit(bucket)(
                        self.state, frame_rays, c2w, i, self._next_key())
                with self._t("volumes_dispatch"):
                    vols = self.get_map_volumes_lazy()
                self._pending_vols = vols
            if i % m.keyframe_every == 0:
                with self._t("keyframe_add"):
                    self.state = self.state._replace(
                        kf=add_keyframe(self.state.kf, frame_rays, i,
                                        self._next_key(),
                                        depth_trunc=self.lw.depth_trunc,
                                        filter_depth=m.filter_depth))
                self._kf_count += 1
        return vols

    # ----------------------------------------------------------- query API
    def predict_sdf(self, pts_world: np.ndarray,
                    chunk: int = 1 << 17) -> np.ndarray:
        """SDF at world points [N,3] (MAD eval contract, eval_mad.py:87-90)."""
        bound = self.spec.bound_np
        x01 = (np.asarray(pts_world, dtype=np.float32) - bound[:, 0]) \
            / (bound[:, 1] - bound[:, 0])
        outs = []
        for s in range(0, x01.shape[0], chunk):
            sdf, _ = self._sdf_query_jit(self.state.params,
                                         jnp.asarray(x01[s:s + chunk]))
            outs.append(np.asarray(sdf))
        return np.concatenate(outs) if outs else np.zeros((0,))

    # ----------------------------------------------------------- checkpoint
    def save_ckpt(self, path: str) -> None:
        """Poses + field params + optimizer-free state (ref save_ckpt
        coslam.py:494-517 stores {pose, pose_rel, model}). Format: versioned
        npz (utils/ckpt_io.py) — pickle-free; legacy pickle still loads."""
        from naruto_tpu.utils import ckpt_io

        ckpt_io.save_tree(
            path,
            {"params": self.state.params, "poses": self.state.poses},
            meta={"kind": "eval_ckpt", "step": int(self.step),
                  "grid_layout": getattr(self.cfg.grid, "layout", "?")})

    def _check_param_compat(self, loaded_params: Dict) -> None:
        """Fail fast with a config hint when a checkpoint was written under
        a different table layout/shape (e.g. grid.layout flipped between
        "cell" and "vertex" — the row width differs 8x; ADVICE r2)."""
        cur = self.state.params
        lk, ck = set(loaded_params), set(cur)
        mism = [f"param set differs: ckpt has {sorted(lk - ck)} extra, "
                f"missing {sorted(ck - lk)}"] if lk != ck else []
        tu = jax.tree_util
        for k in (lk & ck):
            ls = [np.shape(x) for x in tu.tree_leaves(loaded_params[k])]
            cs = [np.shape(x) for x in tu.tree_leaves(cur[k])]
            if ls != cs:
                mism.append(f"{k}: ckpt leaf shapes {ls} vs configured {cs}")
        if mism:
            raise ValueError(
                "checkpoint incompatible with the configured field "
                "(likely saved under a different grid.layout / grid size — "
                "set grid.layout / configs/parity.yaml to match the run "
                "that wrote it): " + "; ".join(mism))

    def load_ckpt(self, path: str) -> None:
        from naruto_tpu.utils import ckpt_io

        if ckpt_io.is_legacy_pickle(path):
            blob = ckpt_io.load_legacy_pickle(path)
            step = int(blob.get("step", 0))
            blob = {"params": blob["params"], "poses": blob["poses"]}
        else:
            template = {"params": self.state.params,
                        "poses": self.state.poses}
            blob, meta = ckpt_io.load_tree(path, template)
            step = int(meta.get("step", 0))
        self._check_param_compat(blob["params"])
        params = jax.tree_util.tree_map(jnp.asarray, blob["params"])
        poses = jnp.asarray(blob["poses"])
        self.state = self.state._replace(params=params, poses=poses)
        self.step = step

    # ---------------------------------------------------- full-state resume
    # The reference writes checkpoints only for evaluation (no mid-run
    # resume — SURVEY.md §5.4). Since all mapper state is one pytree,
    # true resume is cheap here and provided as an extension.
    def save_full_state(self, path: str, extra: Optional[Dict] = None
                        ) -> None:
        """Full pytree snapshot as versioned npz. `extra` is a small
        JSON-able dict stored in the header (e.g. the planner's goal-repeat
        penalty state — ADVICE r4: resuming a rescue-config run must not
        silently reset accrued penalties)."""
        from naruto_tpu.utils import ckpt_io

        meta = {"kind": "full_state", "step": int(self.step),
                "grid_layout": getattr(self.cfg.grid, "layout", "?"),
                # the BA sampling key lives OUTSIDE MapperState (it is
                # split on the host); persist it so a resumed run draws
                # the same ray batches the uninterrupted run would
                "rng_key": [int(v) for v in np.asarray(self._key)]}
        if extra:
            meta["extra"] = extra
        ckpt_io.save_tree(path, self.state._asdict(), meta=meta)

    def load_full_state(self, path: str) -> Dict:
        """Restore a full-state snapshot. Returns the header's `extra` dict
        (planner mitigation state etc.; empty for legacy/plain blobs)."""
        from naruto_tpu.utils import ckpt_io

        if ckpt_io.is_legacy_pickle(path):
            blob = ckpt_io.load_legacy_pickle(path)
            self._check_param_compat(blob["params"])
            # optimizer-state layout changes (e.g. the optax
            # multi_transform -> {embed: EmbedAdamState, decoder: optax}
            # split) would otherwise pass the param check and die with an
            # opaque indexing error deep inside the first jitted BA step
            tu = jax.tree_util
            ref_struct = tu.tree_structure(self.state.map_opt_state)
            got_struct = tu.tree_structure(blob.get("map_opt_state"))
            if got_struct != ref_struct:
                raise ValueError(
                    "checkpoint optimizer state layout differs from this "
                    f"build (ckpt {got_struct} vs configured {ref_struct}) "
                    "— the full-state blob was written by an older "
                    "version; re-run from scratch or load params only via "
                    "load_ckpt()")
            self.step = int(blob.pop("__step__", 0))
            extra: Dict = {}
        else:
            blob, meta = ckpt_io.load_tree(path, self.state._asdict())
            self._check_param_compat(blob["params"])
            self.step = int(meta.get("step", 0))
            extra = meta.get("extra", {})
            if meta.get("rng_key") is not None:
                self._key = jnp.asarray(meta["rng_key"], jnp.uint32)
        state = jax.tree_util.tree_map(jnp.asarray, blob)
        self.state = MapperState(**state)
        self._kf_count = int(self.state.kf.count)
        return extra
