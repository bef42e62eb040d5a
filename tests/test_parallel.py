"""Sharding tests on the virtual 8-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from naruto_tpu.mapping.field import FieldSpec, init_field_params
from naruto_tpu.mapping.losses import LossWeights
from naruto_tpu.mapping.render import RenderConfig
from naruto_tpu.parallel import (
    make_mesh, data_sharding, replicated, sharded_grad_step,
    sharded_volume_query,
)


@pytest.fixture(scope="module")
def setup():
    spec = FieldSpec(bound=((-1, 1), (-1, 1), (-1, 1)), n_levels=4,
                     log2_hashmap_size=12, base_resolution=8, voxel_sdf=0.05,
                     uncert_voxel_size=0.25)
    rc = RenderConfig(n_range_d=5, n_samples_d=8, perturb=0.0)
    lw = LossWeights(smooth=0.0)
    params = init_field_params(jax.random.PRNGKey(0), spec)
    return spec, rc, lw, params


def test_eight_devices_available():
    assert len(jax.devices()) >= 8


def test_sharded_grad_matches_single_device(setup):
    spec, rc, lw, params = setup
    mesh = make_mesh(8)
    data = data_sharding(mesh)
    repl = replicated(mesh)

    n = 64
    key = jax.random.PRNGKey(1)
    rays_o = jnp.zeros((n, 3))
    rays_d = jnp.concatenate([jnp.zeros((n, 2)), jnp.ones((n, 1))], -1)
    rgb = jnp.full((n, 3), 0.5)
    d = jnp.full((n, 1), 0.7)
    mask = jnp.ones((n,))

    step = sharded_grad_step(mesh, spec, rc, lw)
    (loss_sh, _), grads_sh = step(
        jax.device_put(params, repl), jax.device_put(rays_o, data),
        jax.device_put(rays_d, data), jax.device_put(rgb, data),
        jax.device_put(d, data), jax.device_put(mask, data), key)

    # single-device reference
    from naruto_tpu.mapping.losses import total_loss
    from naruto_tpu.mapping.render import render_rays

    def loss_fn(p):
        rend = render_rays(p, spec, rc, key, rays_o, rays_d, d)
        l, _ = total_loss(p, spec, rend, rgb, d, mask, key, lw,
                          with_smooth=False)
        return l

    loss_ref, grads_ref = jax.value_and_grad(loss_fn)(params)
    np.testing.assert_allclose(float(loss_sh), float(loss_ref), rtol=1e-5)
    for k in ("table", "uncert_grid"):
        for a, b in zip(jax.tree_util.tree_leaves(grads_sh[k]),
                        jax.tree_util.tree_leaves(grads_ref[k])):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-7)


def test_sharded_volume_query(setup):
    spec, rc, lw, params = setup
    mesh = make_mesh(8)
    q = sharded_volume_query(mesh, spec)
    n = 8 * 32
    x01 = jax.device_put(
        jax.random.uniform(jax.random.PRNGKey(2), (n, 3)),
        data_sharding(mesh))
    sdf, um = q(jax.device_put(params, replicated(mesh)), x01)
    assert sdf.shape == (n,) and um.shape == (n,)
    assert np.all(np.asarray(um) >= 0)


def test_graft_entry_contract():
    import importlib.util, pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "__graft_entry__.py"
    s = importlib.util.spec_from_file_location("graft_entry", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert out[0].shape == (512, 3)
    mod.dryrun_multichip(8)


def test_production_ba_grads_sharded_vs_single():
    """The PRODUCTION mapper gradient (active rays, smoothness riding the
    render batch, uncertainty grid) computed through the shard_map path on
    the 8-device mesh equals the single-device gradient (psum'd global
    denominators + shared z-noise draw make it exact up to reduction
    order)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "__graft_entry__.py"
    s = importlib.util.spec_from_file_location("graft_entry2", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)

    from naruto_tpu.config.schema import deep_update
    from naruto_tpu.mapping.mapper import Mapper

    cfg_sh = mod.tiny_mapper_config(8)
    cfg_single = deep_update(cfg_sh, {"parallel": {"shard_rays": False}})
    m_sh = Mapper(cfg_sh)
    m_single = Mapper(cfg_single)
    assert m_sh._ba_mesh is not None and m_single._ba_mesh is None
    m_single.state = m_single.state._replace(params=m_sh.state.params)

    n = 192   # base + keep_cap of the active-ray batch shape
    key = jax.random.PRNGKey(3)
    k1, k2, k3 = jax.random.split(key, 3)
    rays_o = jax.random.normal(k1, (n, 3)) * 0.1
    rays_d = jnp.concatenate(
        [jax.random.normal(k2, (n, 2)) * 0.2, jnp.ones((n, 1))], -1)
    rgb = jnp.full((n, 3), 0.4)
    d = jnp.full((n, 1), 0.9)
    mask = jnp.ones((n,))

    g_sh = jax.jit(m_sh._grad_fn, static_argnums=(7,))(
        m_sh.state.params, k3, rays_o, rays_d, rgb, d, mask, True)
    g_ref = jax.jit(m_single._grad_fn, static_argnums=(7,))(
        m_single.state.params, k3, rays_o, rays_d, rgb, d, mask, True)
    # tolerance floor: the table gradient runs through the sort+cumsum
    # segment sum, whose run-boundary differences of large prefix sums
    # carry O(eps * |cs|) cancellation noise that differs between one
    # global cumsum and 8 per-shard cumsums; everything else is plain
    # data-parallel reduction reassociation.
    for k in ("table", "uncert_grid"):
        for a, b in zip(jax.tree_util.tree_leaves(g_sh[k]),
                        jax.tree_util.tree_leaves(g_ref[k])):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-3, atol=2e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g_sh["sdf_mlp"]),
                    jax.tree_util.tree_leaves(g_ref["sdf_mlp"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=1e-5)


def test_mapper_sharded_volumes():
    """Mapper with parallel.shard_volumes on the 8-device CPU mesh matches
    the single-device volume query."""
    from naruto_tpu.config.schema import deep_update
    from naruto_tpu.config import make_config
    from naruto_tpu.mapping.mapper import Mapper

    base = make_config("Replica", "office0", num_iter=20)
    over = {
        "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                "cy": 11.5},
        "grid": {"n_levels": 4, "hash_size": 12, "voxel_sdf": 0.1},
        "mapper": {"sample": 64, "iters": 2, "first_iters": 4,
                   "min_pixels_cur": 4, "act_ray_num_uncert_sample": 8,
                   "bound": ((-1, 1), (-1, 1), (-1, 1)),
                   "marching_cubes_bound": ((-1, 1), (-1, 1), (-1, 1)),
                   "voxel_size": 0.25},
        "training": {"n_samples_d": 8, "n_range_d": 5, "smooth_pts": 4},
    }
    cfg1 = deep_update(base, over)
    cfg2 = deep_update(cfg1, {"parallel": {"shard_volumes": True}})
    m1, m2 = Mapper(cfg1), Mapper(cfg2)
    assert m2._sharded_vol is not None
    m2.state = m2.state._replace(params=m1.state.params)
    u1, s1 = m1.get_map_volumes()
    u2, s2 = m2.get_map_volumes()
    np.testing.assert_allclose(u1, u2, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s1, s2, rtol=1e-5, atol=1e-6)


def test_sharded_grad_collective_structure():
    """Structural guard: the collectives XLA inserts into the sharded
    production gradient must not silently grow — every extra collective
    is interconnect time on real hardware. Counts are from the
    CPU-backend lowering (shard_map psum lowers to all-gather /
    collective-permute chains there; on GPUs the same psum becomes an
    NCCL all-reduce), so the guard pins the STRUCTURE, not the device op
    mix."""
    import importlib.util
    import pathlib
    import re

    path = pathlib.Path(__file__).resolve().parents[1] / "__graft_entry__.py"
    s = importlib.util.spec_from_file_location("graft_entry3", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)

    from naruto_tpu.mapping.mapper import Mapper

    m = Mapper(mod.tiny_mapper_config(8))
    assert m._ba_mesh is not None
    n = 192
    key = jax.random.PRNGKey(3)
    k1, k2, k3 = jax.random.split(key, 3)
    rays_o = jax.random.normal(k1, (n, 3)) * 0.1
    rays_d = jnp.concatenate(
        [jax.random.normal(k2, (n, 2)) * 0.2, jnp.ones((n, 1))], -1)
    args = (m.state.params, k3, rays_o, rays_d, jnp.full((n, 3), 0.4),
            jnp.full((n, 1), 0.9), jnp.ones((n,)), True)
    txt = jax.jit(m._grad_fn, static_argnums=(7,)).lower(
        *args).compile().as_text()
    counts = {}
    pat = re.compile(r"(?<!%)\b(all-reduce|all-gather|reduce-scatter|"
                     r"collective-permute|all-to-all)(-start|-done)?\(")
    for mm in pat.finditer(txt):
        if mm.group(2) == "-done":
            continue
        counts[mm.group(1)] = counts.get(mm.group(1), 0) + 1
    total = sum(counts.values())
    # r4 snapshot: exactly TWO fused all-reduces — one tuple all-reduce
    # of the 5 scalar loss denominators (psum'd global sums) and ONE
    # tuple all-reduce carrying every gradient leaf (XLA fuses the whole
    # psum tree). If this fails HIGH, a change added hidden resharding
    # or broke the fusion — find it before shipping; if LOW, update the
    # bound and celebrate.
    assert 0 < total <= 6, f"collective structure changed: {counts}"


def test_sharded_volume_collective_structure():
    """Same structural pin for the sharded dense volume query: the query is embarrassingly data-parallel over the
    flattened voxel axis — replicated params in, sharded sdf/uncert out —
    so the compiled program must contain NO collectives at all (any
    all-gather here would mean XLA is resharding the voxel axis or
    gathering the table)."""
    import importlib.util
    import pathlib
    import re

    path = pathlib.Path(__file__).resolve().parents[1] / "__graft_entry__.py"
    s = importlib.util.spec_from_file_location("graft_entry4", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)

    from naruto_tpu.mapping.mapper import Mapper

    cfg = mod.tiny_mapper_config(8)
    m = Mapper(cfg)
    assert m._sharded_vol is not None
    txt = m._sharded_vol.lower(
        m.state.params, m._grid01_padded).compile().as_text()
    pat = re.compile(r"(?<!%)\b(all-reduce|all-gather|reduce-scatter|"
                     r"collective-permute|all-to-all)(-start|-done)?\(")
    hits = [mm.group(0) for mm in pat.finditer(txt)
            if mm.group(2) != "-done"]
    assert not hits, f"sharded volume query grew collectives: {hits}"
