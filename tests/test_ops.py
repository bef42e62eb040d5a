"""Ops tests: hash encoding, one-blob, grid sampling, MLP."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from naruto_tpu.ops import (
    HashGridSpec, hash_encode, init_hash_table, one_blob_encode,
    trilinear_sample, init_mlp_params, mlp_apply,
)
from naruto_tpu.ops.grid_sample import trilinear_interp_volume


class TestHashGrid:
    def test_spec_resolutions(self):
        spec = HashGridSpec(n_levels=16, base_resolution=16,
                            finest_resolution=256)
        assert spec.resolutions[0] == 16
        assert spec.resolutions[-1] == 256
        assert all(a <= b for a, b in zip(spec.resolutions, spec.resolutions[1:]))

    def test_spec_from_bound_office0(self):
        bound = np.array([[-2.2, 2.6], [-3.4, 2.1], [-1.4, 2.0]])
        spec = HashGridSpec.from_bound(bound, voxel_sdf=0.02)
        # max side = y: 5.5m -> 275
        assert spec.finest_resolution == 274 or spec.finest_resolution == 275

    def test_dense_levels_fit(self):
        spec = HashGridSpec()
        # level 0: 17^3 = 4913 < 65536 -> dense
        assert spec.level_sizes[0] == 17 ** 3
        assert spec.level_sizes[-1] == spec.table_size
        assert spec.total_entries == sum(spec.level_sizes)

    def test_encode_shapes_and_grad(self):
        spec = HashGridSpec(n_levels=4, finest_resolution=64)
        key = jax.random.PRNGKey(0)
        table = init_hash_table(key, spec)
        x = jax.random.uniform(jax.random.PRNGKey(1), (128, 3))
        out = hash_encode(table, x, spec)
        assert out.shape == (128, spec.output_dim)
        # gradient flows to the table (scatter-add transpose)
        g = jax.grad(lambda t: jnp.sum(hash_encode(t, x, spec) ** 2))(table)
        assert g.shape == table.shape
        assert float(jnp.abs(g).sum()) > 0

    def test_encode_interpolates_continuously(self):
        spec = HashGridSpec(n_levels=2, base_resolution=4,
                            finest_resolution=8)
        table = init_hash_table(jax.random.PRNGKey(0), spec) * 1e4  # O(1)
        x0 = jnp.array([[0.3, 0.4, 0.5]])
        eps = 1e-4
        x1 = x0 + eps
        d = jnp.abs(hash_encode(table, x1, spec) - hash_encode(table, x0, spec))
        assert float(d.max()) < 0.1  # continuous, small step -> small change

    def test_corner_exactness_dense_level(self):
        # at a grid vertex the encoding equals the table entry exactly
        spec = HashGridSpec(n_levels=1, base_resolution=4,
                            finest_resolution=4)
        table = init_hash_table(jax.random.PRNGKey(2), spec)
        # vertex (1,2,3) on a 4-res grid -> x = (1/4, 2/4, 3/4)
        x = jnp.array([[0.25, 0.5, 0.75]])
        out = hash_encode(table, x, spec)
        s = 5  # res+1
        flat = 1 + 2 * s + 3 * s * s
        np.testing.assert_allclose(out[0], table[flat], rtol=1e-5)

    def test_deterministic(self):
        spec = HashGridSpec(n_levels=4)
        table = init_hash_table(jax.random.PRNGKey(0), spec)
        x = jax.random.uniform(jax.random.PRNGKey(3), (16, 3))
        a = hash_encode(table, x, spec)
        b = hash_encode(table, x, spec)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestOneBlob:
    def test_shape(self):
        x = jnp.zeros((7, 3))
        out = one_blob_encode(x, 16)
        assert out.shape == (7, 48)

    def test_partition_of_unity_interior(self):
        # for x well inside [0,1] the features nearly sum to 1
        x = jnp.array([[0.5, 0.3, 0.7]])
        out = one_blob_encode(x, 16).reshape(3, 16)
        np.testing.assert_allclose(np.asarray(out.sum(-1)), 1.0, atol=1e-3)

    def test_peak_at_input_bin(self):
        x = jnp.array([[0.5 + 1e-4]])
        out = np.asarray(one_blob_encode(x, 16))[0]
        assert out.argmax() == 8  # bin containing 0.5+

    def test_smooth(self):
        a = one_blob_encode(jnp.array([[0.42]]), 16)
        b = one_blob_encode(jnp.array([[0.4201]]), 16)
        assert float(jnp.abs(a - b).max()) < 0.01


class TestGridSample:
    def test_align_corners_true_matches_direct(self):
        vol = jnp.arange(4 * 5 * 6, dtype=jnp.float32).reshape(4, 5, 6)
        # at exact vertices, align_corners=True hits the voxel value
        pts = jnp.array([[1 / 3, 2 / 4, 3 / 5]])  # vertex (1,2,3)
        out = trilinear_sample(vol, pts, align_corners=True)
        np.testing.assert_allclose(float(out[0]), float(vol[1, 2, 3]), rtol=1e-5)

    def test_align_corners_false_center(self):
        vol = jnp.ones((4, 4, 4))
        out = trilinear_sample(vol, jnp.array([[0.5, 0.5, 0.5]]),
                               align_corners=False)
        np.testing.assert_allclose(float(out[0]), 1.0, rtol=1e-6)

    def test_align_corners_false_offset_semantics(self):
        # 1D-like check: x01=0.5 with size 4 -> voxel coord (0.5*2*4-1)/2=1.5
        vol = jnp.broadcast_to(
            jnp.arange(4, dtype=jnp.float32)[:, None, None], (4, 4, 4))
        out = trilinear_sample(vol, jnp.array([[0.5, 0.5, 0.5]]),
                               align_corners=False)
        np.testing.assert_allclose(float(out[0]), 1.5, rtol=1e-6)

    def test_volume_interp_matches_reference_formula(self, rng):
        # against a dense numpy trilinear reference
        vol_np = rng.normal(size=(5, 6, 7)).astype(np.float32)
        pts = rng.uniform([0, 0, 0], [4, 5, 6], size=(50, 3)).astype(np.float32)
        out = np.asarray(trilinear_interp_volume(jnp.asarray(vol_np),
                                                 jnp.asarray(pts)))
        for p, o in zip(pts, out):
            x0, y0, z0 = np.floor(p).astype(int)
            x0, y0, z0 = min(x0, 3), min(y0, 4), min(z0, 5)
            dx, dy, dz = p - [x0, y0, z0]
            ref = 0.0
            for cx in (0, 1):
                for cy in (0, 1):
                    for cz in (0, 1):
                        w = ((dx if cx else 1 - dx) * (dy if cy else 1 - dy)
                             * (dz if cz else 1 - dz))
                        ref += w * vol_np[x0 + cx, y0 + cy, z0 + cz]
            np.testing.assert_allclose(o, ref, rtol=1e-4, atol=1e-5)


class TestMLP:
    def test_shapes(self):
        params = init_mlp_params(jax.random.PRNGKey(0), [80, 32, 16])
        x = jnp.ones((10, 80))
        out = mlp_apply(params, x)
        assert out.shape == (10, 16)

    def test_init_bound(self):
        params = init_mlp_params(jax.random.PRNGKey(0), [64, 32])
        w = np.asarray(params[0])
        assert np.abs(w).max() <= 1 / np.sqrt(64) + 1e-6

    def test_grad_flows(self):
        params = init_mlp_params(jax.random.PRNGKey(0), [8, 32, 4])
        x = jax.random.normal(jax.random.PRNGKey(1), (5, 8))
        g = jax.grad(lambda p: jnp.sum(mlp_apply(p, x) ** 2))(params)
        assert all(float(jnp.abs(gi).sum()) > 0 for gi in g)




class TestEmbedAdam:
    """The hand-rolled table Adam (mapper._embed_adam_update) matches
    optax scale_by_adam(eps_root=0) + scale(-lr) step by step."""

    def test_matches_optax_over_steps(self):
        import optax
        from naruto_tpu.mapping.mapper import (EMBED_B1, EMBED_B2,
                                               EMBED_EPS, _embed_adam_update,
                                               _init_embed_state)

        lr = 0.01
        tx = optax.chain(
            optax.scale_by_adam(b1=EMBED_B1, b2=EMBED_B2, eps=EMBED_EPS),
            optax.scale(-lr))
        key = jax.random.PRNGKey(0)
        table = {"a": jax.random.normal(key, (37, 5)),
                 "b": jax.random.normal(key, (16,))}
        p_ref = table
        st_ref = tx.init(p_ref)
        st = _init_embed_state(table)
        for t in range(1, 4):
            g = jax.tree_util.tree_map(
                lambda p: jax.random.normal(
                    jax.random.fold_in(jax.random.PRNGKey(t), p.size),
                    p.shape), table)
            upd, st_ref = tx.update(g, st_ref, p_ref)
            p_ref = optax.apply_updates(p_ref, upd)
            table, st = _embed_adam_update(table, g, st, lr)
            for k in table:
                np.testing.assert_allclose(
                    np.asarray(table[k]), np.asarray(p_ref[k]),
                    rtol=2e-5, atol=1e-7)
