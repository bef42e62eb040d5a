"""Scatter-free segment sum + custom VJP correctness tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from naruto_tpu.ops.encoding import HashGridSpec, hash_encode, init_hash_table
from naruto_tpu.ops.grid_sample import trilinear_sample, trilinear_interp_volume
from naruto_tpu.ops.segment import dense_segment_sum, dense_segment_sum_outer


class TestSegmentSum:
    def test_matches_scatter_exact(self, rng):
        size = 100
        idx = jnp.asarray(rng.integers(0, size, 5000), dtype=jnp.int32)
        vals = jnp.asarray(rng.normal(size=(5000, 2)).astype(np.float32))
        out = dense_segment_sum(idx, vals, size, pack_bf16=False)
        ref = np.zeros((size, 2), np.float32)
        np.add.at(ref, np.asarray(idx), np.asarray(vals))
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-4, atol=1e-4)

    def test_matches_scatter_packed(self, rng):
        """Default bf16-packed payload path: ~0.4% per-update rounding."""
        size = 100
        idx = jnp.asarray(rng.integers(0, size, 5000), dtype=jnp.int32)
        vals = jnp.asarray(rng.normal(size=(5000, 2)).astype(np.float32))
        out = dense_segment_sum(idx, vals, size, pack_bf16=True)
        ref = np.zeros((size, 2), np.float32)
        np.add.at(ref, np.asarray(idx), np.asarray(vals))
        scale = np.abs(ref).max()
        np.testing.assert_allclose(np.asarray(out) / scale, ref / scale,
                                   atol=5e-3)

    def test_empty_slots_zero(self):
        idx = jnp.asarray([3, 3, 7], dtype=jnp.int32)
        vals = jnp.ones((3, 1))
        out = np.asarray(dense_segment_sum(idx, vals, 10))
        assert out[3, 0] == 2.0 and out[7, 0] == 1.0
        assert out.sum() == 3.0

    def test_outer_matches_scatter(self, rng):
        """Rank-1 outer-product segment sum (cell-layout backward)."""
        size = 64
        m = 3000
        idx = jnp.asarray(rng.integers(0, size, m), dtype=jnp.int32)
        a = jnp.asarray(rng.normal(size=(m, 8)).astype(np.float32))
        b = jnp.asarray(rng.normal(size=(m, 4)).astype(np.float32))
        out = dense_segment_sum_outer(idx, a, b, size)
        a16 = np.asarray(a.astype(jnp.bfloat16).astype(jnp.float32))
        b16 = np.asarray(b.astype(jnp.bfloat16).astype(jnp.float32))
        ref = np.zeros((size, 32), np.float32)
        np.add.at(ref, np.asarray(idx),
                  (a16[:, :, None] * b16[:, None, :]).reshape(m, 32))
        scale = np.abs(ref).max()
        np.testing.assert_allclose(np.asarray(out) / scale, ref / scale,
                                   atol=5e-3)

    def test_chunk_ranks_matches_merge_ranks(self, rng):
        """The hierarchical chunk-summary searchsorted is bit-exact vs the
        double-argsort merge-rank on every boundary shape (replaces two
        argsorts over m + size elements in the hot backward)."""
        from naruto_tpu.ops.segment import _chunk_ranks, _merge_ranks
        cases = [(5000, 100), (3000, 204089), (512, 512), (1, 10),
                 (93568, 89760)]
        for m, size in cases:
            keys = jnp.asarray(np.sort(rng.integers(0, size, m))
                               .astype(np.int32))
            np.testing.assert_array_equal(
                np.asarray(_chunk_ranks(keys, size)),
                np.asarray(_merge_ranks(keys, size)), err_msg=f"{m},{size}")
        # degenerate runs: all-equal keys, narrow occupied band
        keys = jnp.full((2048,), 7, jnp.int32)
        np.testing.assert_array_equal(
            np.asarray(_chunk_ranks(keys, 20)),
            np.asarray(_merge_ranks(keys, 20)))

    def test_outer_level_major_matches_point_major(self, rng):
        """Level-major flatten (relayout-free BA path) computes the same
        per-slot sums as the point-major flatten."""
        from naruto_tpu.ops.segment import \
            dense_segment_sum_outer_level_major
        size, n, L, F = 96, 700, 4, 8
        # hash-grid contract: level lv's slot ids live in its own disjoint
        # ascending table range (flat ids include per-level offsets)
        per = size // L
        idx = jnp.asarray(
            rng.integers(0, per, (n, L)) + np.arange(L) * per,
            dtype=jnp.int32)
        w = jnp.asarray(rng.normal(size=(n, L, 8)).astype(np.float32))
        g = jnp.asarray(rng.normal(size=(n, L * F)).astype(np.float32))
        ref = dense_segment_sum_outer(
            idx.reshape(-1), w.reshape(-1, 8),
            g.reshape(n, L, F).reshape(-1, F), size)
        out = dense_segment_sum_outer_level_major(idx, w, g, size)
        scale = float(np.abs(np.asarray(ref)).max())
        np.testing.assert_allclose(np.asarray(out) / scale,
                                   np.asarray(ref) / scale, atol=2e-3)

    def test_batched_sort_equals_flat_sort(self, rng):
        """Per-level batched sort of level-major operands with disjoint
        ascending per-level key ranges flattens to EXACTLY the flat global
        sort's keys (payload order within equal keys may differ)."""
        from naruto_tpu.ops.segment import _batched_sort
        L, n = 4, 512
        key = jnp.asarray(
            (rng.integers(0, 100, (L, n)) + np.arange(L)[:, None] * 100)
            .reshape(-1).astype(np.int32))
        pay = jnp.asarray(rng.integers(-5, 5, L * n).astype(np.int32))
        bk, bp = _batched_sort((key, pay), L)
        fk, fp = jax.lax.sort((key, pay), num_keys=1)
        np.testing.assert_array_equal(np.asarray(bk), np.asarray(fk))
        # payload multisets per key must agree
        import collections
        cb = collections.Counter(zip(np.asarray(bk).tolist(),
                                     np.asarray(bp).tolist()))
        cf = collections.Counter(zip(np.asarray(fk).tolist(),
                                     np.asarray(fp).tolist()))
        assert cb == cf

    def test_batched_sort_env_gate(self, rng, monkeypatch):
        """Default is the single flat lax.sort; NARUTO_BATCHED_SORT=1 opts
        into the per-level batched sort. Results must be identical either way on
        the disjoint-range contract, and the two calls must actually take
        DIFFERENT routes (a silently broken gate would bench the same
        graph twice in the hardware A/B)."""
        import jax as jax_mod

        from naruto_tpu.ops import segment
        # the hardware queue exports this; a leaked value would silently
        # collapse both calls onto the batched path
        monkeypatch.delenv("NARUTO_BATCHED_SORT", raising=False)
        L, n = 4, 256
        # unique keys per level -> a unique sorted order, so the payload
        # comparison below is exact equality, not a vacuous multiset check
        perm = np.stack([rng.permutation(n) for _ in range(L)])
        key = jnp.asarray(
            (perm + np.arange(L)[:, None] * n).reshape(-1).astype(np.int32))
        pay = jnp.asarray(rng.normal(size=L * n).astype(np.float32))

        routes = []
        real_sort = jax_mod.lax.sort

        def recording_sort(ops, **kw):
            routes.append((np.shape(ops[0]), kw.get("dimension")))
            return real_sort(ops, **kw)

        monkeypatch.setattr(segment.jax.lax, "sort", recording_sort)
        fk, fp = segment._batched_sort((key, pay), L)
        monkeypatch.setenv("NARUTO_BATCHED_SORT", "1")
        bk, bp = segment._batched_sort((key, pay), L)

        assert routes[0][0] == (L * n,)        # default: one flat [M] sort
        assert routes[1] == ((L, n), 1)        # opt-in: [L, n] along dim 1
        np.testing.assert_array_equal(np.asarray(bk), np.asarray(fk))
        np.testing.assert_array_equal(np.asarray(bp), np.asarray(fp))

    def test_pack_frac_weight_roundtrip(self, rng):
        """corner_weights_from_packed(pack_frac(f)) reproduces the
        encoding's trilinear corner weights to the 10-bit resolution."""
        from naruto_tpu.ops.encoding import _corner_weights
        from naruto_tpu.ops.segment import (corner_weights_from_packed,
                                            pack_frac)
        frac = jnp.asarray(rng.uniform(0, 1, (500, 2, 3)).astype(np.float32))
        w_ref = np.asarray(_corner_weights(frac)).reshape(-1, 8)
        w_q = np.asarray(
            corner_weights_from_packed(pack_frac(frac).reshape(-1)))
        # 10-bit frac -> <= ~3/1023 absolute weight error
        np.testing.assert_allclose(w_q, w_ref, atol=3.5e-3)
        # weights still partition unity exactly (products of exact pairs)
        np.testing.assert_allclose(w_q.sum(-1), 1.0, atol=1e-5)
        # exact at the corners
        f0 = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
        w0 = np.asarray(corner_weights_from_packed(pack_frac(f0)))
        assert w0[0, 0b010] == 1.0 and w0.sum() == 1.0

    def test_outer_frac_carry_matches_weight_carry(self, rng):
        """The slim frac-carry sort payload computes the same segment sums
        as the weight-carry path (up to the 10-bit frac quantization)."""
        from naruto_tpu.ops.encoding import _corner_weights
        from naruto_tpu.ops.segment import (
            dense_segment_sum_outer_level_major,
            dense_segment_sum_outer_level_major_frac)
        size, n, L, F = 96, 700, 4, 8
        per = size // L
        idx = jnp.asarray(
            rng.integers(0, per, (n, L)) + np.arange(L) * per,
            dtype=jnp.int32)
        frac = jnp.asarray(rng.uniform(0, 1, (n, L, 3)).astype(np.float32))
        g = jnp.asarray(rng.normal(size=(n, L * F)).astype(np.float32))
        w = _corner_weights(frac)
        ref = dense_segment_sum_outer_level_major(idx, w, g, size)
        scale = float(np.abs(np.asarray(ref)).max())
        out = dense_segment_sum_outer_level_major_frac(idx, frac, g, size)
        np.testing.assert_allclose(np.asarray(out) / scale,
                                   np.asarray(ref) / scale, atol=6e-3)


class TestHashEncodeVJP:
    def test_table_grad_matches_autodiff_reference(self, rng):
        """Custom backward must equal the scatter-based JVP-transpose."""
        spec = HashGridSpec(n_levels=3, log2_table_size=10,
                            base_resolution=4, finest_resolution=16)
        table = init_hash_table(jax.random.PRNGKey(0), spec)
        x = jnp.asarray(rng.uniform(0.05, 0.95, (50, 3)).astype(np.float32))
        g = jnp.asarray(rng.normal(size=(50, spec.output_dim))
                        .astype(np.float32))

        # reference: plain take-based implementation (inherits XLA scatter)
        def ref_encode(t):
            from naruto_tpu.ops.encoding import _corner_indices
            idx, w = _corner_indices(x, spec)
            feats = jnp.take(t, idx, axis=0).reshape(
                50, spec.n_levels, 8, spec.n_features)
            return jnp.sum(feats * w[..., None], axis=2).reshape(
                50, spec.output_dim)

        _, ref_vjp = jax.vjp(ref_encode, table)
        (ref_gt,) = ref_vjp(g)
        _, vjp = jax.vjp(lambda t: hash_encode(t, x, spec), table)
        (gt,) = vjp(g)
        # default path packs sort payloads as bf16 (~0.4% per update)
        scale = float(np.abs(np.asarray(ref_gt)).max()) + 1e-12
        np.testing.assert_allclose(np.asarray(gt) / scale,
                                   np.asarray(ref_gt) / scale, atol=6e-3)

    def test_cell_layout_table_grad_matches_autodiff(self, rng):
        """Cell layout: custom backward equals the autodiff reference of
        the same wide-row blend."""
        spec = HashGridSpec(n_levels=3, log2_table_size=10,
                            base_resolution=4, finest_resolution=16,
                            layout="cell")
        table = init_hash_table(jax.random.PRNGKey(0), spec)
        assert table.shape[1] == 8 * spec.n_features
        x = jnp.asarray(rng.uniform(0.05, 0.95, (50, 3)).astype(np.float32))
        g = jnp.asarray(rng.normal(size=(50, spec.output_dim))
                        .astype(np.float32))

        def ref_encode(t):
            from naruto_tpu.ops.encoding import _cell_indices
            idx, w = _cell_indices(x, spec)
            feats = jnp.take(t, idx.reshape(-1), axis=0).reshape(
                50, spec.n_levels, 8, spec.n_features)
            return jnp.sum(feats * w[..., None], axis=2).reshape(
                50, spec.output_dim)

        out_ref = ref_encode(table)
        out = hash_encode(table, x, spec)
        np.testing.assert_allclose(np.asarray(out), np.asarray(out_ref),
                                   rtol=1e-5, atol=1e-7)

        _, ref_vjp = jax.vjp(ref_encode, table)
        (ref_gt,) = ref_vjp(g)
        _, vjp = jax.vjp(lambda t: hash_encode(t, x, spec), table)
        (gt,) = vjp(g)
        scale = float(np.abs(np.asarray(ref_gt)).max()) + 1e-12
        np.testing.assert_allclose(np.asarray(gt) / scale,
                                   np.asarray(ref_gt) / scale, atol=6e-3)

    def test_frac_carry_table_grad_matches_weight_carry(self, rng):
        """sort_carry="frac" (slim sort payload) produces table grads that
        match the weight-carry backward to the frac quantization."""
        for layout in ("cell", "hybrid"):
            spec_w = HashGridSpec(n_levels=3, log2_table_size=10,
                                  base_resolution=4, finest_resolution=16,
                                  layout=layout, sort_carry="weights")
            spec_f = HashGridSpec(n_levels=3, log2_table_size=10,
                                  base_resolution=4, finest_resolution=16,
                                  layout=layout, sort_carry="frac")
            table = init_hash_table(jax.random.PRNGKey(0), spec_w)
            x = jnp.asarray(rng.uniform(0.05, 0.95, (60, 3))
                            .astype(np.float32))
            g = jnp.asarray(rng.normal(size=(60, spec_w.output_dim))
                            .astype(np.float32))
            _, vjp_w = jax.vjp(lambda t: hash_encode(t, x, spec_w), table)
            _, vjp_f = jax.vjp(lambda t: hash_encode(t, x, spec_f), table)
            (gw,), (gf,) = vjp_w(g), vjp_f(g)
            for a, b in zip(jax.tree_util.tree_leaves(gw),
                            jax.tree_util.tree_leaves(gf)):
                scale = float(np.abs(np.asarray(a)).max()) + 1e-12
                np.testing.assert_allclose(
                    np.asarray(b) / scale, np.asarray(a) / scale,
                    atol=8e-3, err_msg=layout)

    def test_cell_layout_input_grad_finite_difference(self, rng):
        spec = HashGridSpec(n_levels=2, log2_table_size=10,
                            base_resolution=4, finest_resolution=8,
                            layout="cell")
        table = init_hash_table(jax.random.PRNGKey(0), spec) * 1e4
        x0 = jnp.asarray([[0.331, 0.472, 0.613]], dtype=jnp.float32)
        g = jnp.ones((1, spec.output_dim))
        _, vjp = jax.vjp(lambda x: hash_encode(table, x, spec), x0)
        (gx,) = vjp(g)
        eps = 1e-4
        for a in range(3):
            dx = np.zeros((1, 3), np.float32)
            dx[0, a] = eps
            f1 = hash_encode(table, x0 + dx, spec).sum()
            f0 = hash_encode(table, x0 - dx, spec).sum()
            fd = float(f1 - f0) / (2 * eps)
            np.testing.assert_allclose(float(gx[0, a]), fd, rtol=2e-2,
                                       atol=1e-3)

    def test_input_grad_finite_difference(self, rng):
        spec = HashGridSpec(n_levels=2, log2_table_size=10,
                            base_resolution=4, finest_resolution=8)
        table = init_hash_table(jax.random.PRNGKey(0), spec) * 1e4
        x0 = jnp.asarray([[0.331, 0.472, 0.613]], dtype=jnp.float32)
        g = jnp.ones((1, spec.output_dim))
        _, vjp = jax.vjp(lambda x: hash_encode(table, x, spec), x0)
        (gx,) = vjp(g)
        eps = 1e-4
        for a in range(3):
            dx = np.zeros((1, 3), np.float32)
            dx[0, a] = eps
            f1 = hash_encode(table, x0 + dx, spec).sum()
            f0 = hash_encode(table, x0 - dx, spec).sum()
            fd = float(f1 - f0) / (2 * eps)
            np.testing.assert_allclose(float(gx[0, a]), fd, rtol=2e-2,
                                       atol=1e-3)


class TestTrilerpVJP:
    def test_vol_grad_matches_scatter(self, rng):
        vol = jnp.asarray(rng.normal(size=(6, 7, 8)).astype(np.float32))
        pts = jnp.asarray(rng.uniform(0.05, 0.95, (40, 3)).astype(np.float32))
        g = jnp.asarray(rng.normal(size=(40,)).astype(np.float32))

        def ref(v):
            # straightforward implementation for autodiff reference
            shape = jnp.asarray(v.shape, jnp.float32)
            coords = pts * (shape - 1.0)   # align_corners=True mapping
            c = jnp.clip(coords, 0.0, shape - 1.0)
            i0 = jnp.clip(jnp.floor(c).astype(jnp.int32), 0,
                          jnp.asarray(v.shape, jnp.int32) - 2)
            f = c - i0
            out = 0.0
            for dx in (0, 1):
                for dy in (0, 1):
                    for dz in (0, 1):
                        w = ((f[:, 0] if dx else 1 - f[:, 0])
                             * (f[:, 1] if dy else 1 - f[:, 1])
                             * (f[:, 2] if dz else 1 - f[:, 2]))
                        out += w * v[i0[:, 0] + dx, i0[:, 1] + dy,
                                     i0[:, 2] + dz]
            return out

        np.testing.assert_allclose(
            np.asarray(trilinear_sample(vol, pts, align_corners=True)),
            np.asarray(ref(vol)), rtol=1e-5, atol=1e-6)

        _, ref_vjp = jax.vjp(ref, vol)
        (ref_g,) = ref_vjp(g)
        _, vjp = jax.vjp(lambda v: trilinear_sample(v, pts,
                                                    align_corners=True), vol)
        (gv,) = vjp(g)
        np.testing.assert_allclose(np.asarray(gv), np.asarray(ref_g),
                                   rtol=1e-4, atol=1e-6)

    def test_coord_grad_finite_difference(self, rng):
        vol = jnp.asarray(rng.normal(size=(5, 5, 5)).astype(np.float32))
        c0 = jnp.asarray([[1.3, 2.6, 3.1]], dtype=jnp.float32)
        _, vjp = jax.vjp(lambda c: trilinear_interp_volume(vol, c), c0)
        (gc,) = vjp(jnp.ones((1,)))
        eps = 1e-3
        for a in range(3):
            d = np.zeros((1, 3), np.float32)
            d[0, a] = eps
            fd = (float(trilinear_interp_volume(vol, c0 + d)[0])
                  - float(trilinear_interp_volume(vol, c0 - d)[0])) / (2 * eps)
            np.testing.assert_allclose(float(gc[0, a]), fd, rtol=2e-2,
                                       atol=1e-3)


class TestAgainstSegmentSum:
    """Every sort-path segment sum against jax.ops.segment_sum of the same
    float32 updates (the plain form: an XLA scatter-add). Tolerances are
    relative to the max: summation order only for the f32 payload; one
    bf16 rounding per factor and of the product where payloads are
    packed; plus the 10-bit frac quantization for the frac carry."""

    SIZE, N, L, F = 96, 700, 4, 8

    def _inputs(self, rng):
        per = self.SIZE // self.L
        idx = jnp.asarray(rng.integers(0, per, (self.N, self.L))
                          + np.arange(self.L) * per, dtype=jnp.int32)
        frac = jnp.asarray(rng.uniform(0, 1, (self.N, self.L, 3))
                           .astype(np.float32))
        g = jnp.asarray(rng.normal(size=(self.N, self.L * self.F))
                        .astype(np.float32))
        return idx, frac, g

    @pytest.mark.parametrize("path,tol", [
        ("f32", 1e-5), ("bf16", 5e-3), ("outer", 5e-3),
        ("outer_level_major", 5e-3), ("outer_level_major_frac", 1.2e-2)])
    def test_matches_segment_sum(self, rng, path, tol):
        from naruto_tpu.ops.encoding import _corner_weights
        from naruto_tpu.ops.segment import (
            dense_segment_sum_outer_level_major,
            dense_segment_sum_outer_level_major_frac)
        idx, frac, g = self._inputs(rng)
        n, L, F, size = self.N, self.L, self.F, self.SIZE
        w = _corner_weights(frac)                         # [N, L, 8]
        idx_f = idx.T.reshape(-1)                         # level-major
        w_f = jnp.transpose(w, (1, 0, 2)).reshape(-1, 8)
        g_f = jnp.transpose(g.reshape(n, L, F), (1, 0, 2)).reshape(-1, F)
        if path in ("f32", "bf16"):
            out = dense_segment_sum(idx_f, g_f, size,
                                    pack_bf16=path == "bf16")
            ref = jax.ops.segment_sum(g_f, idx_f, num_segments=size)
        else:
            if path == "outer":
                out = dense_segment_sum_outer(idx_f, w_f, g_f, size)
            elif path == "outer_level_major":
                out = dense_segment_sum_outer_level_major(idx, w, g, size)
            else:
                out = dense_segment_sum_outer_level_major_frac(
                    idx, frac, g, size)
            ref = jax.ops.segment_sum(
                (w_f[:, :, None] * g_f[:, None, :]).reshape(-1, 8 * F),
                idx_f, num_segments=size)
        scale = float(np.abs(np.asarray(ref)).max())
        np.testing.assert_allclose(np.asarray(out) / scale,
                                   np.asarray(ref) / scale, atol=tol)


class TestHybridLayout:
    """Hybrid layout: dense levels are TRUE shared-vertex grids (wide cell
    rows derived by static slices), hashed levels stay cell-keyed."""

    def _spec(self, **kw):
        from naruto_tpu.ops.encoding import HashGridSpec
        d = dict(n_levels=3, log2_table_size=10, base_resolution=4,
                 finest_resolution=16, layout="hybrid")
        d.update(kw)
        return HashGridSpec(**d)

    def test_dense_levels_match_vertex_layout_exactly(self, rng):
        """On a dense level the hybrid encode equals the vertex-layout
        (exact tcnn) encode with the same vertex values."""
        from naruto_tpu.ops.encoding import HashGridSpec
        res = 4
        spec_h = self._spec(n_levels=1, finest_resolution=res,
                            log2_table_size=12)
        spec_v = HashGridSpec(n_levels=1, base_resolution=res,
                              finest_resolution=res, log2_table_size=12,
                              layout="vertex")
        grid = jnp.asarray(rng.normal(size=(res + 1, res + 1, res + 1, 2))
                           .astype(np.float32))
        table_h = {"hash": jnp.zeros((0, 16), jnp.float32), "dense": [grid]}
        # vertex table: flat = x + y*(res+1) + z*(res+1)^2 — the z-major
        # grid flattens to exactly that (x fastest)
        table_v = grid.reshape(-1, 2)
        x = jnp.asarray(rng.uniform(0.02, 0.98, (64, 3)).astype(np.float32))
        out_h = hash_encode(table_h, x, spec_h)
        out_v = hash_encode(table_v, x, spec_v)
        np.testing.assert_allclose(np.asarray(out_h), np.asarray(out_v),
                                   rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("carry,tol", [("weights", 6e-3),
                                           ("frac", 1.2e-2)])
    def test_grads_match_autodiff_of_derived_table(self, rng, carry, tol):
        """weights carry: exact up to bf16 rounding (6e-3 rel-of-max);
        frac carry (the r4 default): adds the 10-bit frac quantization,
        bounded by ~2x the bf16 tolerance (ops/segment.pack_frac)."""
        from naruto_tpu.ops.encoding import (_cell_indices,
                                             derived_gather_table)
        spec = self._spec(sort_carry=carry)
        table = init_hash_table(jax.random.PRNGKey(0), spec)
        x = jnp.asarray(rng.uniform(0.05, 0.95, (50, 3)).astype(np.float32))
        g = jnp.asarray(rng.normal(size=(50, spec.output_dim))
                        .astype(np.float32))

        def ref_encode(t):
            gt = derived_gather_table(t, spec, jnp.float32)
            idx, w = _cell_indices(x, spec)
            feats = jnp.take(gt, idx.reshape(-1), axis=0).reshape(
                50, spec.n_levels, 8, spec.n_features)
            return jnp.sum(feats * w[..., None], axis=2).reshape(
                50, spec.output_dim)

        np.testing.assert_allclose(
            np.asarray(hash_encode(table, x, spec)),
            np.asarray(ref_encode(table)), rtol=1e-5, atol=1e-7)
        _, ref_vjp = jax.vjp(ref_encode, table)
        (ref_g,) = ref_vjp(g)
        _, vjp = jax.vjp(lambda t: hash_encode(t, x, spec), table)
        (gt,) = vjp(g)
        for a, b in zip(jax.tree_util.tree_leaves(gt),
                        jax.tree_util.tree_leaves(ref_g)):
            s = float(np.abs(np.asarray(b)).max()) + 1e-12
            np.testing.assert_allclose(np.asarray(a) / s,
                                       np.asarray(b) / s, atol=tol)

    def test_field_continuous_across_dense_cell_faces(self):
        spec = self._spec(n_levels=1, finest_resolution=4,
                          log2_table_size=12)
        table = jax.tree_util.tree_map(
            lambda a: a * 1e4, init_hash_table(jax.random.PRNGKey(1), spec))
        eps = 1e-6
        xa = jnp.asarray([[0.25 - eps, 0.4, 0.6]])
        xb = jnp.asarray([[0.25 + eps, 0.4, 0.6]])
        d = float(jnp.abs(hash_encode(table, xa, spec)
                          - hash_encode(table, xb, spec)).max())
        assert d < 1e-3  # the cell layout jumps O(1) here


class TestR5GlueKnobs:
    """Data-movement graph knobs must be EXACTLY output-preserving —
    they reshuffle pads, stacks and converts, not math."""

    def _frac_inputs(self, rng, n=333, L=4, per=16):
        # level-range contract: column lv's ids in [lv*per, (lv+1)*per)
        idx = (rng.integers(0, per, (n, L)) +
               np.arange(L)[None, :] * per).astype(np.int32)
        frac = rng.uniform(0, 1, (n, L, 3)).astype(np.float32)
        b = rng.normal(size=(n, L * 4)).astype(np.float32)
        return jnp.asarray(idx), jnp.asarray(frac), jnp.asarray(b), L * per

    def test_presort_pad_exact(self, rng, monkeypatch):
        """NARUTO_PRESORT_PAD folds a 512-alignment into the pre-sort
        concats; sentinel rows (INT32_MAX key, zero values) must leave
        every slot's sum bit-identical. n*L=1332 is NOT a multiple of 512
        so the pad path is actually exercised."""
        from naruto_tpu.ops.segment import (
            dense_segment_sum_outer_level_major_frac as f)
        idx, frac, b, size = self._frac_inputs(rng)
        monkeypatch.delenv("NARUTO_PRESORT_PAD", raising=False)
        ref = np.asarray(f(idx, frac, b, size))
        monkeypatch.setenv("NARUTO_PRESORT_PAD", "1")
        out = np.asarray(f(idx, frac, b, size))
        np.testing.assert_array_equal(out, ref)

    def test_sorted_unpack_cols_exact(self, rng, monkeypatch):
        """Column-wise reassembly of the sorted bf16-pair payload must
        reproduce the stack+bitcast element order exactly."""
        from naruto_tpu.ops.segment import (
            dense_segment_sum_outer_level_major_frac as f)
        idx, frac, b, size = self._frac_inputs(rng)
        monkeypatch.delenv("NARUTO_SORTED_UNPACK", raising=False)
        ref = np.asarray(f(idx, frac, b, size))
        monkeypatch.setenv("NARUTO_SORTED_UNPACK", "cols")
        out = np.asarray(f(idx, frac, b, size))
        np.testing.assert_array_equal(out, ref)

    def test_dense_bf16_conv_exact(self, rng, monkeypatch):
        """bf16-casting the vertex grid BEFORE the one-hot corner conv is
        bit-identical to converting the conv output (each output element
        is an exact copy of one grid value)."""
        from naruto_tpu.ops.encoding import derived_cell_rows
        res = 7
        grid = jnp.asarray(
            rng.normal(size=(res + 1, res + 1, res + 1, 8))
            .astype(np.float32))
        monkeypatch.delenv("NARUTO_DENSE_BF16_CONV", raising=False)
        ref = np.asarray(derived_cell_rows(grid, res, jnp.bfloat16))
        monkeypatch.setenv("NARUTO_DENSE_BF16_CONV", "1")
        out = np.asarray(derived_cell_rows(grid, res, jnp.bfloat16))
        np.testing.assert_array_equal(
            out.view(np.uint16), ref.view(np.uint16))
