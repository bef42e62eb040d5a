"""Isosurface + PLY tests against analytic SDFs."""
import numpy as np
import pytest

from naruto_tpu.mesh.marching import marching_cubes, _load_lib
from naruto_tpu.mesh.ply import write_ply, read_ply


def sphere_sdf(n=40, r=12.0):
    g = np.arange(n, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    c = (n - 1) / 2.0
    return np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) - r


def mesh_area(verts, faces):
    a = verts[faces[:, 1]] - verts[faces[:, 0]]
    b = verts[faces[:, 2]] - verts[faces[:, 0]]
    return 0.5 * np.linalg.norm(np.cross(a, b), axis=1).sum()


def check_watertight(verts, faces):
    """Every undirected edge appears exactly twice."""
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]])
    edges = np.sort(edges, axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    return np.all(counts == 2)


@pytest.mark.parametrize("backend", ["numpy", "native"])
class TestMarching:
    def _mc(self, sdf, backend, **kw):
        if backend == "native" and _load_lib() is None:
            pytest.skip("native lib unavailable")
        return marching_cubes(sdf, backend=backend, **kw)

    def test_sphere_surface(self, backend):
        sdf = sphere_sdf()
        verts, faces = self._mc(sdf, backend, truncation=1e9)
        assert len(verts) > 100 and len(faces) > 100
        # vertices lie on the sphere
        c = (40 - 1) / 2.0
        rad = np.linalg.norm(verts - c, axis=1)
        np.testing.assert_allclose(rad, 12.0, atol=0.15)
        # area close to analytic 4 pi r^2
        area = mesh_area(verts, faces)
        assert abs(area - 4 * np.pi * 144) / (4 * np.pi * 144) < 0.05
        assert check_watertight(verts, faces)

    def test_truncation_masks_far_cubes(self, backend):
        sdf = sphere_sdf()
        # with small truncation, cubes far from surface are skipped but the
        # surface itself is identical
        v1, f1 = self._mc(sdf, backend, truncation=2.0)
        v2, f2 = self._mc(sdf, backend, truncation=1e9)
        assert len(v1) == len(v2) and len(f1) == len(f2)
        # masking everything removes all faces
        v3, f3 = self._mc(sdf, backend, truncation=0.01)
        assert len(f3) == 0

    def test_interpolation_subvoxel(self, backend):
        # plane at x = 2.3
        n = 8
        g = np.arange(n, dtype=np.float32)
        sdf = np.broadcast_to((g - 2.3)[:, None, None], (n, n, n)).copy()
        verts, faces = self._mc(sdf, backend, truncation=1e9)
        np.testing.assert_allclose(verts[:, 0], 2.3, atol=1e-5)


def test_backends_agree():
    if _load_lib() is None:
        pytest.skip("native lib unavailable")
    sdf = sphere_sdf(24, 8.0)
    vn, fn = marching_cubes(sdf, backend="native")
    vp, fp = marching_cubes(sdf, backend="numpy")
    assert len(vn) == len(vp) and len(fn) == len(fp)
    # same vertex set (ordering may differ)
    sn = set(map(tuple, np.round(vn, 4)))
    sp = set(map(tuple, np.round(vp, 4)))
    assert sn == sp
    assert mesh_area(vn, fn) == pytest.approx(mesh_area(vp, fp), rel=1e-4)


class TestPly:
    def test_roundtrip_binary(self, tmp_path):
        verts = np.random.default_rng(0).normal(size=(10, 3)).astype(np.float32)
        faces = np.array([[0, 1, 2], [3, 4, 5]], dtype=np.int32)
        colors = np.random.default_rng(1).uniform(size=(10, 3)).astype(np.float32)
        p = str(tmp_path / "m.ply")
        write_ply(p, verts, faces, colors)
        v, f, c = read_ply(p)
        np.testing.assert_allclose(v, verts, rtol=1e-6)
        np.testing.assert_array_equal(f, faces)
        assert c is not None and c.shape == (10, 3)

    def test_roundtrip_ascii(self, tmp_path):
        verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], dtype=np.float32)
        faces = np.array([[0, 1, 2]], dtype=np.int32)
        p = str(tmp_path / "m.ply")
        write_ply(p, verts, faces, binary=False)
        v, f, c = read_ply(p)
        np.testing.assert_allclose(v, verts)
        np.testing.assert_array_equal(f, faces)
        assert c is None


class TestExtractChunking:
    """The dense-extraction queries chunk at EXTRACT_CHUNK points and
    zero-pad the tail chunk to a power-of-two family of static shapes
    (mesh/extract.py:_pad_rows). Chunked
    + padded results must be bit-identical to a single unchunked query."""

    def _mapper(self):
        from naruto_tpu.config import make_config
        from naruto_tpu.config.schema import deep_update
        from naruto_tpu.mapping.mapper import Mapper

        bound = ((-1.0, 1.0), (-1.0, 1.0), (-1.0, 1.0))
        cfg = make_config("Replica", "office0", num_iter=10)
        cfg = deep_update(cfg, {
            "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                    "cy": 11.5, "far": 5.0},
            "grid": {"n_levels": 4, "hash_size": 12, "voxel_sdf": 0.1},
            "mapper": {"sample": 64, "iters": 2, "first_iters": 2,
                       "min_pixels_cur": 4, "act_ray_num_uncert_sample": 8,
                       "bound": bound, "marching_cubes_bound": bound,
                       "voxel_size": 0.5},
            "training": {"n_samples_d": 8, "n_range_d": 5, "smooth_pts": 4},
        })
        return Mapper(cfg)

    def test_dense_sdf_chunked_equals_unchunked(self):
        from naruto_tpu.mesh.extract import _dense_sdf

        mapper = self._mapper()
        bound = np.asarray(mapper.cfg.mapper.marching_cubes_bound,
                           dtype=np.float32)
        # voxel 0.16 -> 13x13x13 = 2197 points: one full 1024 chunk plus
        # two tails (1024 + 149-pad), exercising multi-chunk AND padding
        big, bu, _ = _dense_sdf(mapper, bound, 0.16, chunk=1 << 22)
        sml, su, _ = _dense_sdf(mapper, bound, 0.16, chunk=1024)
        np.testing.assert_array_equal(big, sml)
        np.testing.assert_array_equal(bu, su)

    def test_query_colors_chunked_equals_unchunked(self):
        from naruto_tpu.mesh.extract import _query_colors

        mapper = self._mapper()
        rng = np.random.default_rng(3)
        verts = rng.uniform(-0.9, 0.9, size=(1500, 3)).astype(np.float32)
        big = _query_colors(mapper, verts, chunk=1 << 22)
        sml = _query_colors(mapper, verts, chunk=1024)
        np.testing.assert_array_equal(big, sml)

    def test_pad_rows_family(self):
        from naruto_tpu.mesh.extract import _pad_rows

        a = np.ones((1500, 3), np.float32)
        p = _pad_rows(a, 1 << 20)
        assert p.shape == (2048, 3)          # next power of two
        np.testing.assert_array_equal(p[:1500], a)
        assert (p[1500:] == 0).all()
        assert _pad_rows(a, 1024).shape == (1500, 3)   # cap: no shrink-pad
        assert _pad_rows(np.ones((7, 3), np.float32),
                         1 << 20).shape == (1024, 3)   # floor at 2**10
