"""YAML config tree + projection ops tests."""
import os

import jax.numpy as jnp
import numpy as np

from naruto_tpu.config import load_config
from naruto_tpu.geometry.projection import backproject, project, transform3d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestConfigTree:
    def test_all_scene_configs_load(self):
        import dataclasses
        import glob

        n = 0
        for ds in ("Replica", "MP3D", "NARUTO"):
            base = os.path.join(REPO, "configs", ds)
            for scene in sorted(os.listdir(base)):
                cfg = load_config(os.path.join(base, scene, "naruto.yaml"))
                assert cfg.general.dataset == ds
                assert cfg.general.scene == scene
                assert cfg.mapper.bound_np.shape == (3, 2)
                n += 1
        assert n == 16
        # EVERY shipped yaml (incl. parity + ablation overlays) must yield
        # a config whose sections are all live dataclasses — an empty
        # section once nulled cfg.decoder and crashed only at Mapper build
        for path in glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                              recursive=True):
            cfg = load_config(path)
            for f in dataclasses.fields(cfg):
                assert getattr(cfg, f.name) is not None, (path, f.name)

    def test_office0_yaml_matches_preset(self):
        cfg = load_config(os.path.join(REPO, "configs", "Replica", "office0",
                                       "naruto.yaml"))
        np.testing.assert_allclose(
            cfg.mapper.bound_np,
            [[-2.2, 2.6], [-3.4, 2.1], [-1.4, 2.0]])
        assert cfg.general.num_iter == 2000

    def test_inherit_from(self, tmp_path):
        base = tmp_path / "base.yaml"
        base.write_text("dataset: Replica\nscene: room0\n"
                        "mapper:\n  iters: 7\n")
        child = tmp_path / "child.yaml"
        child.write_text(f"inherit_from: {base}\nmapper:\n  sample: 99\n")
        cfg = load_config(str(child))
        assert cfg.mapper.iters == 7 and cfg.mapper.sample == 99
        assert cfg.general.scene == "room0"


class TestProjection:
    def test_backproject_project_roundtrip(self):
        K = jnp.asarray([[50.0, 0, 15.5], [0, 50.0, 11.5], [0, 0, 1.0]])
        inv_K = jnp.linalg.inv(K)
        depth = jnp.full((24, 32), 2.0)
        pts = backproject(depth, inv_K)
        assert pts.shape == (4, 24 * 32)
        uv = project(pts, K)
        u, v = jnp.meshgrid(jnp.arange(32.0), jnp.arange(24.0), indexing="xy")
        np.testing.assert_allclose(np.asarray(uv[:, 0]),
                                   np.asarray(u.reshape(-1)), atol=1e-4)
        np.testing.assert_allclose(np.asarray(uv[:, 1]),
                                   np.asarray(v.reshape(-1)), atol=1e-4)

    def test_transform(self):
        T = jnp.eye(4).at[:3, 3].set(jnp.asarray([1.0, 2, 3]))
        p = jnp.asarray([[0.0], [0], [0], [1]])
        out = transform3d(T, p)
        np.testing.assert_allclose(np.asarray(out[:3, 0]), [1, 2, 3])


def test_parity_config_restores_reference_numerics():
    """configs/parity.yaml pins the exact tcnn layout + fp32 math."""
    import pathlib

    from naruto_tpu.config import load_config

    root = pathlib.Path(__file__).resolve().parents[1]
    cfg = load_config(str(root / "configs" / "parity.yaml"))
    assert cfg.grid.layout == "vertex"
    assert cfg.grid.n_levels == 16
    assert cfg.grid.n_features_per_level == 2
    assert cfg.grid.table_dtype == "float32"
    # and the shipped default is the fast path
    from naruto_tpu.config import make_config
    assert make_config("Replica", "office0").grid.layout == "hybrid"
    # every config section survives the overlay as a dataclass (an empty
    # YAML section parses to None and must mean "no overrides", not
    # "replace the subtree with None" — regression: a dangling `decoder:`
    # nulled cfg.decoder and crashed Mapper construction)
    import dataclasses
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) is not None, f.name


def test_empty_yaml_section_is_noop(tmp_path):
    from naruto_tpu.config import load_config

    p = tmp_path / "exp.yaml"
    p.write_text("dataset: Replica\nscene: office0\ndecoder:\ngrid:\n")
    cfg = load_config(str(p))
    assert cfg.decoder is not None and cfg.grid is not None
    assert cfg.decoder.geo_feat_dim >= 0


def test_empty_section_in_inherit_merge(tmp_path):
    """A dangling section on either side of inherit_from means 'no
    overrides' — it must neither null inherited overrides nor crash."""
    from naruto_tpu.config import load_config

    base = tmp_path / "base.yaml"
    base.write_text("dataset: Replica\nscene: office0\n"
                    "decoder: {geo_feat_dim: 31}\n")
    child = tmp_path / "child.yaml"
    child.write_text(f"inherit_from: {base}\ndecoder:\n")
    assert load_config(str(child)).decoder.geo_feat_dim == 31

    base2 = tmp_path / "base2.yaml"
    base2.write_text("dataset: Replica\nscene: office0\ndecoder:\n")
    child2 = tmp_path / "child2.yaml"
    child2.write_text(f"inherit_from: {base2}\n"
                      "decoder: {geo_feat_dim: 29}\n")
    assert load_config(str(child2)).decoder.geo_feat_dim == 29


def test_shipped_preset_semantics():
    """Pin the knobs the shipped overlay presets exist to set: a silent
    key rename in the schema must fail HERE, not mid-run on hardware.
    turbo composition: configs/turbo.yaml."""
    from naruto_tpu.config import load_config

    turbo = load_config(os.path.join(REPO, "configs", "turbo.yaml"))
    assert turbo.training.smooth_every == 5
    assert turbo.training.n_samples_d == 12
    assert turbo.general.scene == "office0"  # inherits the scene config

    explore = load_config(
        os.path.join(REPO, "configs", "ab", "office0_explore.yaml"))
    assert explore.planner.goal_repeat_penalty == 1.0

    decay = load_config(
        os.path.join(REPO, "configs", "ab", "office0_decay.yaml"))
    assert decay.planner.trav_mask_decay == 10

    # composed livelock rescue (PERFORMANCE.md "Rescue trial 2":
    # seed_1999 74.59 -> 99.30% ratio) — both flags must land together
    rescue = load_config(
        os.path.join(REPO, "configs", "ab", "office0_rescue.yaml"))
    assert rescue.planner.collision_sim_override == 0.05
    assert rescue.planner.goal_repeat_penalty == 1.0
