"""chip_smoke.py off the card: its comparison helpers at tiny widths, its
refusal to run without a GPU (bench.py's too), and the import set of the
preset path it drives. The full-width comparisons are `gpu`-marked."""
import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cs():
    return _load("chip_smoke")


@pytest.fixture(scope="module")
def tiny_mapper():
    from naruto_tpu.config.schema import deep_update
    from naruto_tpu.mapping.mapper import Mapper

    ge = _load("__graft_entry__")
    cfg = deep_update(ge.tiny_mapper_config(1), {
        "parallel": {"shard_rays": False, "shard_volumes": False}})
    return Mapper(cfg)


def _tiny_spec(**kw):
    from naruto_tpu.ops.encoding import HashGridSpec

    d = dict(n_levels=3, log2_table_size=10, base_resolution=4,
             finest_resolution=16, layout="hybrid", gather_dtype="bfloat16",
             sort_carry="frac")
    d.update(kw)
    return HashGridSpec(**d)


@pytest.mark.parametrize("which", ["hash_encode", "segment_sums", "trilerp",
                                   "loss_grads"])
def test_comparisons_within_bounds_tiny(cs, tiny_mapper, which):
    """Each on-card comparison passes its stated bound on the CPU at a
    tiny width, and reports finite errors for every row."""
    if which == "hash_encode":
        rows = cs.compare_hash_encode(_tiny_spec(), 300)
        assert len(rows) == 4          # forward + 3 hybrid table leaves
    elif which == "segment_sums":
        rows = cs.compare_segment_sums(_tiny_spec(), 300)
        assert len(rows) == 4
    elif which == "trilerp":
        rows = cs.compare_trilerp((6, 7, 5), 300)
        assert len(rows) == 2
    else:
        rows = cs.compare_loss_grads(tiny_mapper, 64)
        assert {r[0] for r in rows} >= {"render + total_loss value",
                                        "loss gradient [table]"}
    cs.report(rows)                    # raises CheckFailed over a bound


def test_report_fails_over_bound(cs):
    with pytest.raises(cs.CheckFailed):
        cs.report([("x", 2e-3, 1e-3)])
    with pytest.raises(cs.CheckFailed):
        cs.report([("nan", float("nan"), 1.0)])


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_exits_nonzero_without_gpu(script):
    """On a machine without a GPU both scripts fail with a message and
    print no result line — they never fall back to the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no GPU found" in out.stderr
    assert '"ok"' not in out.stdout and "metric" not in out.stdout


ENGINE_IMPORTS = r"""
import sys
from naruto_tpu.config import make_config
from naruto_tpu.config.schema import deep_update
from naruto_tpu.system.engine import Engine
cfg = deep_update(make_config("Replica", "office0", num_iter=6), {
    "cam": {"H": 24, "W": 32, "fx": 16.0, "fy": 16.0, "cx": 15.5,
            "cy": 11.5, "far": 3.0},
    "sim": {"pinhole_hw": (24, 32), "erp_hw": (16, 32)},
    "grid": {"hash_size": 10},
    "mapper": {"sample": 32, "iters": 1, "first_iters": 2,
               "min_pixels_cur": 8, "act_ray_num_uncert_sample": 8},
    "training": {"n_range_d": 3, "n_samples_d": 4, "smooth_pts": 4},
    "mesh": {"voxel_final": 0.2, "voxel_eval": 0.2},
    "general": {"result_dir": sys.argv[1]},
})
engine = Engine(cfg, quiet=True)
engine.run()
engine.finalize()
print(" ".join(sorted(m for m in ("yaml", "cv2", "matplotlib", "PIL")
                      if m in sys.modules)) or "none")
"""


def test_preset_engine_run_imports_no_extra_packages(tmp_path):
    """A tiny preset Engine run (sim -> map -> plan -> finalize + eval)
    loads none of PyYAML, cv2, matplotlib or PIL: the card's host is sure
    to have only numpy, scipy, optax, chex, einops, pytest and hypothesis
    besides JAX."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    out = subprocess.run(
        [sys.executable, "-c", ENGINE_IMPORTS, str(tmp_path / "run")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "none"
    assert (tmp_path / "run" / "Replica" / "office0"
            / "eval_result.txt").exists()


@pytest.mark.gpu
def test_reference_comparisons_office0_width(cs, gpu_device):
    """The on-card reference comparisons at the shipped office0 widths
    (run on the card; chip_smoke.py runs the same phase)."""
    assert gpu_device.platform == "gpu"
    cs.reference_phase(cs.office0_config(30))
