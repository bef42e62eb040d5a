"""NARUTO-TPU: active neural reconstruction in JAX.

A ground-up JAX/XLA re-design of the capabilities of
oppo-us-research/NARUTO (CVPR 2024): an embodied agent actively explores a 3D
scene, builds a neural implicit surface (SDF + color + uncertainty) with a
Co-SLAM-style mapper, and plans next-best-views by aggregating predicted
uncertainty over a goal space.

Layer map (mirrors reference SURVEY.md L0-L10):
  config/        typed dataclass config tree (ref: configs/ + cfg_loader.py)
  geometry/      camera rays, pose math, ERP conversions (ref: src/layers/)
  ops/           hash-grid / one-blob / grid-sample / MLP / segment-sum ops
  mapping/       neural field, renderer, losses, keyframes, mapper
                 (ref: src/slam/coslam/)
  planner/       FSM, uncertainty aggregation, RRT, rotation planning
                 (ref: src/planner/)
  sim/           simulator interface + analytic / replay / C++ raycast backends
                 (ref: src/simulator/)
  mesh/          marching cubes (C++ ext + numpy fallback), mesh extraction
  evaluation/    accuracy/completion/MAD/trajectory metrics + mesh culling
  visualization/ artifact saver (same directory contract as the reference)
  parallel/      jax.sharding mesh helpers, sharded field eval
  system/        engine: the sim->map->plan loop (ref: src/naruto/main.py)
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API (imports pull in jax; keep module import light)."""
    if name == "Engine":
        from naruto_tpu.system.engine import Engine
        return Engine
    if name == "Mapper":
        from naruto_tpu.mapping.mapper import Mapper
        return Mapper
    if name == "make_config":
        from naruto_tpu.config import make_config
        return make_config
    if name == "load_config":
        from naruto_tpu.config import load_config
        return load_config
    raise AttributeError(name)
