"""Dump the compiled (post-optimization) HLO of the production BA step.

The device trace (scripts/trace_summary.py) names fused ops by their HLO
instruction names; this dump lets those names be matched to actual HLO
instructions (operand shapes + source metadata) so glue ops can be traced
back to the Python that emitted them. The compile reuses the persistent
cache bench.py fills.

Run on a GPU: python scripts/dump_ba_hlo.py > ba_hlo.txt
"""
from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from naruto_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from naruto_tpu.config import make_config
    from naruto_tpu.mapping.keyframes import add_keyframe
    from naruto_tpu.mapping.mapper import Mapper

    cfg = make_config("Replica", "office0")
    mapper = Mapper(cfg)
    H, W = mapper.H, mapper.W
    depth = np.full((H, W), 1.5, dtype=np.float32)
    color = np.full((H, W, 3), 0.5, dtype=np.float32)
    c2w = np.eye(4, dtype=np.float32)
    frame_rays = mapper.frame_to_rays(color, depth)
    key = jax.random.PRNGKey(0)
    for s in range(22):
        key, k = jax.random.split(key)
        mapper.state = mapper.state._replace(
            kf=add_keyframe(mapper.state.kf, frame_rays,
                            s * cfg.mapper.keyframe_every, k))
    bucket = mapper._pick_bucket(int(mapper.state.kf.count))
    ba = mapper._get_ba_jit(bucket)
    lowered = ba.lower(mapper.state, frame_rays, jnp.asarray(c2w), 110,
                       jax.random.PRNGKey(1))
    compiled = lowered.compile()
    print(compiled.as_text())


if __name__ == "__main__":
    main()
