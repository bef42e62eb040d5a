"""Capture a jax.profiler trace of the steady-state BA step (bench setup).

Run on a GPU: python scripts/profile_ba.py [--trace-dir /tmp/ba_trace]
Then inspect the .trace.json.gz with scripts/trace_summary.py.
"""
from __future__ import annotations

import argparse
import os as _os
import sys as _sys
import time

import numpy as np

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace-dir", default="/tmp/ba_trace")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from naruto_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from naruto_tpu.config import make_config
    from naruto_tpu.mapping.keyframes import add_keyframe
    from naruto_tpu.mapping.mapper import Mapper

    cfg = make_config("Replica", "office0")
    import os as _os
    _env = _os.environ.get("NARUTO_BENCH_CFG")
    if _env:
        import json as _json
        from naruto_tpu.config.schema import deep_update
        cfg = deep_update(cfg, _json.loads(_env))
    mapper = Mapper(cfg)
    H, W = mapper.H, mapper.W

    depth = np.full((H, W), 1.5, dtype=np.float32)
    u = np.linspace(0, 1, W, dtype=np.float32)
    color = np.stack([np.tile(u, (H, 1)),
                      np.full((H, W), 0.3, np.float32),
                      np.full((H, W), 0.6, np.float32)], axis=-1)
    c2w = np.eye(4, dtype=np.float32)

    frame_rays = mapper.frame_to_rays(color, depth)
    key = jax.random.PRNGKey(0)
    for s in range(22):
        key, k = jax.random.split(key)
        mapper.state = mapper.state._replace(
            kf=add_keyframe(mapper.state.kf, frame_rays,
                            s * cfg.mapper.keyframe_every, k))
    jax.block_until_ready(mapper.state.kf.rays)

    bucket = mapper._pick_bucket(int(mapper.state.kf.count))
    ba = mapper._get_ba_jit(bucket)

    t0 = time.perf_counter()
    mapper.state = ba(mapper.state, frame_rays, jnp.asarray(c2w), 110,
                      jax.random.PRNGKey(1))
    print("warmup (compile):", round(time.perf_counter() - t0, 1), "s")
    sink = float(jax.tree_util.tree_leaves(
        mapper.state.params["table"])[0].ravel()[0])

    jax.profiler.start_trace(args.trace_dir)
    for i in range(args.steps):
        mapper.state = ba(mapper.state, frame_rays, jnp.asarray(c2w),
                          110 + i, jax.random.PRNGKey(2 + i))
        sink += float(jax.tree_util.tree_leaves(
            mapper.state.params["table"])[0].ravel()[0])
    jax.profiler.stop_trace()
    print("trace written to", args.trace_dir, "sink", sink)


if __name__ == "__main__":
    main()
