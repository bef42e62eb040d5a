"""Benchmark: steady-state mapping-iteration throughput on real hardware.

Measures the reference's hot loop (SURVEY.md §3.2 / BASELINE.md): one global-
BA mapping step = `mapping.iters`(10) iterations of {sample 8192+cur rays from
the keyframe DB, active-ray resample to 2048+~100, render 43 samples/ray
through the hash-grid field, all losses, backward, Adam} at full Replica
office0 settings (680x1200 frames, 16-level hash grid, uncertainty grid).

Baseline: the reference publishes no numbers (BASELINE.md); the RTX-3090
reference workload is estimated at ~100 mapping iters/sec (10 ms per
iteration of ~2148 rays x 43 samples fwd+bwd through tcnn — consistent with
Co-SLAM's reported real-time rates at identical settings). vs_baseline is
measured iters/sec divided by that estimate; the >=5x target means
vs_baseline >= 5.
"""
from __future__ import annotations

import json
import time

import numpy as np

BASELINE_ITERS_PER_SEC = 100.0  # RTX 3090 estimate (see module docstring)


def _require_gpu():
    """The benchmark measures the card: with no GPU it exits non-zero and
    prints no result line (it never falls back to the CPU)."""
    import sys

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py: no GPU found (JAX platform "
                 f"{devs[0].platform!r}); nothing measured")
    return devs


def _measure(cfg, n_steps: int) -> dict:
    """Build a Mapper at `cfg`, drive the keyframe DB to steady state, and
    time `n_steps` chained BA steps. Returns the measurement dict."""
    import os
    import time

    import jax
    import jax.numpy as jnp

    from naruto_tpu.mapping.mapper import Mapper

    mapper = Mapper(cfg)
    H, W = mapper.H, mapper.W

    # synthetic wall frame at full sensor resolution
    depth = np.full((H, W), 1.5, dtype=np.float32)
    u = np.linspace(0, 1, W, dtype=np.float32)
    color = np.stack([np.tile(u, (H, 1)),
                      np.full((H, W), 0.3, np.float32),
                      np.full((H, W), 0.6, np.float32)], axis=-1)
    c2w = np.eye(4, dtype=np.float32)

    # populate the keyframe DB to steady state (>20 KFs -> smallest bucket)
    from naruto_tpu.mapping.keyframes import add_keyframe
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

    # warmup (compile)
    t0 = time.perf_counter()
    mapper.state = ba(mapper.state, frame_rays, jnp.asarray(c2w), 110,
                      jax.random.PRNGKey(1))
    jax.block_until_ready(
        jax.tree_util.tree_leaves(mapper.state.params["table"])[0])
    compile_s = time.perf_counter() - t0

    # untimed settle chain before the window (NARUTO_BENCH_SETTLE
    # overrides the length; 0 for quick smoke benches)
    for i in range(int(os.environ.get("NARUTO_BENCH_SETTLE", "10"))):
        mapper.state = ba(mapper.state, frame_rays, jnp.asarray(c2w),
                          100 + i, jax.random.PRNGKey(100 + i))
    float(jax.tree_util.tree_leaves(
        mapper.state.params["table"])[0].ravel()[0])

    # timed steps: each step consumes the previous step's state, so one
    # scalar pull after the chain waits for every step, while dispatch of
    # step i+1 overlaps device execution of step i
    t0 = time.perf_counter()
    for i in range(n_steps):
        mapper.state = ba(mapper.state, frame_rays, jnp.asarray(c2w),
                          110 + i, jax.random.PRNGKey(2 + i))
    sink = float(jax.tree_util.tree_leaves(
        mapper.state.params["table"])[0].ravel()[0])
    elapsed = time.perf_counter() - t0

    iters = n_steps * cfg.mapper.iters
    iters_per_sec = iters / elapsed
    rays_per_iter = cfg.mapper.sample + bucket // 4
    rays_per_sec = iters_per_sec * rays_per_iter

    return {
        "iters_per_sec": iters_per_sec,
        "rays_per_sec": round(rays_per_sec, 1),
        "rays_per_iter": rays_per_iter,
        "samples_per_ray": mapper.rc.n_samples,
        "bucket": bucket,
        "compile_s": round(compile_s, 1),
    }


def main() -> None:
    import os

    devs = _require_gpu()

    from naruto_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from naruto_tpu.config import make_config
    from naruto_tpu.config.schema import deep_update

    cfg = make_config("Replica", "office0")
    # optional experiment overrides, e.g.
    #   NARUTO_BENCH_CFG='{"grid": {"layout": "cell"}}' python bench.py
    # A/B runs stay single-graph: the turbo extra row is skipped.
    env_over = os.environ.get("NARUTO_BENCH_CFG")
    if env_over:
        cfg = deep_update(cfg, json.loads(env_over))

    # 60 chained steps (600 iterations)
    n_steps = int(os.environ.get("NARUTO_BENCH_STEPS", "60"))
    parity = _measure(cfg, n_steps)
    iters_per_sec = parity.pop("iters_per_sec")

    result = {
        "metric": "mapping_iters_per_sec",
        "value": round(iters_per_sec, 2),
        "unit": "iters/s",
        "vs_baseline": round(iters_per_sec / BASELINE_ITERS_PER_SEC, 3),
        "extra": {**parity, "device": {
            "platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}},
    }

    # Turbo extra row (configs/turbo.yaml): reported alongside — never AS —
    # the parity headline. Warm-gated: only measured when the parity graph
    # came out of the persistent cache (compile_s < 60 s), so a cold run
    # pays one compile. NARUTO_BENCH_TURBO=1/0 forces/disables.
    turbo_env = os.environ.get("NARUTO_BENCH_TURBO")
    want_turbo = (turbo_env == "1") if turbo_env is not None else (
        env_over is None and parity["compile_s"] < 60.0)
    if want_turbo:
        tcfg = deep_update(cfg, {
            "training": {"smooth_every": 5, "n_samples_d": 12}})
        turbo = _measure(tcfg, n_steps)
        result["extra"]["turbo"] = {
            "iters_per_sec": round(turbo["iters_per_sec"], 2),
            "vs_baseline": round(
                turbo["iters_per_sec"] / BASELINE_ITERS_PER_SEC, 3),
            "compile_s": turbo["compile_s"],
        }

    print(json.dumps(result))


if __name__ == "__main__":
    main()
