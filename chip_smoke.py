"""Smoke check of the mapper and the active loop on NVIDIA GPUs.

    python chip_smoke.py           # one GPU
    python chip_smoke.py --four    # the sharded BA path over four GPUs

One process drives everything in-process (a second JAX process could not
get the card's memory). With one GPU the phases are:

  device     platform, device kind, count, JAX version, nvidia-smi name and
             power limit, compile-cache directory;
  reference  the shipped Replica office0 field at real widths (hybrid
             4x8 hash grid, bf16 gathers, frac sort carry, 2x32 MLPs,
             uncertainty grid; the BA step's point count) against plain
             float32 references computed under
             jax.default_matmul_precision("highest"): hash-encode forward
             and VJP, the segment sums, the uncertainty-grid sampler VJP,
             and render + losses with their gradient; plus timings of the
             segment-sum backward against jax.ops.segment_sum;
  ba         Mapper(office0) at 680x1200 with a steady-state keyframe DB:
             compile every CUR_BUCKETS variant, run chained BA steps, print
             step time, memory and check finiteness and a falling loss;
  loop       naruto_tpu.run.main on Replica office0 (analytic simulator,
             shipped defaults) for 30 steps, through finalize and the eval
             row.

With --four only the sharded path runs: one office0 BA step sharded over
four cards (parallel.shard_rays + shard_volumes) against the same step on
card 0 alone, then a short sharded Engine loop.

Any failed check exits non-zero. The last line of standard output is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# third-party top-level modules the preset path must never import (the
# card's host has only jax, numpy, scipy, optax, chex, einops, pytest and
# hypothesis for certain)
FORBIDDEN_MODULES = ("yaml", "cv2", "matplotlib", "PIL", "torch", "trimesh",
                     "open3d")

# active-loop steps: first-frame mapping, five BA rounds, a plan and its
# pursuit. The BA phase builds its Mapper with the same config, so the
# loop's BA programs come out of the persistent compile cache.
LOOP_STEPS = 30


class CheckFailed(RuntimeError):
    pass


# ----------------------------------------------------------------- helpers
def rel_err(got, ref, scale=None) -> float:
    """max |got - ref| over max |ref| (or over `scale`), across a pytree."""
    import jax

    gl = jax.tree_util.tree_leaves(got)
    rl = jax.tree_util.tree_leaves(ref)
    num = max(float(np.abs(np.asarray(g, np.float64)
                           - np.asarray(r, np.float64)).max(initial=0.0))
              for g, r in zip(gl, rl))
    if scale is None:
        scale = max(float(np.abs(np.asarray(r, np.float64)).max(initial=0.0))
                    for r in rl)
    return num / max(scale, 1e-30)


def report(rows) -> None:
    """Print (name, err, bound) rows; raise if any err exceeds its bound
    or is not finite."""
    bad = []
    for name, err, bound in rows:
        ok = bool(np.isfinite(err) and err <= bound)
        print(f"  {name:<46s} err={err:.3e}  bound={bound:.2e}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(name)
    if bad:
        raise CheckFailed(f"comparisons over their bounds: {bad}")


def time_fn(fn, *args, reps: int = 20) -> float:
    """Median wall time of fn(*args) after one warm-up call (seconds)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def ba_points(mapper, bucket: int = 512) -> int:
    """Field points of one BA iteration: rendered rays x samples plus the
    smoothness lattice riding the same encode."""
    m, lw = mapper.cfg.mapper, mapper.lw
    rays = m.sample + bucket // 4
    smooth = (lw.smooth_pts - 1) ** 3 if (lw.smooth > 0
                                          and not lw.smooth_sample) else 0
    return rays * mapper.rc.n_samples + smooth


def _random_table(spec, seed: int):
    """A table with O(1) values (the ±1e-4 init would make every
    comparison one of rounding noise on near-zero numbers)."""
    import jax

    from naruto_tpu.ops.encoding import init_hash_table

    return jax.tree_util.tree_map(
        lambda t: t * 1e4, init_hash_table(jax.random.PRNGKey(seed), spec))


def _ref_encode(table, x, spec):
    """Plain float32 take-based encode (autodiff gives the scatter-add
    backward) — the reference for hash_encode and its custom VJP."""
    import jax.numpy as jnp

    from naruto_tpu.ops.encoding import (_cell_indices, _corner_indices,
                                         derived_gather_table)

    n, L, F = x.shape[0], spec.n_levels, spec.n_features
    if spec.layout == "hybrid":
        rows = derived_gather_table(table, spec, jnp.float32)
    else:
        rows = table.astype(jnp.float32)
    if spec.cell_rows:
        idx, w = _cell_indices(x, spec)
        feats = jnp.take(rows, idx.reshape(-1), axis=0)
    else:
        idx, w = _corner_indices(x, spec)
        feats = jnp.take(rows, idx, axis=0)
    feats = feats.reshape(n, L, 8, F)
    return jnp.sum(feats * w[..., None], axis=2).reshape(n, L * F)


# -------------------------------------------------------------- comparisons
def compare_hash_encode(spec, n_points: int, seed: int = 0,
                        info: dict | None = None):
    """hash_encode forward and custom VJP vs the plain float32 reference.

    Forward bound: with bf16 gathers each corner term w_c * f_c carries
    three bf16 roundings (table value, weight, product; unit roundoff
    2^-8 each), and the weights are a convex combination, so the error is
    at most (1 + 2^-8)^3 - 1 of max |table| (the error is normalized by
    that; 1e-6 more covers the f32 sums).
    Table-gradient bound: 6e-3 relative to the max for the weight carry
    (bf16 packing of the sort payloads), 1.2e-2 for the frac carry (adds
    the 10-bit frac quantization) — the bounds the CPU tests hold."""
    import jax
    import jax.numpy as jnp

    from naruto_tpu.ops.encoding import hash_encode

    kx, kg = jax.random.split(jax.random.PRNGKey(seed + 1))
    x = jax.random.uniform(kx, (n_points, 3), minval=0.02, maxval=0.98)
    g = jax.random.normal(kg, (n_points, spec.output_dim))
    table = _random_table(spec, seed)

    @jax.jit
    def prog(t, g):
        out, vjp = jax.vjp(lambda tt: hash_encode(tt, x, spec), t)
        return out, vjp(g)[0]

    with jax.default_matmul_precision("highest"):
        @jax.jit
        def ref(t, g):
            out, vjp = jax.vjp(lambda tt: _ref_encode(tt, x, spec), t)
            return out, vjp(g)[0]

        r_out, r_gt = ref(table, g)
    out, gt = prog(table, g)
    tmax = max(float(jnp.abs(t).max()) for t in jax.tree_util.tree_leaves(
        table))
    f_bound = ((1 + 2.0 ** -8) ** 3 - 1 + 1e-6
               if spec.gather_dtype != "float32" else 1e-5)
    g_bound = 1.2e-2 if (spec.cell_rows and spec.sort_carry == "frac") \
        else 6e-3
    rows = [("hash_encode forward (/max|table|)",
             rel_err(out, r_out, scale=tmax), f_bound)]
    for name, a, b in zip(
            [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(gt)[0]],
            jax.tree_util.tree_leaves(gt), jax.tree_util.tree_leaves(r_gt)):
        rows.append((f"hash_encode VJP table{name}", rel_err(a, b),
                     g_bound))
    if info is not None:
        # entries the reference gives a nonzero gradient, and the share of
        # them whose sort-path gradient has the other sign (Adam steps by
        # the sign of a small gradient, whatever its size)
        a = np.concatenate([np.asarray(v).ravel()
                            for v in jax.tree_util.tree_leaves(gt)])
        b = np.concatenate([np.asarray(v).ravel()
                            for v in jax.tree_util.tree_leaves(r_gt)])
        nz = b != 0
        info["grad_entries_nonzero"] = int(nz.sum())
        info["grad_sign_mismatch_frac"] = float(
            (np.sign(a[nz]) != np.sign(b[nz])).mean())
    return rows


def segment_inputs(spec, n_points: int, seed: int = 0):
    """Hash-grid backward inputs at the BA step's shapes: per-level slot
    ids and fracs of random points, a random embedding cotangent."""
    import jax

    from naruto_tpu.ops.encoding import _cell_indices, _cell_pos

    kx, kg = jax.random.split(jax.random.PRNGKey(seed + 2))
    x = jax.random.uniform(kx, (n_points, 3))
    idx, w = _cell_indices(x, spec)                   # [N, L], [N, L, 8]
    _, frac = _cell_pos(x, spec)                      # [N, L, 3]
    g = jax.random.normal(kg, (n_points, spec.output_dim))
    return idx, w, frac, g


def compare_segment_sums(spec, n_points: int, seed: int = 0):
    """dense_segment_sum / dense_segment_sum_outer* vs jax.ops.segment_sum
    of the same float32 updates. The sort path sums in another order than
    the reference (whose scatter-add runs as atomics, in a run-to-run
    order on the GPU), so only a tolerance compares them: 1e-4 relative
    to the max for the f32 payload; 5e-3 where payloads are bf16-packed
    (one rounding of unit roundoff 2^-8 per factor and of the product,
    errors of opposite sign cancelling within a slot — the CPU tests'
    bound); 1.2e-2 for the frac carry (adds the 10-bit frac quantization
    of the corner weights)."""
    import jax
    import jax.numpy as jnp

    from naruto_tpu.ops.encoding import _corner_weights
    from naruto_tpu.ops.segment import (
        dense_segment_sum, dense_segment_sum_outer,
        dense_segment_sum_outer_level_major_frac)

    idx, w, frac, g = segment_inputs(spec, n_points, seed)
    n, L, F = n_points, spec.n_levels, spec.n_features
    size = spec.total_entries
    # level-major flatten (the order the backward itself uses)
    idx_f = idx.T.reshape(-1)
    w_f = jnp.transpose(w, (1, 0, 2)).reshape(-1, 8)
    g_f = jnp.transpose(g.reshape(n, L, F), (1, 0, 2)).reshape(-1, F)
    upd = (w_f[:, :, None] * g_f[:, None, :]).reshape(-1, 8 * F)
    wq = _corner_weights(frac)                         # unquantized f32

    with jax.default_matmul_precision("highest"):
        ref_g = jax.jit(lambda v: jax.ops.segment_sum(
            v, idx_f, num_segments=size))(g_f)
        ref_o = jax.jit(lambda u: jax.ops.segment_sum(
            u, idx_f, num_segments=size))(upd)
        wq_f = jnp.transpose(wq, (1, 0, 2)).reshape(-1, 8)
        ref_q = jax.jit(lambda u: jax.ops.segment_sum(
            u, idx_f, num_segments=size))(
            (wq_f[:, :, None] * g_f[:, None, :]).reshape(-1, 8 * F))

    f32 = jax.jit(lambda v: dense_segment_sum(idx_f, v, size,
                                              pack_bf16=False))(g_f)
    b16 = jax.jit(lambda v: dense_segment_sum(idx_f, v, size,
                                              pack_bf16=True))(g_f)
    outer = jax.jit(lambda a, b: dense_segment_sum_outer(
        idx_f, a, b, size))(w_f, g_f)
    lmf = jax.jit(lambda fr, gg: dense_segment_sum_outer_level_major_frac(
        idx, fr, gg, size))(frac, g)
    return [
        ("dense_segment_sum f32 payload", rel_err(f32, ref_g), 1e-4),
        ("dense_segment_sum bf16 payload", rel_err(b16, ref_g), 5e-3),
        ("dense_segment_sum_outer", rel_err(outer, ref_o), 5e-3),
        ("dense_segment_sum_outer_level_major_frac", rel_err(lmf, ref_q),
         1.2e-2),
    ]


def compare_trilerp(vol_shape, n_points: int, seed: int = 0):
    """Uncertainty-grid sampler (align_corners=False, as the field samples
    it) and its custom VJP vs a plain 8-corner float32 reference whose
    autodiff backward is a scatter-add. Both are f32 end to end: forward
    1e-5 and gradient 1e-4 relative to the max (summation order only)."""
    import jax
    import jax.numpy as jnp

    from naruto_tpu.ops.grid_sample import trilinear_sample

    kv, kp, kg = jax.random.split(jax.random.PRNGKey(seed + 3), 3)
    vol = jax.random.normal(kv, tuple(vol_shape))
    pts = jax.random.uniform(kp, (n_points, 3))
    g = jax.random.normal(kg, (n_points,))

    def ref(v):
        shape = jnp.asarray(v.shape, jnp.float32)
        grid = pts * 2.0 - 1.0                   # torch grid_sample coords
        coords = ((grid + 1.0) * shape - 1.0) / 2.0
        c = jnp.clip(coords, 0.0, shape - 1.0)
        i0 = jnp.clip(jnp.floor(c).astype(jnp.int32), 0,
                      jnp.asarray(v.shape, jnp.int32) - 2)
        f = c - i0
        out = 0.0
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    wgt = ((f[:, 0] if dx else 1 - f[:, 0])
                           * (f[:, 1] if dy else 1 - f[:, 1])
                           * (f[:, 2] if dz else 1 - f[:, 2]))
                    out += wgt * v[i0[:, 0] + dx, i0[:, 1] + dy,
                                   i0[:, 2] + dz]
        return out

    def fwd_bwd(f):
        def run(v, g):
            out, vjp = jax.vjp(f, v)
            return out, vjp(g)[0]
        return jax.jit(run)

    with jax.default_matmul_precision("highest"):
        r_out, r_gv = fwd_bwd(ref)(vol, g)
    out, gv = fwd_bwd(lambda v: trilinear_sample(v, pts))(vol, g)
    return [("uncertainty-grid sample forward", rel_err(out, r_out), 1e-5),
            ("uncertainty-grid sample VJP", rel_err(gv, r_gv), 1e-4)]


def wall_frame(mapper, depth: float = 1.5):
    """Synthetic full-sensor RGB-D frame of a fronto-parallel wall."""
    H, W = mapper.H, mapper.W
    d = np.full((H, W), depth, dtype=np.float32)
    u = np.linspace(0, 1, W, dtype=np.float32)
    color = np.stack([np.tile(u, (H, 1)),
                      np.full((H, W), 0.3, np.float32),
                      np.full((H, W), 0.6, np.float32)], axis=-1)
    return color, d


def loss_batch(mapper, n_rays: int, seed: int = 0):
    """A BA-shaped ray batch from the wall frame at the identity pose."""
    import jax
    import jax.numpy as jnp

    from naruto_tpu.mapping.mapper import _transform_rays

    color, depth = wall_frame(mapper)
    frame_rays = mapper.frame_to_rays(color, depth)
    idx = jax.random.randint(jax.random.PRNGKey(seed + 4), (n_rays,), 0,
                             frame_rays.shape[0])
    pose = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (n_rays, 4, 4))
    rays_o, rays_d, rgb, d = _transform_rays(frame_rays[idx], pose)
    return rays_o, rays_d, rgb, d, jnp.ones((n_rays,), jnp.float32)


def compare_loss_grads(mapper, n_rays: int, seed: int = 0):
    """render_rays + total_loss (with the smoothness rider) and the
    gradient w.r.t. every parameter, against the same code traced under
    jax.default_matmul_precision("highest"). The GPU runs f32 matmuls in
    TF32 by default (operands rounded to 10 mantissa bits, 2^-11
    relative); the two 2-layer MLPs compound a few such roundings forward
    and backward, and a rounding can flip a ReLU or truncation mask, so
    the bounds are 5e-3 for the loss and 2e-2 relative to the max for
    each parameter group's gradient."""
    import jax

    batch = loss_batch(mapper, n_rays, seed)
    key = jax.random.PRNGKey(seed + 5)
    params = mapper.state.params

    def lg(p, k, *b):
        (loss, _), grads = jax.value_and_grad(
            mapper._loss_fn, has_aux=True)(p, k, *b, True)
        return loss, grads

    loss, grads = jax.jit(lg)(params, key, *batch)
    with jax.default_matmul_precision("highest"):
        r_loss, r_grads = jax.jit(lg)(params, key, *batch)
    rows = [("render + total_loss value", rel_err(loss, r_loss), 5e-3)]
    for k in sorted(grads):
        rows.append((f"loss gradient [{k}]", rel_err(grads[k], r_grads[k]),
                     2e-2))
    return rows


def segment_timings(spec, n_points: int, seed: int = 0) -> dict:
    """Times of the hash-grid backward pieces at the BA step's M: the XLA
    tail of the sort path, the whole frac-carry segment sum, and
    jax.ops.segment_sum of the same updates (precomputed, and expanded
    from the two factors inside the program)."""
    import jax
    import jax.numpy as jnp

    from naruto_tpu.ops.segment import (
        _outer_from_sorted, dense_segment_sum_outer_level_major_frac)

    idx, w, frac, g = segment_inputs(spec, n_points, seed)
    n, L, F = n_points, spec.n_levels, spec.n_features
    size = spec.total_entries
    m = n * L
    idx_f = idx.T.reshape(-1)
    w_f = jnp.transpose(w, (1, 0, 2)).reshape(-1, 8)
    g_f = jnp.transpose(g.reshape(n, L, F), (1, 0, 2)).reshape(-1, F)
    upd = (w_f[:, :, None] * g_f[:, None, :]).reshape(m, 8 * F)
    si = jnp.sort(idx_f)
    sa = w_f.astype(jnp.bfloat16)
    sb = g_f.astype(jnp.bfloat16)

    tail = jax.jit(lambda s, a, b: _outer_from_sorted(s, a, b, 8, F, size))
    whole = jax.jit(lambda i, fr, gg:
                    dense_segment_sum_outer_level_major_frac(i, fr, gg,
                                                             size))
    seg = jax.jit(lambda u, i: jax.ops.segment_sum(u, i,
                                                   num_segments=size))
    seg_fac = jax.jit(lambda a, b, i: jax.ops.segment_sum(
        (a[:, :, None] * b[:, None, :]).reshape(a.shape[0], -1), i,
        num_segments=size))
    cumsum = jax.jit(lambda u: jnp.cumsum(u, axis=0))
    copy = jax.jit(lambda u: u * 2.0)
    cs_hlo = cumsum.lower(upd).compile().as_text()
    return {
        "rows_M": m, "slots": size,
        "tail_s": time_fn(tail, si, sa, sb),
        "frac_backward_s": time_fn(whole, idx, frac, g),
        "segment_sum_s": time_fn(seg, upd, idx_f),
        "segment_sum_from_factors_s": time_fn(seg_fac, w_f, g_f, idx_f),
        "cumsum_Mx64_s": time_fn(cumsum, upd),
        "scale_Mx64_s": time_fn(copy, upd),
        "cumsum_has_reduce_window": "reduce-window" in cs_hlo,
    }


# ------------------------------------------------------------------- phases
def device_phase(n_devices: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU found (JAX platform "
                 f"{devs[0].platform!r}); nothing measured")
    if len(devs) < n_devices:
        sys.exit(f"chip_smoke: needs {n_devices} GPUs, found {len(devs)}")
    print(f"[device] platform={devs[0].platform} "
          f"kind={devs[0].device_kind} count={len(devs)} "
          f"jax={jax.__version__}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=120, check=True)
    for line in smi.stdout.strip().splitlines():
        print(f"[device] nvidia-smi: {line.strip()}", flush=True)

    from naruto_tpu.utils.cache import enable_compilation_cache

    print(f"[device] compile cache: {enable_compilation_cache()}",
          flush=True)
    return devs


def office0_config(num_iter: int, **parallel):
    from naruto_tpu.config import make_config
    from naruto_tpu.config.schema import deep_update

    cfg = make_config("Replica", "office0", num_iter=num_iter)
    if parallel:
        cfg = deep_update(cfg, {"parallel": parallel})
    return cfg


def reference_phase(cfg) -> dict:
    from naruto_tpu.mapping.mapper import Mapper

    mapper = Mapper(cfg)
    spec = mapper.spec.hash_spec
    n = ba_points(mapper)
    print(f"[reference] office0 field: layout={spec.layout} "
          f"L={spec.n_levels} F={spec.n_features} "
          f"log2T={spec.log2_table_size} gather={spec.gather_dtype} "
          f"carry={spec.sort_carry} slots={spec.total_entries} "
          f"points/iter={n} (rows M={n * spec.n_levels})", flush=True)
    info = {}
    report(compare_hash_encode(spec, n, info=info))
    print(f"[reference] table-gradient entries: {json.dumps(info)}",
          flush=True)
    report(compare_segment_sums(spec, n))
    report(compare_trilerp(mapper.spec.uncert_shape, n))
    report(compare_loss_grads(mapper, cfg.mapper.sample + 512 // 4))
    t = segment_timings(spec, n)
    print("[reference] segment-sum backward timings (median of 20): "
          + json.dumps(t), flush=True)
    return t


def fill_keyframes(mapper, n_kf: int, seed: int = 0):
    """Populate the keyframe DB the way bench.py does (wall frame)."""
    import jax

    from naruto_tpu.mapping.keyframes import add_keyframe

    color, depth = wall_frame(mapper)
    frame_rays = mapper.frame_to_rays(color, depth)
    key = jax.random.PRNGKey(seed)
    for s in range(n_kf):
        key, k = jax.random.split(key)
        mapper.state = mapper.state._replace(
            kf=add_keyframe(mapper.state.kf, frame_rays,
                            s * mapper.cfg.mapper.keyframe_every, k))
    mapper._kf_count = n_kf
    jax.block_until_ready(mapper.state.kf.rays)
    return frame_rays


def eval_loss(mapper, batch, seed: int = 0) -> float:
    import jax

    loss, _ = jax.jit(mapper._loss_fn, static_argnums=(7,))(
        mapper.state.params, jax.random.PRNGKey(seed + 6), *batch, False)
    return float(loss)


def params_finite(params) -> bool:
    import jax

    return all(bool(np.isfinite(np.asarray(p, np.float32)).all())
               for p in jax.tree_util.tree_leaves(params))


def ba_phase(cfg, n_steps: int = 20, n_kf: int = 22) -> dict:
    """Compile every BA bucket, then time chained steps at steady state."""
    import jax
    import jax.numpy as jnp

    from naruto_tpu.mapping.mapper import CUR_BUCKETS, Mapper

    mapper = Mapper(cfg)
    frame_rays = fill_keyframes(mapper, n_kf)
    c2w = jnp.eye(4, dtype=jnp.float32)
    bucket = mapper._pick_bucket(n_kf)
    batch = loss_batch(mapper, cfg.mapper.sample + bucket // 4)
    loss0 = eval_loss(mapper, batch)

    compiled, out = {}, {"compile_s": {}}
    for b in CUR_BUCKETS:
        t0 = time.perf_counter()
        compiled[b] = mapper._get_ba_jit(b).lower(
            mapper.state, frame_rays, c2w, 110,
            jax.random.PRNGKey(1)).compile()
        out["compile_s"][b] = time.perf_counter() - t0
        print(f"[ba] bucket {b}: compile {out['compile_s'][b]:.1f} s",
              flush=True)
    mem = compiled[bucket].memory_analysis()
    if mem is not None:
        out["memory_analysis"] = {
            k: int(getattr(mem, k)) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "alias_size_in_bytes", "temp_size_in_bytes",
                "generated_code_size_in_bytes")}
        print(f"[ba] memory_analysis (bucket {bucket}): "
              f"{json.dumps(out['memory_analysis'])}", flush=True)

    step = compiled[bucket]
    ts = []
    for i in range(n_steps):
        t0 = time.perf_counter()
        mapper.state = step(mapper.state, frame_rays, c2w, 110 + i,
                            jax.random.PRNGKey(2 + i))
        jax.block_until_ready(mapper.state.params)
        ts.append(time.perf_counter() - t0)
    med = float(np.median(ts))
    out.update(bucket=bucket, steps=n_steps, step_median_s=med,
               iters_per_s=cfg.mapper.iters / med,
               step_min_s=float(np.min(ts)), step_max_s=float(np.max(ts)))
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    loss1 = eval_loss(mapper, batch)
    out.update(loss_before=loss0, loss_after=loss1)
    print(f"[ba] bucket {bucket}: {n_steps} chained steps, median "
          f"{med * 1e3:.2f} ms/step (min {out['step_min_s'] * 1e3:.2f}, "
          f"max {out['step_max_s'] * 1e3:.2f}) = "
          f"{out['iters_per_s']:.2f} mapping iters/s; "
          f"peak_bytes_in_use={out['peak_bytes_in_use']}", flush=True)
    print(f"[ba] loss {loss0:.6g} -> {loss1:.6g}", flush=True)
    if not params_finite(mapper.state.params):
        raise CheckFailed("BA produced non-finite parameters")
    if not loss1 < loss0:
        raise CheckFailed(f"BA loss did not fall: {loss0} -> {loss1}")
    return out


def third_party_modules() -> list:
    skip = set(sys.stdlib_module_names) | {"naruto_tpu", "__main__",
                                           "chip_smoke"}
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  - skip - {n for n in sys.modules if n.startswith("_")})


def loop_phase(argv) -> dict:
    """The active loop through its normal entry point, in-process."""
    from naruto_tpu import run
    from naruto_tpu.mesh import marching

    args = run.parse_args(argv)
    run_dir = os.path.join(args.result_dir, args.dataset, args.scene)
    t0 = time.perf_counter()
    engine = run.main(argv)
    wall = time.perf_counter() - t0
    with open(os.path.join(run_dir, "eval_result.txt")) as f:
        text = f.read()
    print("[loop] eval_result.txt:\n" + text.rstrip(), flush=True)
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    header = lines[0].split(",")
    values = [float(v) for v in lines[1].split(",")]
    if not values or not np.all(np.isfinite(values)):
        raise CheckFailed(f"eval row not finite: {lines[1]!r}")
    if "accuracy_cm" not in header:
        raise CheckFailed(f"eval row has no recon metrics: {header}")
    print("[loop] timers:\n" + engine.timer.summary(), flush=True)
    stats = engine.planner.stats_summary() if hasattr(
        engine.planner, "stats_summary") else {}
    print(f"[loop] planner: {stats}", flush=True)
    path = "native" if marching._load_lib() is not None else "numpy"
    print(f"[loop] marching path: {path}", flush=True)
    mods = third_party_modules()
    print(f"[loop] third-party modules loaded: {' '.join(mods)}",
          flush=True)
    bad = [m for m in FORBIDDEN_MODULES if m in sys.modules]
    if bad:
        raise CheckFailed(f"preset path imported {bad}")
    if not params_finite(engine.mapper.state.params):
        raise CheckFailed("active loop produced non-finite parameters")
    return {"wall_s": wall, "eval": dict(zip(header, values)),
            "marching": path}


def four_phase(n_devices: int = 4, num_iter: int = 6) -> dict:
    """One office0 BA step sharded over n_devices against the same step on
    card 0 alone, then a short sharded Engine loop."""
    import jax
    import jax.numpy as jnp

    from naruto_tpu.mapping.mapper import Mapper
    from naruto_tpu.system.engine import Engine

    cfg_sh = office0_config(num_iter, shard_rays=True, shard_volumes=True)
    cfg_1 = office0_config(num_iter)
    m_sh, m_1 = Mapper(cfg_sh), Mapper(cfg_1)
    if m_sh._ba_ndev != n_devices or m_1._ba_mesh is not None:
        raise CheckFailed(f"sharded BA spans {m_sh._ba_ndev} devices")
    # one keyframe: the bucket the Engine's first BA round compiles
    frame_rays = fill_keyframes(m_sh, 1)
    fill_keyframes(m_1, 1)
    bucket = m_sh._pick_bucket(1)
    n_rays = cfg_sh.mapper.sample + bucket // 4

    batch = loss_batch(m_sh, n_rays)
    key = jax.random.PRNGKey(7)
    g_sh = jax.jit(m_sh._grad_fn, static_argnums=(7,))(
        m_sh.state.params, key, *batch, True)
    g_1 = jax.jit(m_1._grad_fn, static_argnums=(7,))(
        m_1.state.params, key, *batch, True)
    rows = [(f"sharded grad [{k}] vs card 0", rel_err(g_sh[k], g_1[k]),
             1e-3) for k in sorted(g_1)]

    # after one BA step from the same state, compare what the step
    # reached (the loss on a fixed batch), not the parameters element by
    # element: rows touched only by the 1e-6-weighted smoothness rider get
    # gradients below the sort path's f32 prefix-sum noise floor, and the
    # table's Adam (eps 1e-15) turns each into a +-lr step of arbitrary
    # sign — on one card as much as on four — so single elements differ
    # by up to 2 lr. The step's loss must agree within 1e-2 relative.
    c2w = jnp.eye(4, dtype=jnp.float32)
    loss0 = eval_loss(m_1, batch)
    before = jax.tree_util.tree_map(np.asarray, m_1.state.params["table"])
    t0 = time.perf_counter()
    m_sh.state = m_sh._get_ba_jit(bucket)(m_sh.state, frame_rays, c2w, 5,
                                          jax.random.PRNGKey(8))
    jax.block_until_ready(m_sh.state.params)
    t_sh = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_1.state = m_1._get_ba_jit(bucket)(m_1.state, frame_rays, c2w, 5,
                                        jax.random.PRNGKey(8))
    jax.block_until_ready(m_1.state.params)
    t_1 = time.perf_counter() - t0
    p_sh = m_sh.state.params
    loss_sh = float(jax.jit(m_1._loss_fn, static_argnums=(7,))(
        p_sh, jax.random.PRNGKey(6), *batch, False)[0])
    loss_1 = eval_loss(m_1, batch)
    print(f"[four] loss on a fixed batch: before {loss0:.6g}, after one BA "
          f"step sharded {loss_sh:.6g}, card 0 {loss_1:.6g}", flush=True)
    rows.append(("loss after one BA step vs card 0",
                 abs(loss_sh - loss_1) / abs(loss_1), 1e-2))
    d_sh = [np.asarray(a) - b for a, b in zip(
        jax.tree_util.tree_leaves(p_sh["table"]),
        jax.tree_util.tree_leaves(before))]
    d_1 = [np.asarray(a) - b for a, b in zip(
        jax.tree_util.tree_leaves(m_1.state.params["table"]),
        jax.tree_util.tree_leaves(before))]
    lr10 = 0.1 * cfg_1.mapper.lr_embed
    moved = sum(int((np.abs(b) > 0).sum()) for b in d_1)
    differ = sum(int((np.abs(a - b) > lr10).sum())
                 for a, b in zip(d_sh, d_1))
    print(f"[four] table entries stepped on card 0: {moved}; entries whose "
          f"sharded step differs by > {lr10:g} (lr/10): {differ}",
          flush=True)
    if not (loss_sh < loss0 and loss_1 < loss0):
        raise CheckFailed("one BA step did not lower the loss")
    steps = {}
    for name, m in (("sharded", m_sh), ("card0", m_1)):
        ba, ts = m._get_ba_jit(bucket), []
        for i in range(10):
            t0 = time.perf_counter()
            m.state = ba(m.state, frame_rays, c2w, 10 + i,
                         jax.random.PRNGKey(20 + i))
            jax.block_until_ready(m.state.params)
            ts.append(time.perf_counter() - t0)
        steps[name] = float(np.median(ts))
    print(f"[four] BA bucket {bucket}, 10 chained steps each: median "
          f"{steps['sharded'] * 1e3:.2f} ms/step over {n_devices} cards, "
          f"{steps['card0'] * 1e3:.2f} ms/step on card 0", flush=True)
    print(f"[four] BA step bucket {bucket} (first call, compile incl.): "
          f"sharded {t_sh:.1f} s, card 0 {t_1:.1f} s", flush=True)
    report(rows)
    spans = {len(leaf.sharding.device_set)
             for leaf in jax.tree_util.tree_leaves(p_sh)}
    print(f"[four] sharded params live on {sorted(spans)} devices",
          flush=True)
    if spans != {n_devices}:
        raise CheckFailed(f"sharded BA params span {spans} devices")

    import tempfile

    run_dir = tempfile.mkdtemp(prefix="four_", dir=_scratch_dir())
    try:
        from naruto_tpu.config.schema import deep_update

        ecfg = deep_update(cfg_sh, {"general": {"result_dir": run_dir}})
        t0 = time.perf_counter()
        engine = Engine(ecfg, quiet=True)
        final = engine.run()
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    if not (np.isfinite(final).all()
            and params_finite(engine.mapper.state.params)):
        raise CheckFailed("sharded Engine loop went non-finite")
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.devices()[:n_devices]]
    print(f"[four] sharded Engine loop: {num_iter} steps in {wall:.1f} s; "
          f"peak_bytes_in_use per device {peaks}", flush=True)
    print("[four] timers:\n" + engine.timer.summary(), flush=True)
    return {"engine_wall_s": wall, "peaks": peaks, "step_s": steps}


def _scratch_dir() -> str:
    path = os.path.join(REPO, "results", "chip_smoke")
    os.makedirs(path, exist_ok=True)
    return path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the sharded BA path over four GPUs")
    args = p.parse_args(argv)
    n = 4 if args.four else 1
    t_start = time.perf_counter()
    devs = device_phase(n)

    walls = {}
    if args.four:
        t0 = time.perf_counter()
        four_phase(n)
        walls["four"] = time.perf_counter() - t0
    else:
        cfg = office0_config(LOOP_STEPS)
        for name, fn in (("reference", lambda: reference_phase(cfg)),
                         ("ba", lambda: ba_phase(cfg))):
            t0 = time.perf_counter()
            fn()
            walls[name] = time.perf_counter() - t0
            print(f"[{name}] phase wall {walls[name]:.1f} s", flush=True)
        import tempfile

        run_dir = tempfile.mkdtemp(prefix="loop_", dir=_scratch_dir())
        try:
            t0 = time.perf_counter()
            loop_phase(["--dataset", "Replica", "--scene", "office0",
                        "--num_iter", str(LOOP_STEPS), "--seed", "0",
                        "--result_dir", run_dir])
            walls["loop"] = time.perf_counter() - t0
        finally:
            shutil.rmtree(run_dir, ignore_errors=True)
    walls["total"] = time.perf_counter() - t_start
    print("[walls] " + " ".join(f"{k}={v:.1f}s" for k, v in walls.items()),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    try:
        main()
    except CheckFailed as e:
        sys.exit(f"chip_smoke: FAILED: {e}")
