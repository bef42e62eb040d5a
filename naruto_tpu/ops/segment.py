"""Scatter-free dense segment sum.

The hash-grid and uncertainty-grid gradients are dense accumulations of
many small updates into table rows (`out[s] = sum of updates with index
s`). The plain form is an XLA scatter-add; this module computes the same
sums from sorts and prefix sums instead:
  1. values are carried through ONE variadic sort keyed by slot index
     (payload columns bf16-packed in pairs into int32 operands);
  2. per-slot sums come from prefix-sum differences at run boundaries;
  3. the boundary positions (the classic searchsorted step) come from
     `_chunk_ranks`, a compare-reduce over chunk summaries of the sorted
     keys (`_merge_ranks`, the double-argsort merge rank, is its oracle).

The sort path was built for a backend whose scatter-add was serialized;
whether it beats scatter-add (atomics) on the GPU is an open measurement,
and `jax.ops.segment_sum` is its reference in the tests.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _merge_ranks(sorted_keys: jnp.ndarray, size: int) -> jnp.ndarray:
    """For each slot t in [0, size): number of sorted_keys <= t, computed
    via tagged merge + double argsort (rank = argsort(argsort(x)))."""
    m = sorted_keys.shape[0]
    # tag: key entries sort before equal-valued slot sentinels
    merged = jnp.concatenate([
        sorted_keys.astype(jnp.int32) * 2,
        jnp.arange(size, dtype=jnp.int32) * 2 + 1,
    ])
    rank = jnp.argsort(jnp.argsort(merged))
    ub = rank[m:] - jnp.arange(size, dtype=jnp.int32)   # keys <= t
    return ub


def _chunk_ranks(sorted_keys: jnp.ndarray, size: int,
                 chunk: int = 512, sub: int = 32) -> jnp.ndarray:
    """ub[t] = #{i: sorted_keys[i] <= t} for all t in [0, size) — the
    merge-rank replacement, O(size * (C + chunk/sub + sub)) fused
    compare-reduces instead of two argsorts over m + size elements.

    Exploits sortedness: chunk maxes are monotone, so every query t has
    at most ONE straddling chunk — chunks with max <= t count wholly,
    chunks after the straddler lie wholly above. Three levels:
      1. count of wholly-below chunks via a fused [size, C] compare-sum
         against the chunk maxes;
      2. gather the straddler's sub-chunk maxes ([size, chunk/sub]) and
         count wholly-below sub-chunks;
      3. gather the straddling sub-chunk's keys ([size, sub]) and count.
    Padding keys are INT32_MAX so they never count; the t >= all-keys
    case is handled by the final min with m.
    """
    m = sorted_keys.shape[0]
    pad = (-m) % chunk
    keys = sorted_keys.astype(jnp.int32)
    if pad:
        keys = jnp.concatenate(
            [keys, jnp.full((pad,), jnp.iinfo(jnp.int32).max, jnp.int32)])
    c = keys.shape[0] // chunk
    nsubs = chunk // sub
    km = keys.reshape(c, nsubs, sub)
    t = jnp.arange(size, dtype=jnp.int32)[:, None]

    cmax = km[:, -1, -1]                                     # [C] monotone
    nfull = jnp.sum((cmax[None, :] <= t).astype(jnp.int32), axis=1)
    sidx = jnp.minimum(nfull, c - 1)                         # straddler

    smax = km[:, :, -1]                                      # [C, nsubs]
    nsub = jnp.sum((smax[sidx] <= t).astype(jnp.int32), axis=1)
    ssidx = jnp.minimum(nsub, nsubs - 1)

    k3 = km.reshape(c * nsubs, sub)[sidx * nsubs + ssidx]    # [size, sub]
    nkey = jnp.sum((k3 <= t).astype(jnp.int32), axis=1)

    within = nsub * sub + jnp.where(nsub < nsubs, nkey, 0)
    return jnp.minimum(nfull * chunk + within, m)


def _check_even(ka: int, kb: int) -> None:
    if ka % 2 or kb % 2:
        raise ValueError(
            f"dense_segment_sum_outer packs bf16 factor PAIRS into int32 "
            f"sort operands and needs even factor widths; got a:{ka} b:{kb} "
            f"(e.g. grid.n_features_per_level must be even — use "
            f"dense_segment_sum on the expanded outer product for odd "
            f"widths)")


def dense_segment_sum_outer(indices: jnp.ndarray, a: jnp.ndarray,
                            b: jnp.ndarray, size: int) -> jnp.ndarray:
    """Segment sum of rank-1 outer-product updates:
    out[s] = sum_{i: indices[i]==s} outer(a[i], b[i]), flattened to
    [size, A*B].

    The sort carries only the a/b FACTORS (bf16-packed) — A+B columns
    instead of A*B — and the outer product is expanded after the sort,
    so wide updates (e.g. the cell-layout hash grid's 8x8 corner-feature
    updates) never pay a wide variadic sort.
    """
    m, ka = a.shape
    kb = b.shape[1]
    _check_even(ka, kb)
    a16 = a.astype(jnp.bfloat16).reshape(m, ka // 2, 2).view(jnp.int32)[..., 0]
    b16 = b.astype(jnp.bfloat16).reshape(m, kb // 2, 2).view(jnp.int32)[..., 0]
    return _segment_sum_outer_packed(indices.astype(jnp.int32), a16, b16,
                                     ka, kb, size)


def _pack_pairs_level_major(x2d: jnp.ndarray, n_levels: int,
                            width: int, pad_rows: int = 0) -> jnp.ndarray:
    """[N, L*width] float -> [L*N (+pad_rows), width//2] int32 of packed
    bf16 pairs, level-major rows. Built exclusively from within-row
    reshapes, column slices, and an axis-0 concat — no [N, L*K] -> [N*L, K]
    row-splitting reshape (a physical relayout of the whole array at
    M~500k; the segment sum is row-order invariant so level-major is
    free). pad_rows appends zero rows INSIDE the same concat (free vs a
    separate pad that re-copies the whole array)."""
    n = x2d.shape[0]
    p = x2d.astype(jnp.bfloat16) \
        .reshape(n, n_levels * width // 2, 2).view(jnp.int32)[..., 0]
    cols = width // 2
    parts = [p[:, lv * cols:(lv + 1) * cols] for lv in range(n_levels)]
    if pad_rows:
        parts.append(jnp.zeros((pad_rows, cols), jnp.int32))
    return jnp.concatenate(parts, axis=0)


def dense_segment_sum_outer_level_major(
        idx_nl: jnp.ndarray, a_nl: jnp.ndarray, b_nl: jnp.ndarray,
        size: int) -> jnp.ndarray:
    """dense_segment_sum_outer for per-level batched updates, flattened
    LEVEL-major instead of point-major.

    idx_nl: [N, L] int32 slot ids; a_nl: [N, L, A]; b_nl: [N, L*B].
    Equivalent to dense_segment_sum_outer(idx_nl.reshape(-1), ...) up to
    within-slot summation order, but avoids the row-splitting
    [N, L*K] -> [N*L, K] relayouts of the point-major flatten.

    Precondition (hash-grid contract, _batched_sort): column lv's ids must
    lie in level lv's own table range [off_lv, off_lv + size_lv) and those
    ranges must ascend with lv — true for flat-table slot ids that include
    the per-level offsets."""
    n, L = idx_nl.shape
    ka = a_nl.shape[-1]
    kb = b_nl.shape[-1] // L
    _check_even(ka, kb)
    key = jnp.concatenate(
        [idx_nl[:, lv] for lv in range(L)]).astype(jnp.int32)
    a16 = _pack_pairs_level_major(a_nl.reshape(n, L * ka), L, ka)
    b16 = _pack_pairs_level_major(b_nl, L, kb)
    return _segment_sum_outer_packed(key, a16, b16, ka, kb, size,
                                     n_batch=L)


def _batched_sort(ops, n_batch: int):
    """Variadic sort of level-major flat [M] operands. Default: ONE flat
    sort. NARUTO_BATCHED_SORT=1 opts into n_batch INDEPENDENT per-level
    sorts ([L, N] batched along axis 0) — valid because every key carries
    its level's table offset so the levels' key ranges are disjoint and
    the concatenation of per-level sorts is already globally sorted.

    The batched variant looks cheaper on paper (~log(N/L)/log(N) of the
    bitonic pass count); kept as an opt-in A/B knob (not measured on the
    GPU)."""
    import os
    m = ops[0].shape[0]
    if (n_batch <= 1 or m % n_batch
            or not os.environ.get("NARUTO_BATCHED_SORT")):
        return jax.lax.sort(ops, num_keys=1)
    n = m // n_batch
    batched = jax.lax.sort(tuple(o.reshape(n_batch, n) for o in ops),
                           dimension=1, num_keys=1)
    return tuple(o.reshape(m) for o in batched)


def _segment_sum_outer_packed(key: jnp.ndarray, a16: jnp.ndarray,
                              b16: jnp.ndarray, ka: int, kb: int,
                              size: int, n_batch: int = 1) -> jnp.ndarray:
    """Shared post-pack pipeline: variadic sort on packed bf16-pair
    columns, merge-rank boundaries, expand+cumsum, boundary diffs."""
    m = key.shape[0]
    ops = (key,) + tuple(
        a16[:, j] for j in range(ka // 2)) + tuple(
        b16[:, j] for j in range(kb // 2))
    sorted_ops = _batched_sort(ops, n_batch)
    si = sorted_ops[0]
    sa16 = jnp.stack(sorted_ops[1:1 + ka // 2], axis=-1)[..., None] \
        .view(jnp.bfloat16).reshape(m, ka)
    sb16 = jnp.stack(sorted_ops[1 + ka // 2:], axis=-1)[..., None] \
        .view(jnp.bfloat16).reshape(m, kb)
    return _outer_from_sorted(si, sa16, sb16, ka, kb, size)


PACK_FRAC_BITS = 10   # 3 axes x 10-bit fixed point in one int32 sort column


def pack_frac(frac: jnp.ndarray) -> jnp.ndarray:
    """Quantize per-cell fractional coords [..., 3] in [0, 1] to 3x10-bit
    fixed point packed in ONE int32 — a 1-column sort payload replacing the
    4 packed-bf16 corner-weight columns (the weights are a pure function of
    frac and get recomputed post-sort). Max weight error from the 1/1023
    frac resolution is ~0.3% relative, the same order as the bf16 rounding
    the weight-carry path already applies."""
    scale = float((1 << PACK_FRAC_BITS) - 1)
    q = jnp.clip(jnp.round(frac * scale), 0, scale).astype(jnp.int32)
    return q[..., 0] | (q[..., 1] << PACK_FRAC_BITS) \
        | (q[..., 2] << (2 * PACK_FRAC_BITS))


def corner_weights_from_packed(qf: jnp.ndarray) -> jnp.ndarray:
    """Packed frac [M] int32 -> trilinear corner weights [M, 8] float32 in
    the encoding's corner order (delegates to encoding._corner_weights so
    the frac-carry backward can never desynchronize from the forward
    blend's corner order)."""
    from naruto_tpu.ops.encoding import _corner_weights
    mask = (1 << PACK_FRAC_BITS) - 1
    scale = float(mask)
    f = jnp.stack(
        [(qf >> (ax * PACK_FRAC_BITS)) & mask for ax in range(3)],
        axis=-1).astype(jnp.float32) / scale               # [M, 3]
    return _corner_weights(f[:, None, :]).reshape(-1, 8)


def dense_segment_sum_outer_level_major_frac(
        idx_nl: jnp.ndarray, frac_nl: jnp.ndarray, b_nl: jnp.ndarray,
        size: int) -> jnp.ndarray:
    """dense_segment_sum_outer_level_major with the 8 corner weights
    replaced in the SORT by one packed-frac column (see pack_frac):
    ~33% less variadic-sort payload (6 operands vs 9 at F=8), with the
    [M, 8] weight expansion recomputed from the sorted fracs — cheap
    elementwise work vs sort bandwidth.

    idx_nl: [N, L] int32 slot ids; frac_nl: [N, L, 3] in [0, 1];
    b_nl: [N, L*B]. Returns [size, 8*B]."""
    import os
    n, L = idx_nl.shape
    kb = b_nl.shape[-1] // L
    _check_even(8, kb)
    # append INT32_MAX-keyed zero-value rows inside the level-major
    # concats so M is a multiple of 512 (the _chunk_ranks chunk); the
    # sentinel keys sort to the tail, never match a slot in _chunk_ranks
    # (which counts keys <= t < size), and contribute 0 to the cumsum.
    # NARUTO_PRESORT_PAD=0 drops the pad (A/B knob).
    pad = ((-(n * L)) % 512
           if os.environ.get("NARUTO_PRESORT_PAD", "1") != "0" else 0)
    key_parts = [idx_nl[:, lv] for lv in range(L)]
    qf = pack_frac(frac_nl)                               # [N, L]
    qf_parts = [qf[:, lv] for lv in range(L)]
    if pad:
        key_parts.append(jnp.full((pad,), jnp.iinfo(jnp.int32).max,
                                  idx_nl.dtype))
        qf_parts.append(jnp.zeros((pad,), qf.dtype))
    key = jnp.concatenate(key_parts).astype(jnp.int32)
    qf_lm = jnp.concatenate(qf_parts)
    b16 = _pack_pairs_level_major(b_nl, L, kb, pad_rows=pad)
    ops = (key, qf_lm) + tuple(b16[:, j] for j in range(kb // 2))
    sorted_ops = _batched_sort(ops, L if not pad else 1)
    si = sorted_ops[0]
    m = si.shape[0]
    sa16 = corner_weights_from_packed(sorted_ops[1]).astype(jnp.bfloat16)
    # default "cols" (identical element order);
    # NARUTO_SORTED_UNPACK=stack restores the stack+bitcast assembly
    if os.environ.get("NARUTO_SORTED_UNPACK", "cols") == "cols":
        # reassemble the sorted bf16-pair payload column by column
        # ([M,1] u32 -> [M,2] bf16, one axis-1 concat) instead of
        # stack+bitcast, which materializes u32[M, kb/2] column-major
        # and re-copies it row-major. Identical element order: sorted
        # column j carries bf16 feature pair (2j, 2j+1).
        sb16 = jnp.concatenate(
            [c[:, None].view(jnp.bfloat16) for c in sorted_ops[2:]],
            axis=1)
    else:
        sb16 = jnp.stack(sorted_ops[2:], axis=-1)[..., None] \
            .view(jnp.bfloat16).reshape(m, kb)
    return _outer_from_sorted(si, sa16, sb16, 8, kb, size)


def _outer_from_sorted(si: jnp.ndarray, sa16: jnp.ndarray,
                       sb16: jnp.ndarray, ka: int, kb: int,
                       size: int) -> jnp.ndarray:
    """Post-sort tail shared by the weight-carry and frac-carry paths:
    run boundaries, outer-product expansion, f32 prefix sums, boundary
    diffs."""
    m = si.shape[0]
    ub = _chunk_ranks(si, size)
    # outer product in bf16 (one rounding of the bf16 factors' product),
    # then f32 prefix sums
    sv = (sa16[:, :, None] * sb16[:, None, :]).astype(jnp.float32) \
        .reshape(m, ka * kb)
    cs = jnp.concatenate(
        [jnp.zeros((1, ka * kb), jnp.float32), jnp.cumsum(sv, axis=0)],
        axis=0)
    # hi[t] = total of all entries with key <= t (monotone per slot);
    # per-slot sums are adjacent differences — ONE boundary gather
    # instead of two (the lo gather is just hi shifted by one slot)
    hi = cs[ub]
    return hi - jnp.concatenate(
        [jnp.zeros((1, hi.shape[1]), hi.dtype), hi[:-1]])


def dense_segment_sum(indices: jnp.ndarray, values: jnp.ndarray,
                      size: int, pack_bf16: bool = True) -> jnp.ndarray:
    """indices: [M] int32 in [0, size); values: [M, F].
    Returns [size, F] with out[s] = sum of values where indices == s.

    pack_bf16: carry value columns through the sort as bf16 PAIRS bitcast
    into int32 operands — halves the dominant variadic-sort payload width.
    Individual updates get bf16-rounded (~0.4% relative) before the fp32
    prefix sum; gradient-noise dominated training is insensitive to this
    (flip off for exact accumulation).
    """
    f = values.shape[1]
    if pack_bf16 and f % 2 == 0:
        v16 = values.astype(jnp.bfloat16).reshape(-1, f // 2, 2)
        packed = v16.view(jnp.int32)[..., 0]             # [M, F//2]
        ops = (indices.astype(jnp.int32),) + tuple(
            packed[:, j] for j in range(f // 2))
        sorted_ops = jax.lax.sort(ops, num_keys=1)
        si = sorted_ops[0]
        sp = jnp.stack(sorted_ops[1:], axis=-1)          # [M, F//2] int32
        sv = sp[..., None].view(jnp.bfloat16).reshape(-1, f)
        sv = sv.astype(values.dtype)
    else:
        ops = (indices.astype(jnp.int32),) + tuple(
            values[:, j] for j in range(f))
        sorted_ops = jax.lax.sort(ops, num_keys=1)
        si = sorted_ops[0]
        sv = jnp.stack(sorted_ops[1:], axis=-1)          # [M, F] sorted
    cs = jnp.concatenate(
        [jnp.zeros((1, f), values.dtype), jnp.cumsum(sv, axis=0)], axis=0)
    ub = _chunk_ranks(si, size)                          # keys <= t
    hi = cs[ub]
    return hi - jnp.concatenate(
        [jnp.zeros((1, f), hi.dtype), hi[:-1]])
