"""Multi-resolution hash-grid encoding (instant-ngp style).

Replaces tcnn's CUDA HashGrid used by the reference
(src/slam/coslam/model/decoder.py:11, configs/Replica/replica_coslam.yaml
grid: hash_size=16, n_levels=16, F=2, base_resolution=16; finest resolution =
max AABB side / voxel_sdf — upstream JointEncoding.get_resolution contract,
SURVEY.md §2.9).

Design notes:
  * All levels live in ONE flat [total_entries, F] table. The forward pass is
    a single big gather; the backward pass is its transpose, computed by the
    scatter-free segment sum (ops/segment.py). Index computation is
    elementwise integer math on [N, L, 8] arrays — static shapes, no host
    sync.
  * Levels whose dense vertex count fits in the table are indexed densely
    (no collisions); finer levels use the instant-ngp spatial hash
    (xor of per-axis primes, mod table size — table size is a power of two so
    the mod is a mask).
  * fp32 table by default; the gather/blend math is cheap compared to the MLP
    matmuls that follow.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# instant-ngp hash primes (pi1=1 keeps dense-ish x ordering)
_PRIMES = (1, 2654435761, 805459861)


@dataclass(frozen=True)
class HashGridSpec:
    n_levels: int = 16
    n_features: int = 2
    log2_table_size: int = 16
    base_resolution: int = 16
    finest_resolution: int = 256
    # dtype the table is cast to for the corner gather: bf16 halves the
    # gathered bytes. Master params and the trilinear blend stay fp32.
    gather_dtype: str = "float32"
    # table layout (the cell/hybrid layouts exist for hardware whose
    # gather cost is dominated by a per-ROW constant — fewer, wider rows):
    #   "vertex": instant-ngp layout — one row per grid VERTEX, 8 gathers
    #             per (point, level). Exact tcnn semantics.
    #   "cell":   one row per grid CELL holding all 8 corner features
    #             contiguously — ONE wide gather per (point, level), 8x
    #             fewer sort keys in the backward. Corners are not shared
    #             between cells (each cell trains its own copies), so the
    #             field is continuous within cells but not across faces;
    #             reconstruction quality is validated in tests/bench.
    #   "hybrid": cell-speed reads with shared-vertex TRAINING on dense
    #             levels — the coarse (dense-indexed) levels' parameters are
    #             true vertex grids and their wide cell rows are DERIVED
    #             each evaluation by 8 static slices (no gather, ~free);
    #             exact tcnn semantics on those levels. Only the hashed
    #             fine levels keep independent per-cell corner copies
    #             (collisions make the cell->vertex map non-invertible).
    layout: str = "vertex"
    # hybrid only: allow a level to stay DENSE (collision-free, shared
    # vertices) when res^3 <= table_size * this slack. With the L4F8
    # default on Replica-size scenes, level 1 (41^3 = 68,921 cells) misses
    # the 2^16 cap by 5% and would otherwise hash with per-cell copies —
    # the slack trades +1.7% total parameters for exact shared-vertex
    # semantics on every level coarser than ~10 cm.
    hybrid_dense_slack: float = 1.25
    # cell/hybrid backward: what the gradient sort carries for the corner
    # weights. "frac" (default; r4 A/B +10.5%) = ONE 3x10-bit packed-frac
    # column with the weights recomputed post-sort (~33% less sort
    # payload; <=0.3% extra weight quantization, the same order as the
    # bf16 rounding of the alternative — see ops/segment.pack_frac);
    # "weights" = 8 bf16 weights (4 packed int32 columns, exact up to
    # bf16 rounding).
    sort_carry: str = "frac"

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @functools.cached_property
    def per_level_scale(self) -> float:
        if self.n_levels == 1:
            return 1.0
        return float(
            np.exp(np.log(self.finest_resolution / self.base_resolution)
                   / (self.n_levels - 1))
        )

    @functools.cached_property
    def resolutions(self) -> Tuple[int, ...]:
        b = self.per_level_scale
        return tuple(
            int(np.floor(self.base_resolution * b ** l + 1e-6))
            for l in range(self.n_levels)
        )

    @property
    def cell_rows(self) -> bool:
        """True when gather rows are per-CELL (8 corners wide)."""
        return self.layout in ("cell", "hybrid")

    @functools.cached_property
    def level_sizes(self) -> Tuple[int, ...]:
        """Rows per level: dense count when it fits, else hash table.
        vertex layout: (res+1)^3 vertices; cell/hybrid: res^3 cells."""
        sizes = []
        for res, d in zip(self.resolutions, self.dense_mask):
            dense = res ** 3 if self.cell_rows else (res + 1) ** 3
            sizes.append(dense if d else self.table_size)
        return tuple(sizes)

    @functools.cached_property
    def dense_mask(self) -> Tuple[bool, ...]:
        """Per level: dense-indexed (no hash) under the current layout.
        hybrid admits hybrid_dense_slack x table_size dense cells."""
        if self.layout == "hybrid":
            cap = int(self.table_size * self.hybrid_dense_slack)
            return tuple(r ** 3 <= cap for r in self.resolutions)
        if self.cell_rows:
            return tuple(r ** 3 <= self.table_size for r in self.resolutions)
        return tuple((r + 1) ** 3 <= self.table_size
                     for r in self.resolutions)

    @property
    def hybrid_hash_rows(self) -> int:
        """Hybrid layout: rows of the hashed-levels cell-table parameter."""
        return sum(s for s, d in zip(self.level_sizes, self.dense_mask)
                   if not d)

    @functools.cached_property
    def level_offsets(self) -> Tuple[int, ...]:
        offs = [0]
        for s in self.level_sizes:
            offs.append(offs[-1] + s)
        return tuple(offs)

    @property
    def total_entries(self) -> int:
        return self.level_offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features

    @property
    def row_features(self) -> int:
        """Feature columns per table row (cell rows pack all 8 corners)."""
        return 8 * self.n_features if self.cell_rows else self.n_features

    @classmethod
    def from_bound(cls, bound, voxel_sdf: float = 0.02, **kw) -> "HashGridSpec":
        """Finest resolution from scene AABB, matching upstream
        get_resolution: res = int(max_side / voxel_sdf)."""
        bound = np.asarray(bound)
        max_side = float((bound[:, 1] - bound[:, 0]).max())
        return cls(finest_resolution=max(int(max_side / voxel_sdf), 16), **kw)


def init_hash_table(key, spec: HashGridSpec, dtype=jnp.float32):
    """tcnn-style init: uniform in [-1e-4, 1e-4].

    vertex/cell: one flat [total_entries, row_features] array.
    hybrid: {"hash": [hybrid_hash_rows, 8F] cell rows for hashed levels,
             "dense": [per dense level, a (R+1, R+1, R+1, F) VERTEX grid
             stored z-major so cell (x,y,z) flattens to x + y*R + z*R^2]}.
    """
    if spec.layout != "hybrid":
        return jax.random.uniform(
            key, (spec.total_entries, spec.row_features), dtype=dtype,
            minval=-1e-4, maxval=1e-4)
    keys = jax.random.split(key, spec.n_levels + 1)
    dense_grids = []
    for li, (res, d) in enumerate(zip(spec.resolutions, spec.dense_mask)):
        if d:
            dense_grids.append(jax.random.uniform(
                keys[li], (res + 1, res + 1, res + 1, spec.n_features),
                dtype=dtype, minval=-1e-4, maxval=1e-4))
    hash_rows = jax.random.uniform(
        keys[-1], (spec.hybrid_hash_rows, spec.row_features), dtype=dtype,
        minval=-1e-4, maxval=1e-4)
    return {"hash": hash_rows, "dense": dense_grids}


@functools.lru_cache(maxsize=8)
def _patch_kernel(n_features: int) -> np.ndarray:
    """One-hot 2x2x2 'conv' kernel extracting the 8 corner features of
    every cell: k[cz, cy, cx, f, c*F + f] = 1 (c = cx*4 + cy*2 + cz)."""
    F = n_features
    k = np.zeros((2, 2, 2, F, 8 * F), np.float32)
    for c, (cx, cy, cz) in enumerate(_CORNERS):
        for f in range(F):
            k[cz, cy, cx, f, c * F + f] = 1.0
    return k


def derived_cell_rows(grid: jnp.ndarray, res: int, dtype) -> jnp.ndarray:
    """Vertex grid [(R+1)^3-shaped z-major, F] -> derived cell rows
    [R^3, 8F] with corner c = cx*4+cy*2+cz at columns [c*F, (c+1)*F) —
    exact shared-vertex semantics, no gather. Expressed as a VALID 2x2x2
    one-hot convolution (patch extraction) instead of an 8-slice concat
    of narrow minor slices."""
    F = grid.shape[-1]
    import os
    # NOTE: gather_dtype reaches here as the STRING "bfloat16" (GridConfig
    # stores dtype names); np.dtype normalizes both spellings — comparing
    # `dtype == jnp.bfloat16` directly is always False for the string and
    # silently disabled this knob in the first r5 A/B (cache-hit tell).
    if (np.dtype(dtype) == np.dtype(jnp.bfloat16)
            and os.environ.get("NARUTO_DENSE_BF16_CONV")):
        # A/B knob: the one-hot conv copies exactly one grid value per
        # output element, so bf16-casting the SMALL vertex grid first
        # ([42^3, F]) is bit-identical to converting the 8x larger conv
        # output ([41^3, 8F]) and runs the conv in bf16
        out = jax.lax.conv_general_dilated(
            grid[None].astype(jnp.bfloat16),
            jnp.asarray(_patch_kernel(F)).astype(jnp.bfloat16),
            (1, 1, 1), "VALID",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.bfloat16)
        return out[0].reshape(res ** 3, 8 * F)
    out = jax.lax.conv_general_dilated(
        grid[None].astype(jnp.float32), jnp.asarray(_patch_kernel(F)),
        (1, 1, 1), "VALID",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    return out[0].astype(dtype).reshape(res ** 3, 8 * F)


def derived_gather_table(table, spec: HashGridSpec, dtype) -> jnp.ndarray:
    """Hybrid layout: assemble the full [total_entries, 8F] gather table
    from the vertex-grid params (dense levels) + hashed cell rows."""
    blocks = []
    di = 0
    hoff = 0
    for res, size, d in zip(spec.resolutions, spec.level_sizes,
                            spec.dense_mask):
        if d:
            blocks.append(derived_cell_rows(table["dense"][di], res, dtype))
            di += 1
        else:
            blocks.append(table["hash"][hoff:hoff + size].astype(dtype))
            hoff += size
    return jnp.concatenate(blocks, axis=0)


def _cell_rows_transpose(d_rows: jnp.ndarray, res: int,
                         n_features: int) -> jnp.ndarray:
    """Cotangent of derived cell rows [R^3, 8F] -> vertex grid
    [(R+1), (R+1), (R+1), F] as a sum of 8 corner-shifted PADS (no
    scatter, no update chain).

    Each corner block c of the cell cotangent adds into the vertex grid
    at offset (cz, cy, cx): pad each block by its offset and sum — 8
    reads + 7 adds that XLA fuses into ONE elementwise pass over the
    (R+1)^3 F output (no transposed conv, no chain of eight
    `.at[slice].add` dynamic-update-slices)."""
    F = n_features
    out = None
    for c, (cx, cy, cz) in enumerate(_CORNERS):
        blk = d_rows[:, c * F:(c + 1) * F].astype(jnp.float32) \
            .reshape(res, res, res, F)          # [z, y, x, F] (x fastest)
        p = jnp.pad(blk, ((cz, 1 - cz), (cy, 1 - cy), (cx, 1 - cx),
                          (0, 0)))
        out = p if out is None else out + p
    return out


def split_table_grads(d_full: jnp.ndarray, spec: HashGridSpec, table):
    """Hybrid layout: split the derived-table cotangent [total, 8F] into
    {"hash": ..., "dense": [...]} — the dense-level part is the patch
    convolution's transposed conv back onto the vertex grids."""
    del table  # structure is implied by the spec
    f = spec.n_features
    hash_parts = []
    dense_parts = []
    for res, size, off, d in zip(spec.resolutions, spec.level_sizes,
                                 spec.level_offsets[:-1], spec.dense_mask):
        block = d_full[off:off + size]
        if d:
            dense_parts.append(_cell_rows_transpose(block, res, f))
        else:
            hash_parts.append(block.astype(jnp.float32))
    hash_grad = (jnp.concatenate(hash_parts, axis=0) if hash_parts
                 else jnp.zeros((0, 8 * f), jnp.float32))
    return {"hash": hash_grad, "dense": dense_parts}


_CORNERS = [[cx, cy, cz] for cx in (0, 1) for cy in (0, 1) for cz in (0, 1)]


def _cell_pos(x: jnp.ndarray, spec: HashGridSpec):
    """Per-level cell base i0 [N, L, 3] and fractional coords [N, L, 3]."""
    res = jnp.asarray(spec.resolutions, dtype=jnp.float32)
    res_i = jnp.asarray(spec.resolutions, dtype=jnp.int32)
    pos = x[:, None, :] * res[None, :, None]
    i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0,
                  (res_i - 1)[None, :, None])
    frac = jnp.clip(pos - i0.astype(jnp.float32), 0.0, 1.0)
    return i0, frac


def _corner_weights(frac: jnp.ndarray) -> jnp.ndarray:
    """Trilinear weights [N, L, 8] in _CORNERS order from frac [N, L, 3]."""
    cf = jnp.asarray(_CORNERS, dtype=jnp.float32)          # [8, 3]
    return jnp.prod(
        jnp.where(cf[None, None, :, :] > 0.5, frac[:, :, None, :],
                  1.0 - frac[:, :, None, :]),
        axis=-1)


def _cell_indices(x: jnp.ndarray, spec: HashGridSpec):
    """Cell-layout rows: flat table row per (point, level).

    Returns (idx [N, L] int32, w [N, L, 8] float32 in _CORNERS order).
    """
    i0, frac = _cell_pos(x, spec)                          # [N, L, 3]
    res_i = jnp.asarray(spec.resolutions, dtype=jnp.int32)
    offsets = jnp.asarray(spec.level_offsets[:-1], dtype=jnp.int32)
    # hashed levels are table_size (power of two) so the mod is a mask
    sizes = jnp.asarray([spec.table_size] * spec.n_levels, dtype=jnp.int32)
    dense = jnp.asarray(spec.dense_mask, dtype=jnp.bool_)

    s = res_i[None, :]
    dense_idx = i0[..., 0] + i0[..., 1] * s + i0[..., 2] * s * s
    cu = i0.astype(jnp.uint32)
    h = (cu[..., 0] * jnp.uint32(_PRIMES[0])) \
        ^ (cu[..., 1] * jnp.uint32(_PRIMES[1])) \
        ^ (cu[..., 2] * jnp.uint32(_PRIMES[2]))
    hash_idx = (h & (sizes.astype(jnp.uint32) - 1)[None, :]).astype(jnp.int32)
    idx = jnp.where(dense[None, :], dense_idx, hash_idx) + offsets[None, :]
    return idx, _corner_weights(frac)


def _corner_indices(x: jnp.ndarray, spec: HashGridSpec):
    """Flat table indices + trilinear weights for all levels.

    x: [N, 3] in [0, 1]. Returns (idx [N, L*8] int32, w [N, L, 8] float32).
    """
    n = x.shape[0]
    L = spec.n_levels
    res = jnp.asarray(spec.resolutions, dtype=jnp.float32)       # [L]
    res_i = jnp.asarray(spec.resolutions, dtype=jnp.int32)       # [L]
    offsets = jnp.asarray(spec.level_offsets[:-1], dtype=jnp.int32)  # [L]
    sizes = jnp.asarray([spec.table_size] * spec.n_levels,
                        dtype=jnp.int32)                          # [L]
    dense = jnp.asarray(spec.dense_mask, dtype=jnp.bool_)         # [L]

    # position on each level's grid: [N, L, 3]
    pos = x[:, None, :] * res[None, :, None]
    i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0,
                  (res_i - 1)[None, :, None])
    frac = jnp.clip(pos - i0.astype(jnp.float32), 0.0, 1.0)

    # 8 corner offsets [8, 3]
    corners = jnp.asarray(
        [[cx, cy, cz] for cx in (0, 1) for cy in (0, 1) for cz in (0, 1)],
        dtype=jnp.int32)
    cidx = i0[:, :, None, :] + corners[None, None, :, :]          # [N, L, 8, 3]

    # dense index: x + y*(res+1) + z*(res+1)^2 ; hashed: xor of primes & mask
    s = (res_i + 1)[None, :, None]                                # [1, L, 1]
    dense_idx = (cidx[..., 0] + cidx[..., 1] * s + cidx[..., 2] * s * s)
    cu = cidx.astype(jnp.uint32)
    h = (cu[..., 0] * jnp.uint32(_PRIMES[0])) \
        ^ (cu[..., 1] * jnp.uint32(_PRIMES[1])) \
        ^ (cu[..., 2] * jnp.uint32(_PRIMES[2]))
    # level table sizes are powers of two for hashed levels -> mod == mask
    hash_idx = (h & (sizes.astype(jnp.uint32) - 1)[None, :, None]).astype(jnp.int32)
    idx = jnp.where(dense[None, :, None], dense_idx, hash_idx)
    idx = idx + offsets[None, :, None]                            # [N, L, 8]

    # trilinear weights: prod over axes of (1-frac or frac)
    cf = corners.astype(jnp.float32)                              # [8, 3]
    w = jnp.prod(
        jnp.where(cf[None, None, :, :] > 0.5, frac[:, :, None, :],
                  1.0 - frac[:, :, None, :]),
        axis=-1)                                                  # [N, L, 8]
    return idx.reshape(n, L * 8), w


@functools.lru_cache(maxsize=8)
def _repeat_matrix(n_levels: int, n_features: int) -> np.ndarray:
    """One-hot matrix R [L*8, L*8*F] with R[i, i*F+f] = 1: w_rep = w @ R
    replicates each corner weight across its F feature columns as ONE
    matmul instead of a jnp.repeat narrow-minor reshape. Cached as NUMPY
    (jnp constants leak tracers)."""
    L, F = n_levels, n_features
    r = np.zeros((L * 8, L * 8 * F), dtype=np.float32)
    for i in range(L * 8):
        r[i, i * F:(i + 1) * F] = 1.0
    return r


@functools.lru_cache(maxsize=8)
def _blend_matrix(n_levels: int, n_features: int) -> np.ndarray:
    """Selection matrix S [L*8*F, L*F] folding the 8-corner blend into one
    matmul: out = (rows * w_rep) @ S. S[(l*8+c)*F + f, l*F + f] = 1.
    Cached as NUMPY (a cached jnp constant would leak tracers across
    jit traces)."""
    L, F = n_levels, n_features
    s = np.zeros((L * 8 * F, L * F), dtype=np.float32)
    for l in range(L):
        for c in range(8):
            for f in range(F):
                s[(l * 8 + c) * F + f, l * F + f] = 1.0
    return s


def _blend(rows: jnp.ndarray, w: jnp.ndarray, spec: HashGridSpec,
           n: int) -> jnp.ndarray:
    """rows: gathered corner features [n, L*8*F] (gather dtype), w corner
    weights [n, L, 8] f32 -> blended embedding [n, L*F] f32.

    The weighted reduction over corners runs as ONE bf16 matmul with f32
    accumulation — no [n, L, 8, F] float32 materialization."""
    L, F = spec.n_levels, spec.n_features
    # the selection/repeat matmuls are exact one-hot; keep full precision
    # on the fp32 (reference-parity) path, single-pass on the bf16 fast
    # path. (The repeat-matmul avoids a 3-D broadcast multiply with F as
    # a narrow minor dim and a jnp.repeat reshape.)
    precision = (jax.lax.Precision.HIGHEST
                 if rows.dtype == jnp.float32 else jax.lax.Precision.DEFAULT)
    w_rep = jax.lax.dot_general(
        w.reshape(n, L * 8).astype(rows.dtype),
        jnp.asarray(_repeat_matrix(L, F), dtype=rows.dtype),
        (((1,), (0,)), ((), ())),
        preferred_element_type=rows.dtype, precision=precision)
    weighted = rows * w_rep
    return jax.lax.dot_general(
        weighted, jnp.asarray(_blend_matrix(L, F), dtype=rows.dtype),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32, precision=precision)


def _gather_table(table, spec: HashGridSpec):
    """The flat table rows the forward gather reads (derived for hybrid)."""
    if spec.layout == "hybrid":
        return derived_gather_table(table, spec, spec.gather_dtype)
    return table.astype(spec.gather_dtype) \
        if spec.gather_dtype != "float32" else table


def _encode_impl(table, x, spec: HashGridSpec):
    n = x.shape[0]
    gtable = _gather_table(table, spec)
    if spec.cell_rows:
        idx, w = _cell_indices(x, spec)                   # [N, L], [N, L, 8]
        rows = jnp.take(gtable, idx.reshape(-1), axis=0)  # [N*L, 8F]
        rows = rows.reshape(n, spec.n_levels * 8 * spec.n_features)
    else:
        idx, w = _corner_indices(x, spec)
        rows = jnp.take(gtable, idx, axis=0)              # [N, L*8, F]
        rows = rows.reshape(n, spec.n_levels * 8 * spec.n_features)
    out = _blend(rows, w, spec, n)                        # [N, L*F] f32
    return out, (idx, w)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def hash_encode(table: jnp.ndarray, x: jnp.ndarray,
                spec: HashGridSpec) -> jnp.ndarray:
    """Encode points. table: [total, F]; x: [N, 3] in [0,1].
    Returns [N, L*F] features.

    Custom VJP: the natural backward is a large scatter-add into the
    table (tcnn's CUDA backward does it with atomics). The backward here
    uses the scatter-free sort + prefix-sum segment sum (ops/segment.py)
    instead.
    """
    out, _ = _encode_impl(table, x, spec)
    return out


def _hash_encode_fwd(table, x, spec):
    out, (idx, w) = _encode_impl(table, x, spec)
    return out, (table, x, idx, w)


def _hash_encode_bwd(spec, res, g):
    table, x, idx, w = res
    return encode_grads_from_gembed(spec, table, x, idx, w, g)


def encode_grads_from_gembed(spec, table, x, idx, w, g):
    """(d_table, d_x) from the embedding cotangent g [N, L*F] — the shared
    backward core behind hash_encode's VJP."""
    from naruto_tpu.ops.segment import (
        dense_segment_sum, dense_segment_sum_outer_level_major,
        dense_segment_sum_outer_level_major_frac)

    n = x.shape[0]
    L, F = spec.n_levels, spec.n_features
    gl = g.reshape(n, L, 1, F)                            # [N, L, 1, F]

    if spec.cell_rows:
        # row update = outer(corner weights, level grad) — the sort carries
        # the two rank-1 factors, the 8F-wide expansion happens post-sort.
        # Level-major flatten: avoids the point-major [N, L*K] -> [N*L, K]
        # relayouts of idx/w/g; segment sums are row-order invariant.
        if spec.sort_carry == "frac":
            # slim sort payload: one packed-frac column instead of 4
            # packed-weight columns; weights recomputed post-sort
            _, frac_s = _cell_pos(x, spec)
            d_full = dense_segment_sum_outer_level_major_frac(
                idx, frac_s, g, spec.total_entries)
        else:
            d_full = dense_segment_sum_outer_level_major(
                idx, w.reshape(n, L, 8), g, spec.total_entries)
        if spec.layout == "hybrid":
            d_raw = split_table_grads(d_full, spec, table)
            d_table = jax.tree_util.tree_map(
                lambda dt, t: dt.astype(t.dtype), d_raw, table)
            # position grads read the f32-derived rows (master precision)
            flat_fn = lambda: derived_gather_table(       # noqa: E731
                table, spec, jnp.float32)
        else:
            d_table = d_full.astype(table.dtype)
            flat_fn = lambda: table                       # noqa: E731
        feats_fn = lambda: jnp.take(                      # noqa: E731
            flat_fn(), idx.reshape(-1), axis=0).reshape(n, L, 8, F)
    else:
        # update (n, l, c) = g[n, l] * w[n, l, c]
        upd = (gl * w[..., None]).reshape(-1, F)          # [N*L*8, F]
        d_table = dense_segment_sum(idx.reshape(-1), upd,
                                    spec.total_entries).astype(table.dtype)
        feats_fn = lambda: jnp.take(                      # noqa: E731
            table, idx, axis=0).reshape(n, L, 8, F)

    # input gradient: d out / d frac via per-axis product rule; frac = x*res
    feats = feats_fn()
    res_l = jnp.asarray(spec.resolutions, dtype=x.dtype)  # [L]
    pos = x[:, None, :] * res_l[None, :, None]
    i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0,
                  jnp.asarray(spec.resolutions, jnp.int32)[None, :, None] - 1)
    frac = jnp.clip(pos - i0.astype(x.dtype), 0.0, 1.0)   # [N, L, 3]
    corners = jnp.asarray(_CORNERS, dtype=x.dtype)        # [8, 3]
    t = jnp.where(corners[None, None, :, :] > 0.5, frac[:, :, None, :],
                  1.0 - frac[:, :, None, :])              # [N, L, 8, 3]
    sign = jnp.where(corners > 0.5, 1.0, -1.0)            # [8, 3]
    p = jnp.stack([t[..., 1] * t[..., 2],
                   t[..., 0] * t[..., 2],
                   t[..., 0] * t[..., 1]], axis=-1)       # [N, L, 8, 3]
    gdotf = jnp.sum(gl * feats, axis=-1)                  # [N, L, 8]
    d_x = jnp.einsum("nlc,ca,nlca,l->na", gdotf, sign, p, res_l)
    return d_table, d_x.astype(x.dtype)


hash_encode.defvjp(_hash_encode_fwd, _hash_encode_bwd)
