"""Tiny bias-free MLPs (the reference's SDF/color decoders).

Contract from src/slam/coslam/model/decoder.py: `nn.Linear(in, out,
bias=False)` stacks with ReLU between hidden layers and no output activation;
torch's default kaiming-uniform init gives W ~ U(-1/sqrt(fan_in),
+1/sqrt(fan_in)).

These MLPs are 2 layers x 32 hidden — far below a matrix unit's tile size
on their own. Throughput comes from batching: the mapper evaluates them on
~10^5-10^6 points at once, so each layer is a [N, in] x [in, out] matmul
with N in the hundreds of thousands, as long as the batch dimension stays
large and contiguous (the renderer flattens rays x samples). On the GPU an
f32 matmul runs in TF32 unless a precision is asked for.
"""
from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp


def init_mlp_params(key, dims: Sequence[int], dtype=jnp.float32) -> List[jnp.ndarray]:
    """dims: [in, hidden..., out]. Returns list of weight matrices [in, out]."""
    params = []
    keys = jax.random.split(key, len(dims) - 1)
    for k, d_in, d_out in zip(keys, dims[:-1], dims[1:]):
        bound = 1.0 / jnp.sqrt(jnp.asarray(d_in, dtype=jnp.float32))
        w = jax.random.uniform(k, (d_in, d_out), dtype=dtype,
                               minval=-bound, maxval=bound)
        params.append(w)
    return params


def mlp_apply(params: List[jnp.ndarray], x: jnp.ndarray,
              compute_dtype=None) -> jnp.ndarray:
    """ReLU between layers, linear output, fp32 result.

    compute_dtype: optional lower-precision matmul dtype (bf16 weights +
    activations with fp32 accumulation — the master params stay fp32
    in the optimizer; ref parity keeps None = full fp32)."""
    h = x if compute_dtype is None else x.astype(compute_dtype)
    for i, w in enumerate(params):
        wc = w if compute_dtype is None else w.astype(compute_dtype)
        h = jnp.dot(h, wc, preferred_element_type=jnp.float32)
        if i < len(params) - 1:
            h = jax.nn.relu(h)
            if compute_dtype is not None:
                h = h.astype(compute_dtype)
    return h
