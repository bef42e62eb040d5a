"""Device profiling hooks.

The reference only has the wall-clock Timer (SURVEY.md §5.1); here we add
`jax.profiler` trace capture so kernels show up in TensorBoard/XProf, plus a
tiny helper to time a jitted callable with block_until_ready.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable


@contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace for the enclosed block."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_jitted(fn: Callable, *args, warmup: int = 1, iters: int = 10,
                **kw) -> float:
    """Median seconds per call of a jitted fn, device-synchronized."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kw))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
