"""Device mesh helpers.

The reference is single-GPU with no distributed execution (SURVEY.md §2.7).
The one scale axis is:
  * 'data' — the ray batch (rays are embarrassingly parallel; grads
    all-reduced by XLA) and the voxel axis of dense volume queries.
The mesh is 1-D over every visible device: on cards joined all to all
(NVLink) every device reaches every other at the same rate, so the mesh
follows the algorithm alone. Params (hash table ~13M floats, MLPs tiny)
are replicated — tensor parallelism would be counterproductive at this
size.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "data") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (axis_name,))


def data_sharding(mesh: Mesh, axis_name: str = "data") -> NamedSharding:
    """First-dim sharding for ray/voxel batches."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
