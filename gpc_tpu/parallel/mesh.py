"""Device mesh helpers for multi-chip / multi-host GP training.

The reference is strictly single-process single-thread (SURVEY.md §2.15); this
module supplies the communication backend the rebuild introduces: a 1-D data
mesh (axis "dp") over all devices — the cards of a host are joined all to
all by NVLink, so the mesh follows the algorithm alone; hosts join via
jax.distributed — with row-block sharding of (X, y) and psum-reduced
likelihood terms.  The SCG control flow stays replicated: every device computes
identical line-search scalars from mesh-deterministic reductions.
"""

from __future__ import annotations

import math

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "dp"


def data_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (DATA_AXIS,))


def pad_rows(arr, multiple: int):
    """Pad axis 0 to a multiple (sharding needs equal blocks); returns
    (padded, n_valid)."""
    n = arr.shape[0]
    target = math.ceil(n / multiple) * multiple
    if target == n:
        return arr, n
    pad = np.zeros((target - n,) + arr.shape[1:], dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0), n


def shard_rows(mesh: Mesh, arr):
    """Place an array row-sharded over the data axis."""
    return jax.device_put(arr, NamedSharding(mesh, P(DATA_AXIS)))


def replicated(mesh: Mesh, arr):
    return jax.device_put(arr, NamedSharding(mesh, P()))
