"""Device-mesh sharding: the replacement for the pthread tile pool.

The reference parallelizes with a mutex work queue over 32×32 tiles
(`pathtracer.cpp:243-281`, `work_queue.h:11-51`). Here the unit of
parallelism is the flat ray-lane axis of every megabatch: lanes are sharded
across a 1-D `jax.sharding.Mesh` ("batch" axis), the scene/BVH/BSDF tables
are replicated (they are small), and XLA's GSPMD partitioner runs the whole
wavefront per-device with no cross-device traffic in the forward pass.
Gradients of sharded renders are all-reduced automatically by GSPMD when the loss sums over lanes (the psum the reference never needed,
SURVEY §2.5).

Multi-host: the same program runs under `jax.distributed.initialize`; the
mesh then spans all hosts' devices and the batch axis shards globally.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


BATCH_AXIS = "batch"


def make_mesh(devices: Optional[Sequence] = None,
              axis: str = BATCH_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), (axis,))


def batch_sharding(mesh: Mesh, axis: str = BATCH_AXIS) -> NamedSharding:
    """Shard the leading (lane) axis; trailing axes replicated."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(tree, mesh: Mesh, axis: str = BATCH_AXIS):
    """Place every leaf of a ray-batch pytree with its leading axis sharded
    over the mesh."""
    sh = batch_sharding(mesh, axis)
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), tree)


def replicate(tree, mesh: Mesh):
    """Replicate scene-like pytrees across the mesh."""
    sh = replicated(mesh)
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sh), tree)


def pad_to_multiple(n: int, k: int) -> int:
    return -(-n // k) * k
