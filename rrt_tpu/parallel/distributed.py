"""Multi-host execution: `jax.distributed` init + global-mesh helpers.

The reference is a single-process pthread renderer (`pathtracer.cpp:243-281`);
its only "multi-host" story is running the binary twice. The equivalent
here (SURVEY §2.5) is one SPMD program per host under
`jax.distributed.initialize`: every process sees the global device list,
builds the same 1-D lane mesh over it, feeds its *local* shard of the ray
batch through `make_global_batch`, and GSPMD inserts the collectives
(the film gather, gradient all-reduce) automatically.

Entry points:
  initialize(...)        — explicit coordinator/num_processes/process_id
  initialize_from_env()  — picks up RRT_COORDINATOR / RRT_NUM_PROCESSES /
                           RRT_PROCESS_ID (or defers to jax's own cluster
                           auto-detection where the platform provides it)
  global_mesh()          — 1-D "batch" mesh over all processes' devices
  make_global_batch(...) — local numpy shard → globally-sharded jax.Array
  all_processes_done()   — barrier (used around checkpoint writes)

Tested in tests/test_distributed.py by spawning 2 real OS processes with a
localhost coordinator on the CPU backend (gloo collectives), asserting a
cross-process psum — the same code path a multi-host GPU run takes.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rrt_tpu.parallel.sharding import BATCH_AXIS

_ENV_COORD = "RRT_COORDINATOR"
_ENV_NPROC = "RRT_NUM_PROCESSES"
_ENV_PID = "RRT_PROCESS_ID"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """Idempotent wrapper over `jax.distributed.initialize`.

    Where the platform describes the cluster, all arguments are optional
    (jax auto-detects it); otherwise, as on a single GPU host, pass
    coordinator (e.g. "localhost:<port>"), num_processes and process_id.
    """
    if is_initialized():
        return
    kw = {}
    if coordinator_address is not None:
        kw["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kw["num_processes"] = int(num_processes)
    if process_id is not None:
        kw["process_id"] = int(process_id)
    if local_device_ids is not None:
        kw["local_device_ids"] = list(local_device_ids)
    jax.distributed.initialize(**kw)


def initialize_from_env() -> bool:
    """Initialize from RRT_* env vars; returns True if distributed mode was
    entered, False when the vars are absent (single-process run)."""
    coord = os.environ.get(_ENV_COORD)
    if not coord:
        return False
    initialize(coordinator_address=coord,
               num_processes=int(os.environ[_ENV_NPROC]),
               process_id=int(os.environ[_ENV_PID]))
    return True


def is_initialized() -> bool:
    try:
        return jax.distributed.is_initialized()
    except AttributeError:  # older jax
        state = getattr(jax.distributed, "global_state", None)
        return bool(state and state.client is not None)


def process_index() -> int:
    return jax.process_index()


def process_count() -> int:
    return jax.process_count()


def global_mesh(axis: str = BATCH_AXIS) -> Mesh:
    """1-D mesh over the GLOBAL device list (all hosts)."""
    return Mesh(np.array(jax.devices()), (axis,))


def make_global_batch(local, mesh: Mesh, axis: str = BATCH_AXIS):
    """Assemble a globally lane-sharded jax.Array from each process's local
    shard (leading axis = this host's lanes). Every leaf's global leading
    axis is process_count() * local_lanes."""
    sh = NamedSharding(mesh, P(axis))
    return jax.tree_util.tree_map(
        lambda a: jax.make_array_from_process_local_data(sh, np.asarray(a)),
        local)


def replicate_global(tree, mesh: Mesh):
    """Replicate scene-like pytrees onto every device of the global mesh.
    All processes must pass bit-identical values."""
    sh = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda a: jax.make_array_from_process_local_data(
            sh, np.asarray(a)), tree)


def all_processes_done(name: str = "rrt_barrier") -> None:
    """Cross-process barrier (no-op single-process)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(name)
