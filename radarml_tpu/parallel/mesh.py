"""Device mesh construction and batch sharding.

The reference is a single-process Raspberry Pi program with no
distribution at all (SURVEY.md §2.3); this module is the greenfield
scale-out layer the JAX re-design adds: a named mesh, batch-DP
shardings for training and batched inference (samples are independent
— the natural parallel axis of this workload), and replicated params
with XLA-inserted collectives over ICI.

The mesh is 1-D ('data') by default; `make_mesh` accepts an explicit
shape for future model axes so call sites don't change when a 'model'
axis appears.

Multi-process / multi-slice (DCN) support: `init_distributed` wraps
`jax.distributed.initialize` so several host processes (one per GPU
slice or VM) form one global runtime — `jax.devices()` then spans all
processes, `make_mesh` builds a global mesh over it, and XLA routes
the DP all-reduce over ICI within a slice and DCN across slices with
no code change in the train steps. `local_to_global` assembles a
globally-sharded batch from each process's local shard (the host
data-loading seam). Tested with a 2-process × 4-virtual-CPU-device
runtime in tests/test_parallel.py.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join this host process to the global (DCN) JAX runtime.

    Call once per process before any device query. Nothing tells JAX
    of a GPU cluster, so give the process-0 address, world size, and
    this process's rank. Idempotent: a second call is a no-op.
    """
    # Idempotence check that must NOT touch the backend (jax.devices/
    # process_count would initialize XLA, after which distributed
    # init is rejected).
    try:
        from jax._src.distributed import global_state as _gs

        if _gs.client is not None:
            return  # already distributed
    except ImportError:  # pragma: no cover - jax internals moved
        pass
    if (
        coordinator_address is None
        and num_processes is None
        and process_id is None
    ):
        jax.distributed.initialize()
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )


def local_to_global(mesh: Mesh, *arrays):
    """Assemble globally-sharded arrays from per-process local shards.

    Each process passes its own contiguous slice of the global batch
    (leading axis); the result is one logical array sharded over
    'data' across every process's devices — the input seam between
    host-local data loading and the global DP train step.
    """
    sh = NamedSharding(mesh, P(DATA_AXIS))
    out = tuple(
        jax.make_array_from_process_local_data(sh, np.asarray(a))
        for a in arrays
    )
    return out if len(out) > 1 else out[0]


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (DATA_AXIS,),
) -> Mesh:
    """Build a mesh over the first n_devices (defaults to all).

    With shape given, devices are arranged (data, model, ...); the
    default is a flat data-parallel mesh.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"requested {n_devices} devices, only {len(devices)} available"
        )
    devices = devices[:n_devices]
    if shape is None:
        shape = (n_devices,)
    if int(np.prod(shape)) != n_devices:
        raise ValueError(f"mesh shape {shape} != {n_devices} devices")
    if len(axis_names) != len(shape):
        axis_names = tuple(axis_names) + tuple(
            f"axis{i}" for i in range(len(axis_names), len(shape))
        )
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, tuple(axis_names))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, *arrays):
    """device_put arrays with their leading axis split across 'data'."""
    sh = batch_sharding(mesh)
    out = tuple(jax.device_put(a, sh) for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate(mesh: Mesh, tree):
    """device_put a pytree fully replicated across the mesh."""
    return jax.device_put(tree, replicated(mesh))
