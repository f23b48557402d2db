"""Multi-host scaffolding: jax.distributed initialization + mesh layout.

The reference is single-process/single-GPU (SURVEY §2.2); this module holds
the multi-host entry points. On a multi-host cluster every host runs the
same program: ``initialize()`` wires the JAX runtime across hosts, after
which ``jax.devices()`` spans every host's devices and the existing
shard_map training paths (parallel/train_sharded.py, parallel/train_dp.py)
scale unchanged — XLA routes the psums over the devices' interconnect
(NVLink within a host) and the network across hosts.

Single-process (CI, one chip, CPU mesh) is the default: ``initialize()``
is a no-op unless multi-host coordinates are provided explicitly or via
standard cluster env vars, so every CLI can call it unconditionally.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed for multi-host runs; no-op otherwise.

    Coordinates come from arguments or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID). Returns
    True when a multi-process runtime was initialized.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes in (None, 1):
        return False   # single-process: nothing to initialize

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    return True


def replicate(tree, mesh: Mesh):
    """Fully-replicated global arrays on ``mesh`` from host values every
    process holds identically.

    In a multi-controller run (``initialize()`` with num_processes > 1) a
    jit over a global mesh needs inputs that are global jax.Arrays; plain
    host arrays are process-local. Every process already holds the same
    bytes (same dataset, same seeded init), so the global array is built
    locally with ``make_array_from_callback`` — no cross-host transfer.
    Single-process it's an ordinary replicated device_put.
    """
    from jax.sharding import NamedSharding, PartitionSpec
    sh = NamedSharding(mesh, PartitionSpec())

    def put(x):
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, sh,
                                            lambda idx: x[idx])

    return jax.tree.map(put, tree)


def tiles_mesh(n_devices: Optional[int] = None,
               devices: Optional[Sequence] = None) -> Mesh:
    """A 1-axis ('tiles',) mesh over the first n devices (default: all).

    With multiple hosts, jax.devices() already spans the pod; devices of
    one host are contiguous, so a tiles axis across all of them keeps the
    per-render psum mostly inside one host."""
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("tiles",))
