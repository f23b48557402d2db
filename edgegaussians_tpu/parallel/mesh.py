"""Device-mesh construction and sharding helpers.

The reference is strictly single-process single-GPU (SURVEY §2.2); all
scale-out here is new, built on ``jax.sharding.Mesh`` + ``shard_map`` with
XLA collectives over the device interconnect. Two mesh axes cover this workload's parallelism:

- ``views``: camera/data parallelism — each device renders a disjoint subset
  of the view batch; Gaussian parameters are replicated and gradients are
  ``psum``-reduced (the DP row of SURVEY §2.2),
- ``tiles``: intra-view pixel/tile parallelism (the workload's
  sequence/context-parallel analog — SURVEY §5.7): each device rasterizes a
  tile slice of the SAME view, preserving the reference's per-view SGD
  semantics while scaling a single render.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(view_axis: int = 0, tile_axis: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('views', 'tiles') mesh. view_axis=0 means 'use all devices
    on the views axis'."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if view_axis <= 0:
        view_axis = max(n // max(tile_axis, 1), 1)
    if view_axis * tile_axis > n:
        raise ValueError(
            f"mesh {view_axis}x{tile_axis} exceeds {n} devices")
    dev_array = np.array(devices[: view_axis * tile_axis]).reshape(
        view_axis, tile_axis)
    return Mesh(dev_array, ("views", "tiles"))


def make_views_gauss_mesh(view_axis: int, gauss_axis: int,
                          devices: Optional[Sequence] = None) -> Mesh:
    """Build a ('views', 'gauss') mesh: DP over view shards composed with
    Gaussian-axis TP inside each view row (parallel/train_dp.py composed-TP
    mode) — the large-capacity multi-host recipe of docs/SCALING.md §4."""
    devices = list(devices if devices is not None else jax.devices())
    n = view_axis * gauss_axis
    if n > len(devices):
        raise ValueError(
            f"mesh {view_axis}x{gauss_axis} exceeds {len(devices)} devices")
    return Mesh(np.array(devices[:n]).reshape(view_axis, gauss_axis),
                ("views", "gauss"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def view_sharded(mesh: Mesh) -> NamedSharding:
    """Shard axis 0 (views) across the 'views' mesh axis."""
    return NamedSharding(mesh, P("views"))


def tile_sharded(mesh: Mesh) -> NamedSharding:
    """Shard axis 0 (tiles) across the 'tiles' mesh axis."""
    return NamedSharding(mesh, P("tiles"))
