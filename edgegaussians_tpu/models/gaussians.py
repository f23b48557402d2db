"""Functional Gaussian model state (fixed-capacity, masked).

The functional counterpart of the reference's mutable
``torch.nn.ParameterDict`` model (edge_gs.py:61-133). Parameters live in
fixed-capacity ``[N_max, ...]`` arrays with an ``alive`` mask so every
jitted computation — rendering, losses, adaptive density control — keeps
static shapes. Parameterization matches the reference exactly: log scales,
logit opacities, wxyz quats (edge_gs.py:78-103).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from edgegaussians_tpu.config import ModelConfig, resolve_capacity
from edgegaussians_tpu.data.seed_points import random_quats
from edgegaussians_tpu.io import ply as ply_io
from edgegaussians_tpu.ops.rasterize import RenderResult, rasterize


class GaussianParams(NamedTuple):
    """The four optimized parameter groups (edge_gs.py:96-103)."""
    means: jnp.ndarray       # [Nmax,3]
    scales: jnp.ndarray      # [Nmax,3] log-space
    quats: jnp.ndarray       # [Nmax,4] wxyz
    opacities: jnp.ndarray   # [Nmax,1] logit-space


class GaussianState(NamedTuple):
    """Params + bookkeeping the density controller mutates."""
    params: GaussianParams
    alive: jnp.ndarray          # [Nmax] bool
    absgrads: jnp.ndarray       # [Nmax] accumulated ||d means2d|| (abs)
    absgrad_count: jnp.ndarray  # scalar f32 normalize factor (edge_gs.py:613)

    @property
    def capacity(self) -> int:
        return self.alive.shape[0]

    def num_alive(self) -> jnp.ndarray:
        return jnp.sum(self.alive.astype(jnp.int32))


def init_state(seed_points: np.ndarray, config: ModelConfig,
               seed: int = 0, capacity: Optional[int] = None) -> GaussianState:
    """Populate the model from seed points (edge_gs.py:67-104).

    Scales start at log(init_scales_val), opacities at
    logit(init_opacity_val), quats uniform-random on SO(3).
    """
    n = seed_points.shape[0]
    cap = capacity or resolve_capacity(config, n)
    if n > cap:
        raise ValueError(f"{n} seed points exceed capacity {cap}")
    rng = np.random.default_rng(seed)

    means = np.zeros((cap, 3), dtype=np.float32)
    means[:n] = seed_points

    scales = np.full((cap, 3), math.log(config.init_scales_val),
                     dtype=np.float32)
    opacities = np.full(
        (cap, 1), math.log(config.init_opacity_val /
                           (1.0 - config.init_opacity_val)),
        dtype=np.float32)
    quats = random_quats(cap, rng)

    alive = np.zeros((cap,), dtype=bool)
    alive[:n] = True

    return GaussianState(
        params=GaussianParams(
            means=jnp.asarray(means), scales=jnp.asarray(scales),
            quats=jnp.asarray(quats), opacities=jnp.asarray(opacities)),
        alive=jnp.asarray(alive),
        absgrads=jnp.zeros((cap,), dtype=jnp.float32),
        absgrad_count=jnp.asarray(1.0, dtype=jnp.float32))


def linear_scales(params: GaussianParams) -> jnp.ndarray:
    return jnp.exp(params.scales)


def linear_opacities(params: GaussianParams) -> jnp.ndarray:
    return jax.nn.sigmoid(params.opacities[:, 0])


def render_view(params: GaussianParams, alive: jnp.ndarray,
                viewmat: jnp.ndarray, K: jnp.ndarray,
                width: int, height: int, *,
                tile_size: int = 16, capacity: int = 512,
                dense_capacity: int = 0, overflow_tiles: int = 0,
                pair_budget: int = 0, occupancy_sort: bool = False,
                pair_kernel: bool = False,
                max_tiles_per_gaussian: int = 64,
                backend: str = "jax", antialiased: bool = True,
                absgrad_sink: Optional[jnp.ndarray] = None,
                band_row0: Optional[jnp.ndarray] = None,
                band_tile_rows: Optional[int] = None) -> RenderResult:
    """Render one camera from the model state (edge_gs.py:197-286).

    Applies the exp/sigmoid reparameterizations at the rasterizer boundary
    exactly as the reference's get_outputs does (edge_gs.py:253-254).
    Band mode renders a horizontal tile-row band (see ops.rasterize).
    """
    return rasterize(
        params.means, params.quats, linear_scales(params),
        linear_opacities(params), viewmat, K, width, height,
        tile_size=tile_size, capacity=capacity,
        dense_capacity=dense_capacity, overflow_tiles=overflow_tiles,
        pair_budget=pair_budget, occupancy_sort=occupancy_sort,
        pair_kernel=pair_kernel,
        max_tiles_per_gaussian=max_tiles_per_gaussian,
        backend=backend, antialiased=antialiased, alive=alive,
        absgrad_sink=absgrad_sink,
        band_row0=band_row0, band_tile_rows=band_tile_rows)


def export_as_ply(state: GaussianState, ply_path: str) -> int:
    """Write live Gaussians in the reference PLY contract (edge_gs.py:635-642).

    Linear scales/opacities, compacted to alive rows. Returns the count.
    """
    alive = np.asarray(state.alive)
    means = np.asarray(state.params.means)[alive]
    scales = np.exp(np.asarray(state.params.scales))[alive]
    quats = np.asarray(state.params.quats)[alive]
    opac = 1.0 / (1.0 + np.exp(-np.asarray(state.params.opacities)))
    ply_io.write_gaussian_params_as_ply(means, scales, quats, opac[alive],
                                        ply_path)
    return int(alive.sum())


def load_from_ply(ply_path: str, config: ModelConfig,
                  capacity: Optional[int] = None) -> GaussianState:
    """Rebuild a state from an exported PLY (inverse of export_as_ply)."""
    pos, scales_lin, quats, opac_lin = ply_io.read_gaussian_params_from_ply(
        ply_path)
    n = pos.shape[0]
    cap = capacity or resolve_capacity(config, n)
    state = init_state(pos, config, capacity=cap)
    eps = 1e-7
    scales_log = np.log(np.maximum(scales_lin, eps))
    opac_logit = np.log(np.clip(opac_lin, eps, 1 - eps) /
                        (1 - np.clip(opac_lin, eps, 1 - eps)))
    params = GaussianParams(
        means=state.params.means,
        scales=state.params.scales.at[:n].set(jnp.asarray(scales_log)),
        quats=state.params.quats.at[:n].set(jnp.asarray(quats)),
        opacities=state.params.opacities.at[:n].set(jnp.asarray(opac_logit)))
    return state._replace(params=params)
