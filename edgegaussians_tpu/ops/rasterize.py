"""Differentiable tile-based Gaussian rasterization (the L0 replacement).

JAX re-design of the external gsplat CUDA rasterizer the reference
depends on (call site: edgegaussians/models/edge_gs.py:250-268). One call
renders one camera's edge-intensity image and backpropagates to means /
quats / scales / opacities, with the gsplat 'antialiased' opacity
compensation and absgrad signal.

Pipeline (all static shapes, jit-safe):

    project (JAX, autodiff)  ->  bin (sort + prefix sums, stop-grad)
    -> gather per-tile data  ->  composite (custom VJP; GPU kernel or XLA)
    -> assemble [H, W]

Colors are implicitly all-ones (edge_gs.py:247): the rendered intensity is
the accumulated alpha, so 'rgb' and 'accumulation' outputs coincide.

Render backends (``resolve_backend``):

- ``gpu``: the segmented pair compositor (``pair_kernel="seg"``) runs as
  compiled Pallas/Triton kernels (ops/segpair.py); needs a GPU,
- ``interpret``: the same kernels on the Pallas interpreter — for tests
  and CPU rehearsals, and only when asked for by name,
- ``jax``: plain XLA for every path. A ``seg`` configuration renders
  through the single-level XLA oracle (``composite.tile_render``), which
  composites the same min(count, capacity) Gaussians per tile; only a
  pair-budget overflow (which the trainer audits) would differ.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from edgegaussians_tpu.ops import segpair, tiles as tiles_mod, vma
from edgegaussians_tpu.ops.composite import (tile_render, tile_render_two_level)
from edgegaussians_tpu.ops.projection import project_gaussians
from edgegaussians_tpu.ops.tiles import (
    assemble_image, bin_gaussians, pixel_basis, tile_origins)


BACKENDS = ("gpu", "interpret", "jax")


def resolve_backend(requested: str = "auto") -> str:
    """The render backend to use for ``requested``.

    ``'auto'`` is ``'gpu'`` when JAX's default platform is a GPU and
    ``'jax'`` otherwise; it never chooses ``'interpret'``. Asking for
    ``'gpu'`` without a GPU raises. Callers log the returned choice.
    """
    platform = jax.default_backend()
    if requested == "auto":
        return "gpu" if platform == "gpu" else "jax"
    if requested not in BACKENDS:
        raise ValueError(f"unknown render backend {requested!r}; expected "
                         f"'auto' or one of {BACKENDS}")
    if requested == "gpu" and platform != "gpu":
        raise RuntimeError(
            f"render backend 'gpu' needs a GPU, but JAX's default platform "
            f"is {platform!r}")
    return requested


class RenderResult(NamedTuple):
    image: jnp.ndarray          # [H,W] edge intensity in [0,1+] (pre-clamp)
    tile_counts: jnp.ndarray    # [T] per-tile Gaussian counts (diagnostics)
    num_visible: jnp.ndarray    # scalar: Gaussians surviving projection
    num_truncated: jnp.ndarray  # scalar: Gaussians whose tile footprint
                                # exceeded max_tiles_per_gaussian
    num_pairs: jnp.ndarray = None
                                # scalar: true (tile, Gaussian) pair count;
                                # must stay <= pair_budget when that is set
                                # or renders truncate silently (None when
                                # the pair-prefix path is off)


def rasterize(
    means: jnp.ndarray,            # [N,3]
    quats: jnp.ndarray,            # [N,4] wxyz
    scales: jnp.ndarray,           # [N,3] linear
    opacities: jnp.ndarray,        # [N] linear
    viewmat: jnp.ndarray,          # [4,4]
    K: jnp.ndarray,                # [3,3]
    width: int,
    height: int,
    *,
    tile_size: int = 16,
    capacity: int = 512,
    max_tiles_per_gaussian: int = 64,
    dense_capacity: int = 0,     # 0 = single-level; else two-level K1
    overflow_tiles: int = 0,     # 0 = auto (T//4); budget of level-2 tiles
    pair_budget: int = 0,        # 0 = off; else sorted-pair-prefix frame
                                 # build + backward reduction (two-level
                                 # and "seg" paths)
    backend: str = "jax",        # resolved: one of BACKENDS
    occupancy_sort: bool = False,
    antialiased: bool = True,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    alive: Optional[jnp.ndarray] = None,
    absgrad_sink: Optional[jnp.ndarray] = None,   # [N,2] zeros
    band_row0: Optional[jnp.ndarray] = None,  # traced int32: first tile row
    band_tile_rows: Optional[int] = None,     # static: tile rows in band
    pair_kernel=False,           # False | "seg": segmented pair
                                 # compositor (ops/segpair.py); needs
                                 # pair_budget
) -> RenderResult:
    """Render one view. Differentiable in means/quats/scales/opacities and,
    through ``absgrad_sink``'s cotangent, reports accumulated |d means2d|.

    Band mode (``band_row0`` + ``band_tile_rows``): render only a
    horizontal band of ``band_tile_rows`` tile rows starting at tile row
    ``band_row0`` — the unit of tile-sharded multi-chip rendering
    (parallel/train_sharded.py). The projection is computed in full-image
    coordinates and shifted so binning sees a ``band_tile_rows*tile_size``
    high image; Gaussians outside the band produce zero (tile, rank) pairs
    (their clipped spans collapse), so per-tile lists — and hence the
    composited band pixels — are identical to the corresponding rows of a
    full-image render. ``image`` is then ``[band_tile_rows*tile_size, W]``
    and per-tile diagnostics cover only the band.
    """
    n = means.shape[0]
    proj = project_gaussians(
        means, quats, scales, opacities, viewmat, K, width, height,
        near_plane=near_plane, far_plane=far_plane,
        antialiased=antialiased, alive=alive)
    packed = tiles_mod.pack_gaussian_render_data(proj)    # [N,8]
    return rasterize_packed(
        proj, packed, width, height, tile_size=tile_size,
        capacity=capacity, dense_capacity=dense_capacity,
        overflow_tiles=overflow_tiles, pair_budget=pair_budget,
        max_tiles_per_gaussian=max_tiles_per_gaussian, backend=backend,
        occupancy_sort=occupancy_sort,
        absgrad_sink=absgrad_sink, band_row0=band_row0,
        band_tile_rows=band_tile_rows, pair_kernel=pair_kernel)


def rasterize_packed(
    proj,                          # ProjectedGaussians (binning; stop-grad)
    packed: jnp.ndarray,           # [N,8] packed rows (differentiable)
    width: int,
    height: int,
    *,
    tile_size: int = 16,
    capacity: int = 512,
    dense_capacity: int = 0,
    overflow_tiles: int = 0,
    pair_budget: int = 0,
    max_tiles_per_gaussian: int = 64,
    backend: str = "jax",
    occupancy_sort: bool = False,
    absgrad_sink: Optional[jnp.ndarray] = None,
    band_row0: Optional[jnp.ndarray] = None,
    band_tile_rows: Optional[int] = None,
    pair_kernel=False,
) -> RenderResult:
    """Bin + composite pre-projected, pre-packed Gaussians.

    The entry point for Gaussian-axis (tensor-parallel) sharding
    (parallel/train_tp.py): devices project disjoint parameter shards,
    all-gather the cheap [N,8] packed rows, and call this on the full set —
    gradients flow through ``packed`` (transposing the all-gather into a
    reduce-scatter back to the owning shard). ``proj`` is consumed under
    stop_gradient for binning only.
    """
    n = packed.shape[0]

    if band_tile_rows is not None:
        height = band_tile_rows * tile_size
        shift = (band_row0 * tile_size).astype(jnp.float32)
        off = jnp.stack([jnp.zeros_like(shift), shift])[None, :]
        proj = proj._replace(means2d=proj.means2d - off)
        # cols 3:5 of the packed rows are the screen-space center
        packed = packed - jnp.pad(off, ((0, 0), (3, 3)))

    origins = tile_origins(width, height, tile_size)
    basis = pixel_basis(tile_size)
    if absgrad_sink is None:
        absgrad_sink = jnp.zeros((n, 2), dtype=jnp.float32)
    # Strict-vma note: under shard_map, ``absgrad_sink`` must be declared
    # varying (ops.vma.match_vma) by the caller BEFORE the function being
    # differentiated — a pvary inside the grad would transpose to a psum
    # and silently change absgrad semantics. See parallel/train_dp.py.
    # The render data then varies wherever the sink does, so the image
    # cotangent (and with it absgrad) stays per-device; for replicated
    # parameters this pvary transposes into the psum their gradient needs.
    packed = vma.match_vma(packed, absgrad_sink)
    num_tiles = tiles_mod.tile_grid(width, height, tile_size)[2]
    capacity = min(capacity, n) if n > 0 else capacity

    num_pairs = None
    if pair_kernel and pair_kernel != "seg":
        raise ValueError(f"pair_kernel={pair_kernel!r}: only 'seg' exists")
    if pair_kernel and pair_budget > 0 and backend != "jax":
        # segmented pair compositor: no dense frame, single-level per-tile
        # capacity (every tile composites min(count, capacity) — strictly
        # more complete than the two-level truncation)
        pbins = tiles_mod.bin_pairs_frame_order(
            jax.lax.stop_gradient(proj), width, height, tile_size,
            capacity, pair_budget,
            max_tiles_per_gaussian=max_tiles_per_gaussian)
        packed_sorted = packed[pbins.order]
        img_f = segpair.segpair_render(
            packed_sorted, pbins, origins, basis, absgrad_sink,
            backend == "interpret")
        # frame order -> tile order (autodiff transposes to a gather)
        tile_imgs = jnp.zeros_like(img_f).at[pbins.perm].set(
            img_f, unique_indices=True)
        image = assemble_image(tile_imgs, width, height, tile_size)
        return RenderResult(
            image=image, tile_counts=pbins.counts,
            num_visible=jnp.sum(proj.valid.astype(jnp.int32)),
            num_truncated=pbins.num_truncated,
            num_pairs=pbins.num_pairs)
    if 0 < dense_capacity < capacity and not pair_kernel:
        # two-level: dense K1 everywhere + overflow budget of busy tiles
        t2 = overflow_tiles or max(num_tiles // 4, 8)
        t2 = min(t2, num_tiles)
        k1, k2 = dense_capacity, capacity - dense_capacity
        bins2 = tiles_mod.bin_gaussians_two_level(
            jax.lax.stop_gradient(proj), width, height, tile_size,
            k1, k2, t2, max_tiles_per_gaussian=max_tiles_per_gaussian,
            pair_budget=pair_budget, occupancy_sort=occupancy_sort)
        packed_sorted = packed[bins2.order]               # [N,8] cheap permute
        origins_f = (origins[bins2.tile_perm]
                     if bins2.tile_perm is not None else origins)
        tile_imgs = tile_render_two_level(
            packed_sorted, bins2, origins_f, basis,
            bins2.order, absgrad_sink, k1, k2)
        if bins2.tile_perm is not None:
            # frame rows -> tile order (scatter by the forward permutation;
            # autodiff transposes this into the matching gather)
            tile_imgs = jnp.zeros_like(tile_imgs).at[bins2.tile_perm].set(
                tile_imgs, unique_indices=True)
        tile_counts = bins2.counts
        num_truncated = bins2.num_truncated
        num_pairs = bins2.num_pairs
    else:
        bins = bin_gaussians(jax.lax.stop_gradient(proj), width, height,
                             tile_size, capacity,
                             max_tiles_per_gaussian=max_tiles_per_gaussian)
        packed_sorted = packed[bins.order]
        gathered = packed_sorted[bins.ranks]              # [T,Kc,8] row gather
        slot_validf = bins.valid.astype(jnp.float32)
        tile_imgs = tile_render(gathered, slot_validf, origins,
                                basis, bins.ranks, bins.order, absgrad_sink)
        tile_counts = bins.counts
        num_truncated = bins.num_truncated
    image = assemble_image(tile_imgs, width, height, tile_size)
    return RenderResult(
        image=image,
        tile_counts=tile_counts,
        num_visible=jnp.sum(proj.valid.astype(jnp.int32)),
        num_truncated=num_truncated,
        num_pairs=num_pairs)
