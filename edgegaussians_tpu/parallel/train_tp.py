"""Gaussian-axis (tensor-parallel) sharding for large-N scenes.

The SURVEY §2.2 TP row: shard the N-Gaussian axis of the projection work
across the mesh, then all-gather the cheap packed screen-space rows so each
device bins and composites its own tile band of the SAME view (reference
param store being scaled: edge_gs.py:96-103; DTU/Replica run 20k seeds
growing to 131k capacity — configs/DTU.json).

Per render on a d-way 'gauss' axis:

1. every device projects its N/d parameter shard (quat->R, Sigma, EWA
   conic, antialias compensation — the O(N) math shards perfectly),
2. ``all_gather`` of the [N,8] packed rows + depths + radii (~4.5 MB at
   DTU's 131k capacity — cheap over NVLink),
3. each device bins + composites its tile-row band against the full set
   (ops.rasterize.rasterize_packed with band args) — the compositing also
   shards d ways; only the fused-key pair sort stays replicated (static
   shapes: a band's candidate pairs are the full N x M set with non-band
   pairs invalidated),
4. the backward transposes the all-gather into a reduce-scatter: packed
   cotangents psum back to the owning shard and flow through the LOCAL
   projection VJP; full [N] parameter grads are reassembled with a
   dynamic-update-slice + psum so the surrounding (replicated) Adam step
   is unchanged.

Implements the trainer proj-grad contract, so ``make_tp_epoch_fn`` trains
with exact single-device semantics (tests/test_train_tp.py pins the
trajectory). The direction/ratio losses and density control stay
replicated — they are O(N)–O(N^2 top-k) between-render work outside the
hot path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from edgegaussians_tpu.config import FrameworkConfig
from edgegaussians_tpu.ops import vma as vma_mod
from edgegaussians_tpu.ops.projection import (ProjectedGaussians,
                                              project_gaussians)
from edgegaussians_tpu.ops.rasterize import rasterize_packed
from edgegaussians_tpu.ops.tiles import pack_gaussian_render_data, tile_grid
from edgegaussians_tpu.parallel import bands
from edgegaussians_tpu.parallel.bands import band_geometry
from edgegaussians_tpu.train import trainer as trainer_mod
from edgegaussians_tpu.train.trainer import ProjGradStats


def make_tp_proj_grad_fn(cfg: FrameworkConfig, width: int, height: int,
                         backend: str, mesh: Mesh, axis: str = "gauss"):
    """Gaussian-axis-sharded projection loss+grad (trainer contract).

    Parameters stay replicated at rest (the Adam step and density control
    are untouched); the projection/binning/compositing WORK shards over
    ``mesh.shape[axis]``. Capacity must divide the axis size.
    """
    mcfg = cfg.model
    pl_cfg = cfg.training.loss.projection_losses
    ts_px = mcfg.tile_size
    ntx, nty, num_tiles = tile_grid(width, height, ts_px)
    d = mesh.shape[axis]
    rows_per, band_h, pad_h = band_geometry(width, height, ts_px, d)
    ovf_full = mcfg.tile_overflow_tiles or max(num_tiles // 4, 8)
    render_kwargs = dict(
        tile_size=ts_px, capacity=mcfg.tile_gaussian_capacity,
        dense_capacity=mcfg.tile_dense_capacity,
        overflow_tiles=min(ovf_full, rows_per * ntx),
        pair_budget=mcfg.tile_pair_budget,
        occupancy_sort=mcfg.tile_occupancy_sort,
        pair_kernel=mcfg.tile_pair_kernel,
        max_tiles_per_gaussian=mcfg.max_tiles_per_gaussian,
        backend=backend)
    antialiased = mcfg.rasterize_mode == "antialiased"

    @functools.partial(vma_mod.shard_map, mesh=mesh,
                       in_specs=(P(),) * 9,
                       out_specs=(P(), P(), P(), P()), backend=backend)
    def sharded(params, alive, viewmat, K, gt, edge_mask, strategy_idx,
                bg_ratio, key):
        n = params.means.shape[0]
        if n % d:
            raise ValueError(f"capacity {n} not divisible by '{axis}' "
                             f"axis size {d}")
        shard_n = n // d
        me = jax.lax.axis_index(axis)
        g0 = me * shard_n
        row0 = (me * rows_per).astype(jnp.int32)
        y0 = row0 * ts_px

        p_sh = jax.tree.map(
            lambda x: jax.lax.dynamic_slice_in_dim(x, g0, shard_n, 0),
            params)
        alive_sh = jax.lax.dynamic_slice_in_dim(alive, g0, shard_n, 0)
        p_sh = jax.tree.map(lambda x: vma_mod.match_vma(x, row0), p_sh)
        sink0 = vma_mod.match_vma(
            jnp.zeros((n, 2), jnp.float32), row0)

        gt_b, em_b, valid_b = bands.band_inputs(gt, edge_mask, y0, band_h,
                                                pad_h, height, width)

        def band_loss(pred):
            # band-PARTIAL losses with globally-known denominators; see
            # parallel/bands.py for why no psum may appear here
            return bands.band_partial_loss(
                pred, gt_b, em_b, valid_b, edge_mask, strategy_idx,
                bg_ratio, key, loss_type=pl_cfg.loss_type, height=height,
                width=width, y0=y0, band_h=band_h, pad_h=pad_h)

        def loss_fn(p_sh, sink):
            # 1. project MY parameter shard
            proj_sh = project_gaussians(
                p_sh.means, p_sh.quats, jnp.exp(p_sh.scales),
                jax.nn.sigmoid(p_sh.opacities[:, 0]), viewmat, K,
                width, height, antialiased=antialiased, alive=alive_sh)
            packed_sh = pack_gaussian_render_data(proj_sh)   # [N/d, 8]
            # 2. all-gather the packed rows (+ binning metadata); the
            #    gather's transpose reduce-scatters the cotangents back
            packed = jax.lax.all_gather(packed_sh, axis, tiled=True)
            depths = jax.lax.all_gather(proj_sh.depths, axis, tiled=True)
            radii = jax.lax.all_gather(proj_sh.radii, axis, tiled=True)
            proj = ProjectedGaussians(
                means2d=packed[:, 3:5],
                conics=packed[:, 0:3],
                depths=depths, radii=radii,
                opacities=jnp.exp(packed[:, 5]),
                valid=packed[:, 6] > 0)
            # 3. bin + composite MY tile band against the full set
            out = rasterize_packed(
                proj, packed, width, height, absgrad_sink=sink,
                band_row0=row0, band_tile_rows=rows_per, **render_kwargs)
            pred = jnp.clip(out.image, 0.0, 1.0)
            return band_loss(pred), out

        (proj_loss, out), (g_sh, gsink) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(p_sh, sink0)

        # 4. reassemble full replicated grads: each device owns rows
        #    [g0, g0+shard_n); slice-in + psum
        def full(g_shard, like):
            z = jnp.zeros_like(like)
            return jax.lax.psum(
                jax.lax.dynamic_update_slice_in_dim(z, g_shard, g0, 0),
                axis)

        gparams = jax.tree.map(full, g_sh, params)
        stats = ProjGradStats(
            max_tile=jax.lax.pmax(jnp.max(out.tile_counts), axis),
            n_overflow=jax.lax.psum(
                jnp.sum((out.tile_counts > mcfg.tile_dense_capacity)
                        .astype(jnp.int32)), axis),
            num_truncated=jax.lax.psum(out.num_truncated, axis),
            # pmax, not psum: every band keeps the full pair_budget
            # (render_kwargs above), so the budget check compares against
            # the busiest band
            num_pairs=(None if out.num_pairs is None
                       else jax.lax.pmax(out.num_pairs, axis)))
        return (jax.lax.psum(proj_loss, axis), stats, gparams,
                jax.lax.psum(gsink, axis))

    return sharded


def make_tp_epoch_fn(cfg: FrameworkConfig, width: int, height: int,
                     backend: str, mesh: Mesh, axis: str = "gauss"):
    """Full-semantics epoch program with Gaussian-axis-sharded renders."""
    proj = make_tp_proj_grad_fn(cfg, width, height, backend, mesh, axis)
    memo_extra = ("tp", axis, tuple(mesh.shape.items()))
    return trainer_mod.make_epoch_fn(cfg, width, height, backend,
                                     proj_grad_fn=proj,
                                     memo_extra=memo_extra)
