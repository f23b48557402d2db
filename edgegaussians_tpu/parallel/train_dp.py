"""Multi-chip training steps: view data-parallelism and tile sharding.

Two scale-out strategies over a ('views', 'tiles') mesh (see mesh.py), both
expressed with ``shard_map`` so XLA inserts the collectives:

- :func:`make_dp_train_step` — *view batch* mode: every device renders its
  shard of the view batch, local gradients are accumulated over a
  ``lax.scan`` and ``psum``-reduced across the mesh; one Adam step per
  batch, with the full loss surface (strategy alternation on the
  batch-step counter, direction/ratio losses every 5 batch steps, absgrad
  accumulation). Large-batch THROUGHPUT semantics — the reference's exact
  per-view SGD cadence is parallel/train_sharded.py's job.

  **Hierarchical composition** (the production multi-host recipe,
  docs/SCALING.md §4): when the mesh's 'tiles' axis has size > 1, each
  view's render+backward additionally spans the 'tiles' axis — every
  device renders its tile-row BAND of its view shard (band-partial losses
  from parallel/bands.py), and gradients psum over BOTH axes. DP across
  hosts rides the cheap per-batch psum over the network while tile-band
  splits each render's latency/memory inside a host over NVLink. Composition is
  exact: band renders equal the matching rows of a full render and band
  losses sum to the full-image loss, so a (v, t) mesh follows the
  (v, 1) trajectory to f32 reduction-order noise
  (tests/test_train_dp_trajectory.py).

  **DP x TP composition** (('views','gauss') mesh): the large-capacity
  variant of the same recipe — inside each view row the render runs the
  Gaussian-axis TP pattern (project MY parameter shard → all-gather the
  packed [N,8] rows → composite MY tile band; parallel/train_tp.py), so
  the per-chip projection/compositing memory and work scale down by the
  'gauss' axis while DP scales view throughput across hosts. Gradients
  accumulate in shard space over the view scan and reassemble with one
  dynamic-update-slice + psum over both axes. Exact: follows the (v, 1)
  trajectory to f32 noise (tests/test_train_dp_trajectory.py).
- :func:`make_tile_sharded_render` — *tile* mode: one view's tile axis is
  sharded so a single render (and its backward) spans the 'tiles' axis;
  parameter gradients psum back to replicas. Preserves per-view SGD
  semantics while scaling one render.

Gaussian parameters are replicated; gradients are reduced via ``psum``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from edgegaussians_tpu.config import FrameworkConfig
from edgegaussians_tpu.ops import vma as vma_mod
from edgegaussians_tpu.models import losses
from edgegaussians_tpu.parallel import bands
from edgegaussians_tpu.models.gaussians import GaussianParams, render_view
from edgegaussians_tpu.train import optim
from edgegaussians_tpu.train.trainer import TrainState


def make_dp_train_step(cfg: FrameworkConfig, width: int, height: int,
                       backend: str, mesh: Mesh):
    """Build a jitted view-data-parallel batch step.

    Views (axis 0 of images/viewmats/Ks) must be sharded across the 'views'
    mesh axis and divisible by its size; parameters replicated. When the
    mesh's 'tiles' axis has size > 1, each render additionally spans that
    axis (hierarchical DP x tile-band — module docstring).

    Returns ``dp_step(ts, epoch, images, edge_masks, viewmats, Ks) ->
    (ts, batch_mean_loss, max_pairs)`` where ``max_pairs`` is the batch's
    peak per-render (tile, Gaussian) pair count (0 when the pair-prefix
    path is off) — the overflow watermark trainer.train checks against
    ``tile_pair_budget``.
    """
    mcfg = cfg.model
    pl_cfg = cfg.training.loss.projection_losses
    from edgegaussians_tpu.ops.tiles import tile_grid
    ntx, nty, num_tiles = tile_grid(width, height, mcfg.tile_size)
    n_tiles_axis = dict(mesh.shape).get("tiles", 1)
    n_gauss_axis = dict(mesh.shape).get("gauss", 1)
    composed = n_tiles_axis > 1
    # DP x TP: ('views','gauss') mesh — every view shard's render runs
    # the TP pattern (project MY Gaussian shard -> all-gather packed
    # rows -> composite MY tile band; parallel/train_tp.py) inside its
    # view row. The per-chip memory/work axis for DTU/Replica-scale
    # capacities composed with DP across hosts (docs/SCALING.md §4).
    composed_tp = n_gauss_axis > 1
    band_axis = "tiles" if composed else "gauss"
    if composed or composed_tp:
        rows_per, band_h, pad_h = bands.band_geometry(
            width, height, mcfg.tile_size, n_tiles_axis * n_gauss_axis)
        ovf_full = mcfg.tile_overflow_tiles or max(num_tiles // 4, 8)
        overflow_tiles = min(ovf_full, rows_per * ntx)
    else:
        rows_per, band_h, pad_h = nty, nty * mcfg.tile_size, \
            nty * mcfg.tile_size
        overflow_tiles = mcfg.tile_overflow_tiles
    render_kwargs = dict(
        tile_size=mcfg.tile_size, capacity=mcfg.tile_gaussian_capacity,
        dense_capacity=mcfg.tile_dense_capacity,
        overflow_tiles=overflow_tiles,
        pair_budget=mcfg.tile_pair_budget,
        occupancy_sort=mcfg.tile_occupancy_sort,
        pair_kernel=mcfg.tile_pair_kernel,
        max_tiles_per_gaussian=mcfg.max_tiles_per_gaussian,
        backend=backend, antialiased=(mcfg.rasterize_mode == "antialiased"))
    strat_before = losses_strategy_index(pl_cfg.loss_before_alternating)
    strat_less = losses_strategy_index(pl_cfg.less_freq_loss)
    strat_more = losses_strategy_index(pl_cfg.more_freq_loss)
    sampling_ratio = max(int(pl_cfg.sampling_whole_num_epochs_ratio), 1)
    ol_cfg = cfg.training.loss.orientation_losses
    num_nn = ol_cfg.dir_loss_num_nn
    enforce = ol_cfg.dir_loss_enforce_method

    def local_grads(params, alive, images, edge_masks, viewmats, Ks, key,
                    strategy_idx, lambda_proj, bg_ratio, row0, g0):
        """Grad sum over this device's views (lax.scan, rematerialized).

        ``row0``: this device's first tile row (composed modes; 0 and
        unused otherwise). Composed modes render only the [row0,
        row0+rows_per) band of each view and compute band-PARTIAL losses;
        the caller's psum over both mesh axes is then the exact
        full-batch reduction. ``g0``: this device's first Gaussian row
        (composed-TP mode; 0 and unused otherwise) — grads accumulate in
        SHARD space and the caller reassembles them.
        """
        nv = images.shape[0]
        # Differentiate w.r.t. VARYING params so grads stay per-device
        # partials and the explicit psum below is the one true reduction.
        # Grads w.r.t. a replicated (unvarying) input inside shard_map come
        # back already cross-device-summed (the auto-inserted pvary
        # transposes to a psum), which made the explicit psum overcount by
        # the axis size — measured 4x on a 4-way mesh.
        vrefs = (images, row0) if (composed or composed_tp) else (images,)
        params = jax.tree.map(lambda x: vma_mod.match_vma(x, *vrefs),
                              params)
        y0 = (row0 * mcfg.tile_size).astype(jnp.int32)
        if composed_tp:
            if params.means.shape[0] % n_gauss_axis:
                raise ValueError(
                    f"capacity {params.means.shape[0]} not divisible by "
                    f"'gauss' axis size {n_gauss_axis} (required for the "
                    "DP x TP composed shard reassembly)")
            shard_n = params.means.shape[0] // n_gauss_axis
            p_shard = jax.tree.map(
                lambda x: jax.lax.dynamic_slice_in_dim(x, g0, shard_n, 0),
                params)
            alive_sh = jax.lax.dynamic_slice_in_dim(
                vma_mod.match_vma(alive, *vrefs), g0, shard_n, 0)
            rkw_tp = {k: v for k, v in render_kwargs.items()
                      if k != "antialiased"}

        def one_view(carry, iv):
            gsum, lsum, asum, psum_pairs, key = carry
            key, k_bg = jax.random.split(key)

            def loss_fn(p, sink):
                if composed_tp:
                    # TP pattern inside this view row (train_tp.py):
                    # project MY shard, all-gather the packed rows,
                    # composite MY band; band-partial loss
                    from edgegaussians_tpu.ops.projection import (
                        ProjectedGaussians, project_gaussians)
                    from edgegaussians_tpu.ops.rasterize import \
                        rasterize_packed
                    from edgegaussians_tpu.ops.tiles import \
                        pack_gaussian_render_data
                    proj_sh = project_gaussians(
                        p.means, p.quats, jnp.exp(p.scales),
                        jax.nn.sigmoid(p.opacities[:, 0]), viewmats[iv],
                        Ks[iv], width, height,
                        antialiased=(mcfg.rasterize_mode == "antialiased"),
                        alive=alive_sh)
                    packed_sh = pack_gaussian_render_data(proj_sh)
                    packed = jax.lax.all_gather(packed_sh, "gauss",
                                                tiled=True)
                    depths = jax.lax.all_gather(proj_sh.depths, "gauss",
                                                tiled=True)
                    radii = jax.lax.all_gather(proj_sh.radii, "gauss",
                                               tiled=True)
                    proj = ProjectedGaussians(
                        means2d=packed[:, 3:5], conics=packed[:, 0:3],
                        depths=depths, radii=radii,
                        opacities=jnp.exp(packed[:, 5]),
                        valid=packed[:, 6] > 0)
                    out = rasterize_packed(
                        proj, packed, width, height, absgrad_sink=sink,
                        band_row0=row0, band_tile_rows=rows_per, **rkw_tp)
                    pred = jnp.clip(out.image, 0.0, 1.0)
                    gt_b, em_b, valid_b = bands.band_inputs(
                        images[iv], edge_masks[iv], y0, band_h, pad_h,
                        height, width)
                    l = bands.band_partial_loss(
                        pred, gt_b, em_b, valid_b, edge_masks[iv],
                        strategy_idx, bg_ratio, k_bg,
                        loss_type=pl_cfg.loss_type, height=height,
                        width=width, y0=y0, band_h=band_h, pad_h=pad_h)
                    return l, out
                if composed:
                    out = render_view(p, alive, viewmats[iv], Ks[iv],
                                      width, height, absgrad_sink=sink,
                                      band_row0=row0,
                                      band_tile_rows=rows_per,
                                      **render_kwargs)
                    pred = jnp.clip(out.image, 0.0, 1.0)
                    gt_b, em_b, valid_b = bands.band_inputs(
                        images[iv], edge_masks[iv], y0, band_h, pad_h,
                        height, width)
                    l = bands.band_partial_loss(
                        pred, gt_b, em_b, valid_b, edge_masks[iv],
                        strategy_idx, bg_ratio, k_bg,
                        loss_type=pl_cfg.loss_type, height=height,
                        width=width, y0=y0, band_h=band_h, pad_h=pad_h)
                    return l, out
                out = render_view(p, alive, viewmats[iv], Ks[iv],
                                  width, height, absgrad_sink=sink,
                                  **render_kwargs)
                pred = jnp.clip(out.image, 0.0, 1.0)
                branches = [
                    lambda: losses.projection_loss_whole(
                        pred, images[iv], pl_cfg.loss_type),
                    lambda: losses.projection_loss_bg_edge_ratio(
                        pred, images[iv], edge_masks[iv], bg_ratio, k_bg),
                    lambda: losses.projection_loss_weighted(
                        pred, images[iv],
                        losses.compute_weight_mask(edge_masks[iv])),
                ]
                return jax.lax.switch(strategy_idx, branches), out

            # the sink's cotangent varies over 'views' (+ 'tiles' in
            # composed mode: it is derived from the device-local band
            # loss), so the primal must be declared varying too — and
            # OUTSIDE loss_fn, else the pvary transposes to a psum and
            # absgrad becomes norm-of-sum across devices
            sink0 = vma_mod.match_vma(
                jnp.zeros((params.means.shape[0], 2), jnp.float32),
                *vrefs)
            primal = p_shard if composed_tp else params
            (l, out), (g, gsink) = jax.value_and_grad(
                loss_fn, argnums=(0, 1), has_aux=True)(primal, sink0)
            if composed or composed_tp:
                # absgrad is norm-of-the-TILE-SUM per render
                # (edge_gs.py:607-613); bands hold disjoint tile subsets,
                # so the [N,2] sink cotangent psums over the band axis
                # BEFORE the norm — a small per-view collective (8N bytes)
                gsink = jax.lax.psum(gsink, (band_axis,))
            if out.num_pairs is not None:
                psum_pairs = jnp.maximum(psum_pairs, out.num_pairs)
            gsum = jax.tree.map(jnp.add, gsum, g)
            return (gsum, lsum + l,
                    asum + jnp.linalg.norm(gsink, axis=-1), psum_pairs,
                    key), None

        # the scan carries become device-varying over the sharded axes;
        # mark the initial zeros accordingly (shard_map vma tracking)
        def vary(x):
            return vma_mod.match_vma(x, *vrefs)

        def vary_v(x):      # 'views'-only (post-band-psum quantities)
            return vma_mod.match_vma(x, images)

        gsum0 = jax.tree.map(lambda x: vary(jnp.zeros_like(x)),
                             p_shard if composed_tp else params)
        (gsum, lsum, asum, pairs, _), _ = jax.lax.scan(
            one_view, (gsum0, vary(jnp.float32(0.0)),
                       vary_v(jnp.zeros((params.means.shape[0],))),
                       vary(jnp.int32(0)), key),
            jnp.arange(nv))
        return gsum, lsum, asum, pairs

    @functools.partial(
        vma_mod.shard_map, mesh=mesh,
        in_specs=(P(), P(), P("views"), P("views"), P("views"), P("views"),
                  P(), P(), P(), P()),
        out_specs=(P(), P(), P(), P()), backend=backend)
    def sharded_grads(params, alive, images, edge_masks, viewmats, Ks,
                      key, strategy_idx, lambda_proj, bg_ratio):
        # decorrelate per-device RNG along the views axis ONLY: devices in
        # the same view row must share the sampler key (composed mode
        # band-slices one replicated sampler mask per view; plain mode
        # replicates the whole render across 'tiles')
        vid = jax.lax.axis_index("views")
        key = jax.random.fold_in(key, vid)
        if composed:
            row0 = (jax.lax.axis_index("tiles")
                    * rows_per).astype(jnp.int32)
        elif composed_tp:
            row0 = (jax.lax.axis_index("gauss")
                    * rows_per).astype(jnp.int32)
        else:
            row0 = jnp.int32(0)
        g0 = ((jax.lax.axis_index("gauss")
               * (params.means.shape[0] // n_gauss_axis)).astype(jnp.int32)
              if composed_tp else jnp.int32(0))
        g, l, a, pairs = local_grads(params, alive, images, edge_masks,
                                     viewmats, Ks, key, strategy_idx,
                                     lambda_proj, bg_ratio, row0, g0)
        if composed_tp:
            # shard grads reassemble: each device owns Gaussian rows
            # [g0, g0+n/d) of its view shard's sum; slice-in + psum over
            # BOTH axes (train_tp.py's `full`, plus the view reduction)
            def full(g_shard, like):
                z = jnp.zeros_like(vma_mod.match_vma(like, images, row0))
                return jax.lax.psum(
                    jax.lax.dynamic_update_slice_in_dim(z, g_shard, g0, 0),
                    ("views", "gauss"))

            g = jax.tree.map(full, g, params)
            l = jax.lax.psum(l, ("views", "gauss"))
            a = jax.lax.psum(a, ("views",))
            pairs = jax.lax.pmax(pairs, ("views", "gauss"))
        elif composed:
            # band partials reduce over BOTH axes; absgrad already
            # tiles-psum'd per view, so it rides 'views' only
            g = jax.lax.psum(g, ("views", "tiles"))
            l = jax.lax.psum(l, ("views", "tiles"))
            a = jax.lax.psum(a, ("views",))
            # every band enjoys the full pair budget -> watermark is the
            # busiest band (pmax), matching train_sharded.py
            pairs = jax.lax.pmax(pairs, ("views", "tiles"))
        else:
            # values are tile-invariant (DP work is replicated across
            # 'tiles'), so the reduction rides the 'views' axis only
            g = jax.lax.psum(g, ("views",))
            l = jax.lax.psum(l, ("views",))
            a = jax.lax.psum(a, ("views",))
            pairs = jax.lax.pmax(pairs, ("views",))
        return g, l, a, pairs

    @jax.jit
    def dp_step(ts: TrainState, epoch, images, edge_masks, viewmats, Ks
                ) -> Tuple[TrainState, jnp.ndarray]:
        num_views = images.shape[0]
        key, k_step = jax.random.split(ts.key)
        lrs = optim.all_lrs(cfg.training.optim, epoch)
        lambda_proj = optim.annealed(
            pl_cfg.lambda_start, pl_cfg.lambda_end, pl_cfg.lambda_annealing,
            epoch, cfg.training.num_epochs)
        bg_ratio = optim.annealed(
            pl_cfg.bg_edge_pixel_ratio_start, pl_cfg.bg_edge_pixel_ratio_end,
            pl_cfg.bg_edge_pixel_ratio_annealing, epoch,
            cfg.training.num_epochs)

        gs = ts.gaussians
        # strategy alternation on the batch-step counter (the reference
        # alternates on per-view renders, train_gaussians.py:73-77; here a
        # batch step is the cadence unit -- large-batch semantics)
        alt = jnp.where(ts.step % sampling_ratio == 0, strat_less,
                        strat_more)
        strategy_idx = jnp.where(
            epoch > pl_cfg.start_alternating_at_epoch, alt, strat_before)
        grads, loss_sum, absgrad, max_pairs = sharded_grads(
            gs.params, gs.alive, images, edge_masks, viewmats, Ks,
            k_step, strategy_idx, lambda_proj, bg_ratio)
        grads = jax.tree.map(
            lambda g: lambda_proj * g / num_views, grads)
        params, opt = optim.apply_updates(gs.params, grads, ts.opt, lrs)
        step = ts.step + 1

        # direction / ratio losses every 5 batch steps, replicated compute
        # (the reference fires every 5 renders and scales by the running
        # projection-loss sum, train_gaussians.py:108-131; the batch loss
        # sum plays that role here)
        fire = (step % 5) == 0
        apply_dir = epoch > ol_cfg.start_dir_loss_at_epoch
        apply_ratio = epoch > ol_cfg.start_ratio_loss_at_epoch
        geo_groups = ("means", "scales", "quats")

        def dir_branch(args):
            params, opt = args
            nn_idx = losses.update_nearest_neighbors(
                params.means, gs.alive, num_nn, enforce,
                approx=cfg.training.approx_knn)

            def dloss(p):
                return losses.direction_loss(
                    p.means, jnp.exp(p.scales), p.quats, nn_idx,
                    gs.alive, num_nn, enforce)

            dval, dgrads = jax.value_and_grad(dloss)(params)
            lam = (loss_sum * ol_cfg.dir_loss_scale_factor) / \
                jnp.maximum(dval, 1e-12)
            dgrads = jax.tree.map(lambda g: lam * g, dgrads)
            return optim.apply_updates(params, dgrads, opt, lrs,
                                       geo_groups)

        def ratio_branch(args):
            params, opt = args

            def rloss(p):
                return losses.ratio_loss(jnp.exp(p.scales), gs.alive)

            rval, rgrads = jax.value_and_grad(rloss)(params)
            lam = (loss_sum * ol_cfg.ratio_loss_scale_factor) / \
                jnp.maximum(rval, 1e-12)
            rgrads = jax.tree.map(lambda g: lam * g, rgrads)
            return optim.apply_updates(params, rgrads, opt, lrs,
                                       geo_groups)

        params, opt = jax.lax.cond(
            apply_dir & fire, dir_branch, lambda a: a, (params, opt))
        params, opt = jax.lax.cond(
            apply_ratio & fire, ratio_branch, lambda a: a, (params, opt))

        gs = gs._replace(
            params=params,
            absgrads=gs.absgrads + absgrad * lambda_proj / num_views,
            absgrad_count=gs.absgrad_count + 1.0)
        ts = TrainState(gaussians=gs, opt=opt, step=step, key=key)
        return ts, loss_sum / num_views, max_pairs

    dp_step.sharded_grads = sharded_grads   # exposed for equivalence tests
    return dp_step


def losses_strategy_index(name: str) -> int:
    return {"whole": 0, "bg_edge_ratio": 1, "weighted": 2}[name]


def make_tile_sharded_render(cfg: FrameworkConfig, width: int, height: int,
                             backend: str, mesh: Mesh):
    """Build a tile-sharded single-view loss+grad function.

    The image's tile grid is split across the 'tiles' mesh axis: every
    device projects all Gaussians (cheap, O(N)), bins and composites only
    its tile rows, computes a partial pixel-loss sum, and psums the
    parameter gradients — one view's render scaled across chips with
    reference-identical per-view semantics ('whole' L1 loss).
    """
    from edgegaussians_tpu.ops import tiles as tiles_mod
    from edgegaussians_tpu.ops.composite import tile_render
    from edgegaussians_tpu.ops.projection import project_gaussians
    from edgegaussians_tpu.ops.tiles import bin_gaussians, pixel_basis

    mcfg = cfg.model
    ts_px = mcfg.tile_size
    ntx, nty, num_tiles = tiles_mod.tile_grid(width, height, ts_px)
    n_shards = mesh.shape["tiles"]
    if nty % n_shards != 0:
        raise ValueError(f"tile rows {nty} not divisible by mesh axis "
                         f"'tiles'={n_shards}")

    def local_loss(params, alive, viewmat, K, gt_tiles, pix_valid, sink):
        """Loss partial-sum over this device's tile rows."""
        tile_rows = nty // n_shards
        shard = jax.lax.axis_index("tiles")
        row0 = shard * tile_rows

        proj = project_gaussians(
            params.means, params.quats, jnp.exp(params.scales),
            jax.nn.sigmoid(params.opacities[:, 0]), viewmat, K,
            width, height, alive=alive,
            antialiased=(mcfg.rasterize_mode == "antialiased"))
        # shift the projection vertically so this shard's tile rows start at
        # row 0 of a reduced-height image — binning then only produces the
        # local tiles
        shift = (row0 * ts_px).astype(jnp.float32)
        proj_local = proj._replace(
            means2d=proj.means2d - jnp.stack(
                [jnp.zeros_like(shift), shift])[None, :])
        local_h = tile_rows * ts_px
        bins = bin_gaussians(jax.lax.stop_gradient(proj_local), width,
                             local_h, ts_px, mcfg.tile_gaussian_capacity)

        packed = tiles_mod.pack_gaussian_render_data(proj_local)
        packed_sorted = packed[bins.order]
        gathered = packed_sorted[bins.ranks]
        origins = tiles_mod.tile_origins(width, local_h, ts_px)
        basis = pixel_basis(ts_px)
        tile_imgs = tile_render(gathered, bins.valid.astype(jnp.float32),
                                origins, basis, bins.ranks, bins.order,
                                sink)
        pred = jnp.clip(tile_imgs, 0.0, 1.0)
        # partial sum of |pred-gt| over this shard's valid pixels
        return jnp.sum(jnp.abs(pred - gt_tiles) * pix_valid)

    @functools.partial(
        vma_mod.shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P("tiles"), P("tiles"), P()),
        out_specs=(P(), P(), P()), backend=backend)
    def sharded_loss_grad(params, alive, viewmat, K, gt_tiles, pix_valid,
                          sink):
        def f(p, s):
            return local_loss(p, alive, viewmat, K, gt_tiles, pix_valid, s)

        # params and sink enter replicated (P()) but their cotangents vary
        # over 'tiles'; declare them varying BEFORE differentiating so the
        # grads stay per-device partials (else they arrive auto-psum'd and
        # the explicit psum below overcounts by the axis size)
        params = jax.tree.map(lambda x: vma_mod.match_vma(x, gt_tiles),
                              params)
        sink = vma_mod.match_vma(sink, gt_tiles)
        loss, (g, gsink) = jax.value_and_grad(
            f, argnums=(0, 1))(params, sink)
        # partial sums vary over 'tiles' only (inputs are view-invariant)
        loss = jax.lax.psum(loss, ("tiles",))
        g = jax.lax.psum(g, ("tiles",))
        gsink = jax.lax.psum(gsink, ("tiles",))
        return loss, g, gsink

    @jax.jit
    def loss_and_grad(params: GaussianParams, alive, viewmat, K, gt_image):
        gt_tiles, pix_valid = tileize_image(gt_image, width, height, ts_px)
        total_px = jnp.float32(width * height)
        sink = jnp.zeros((params.means.shape[0], 2), jnp.float32)
        loss_sum, grads, gsink = sharded_loss_grad(
            params, alive, viewmat, K, gt_tiles, pix_valid, sink)
        scale = 1.0 / total_px          # 'whole' strategy = mean over pixels
        return (loss_sum * scale,
                jax.tree.map(lambda g: g * scale, grads), gsink * scale)

    return loss_and_grad


def tileize_image(image: jnp.ndarray, width: int, height: int,
                  tile_size: int):
    """[H,W] image -> ([T,P] tile pixels, [T,P] validity for pad pixels)."""
    from edgegaussians_tpu.ops.tiles import tile_grid
    ntx, nty, _ = tile_grid(width, height, tile_size)
    ph, pw = nty * tile_size, ntx * tile_size
    img = jnp.pad(image, ((0, ph - height), (0, pw - width)))
    valid = jnp.pad(jnp.ones((height, width), jnp.float32),
                    ((0, ph - height), (0, pw - width)))
    def to_tiles(x):
        return x.reshape(nty, tile_size, ntx, tile_size) \
                .transpose(0, 2, 1, 3).reshape(nty * ntx, -1)
    return to_tiles(img), to_tiles(valid)
