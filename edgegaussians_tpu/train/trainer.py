"""Training orchestration: jit-compiled epoch scan + host-side density loop.

Compiled redesign of the reference training loop (train_gaussians.py:17-222):
one jitted function runs a whole epoch as a ``lax.scan`` over shuffled views
— one Adam step per view, exactly the reference's per-view SGD cadence —
with the direction/ratio losses applied every 5 renders via ``lax.cond``
(train_gaussians.py:108-131). The epoch index is a traced scalar so a single
compilation serves the entire run; only adaptive density control runs
between epochs (host-dispatched, each op itself jitted with fixed shapes).

Reference semantics carried over verbatim:
- loss alternation schedule on ``model.step`` (train_gaussians.py:73-77),
- direction/ratio lambdas scaled by the *running sum* of projection losses
  (bug-faithful: 'avg_loss' is a sum at that point — SURVEY §6.5.4),
- absgrad accumulation after every projection backward (edge_gs.py:607-613),
- kNN refreshed immediately before every direction-loss application
  (train_gaussians.py:110).
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from edgegaussians_tpu.config import FrameworkConfig
from edgegaussians_tpu.models import density, losses
from edgegaussians_tpu.models.gaussians import (
    GaussianParams, GaussianState, init_state, render_view)
from edgegaussians_tpu.train import optim
from edgegaussians_tpu.train.optim import OptState, annealed

STRATEGIES = ("whole", "bg_edge_ratio", "weighted")


class TrainState(NamedTuple):
    gaussians: GaussianState
    opt: OptState
    step: jnp.ndarray          # int32, renders so far (model.step)
    key: jnp.ndarray           # PRNG key


class EpochStats(NamedTuple):
    avg_loss: jnp.ndarray
    num_alive: jnp.ndarray
    max_tile_count: jnp.ndarray
    max_overflow_tiles: jnp.ndarray  # peak count of tiles past the dense
                                     # budget; must stay < tile_overflow_tiles
                                     # or renders truncate silently
    max_truncated: jnp.ndarray       # peak Gaussians truncated by
                                     # max_tiles_per_gaussian
    max_pairs: jnp.ndarray = None    # peak per-view (tile, Gaussian) pair
                                     # count; must stay <= tile_pair_budget
                                     # when that is set (two-level only)


def _strategy_index(name: str) -> int:
    try:
        return STRATEGIES.index(name)
    except ValueError:
        raise ValueError(f"Unknown projection loss strategy: {name}")


# Program memo: multi-scene sweeps call make_epoch_fn/make_density_fn once
# per scene; without memoization each scene gets fresh jax.jit wrappers and
# re-compiles every program. Keyed on the full static configuration, so
# scenes with identical geometry share executables.
_PROGRAM_MEMO: dict = {}


# Density-control fields are consumed only by the density program (its
# dispatch schedule is host-side — density_flags); the epoch program never
# reads them, so they are excluded from its memo key and a strategy sweep
# reuses the (expensive) epoch executable. If make_epoch_fn ever
# starts reading one of these, remove it from this list.
_DENSITY_ONLY_MODEL_FIELDS = (
    "if_duplicate_high_pos_grad", "dup_threshold_type",
    "dup_threshold_value", "dup_factor", "dup_high_pos_grads_at_epoch",
    "if_cull_low_opacity", "cull_opacity_type", "cull_opacity_value",
    "cull_opacity_at_epoch", "if_cull_wayward", "cull_wayward_method",
    "cull_wayward_num_neighbors", "cull_wayward_threshold_type",
    "cull_wayward_threshold_value", "cull_wayward_at_epoch",
    "cull_wayward_apply", "if_cull_gaussians_not_projecting",
    "cull_gaussians_not_projecting_threshold",
    "cull_gaussians_not_projecting_at_epoch", "if_reset_opacity",
    "reset_opacity_value", "reset_opacity_at_epoch",
    "init_dup_rand_noise_scale",
)


def _cfg_memo_key(cfg: FrameworkConfig, program: str = "epoch") -> str:
    import dataclasses
    import json
    d = dataclasses.asdict(cfg)
    # runtime-only knobs that never reach a traced program: the RNG seed is
    # carried in TrainState/inputs, and output paths are host-side. Dropping
    # them lets multi-seed spread sweeps share compiled programs.
    d["training"].pop("seed", None)
    d.pop("output", None)
    # host-side dispatch knob, never read by a traced program
    d["model"].pop("tile_pair_overflow_action", None)
    if program == "epoch":
        for f in _DENSITY_ONLY_MODEL_FIELDS:
            d["model"].pop(f, None)
    elif program == "density":
        # the density program reads only the model section
        d = {"model": d["model"]}
    return json.dumps(d, sort_keys=True, default=str)


class ProjGradStats(NamedTuple):
    """Reduced per-render diagnostics returned by a proj-grad function
    (device-count-independent so sharded and single-device renders share
    the epoch program structure)."""
    max_tile: jnp.ndarray        # max per-tile occupancy
    n_overflow: jnp.ndarray      # tiles past the dense budget
    num_truncated: jnp.ndarray   # Gaussians truncated by max_tiles_per_g
    num_pairs: Optional[jnp.ndarray] = None   # true pair count (pair mode)


def make_proj_grad_fn(cfg: FrameworkConfig, width: int, height: int,
                      backend: str):
    """Single-device projection loss+grad for one view.

    Signature contract (shared with the tile-sharded variant in
    parallel/train_sharded.py):
      (params, alive, viewmat, K, gt, edge_mask, strategy_idx, bg_ratio,
       key) -> (loss, ProjGradStats, param_grads, sink_grads)
    """
    mcfg = cfg.model
    pl_cfg = cfg.training.loss.projection_losses
    render_kwargs = dict(
        tile_size=mcfg.tile_size, capacity=mcfg.tile_gaussian_capacity,
        dense_capacity=mcfg.tile_dense_capacity,
        overflow_tiles=mcfg.tile_overflow_tiles,
        pair_budget=mcfg.tile_pair_budget,
        occupancy_sort=mcfg.tile_occupancy_sort,
        pair_kernel=mcfg.tile_pair_kernel,
        max_tiles_per_gaussian=mcfg.max_tiles_per_gaussian,
        backend=backend, antialiased=(mcfg.rasterize_mode == "antialiased"))

    def projection_loss(pred, gt, edge_mask, strategy_idx, bg_ratio, key):
        branches = [
            lambda: losses.projection_loss_whole(pred, gt, pl_cfg.loss_type),
            lambda: losses.projection_loss_bg_edge_ratio(
                pred, gt, edge_mask, bg_ratio, key),
            lambda: losses.projection_loss_weighted(
                pred, gt, losses.compute_weight_mask(edge_mask)),
        ]
        return jax.lax.switch(strategy_idx, branches)

    def proj_grad(params, alive, viewmat, K, gt, edge_mask, strategy_idx,
                  bg_ratio, key):
        sink0 = jnp.zeros((params.means.shape[0], 2), dtype=jnp.float32)

        def loss_fn(p: GaussianParams, sink):
            out = render_view(p, alive, viewmat, K, width, height,
                              absgrad_sink=sink, **render_kwargs)
            pred = jnp.clip(out.image, 0.0, 1.0)   # edge_gs.py:279
            l = projection_loss(pred, gt, edge_mask, strategy_idx,
                                bg_ratio, key)
            return l, out

        (proj_loss, out), (gparams, gsink) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(params, sink0)
        stats = ProjGradStats(
            max_tile=jnp.max(out.tile_counts),
            n_overflow=jnp.sum((out.tile_counts > mcfg.tile_dense_capacity)
                               .astype(jnp.int32)),
            num_truncated=out.num_truncated,
            num_pairs=out.num_pairs)
        return proj_loss, stats, gparams, gsink

    return proj_grad


def make_epoch_fn(cfg: FrameworkConfig, width: int, height: int,
                  backend: str, proj_grad_fn=None, memo_extra=None):
    """Build (or reuse) the jitted epoch function for a scene geometry.

    ``proj_grad_fn`` overrides the per-view projection loss+grad
    computation (see make_proj_grad_fn for the contract) — the hook the
    tile-sharded multi-chip trainer plugs into; ``memo_extra`` must then
    distinguish the program (e.g. the mesh shape)."""
    memo_key = ("epoch", _cfg_memo_key(cfg, "epoch"), width, height,
                backend, memo_extra)
    if memo_key in _PROGRAM_MEMO:
        return _PROGRAM_MEMO[memo_key]
    tcfg = cfg.training
    pl_cfg = tcfg.loss.projection_losses
    ol_cfg = tcfg.loss.orientation_losses

    strat_before = _strategy_index(pl_cfg.loss_before_alternating)
    strat_less = _strategy_index(pl_cfg.less_freq_loss)
    strat_more = _strategy_index(pl_cfg.more_freq_loss)
    sampling_ratio = max(int(pl_cfg.sampling_whole_num_epochs_ratio), 1)
    num_nn = ol_cfg.dir_loss_num_nn
    enforce = ol_cfg.dir_loss_enforce_method
    if proj_grad_fn is None:
        proj_grad_fn = make_proj_grad_fn(cfg, width, height, backend)

    def view_step(carry, view_idx, *, epoch, images, edge_masks, viewmats,
                  Ks, lrs, lambda_proj, bg_ratio, apply_dir, apply_ratio,
                  check_sampling):
        ts, run_sum, max_tiles, max_ovf, max_trunc, max_pairs = carry
        gs = ts.gaussians
        key, k_bg, k_next = jax.random.split(ts.key, 3)

        # strategy for this render (train_gaussians.py:73-77): before the
        # alternating epoch use 'loss_before_alternating'; after, alternate
        # on the render counter.
        alt = jnp.where(ts.step % sampling_ratio == 0, strat_less, strat_more)
        strategy_idx = jnp.where(check_sampling, alt, strat_before)

        proj_loss, out, gparams, gsink = proj_grad_fn(
            gs.params, gs.alive, viewmats[view_idx], Ks[view_idx],
            images[view_idx], edge_masks[view_idx], strategy_idx,
            bg_ratio, k_bg)

        # the reference backprops lambda * loss but logs/accumulates the raw
        # loss (train_gaussians.py:98-101)
        gparams = jax.tree.map(lambda g: lambda_proj * g, gparams)
        absgrad = jnp.linalg.norm(gsink, axis=-1) * lambda_proj
        run_sum = run_sum + proj_loss

        params, opt = optim.apply_updates(gs.params, gparams, ts.opt, lrs)
        gs = gs._replace(
            params=params,
            absgrads=gs.absgrads + absgrad,
            absgrad_count=gs.absgrad_count + 1.0)
        step = ts.step + 1

        # direction / ratio losses every 5 renders (train_gaussians.py:108-131)
        fire = (step % 5) == 0
        geo_groups = ("means", "scales", "quats")

        def dir_branch(args):
            params, opt = args
            nn_idx = losses.update_nearest_neighbors(
                params.means, gs.alive, num_nn, enforce,
                approx=tcfg.approx_knn)

            def dloss(p):
                return losses.direction_loss(
                    p.means, jnp.exp(p.scales), p.quats, nn_idx,
                    gs.alive, num_nn, enforce)

            dval, dgrads = jax.value_and_grad(dloss)(params)
            lam = (run_sum * ol_cfg.dir_loss_scale_factor) / \
                jnp.maximum(dval, 1e-12)
            dgrads = jax.tree.map(lambda g: lam * g, dgrads)
            return optim.apply_updates(params, dgrads, opt, lrs, geo_groups)

        def ratio_branch(args):
            params, opt = args

            def rloss(p):
                return losses.ratio_loss(jnp.exp(p.scales), gs.alive)

            rval, rgrads = jax.value_and_grad(rloss)(params)
            lam = (run_sum * ol_cfg.ratio_loss_scale_factor) / \
                jnp.maximum(rval, 1e-12)
            rgrads = jax.tree.map(lambda g: lam * g, rgrads)
            return optim.apply_updates(params, rgrads, opt, lrs, geo_groups)

        params, opt = jax.lax.cond(
            apply_dir & fire, dir_branch, lambda a: a, (gs.params, opt))
        params, opt = jax.lax.cond(
            apply_ratio & fire, ratio_branch, lambda a: a, (params, opt))

        gs = gs._replace(params=params)
        ts = TrainState(gaussians=gs, opt=opt, step=step, key=k_next)
        max_tiles = jnp.maximum(max_tiles, out.max_tile)
        max_ovf = jnp.maximum(max_ovf, out.n_overflow)
        max_trunc = jnp.maximum(max_trunc, out.num_truncated)
        if out.num_pairs is not None:
            max_pairs = jnp.maximum(max_pairs, out.num_pairs)
        return (ts, run_sum, max_tiles, max_ovf, max_trunc,
                max_pairs), proj_loss

    @jax.jit
    def epoch_fn(ts: TrainState, epoch: jnp.ndarray,
                 images: jnp.ndarray, edge_masks: jnp.ndarray,
                 viewmats: jnp.ndarray, Ks: jnp.ndarray
                 ) -> Tuple[TrainState, EpochStats]:
        num_views = images.shape[0]
        key, k_perm = jax.random.split(ts.key)
        ts = ts._replace(key=key)
        view_order = jax.random.permutation(k_perm, num_views)

        lrs = optim.all_lrs(cfg.training.optim, epoch)
        bg_ratio = annealed(pl_cfg.bg_edge_pixel_ratio_start,
                            pl_cfg.bg_edge_pixel_ratio_end,
                            pl_cfg.bg_edge_pixel_ratio_annealing,
                            epoch, tcfg.num_epochs)
        lambda_proj = annealed(pl_cfg.lambda_start, pl_cfg.lambda_end,
                               pl_cfg.lambda_annealing, epoch,
                               tcfg.num_epochs)
        apply_dir = epoch > ol_cfg.start_dir_loss_at_epoch
        apply_ratio = epoch > ol_cfg.start_ratio_loss_at_epoch
        check_sampling = epoch > pl_cfg.start_alternating_at_epoch

        body = functools.partial(
            view_step, epoch=epoch, images=images, edge_masks=edge_masks,
            viewmats=viewmats, Ks=Ks, lrs=lrs, lambda_proj=lambda_proj,
            bg_ratio=bg_ratio, apply_dir=apply_dir, apply_ratio=apply_ratio,
            check_sampling=check_sampling)

        (ts, run_sum, max_tiles, max_ovf, max_trunc, max_pairs), \
            view_losses = jax.lax.scan(
                body, (ts, jnp.float32(0.0), jnp.int32(0), jnp.int32(0),
                       jnp.int32(0), jnp.int32(0)), view_order)

        stats = EpochStats(
            avg_loss=run_sum / num_views,
            num_alive=ts.gaussians.num_alive(),
            max_tile_count=max_tiles,
            max_overflow_tiles=max_ovf,
            max_truncated=max_trunc,
            max_pairs=max_pairs)
        return ts, stats

    _PROGRAM_MEMO[memo_key] = epoch_fn
    return epoch_fn


def density_flags(epoch: int, cfg: FrameworkConfig) -> np.ndarray:
    """Host-side schedule: which density ops fire at this epoch
    (train_gaussians.py:186-219)."""
    m = cfg.model
    return np.array([
        m.if_duplicate_high_pos_grad and
        epoch in m.dup_high_pos_grads_at_epoch,
        m.if_cull_gaussians_not_projecting and
        epoch in m.cull_gaussians_not_projecting_at_epoch,
        m.if_cull_low_opacity and epoch in m.cull_opacity_at_epoch,
        m.if_cull_wayward and epoch in m.cull_wayward_at_epoch,
        m.if_reset_opacity and epoch in m.reset_opacity_at_epoch,
    ], dtype=bool)


def make_density_fn(cfg: FrameworkConfig):
    """Density-op dispatcher, jit-specialized per (host-static) flag combo.

    The ops fire on a host-static schedule (``density_flags``), so each
    distinct flag combination compiles a program containing EXACTLY the
    scheduled ops, compiled lazily at its first event epoch.
    """
    memo_key = ("density", _cfg_memo_key(cfg, "density"))
    if memo_key in _PROGRAM_MEMO:
        return _PROGRAM_MEMO[memo_key]
    mcfg = cfg.model
    cache = {}

    def specialize(flags_key):
        @jax.jit
        def fn(gs: GaussianState, moments, viewmats, Ks, edge_masks,
               key: jnp.ndarray):
            if flags_key[0]:
                gs, moments = density.duplicate_high_pos_gradients(
                    gs, moments, mcfg, key)
            if flags_key[1]:
                gs, moments = density.cull_not_projecting(
                    gs, moments, mcfg, viewmats, Ks, edge_masks)
            if flags_key[2]:
                gs, moments = density.cull_low_opacity(gs, moments, mcfg)
            if flags_key[3]:
                gs, moments = density.cull_wayward(gs, moments, mcfg)
            if flags_key[4]:
                gs = gs._replace(params=density.reset_opacities(
                    gs.params, mcfg.reset_opacity_value))
            gs = gs._replace(
                absgrads=jnp.zeros_like(gs.absgrads),
                absgrad_count=jnp.ones_like(gs.absgrad_count))
            return gs, moments

        return fn

    def density_fn(gs: GaussianState, moments, flags, viewmats, Ks,
                   edge_masks, key: jnp.ndarray):
        flags_key = tuple(bool(f) for f in np.asarray(flags))
        if flags_key not in cache:
            cache[flags_key] = specialize(flags_key)
        return cache[flags_key](gs, moments, viewmats, Ks, edge_masks, key)

    _PROGRAM_MEMO[memo_key] = density_fn
    return density_fn


def run_density_control(ts: TrainState, epoch: int, cfg: FrameworkConfig,
                        viewmats, Ks, edge_masks, key: jnp.ndarray,
                        density_fn=None) -> Tuple[TrainState, bool]:
    """Epoch-scheduled densify/cull dispatch (train_gaussians.py:186-219).

    Returns the updated state and whether anything fired (the reference then
    refreshes kNN and resets absgrads; kNN here is recomputed lazily at the
    next direction-loss step, so only the absgrad reset is handled — inside
    ``density_fn``, which only runs on event epochs).
    """
    flags = density_flags(epoch, cfg)
    if not flags.any():
        return ts, False
    if density_fn is None:
        density_fn = make_density_fn(cfg)
    gs, moments = density_fn(ts.gaussians, ts.opt.moments,
                             jnp.asarray(flags), viewmats, Ks, edge_masks,
                             key)
    return ts._replace(gaussians=gs,
                       opt=ts.opt._replace(moments=moments)), True


def _host_stats(stats: EpochStats) -> EpochStats:
    """Fetch an epoch's stats with ONE device transfer.

    The train loop reads ~6 scalar diagnostics per epoch (log line + the
    pair-overflow check). Stacking them on-device and transferring once
    makes that one host sync per epoch instead of one per field. Counts
    fit f32 exactly (< 2^24)."""
    vals = [stats.avg_loss, stats.num_alive, stats.max_tile_count,
            stats.max_overflow_tiles, stats.max_truncated]
    if stats.max_pairs is not None:
        vals.append(stats.max_pairs)
    packed = np.asarray(jnp.stack(
        [jnp.asarray(v, jnp.float32) for v in vals]))
    return EpochStats(
        avg_loss=float(packed[0]),
        num_alive=int(packed[1]),
        max_tile_count=int(packed[2]),
        max_overflow_tiles=int(packed[3]),
        max_truncated=int(packed[4]),
        max_pairs=(int(packed[5]) if stats.max_pairs is not None
                   else None))


def _put_images(images: np.ndarray) -> jnp.ndarray:
    """Host->device image transfer, as uint8 when lossless.

    Edge maps come from 8-bit PNGs, so their float values are exactly
    n/255; shipping them as uint8 and converting on-device cuts the
    transfer 4x in bytes. Keeps f32 when quantization would lose data
    (e.g., resampled images).
    """
    arr = np.asarray(images, np.float32)
    u8 = np.clip(np.rint(arr * 255.0), 0, 255).astype(np.uint8)
    if np.max(np.abs(u8.astype(np.float32) / 255.0 - arr)) < 1e-6:
        return jnp.asarray(u8).astype(jnp.float32) / 255.0
    return jnp.asarray(arr)


def grow_capacity(ts: TrainState, new_cap: int) -> TrainState:
    """Pad every capacity-sized array to ``new_cap`` dead slots.

    Supports staged capacity growth: parameters, Adam moments, the alive
    mask, and absgrad accumulators keep their contents; new slots are dead
    (alive=False, zero moments) and get unit-w quats so projection of the
    padding stays finite. Shapes change, so jitted epoch/density functions
    re-trace once per stage.
    """
    gs = ts.gaussians
    old = gs.capacity
    if new_cap <= old:
        return ts
    pad = new_cap - old

    def padrows(x, value=0.0):
        widths = ((0, pad),) + ((0, 0),) * (x.ndim - 1)
        return jnp.pad(x, widths, constant_values=value)

    quats = jnp.concatenate(
        [gs.params.quats,
         jnp.tile(jnp.array([[1.0, 0, 0, 0]], jnp.float32), (pad, 1))])
    params = GaussianParams(
        means=padrows(gs.params.means),
        scales=padrows(gs.params.scales),
        quats=quats,
        opacities=padrows(gs.params.opacities))
    moments = jax.tree.map(padrows, ts.opt.moments)
    gs = gs._replace(
        params=params,
        alive=padrows(gs.alive, value=False),
        absgrads=padrows(gs.absgrads))
    return ts._replace(gaussians=gs,
                       opt=ts.opt._replace(moments=moments))


def _staged_start_capacity(n_seed: int, cfg: FrameworkConfig,
                           max_cap: int) -> int:
    target = max(int(cfg.model.staged_capacity_start_factor * n_seed), 1024)
    cap = 1024
    while cap < target:
        cap *= 2
    return min(cap, max_cap)


def init_train_state(seed_points: np.ndarray, cfg: FrameworkConfig,
                     capacity: Optional[int] = None) -> TrainState:
    gs = init_state(seed_points, cfg.model, seed=cfg.training.seed,
                    capacity=capacity)
    return TrainState(
        gaussians=gs,
        opt=optim.init_opt_state(gs.params),
        step=jnp.zeros((), dtype=jnp.int32),
        key=jax.random.PRNGKey(cfg.training.seed))


def train(scene, seed_points: np.ndarray, cfg: FrameworkConfig,
          backend: str = "auto", log_fn=print,
          checkpoint_dir: Optional[str] = None,
          log_dir: Optional[str] = None,
          initial_state: Optional[TrainState] = None,
          profile_dir: Optional[str] = None,
          profile_epochs: int = 1,
          mesh=None, mesh_strategy: str = "tiles") -> TrainState:
    """Full training run on one scene (train_gaussians.py:144-222).

    ``scene`` is a SceneViews; returns the trained state. Checkpoints are
    written as .npz (params + opt + step) when ``checkpoint_dir`` is set;
    TensorBoard scalars/images go to ``log_dir`` when set (the reference
    logs the same quantities — train_gaussians.py:96,136-139,190).
    ``mesh`` scales every render+backward across devices with identical
    semantics; ``mesh_strategy`` picks the sharded axis: 'tiles' shards
    the pixel/tile-row axis (parallel/train_sharded.py), 'gauss' shards
    the N-Gaussian projection/compositing work (parallel/train_tp.py —
    the per-chip memory/work axis for DTU/Replica-scale capacities).
    """
    from edgegaussians_tpu.ops.rasterize import resolve_backend
    requested = cfg.model.rasterizer_backend if backend == "auto" \
        else backend
    backend = resolve_backend(requested)
    log_fn(f"render backend: {backend} (requested {requested!r}, "
           f"platform {jax.default_backend()!r})")

    writer = None
    if log_dir:
        try:
            from tensorboardX import SummaryWriter
            writer = SummaryWriter(log_dir)
        except Exception:
            pass

    images = _put_images(scene.images)
    edge_masks = images >= cfg.model.edge_detection_threshold
    viewmats = jnp.asarray(scene.viewmats)
    Ks = jnp.asarray(scene.Ks)

    from edgegaussians_tpu.config import resolve_capacity
    max_cap = resolve_capacity(cfg.model, len(seed_points))
    if initial_state is not None:
        ts = initial_state
    elif cfg.model.staged_capacity:
        start_cap = _staged_start_capacity(len(seed_points), cfg, max_cap)
        ts = init_train_state(seed_points, cfg, capacity=start_cap)
    else:
        ts = init_train_state(seed_points, cfg)
    dp_step = None
    if cfg.training.step_mode == "view_batch":
        # Data-parallel large-batch mode (parallel/train_dp.py): one Adam
        # step per view batch — a documented throughput-mode divergence
        # from the reference's per-view SGD (train_gaussians.py:71-106).
        from edgegaussians_tpu.parallel import mesh as mesh_mod
        from edgegaussians_tpu.parallel import train_dp
        make_mesh_epoch_fn, epoch_fn = None, None
        if mesh is not None and "views" not in mesh.shape:
            raise ValueError(
                "step_mode='view_batch' needs a mesh with a 'views' axis; "
                f"got axes {tuple(mesh.shape)} — pass --mesh_views (or a "
                "('views','tiles') mesh) instead of --mesh_tiles/"
                "--mesh_gauss")
        dp_mesh = mesh if mesh is not None \
            else mesh_mod.make_mesh(view_axis=1, tile_axis=1)
        # a batch can never exceed the scene's view count: clamp BEFORE the
        # divisibility check so the value validated is the batch actually
        # gathered each step
        bsz0 = min(cfg.training.view_batch_size or scene.num_views,
                   scene.num_views)
        if bsz0 % dp_mesh.shape["views"]:
            raise ValueError(
                f"view_batch_size {bsz0} must divide by the 'views' mesh "
                f"axis size {dp_mesh.shape['views']}")
        dp_step = train_dp.make_dp_train_step(cfg, scene.width,
                                              scene.height, backend,
                                              dp_mesh)
        dp_rng = np.random.default_rng(cfg.training.seed + 977)
    elif mesh is not None:
        if mesh_strategy == "gauss":
            from edgegaussians_tpu.parallel.train_tp import \
                make_tp_epoch_fn as make_mesh_epoch_fn
        elif mesh_strategy == "tiles":
            from edgegaussians_tpu.parallel.train_sharded import \
                make_sharded_epoch_fn as make_mesh_epoch_fn
        else:
            raise ValueError(f"unknown mesh_strategy {mesh_strategy!r}")
        epoch_fn = make_mesh_epoch_fn(cfg, scene.width, scene.height,
                                      backend, mesh, axis=mesh_strategy)
    else:
        make_mesh_epoch_fn = None
        epoch_fn = make_epoch_fn(cfg, scene.width, scene.height, backend)
    pair_mode = bool(cfg.model.tile_pair_budget)
    density_fn = make_density_fn(cfg)
    grow_at = cfg.model.staged_capacity_grow_threshold

    key = jax.random.PRNGKey(cfg.training.seed + 1)
    px_per_epoch = scene.num_views * scene.width * scene.height
    # resolved level-2 tile budget for the log line (0/None = auto T//4,
    # matching rasterize())
    from edgegaussians_tpu.ops.tiles import tile_grid
    _num_tiles = tile_grid(scene.width, scene.height,
                           cfg.model.tile_size)[2]
    ovf_budget = cfg.model.tile_overflow_tiles or max(_num_tiles // 4, 8)
    t0 = time.time()
    t_prev = t0
    # steady-state trace window: skip the compile epochs (0-1), trace
    # [2, 2 + profile_epochs)
    prof_start = 2 if profile_dir else None
    prof_stop = (2 + max(profile_epochs, 1)) if profile_dir else None

    for epoch in range(cfg.training.num_epochs):
        if prof_start is not None and epoch == prof_start:
            jax.block_until_ready(ts.gaussians.params.means)
            jax.profiler.start_trace(profile_dir)
        if dp_step is not None:
            nv = scene.num_views
            bsz = min(cfg.training.view_batch_size or nv, nv)
            nb = max(nv // bsz, 1)
            perm = dp_rng.permutation(nv)[:nb * bsz]
            loss_sum = jnp.float32(0.0)
            dp_pairs = jnp.int32(0)
            for i in range(nb):
                sel = jnp.asarray(np.sort(perm[i * bsz:(i + 1) * bsz]))
                ts, loss, bp = dp_step(ts, jnp.int32(epoch), images[sel],
                                       edge_masks[sel], viewmats[sel],
                                       Ks[sel])
                loss_sum = loss_sum + loss
                dp_pairs = jnp.maximum(dp_pairs, bp)
            stats = EpochStats(
                avg_loss=loss_sum / nb,
                num_alive=ts.gaussians.num_alive(),
                max_tile_count=jnp.int32(0),
                max_overflow_tiles=jnp.int32(0),
                max_truncated=jnp.int32(0),
                max_pairs=(dp_pairs if pair_mode else None))
        else:
            ts, stats = epoch_fn(ts, jnp.int32(epoch), images, edge_masks,
                                 viewmats, Ks)
        stats = _host_stats(stats)
        if prof_stop is not None and prof_start <= epoch < prof_stop and \
                epoch + 1 == prof_stop:
            jax.block_until_ready(ts.gaussians.params.means)
            jax.profiler.stop_trace()
            log_fn(f"profiler trace written to {profile_dir}")
        key, sub = jax.random.split(key)
        if cfg.model.staged_capacity and ts.gaussians.capacity < max_cap:
            # a scheduled duplication can add up to `alive` clones — make
            # room first so the event is not clipped by the current stage
            cap = ts.gaussians.capacity
            alive = stats.num_alive       # fetched once in _host_stats
            dup_scheduled = (cfg.model.if_duplicate_high_pos_grad and
                             epoch in cfg.model.dup_high_pos_grads_at_epoch)
            want = 2 * alive if dup_scheduled else alive
            if want > grow_at * cap:
                new_cap = cap
                while want > grow_at * new_cap and new_cap < max_cap:
                    new_cap = min(new_cap * 2, max_cap)
                ts = grow_capacity(ts, new_cap)
                log_fn(f"epoch {epoch}: capacity {cap} -> {new_cap} "
                       f"(alive {alive})")
        ts, _ = run_density_control(ts, epoch, cfg, viewmats, Ks,
                                    edge_masks, sub, density_fn=density_fn)
        if epoch % max(cfg.training.log_interval, 1) == 0:
            now = time.time()
            dt = max(now - t_prev, 1e-9)
            t_prev = now
            log_fn(f"epoch {epoch}: loss={float(stats.avg_loss):.7f} "
                   f"alive={int(stats.num_alive)} "
                   f"max_tile={int(stats.max_tile_count)} "
                   f"ovf={int(stats.max_overflow_tiles)}/"
                   f"{ovf_budget} "
                   f"trunc={int(stats.max_truncated)} "
                   + (f"pairs={int(stats.max_pairs)}"
                      + (f"/{cfg.model.tile_pair_budget} "
                         if cfg.model.tile_pair_budget else " ")
                      if stats.max_pairs is not None else "")
                   + f"px/s={px_per_epoch / dt / 1e6:.1f}M "
                   f"t={now - t0:.3f}s")
        if (pair_mode and stats.max_pairs is not None
                and int(stats.max_pairs) > cfg.model.tile_pair_budget):
            msg = (f"epoch {epoch}: {int(stats.max_pairs)} (tile, Gaussian) "
                   f"pairs exceed tile_pair_budget="
                   f"{cfg.model.tile_pair_budget}; pairs past the budget "
                   "were DROPPED from this epoch's renders")
            action = cfg.model.tile_pair_overflow_action
            if action == "error":
                raise RuntimeError(
                    msg + " — raise the budget (tile_pair_overflow_action="
                          "'error')")
            if action == "fallback":
                # rebuild the epoch program on the exact dense frame path
                # for the rest of the run (one re-jit); the overflowed
                # epoch itself stays truncated
                import dataclasses
                dense_cfg = dataclasses.replace(
                    cfg, model=dataclasses.replace(
                        cfg.model, tile_pair_budget=0))
                if dp_step is not None:
                    dp_step = train_dp.make_dp_train_step(
                        dense_cfg, scene.width, scene.height, backend,
                        dp_mesh)
                elif mesh is not None:
                    epoch_fn = make_mesh_epoch_fn(
                        dense_cfg, scene.width, scene.height, backend, mesh,
                        axis=mesh_strategy)
                else:
                    epoch_fn = make_epoch_fn(dense_cfg, scene.width,
                                             scene.height, backend)
                pair_mode = False
                log_fn("WARNING: " + msg + "; switching to the dense frame "
                       "path for the remaining epochs "
                       "(tile_pair_overflow_action='fallback')")
            else:
                log_fn("WARNING: " + msg + " — raise the budget")
        if writer is not None:
            writer.add_scalar("Projection loss", float(stats.avg_loss),
                              epoch)
            writer.add_scalar("num_gaussians", int(stats.num_alive), epoch)
            if epoch % 5 == 0:
                from edgegaussians_tpu.models.gaussians import render_view
                out = render_view(ts.gaussians.params, ts.gaussians.alive,
                                  viewmats[0], Ks[0], scene.width,
                                  scene.height, backend=backend,
                                  tile_size=cfg.model.tile_size,
                                  capacity=cfg.model.tile_gaussian_capacity)
                writer.add_image(
                    "Output Image",
                    np.clip(np.asarray(out.image), 0, 1)[None], epoch)
        if (checkpoint_dir and cfg.training.checkpoint_interval
                and (epoch + 1) % cfg.training.checkpoint_interval == 0):
            save_checkpoint(ts, checkpoint_dir, epoch)
    if writer is not None:
        writer.close()
    return ts


CHECKPOINT_SCHEMA = 1


def _ckpt_field_key(path) -> str:
    """Stable npz key for a TrainState leaf: its pytree key path."""
    return "f:" + jax.tree_util.keystr(path).replace("/", "_")


def save_checkpoint(ts: TrainState, out_dir: str, epoch: int) -> str:
    """Checkpoint params + optimizer state + step (richer than the
    reference's params-only .pth — SURVEY §5.4).

    Fields are stored under their pytree key paths with a schema tag, so a
    TrainState/OptState refactor changes key names (load fails loudly)
    instead of silently permuting positional leaves."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"epoch{epoch}.npz")
    if os.path.exists(path):
        path = os.path.join(out_dir,
                            f"epoch{epoch}_{time.strftime('%m%d%H%M%S')}.npz")
    flat = {"__schema__": np.int32(CHECKPOINT_SCHEMA)}
    for p, leaf in jax.tree_util.tree_flatten_with_path(ts)[0]:
        flat[_ckpt_field_key(p)] = np.asarray(leaf)
    np.savez(path, **flat)
    return path


def load_checkpoint(path: str, template: TrainState) -> TrainState:
    """Restore a checkpoint into the template's structure.

    Schema >= 1 files match leaves by pytree key path and raise KeyError on
    any missing field; legacy (round-1, positional ``leaf_{i}``) files load
    through the old order as a compatibility shim."""
    data = np.load(path)
    if "__schema__" in data.files:
        keyed, treedef = jax.tree_util.tree_flatten_with_path(template)
        missing = [
            _ckpt_field_key(p) for p, _ in keyed
            if _ckpt_field_key(p) not in data.files]
        if missing:
            raise KeyError(
                f"checkpoint {path} lacks fields {missing}; it was written "
                "by an incompatible TrainState version")
        leaves = [jnp.asarray(data[_ckpt_field_key(p)]) for p, _ in keyed]
        return jax.tree.unflatten(treedef, leaves)
    # legacy positional format
    leaves, treedef = jax.tree.flatten(template)
    new_leaves = [jnp.asarray(data[f"leaf_{i}"]) for i in range(len(leaves))]
    return jax.tree.unflatten(treedef, new_leaves)
