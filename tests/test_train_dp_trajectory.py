"""Multi-epoch view-DP trajectory tests on the virtual 8-device CPU mesh.

Two anchors for the DP strategy (parallel/train_dp.py):

1. the sharded batch step follows a hand-rolled SINGLE-DEVICE batch oracle
   implementing exactly the documented large-batch semantics — one Adam
   step per view batch, strategy alternation on the batch-step counter,
   direction/ratio losses every 5 batch steps scaled by the raw batch loss
   sum, absgrad accumulated as per-view sink-cotangent norms — over
   multiple epochs;
2. the hierarchical composition (views x tiles mesh, every render
   tile-band-sharded) follows the DP-only (views x 1) trajectory, with
   the full loss surface including the bg_edge_ratio sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from edgegaussians_tpu.config import FrameworkConfig
from edgegaussians_tpu.models import losses
from edgegaussians_tpu.models.gaussians import render_view
from edgegaussians_tpu.parallel import mesh as mesh_mod
from edgegaussians_tpu.parallel import train_dp
from edgegaussians_tpu.train import optim, trainer
from edgegaussians_tpu.train.trainer import TrainState

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _setup(num_views=8, width=64, height=64, n_seed=64):
    r = np.random.default_rng(3)
    seeds = r.uniform(-0.5, 0.5, (n_seed, 3)).astype(np.float32)
    seeds[:, 2] += 2.0
    images = jnp.asarray(r.random((num_views, height, width)), jnp.float32)
    edge_masks = images > 0.5
    f = 60.0
    Ks = jnp.tile(jnp.array([[[f, 0, width / 2], [0, f, height / 2],
                              [0, 0, 1]]], jnp.float32), (num_views, 1, 1))
    viewmats = jnp.tile(jnp.eye(4, dtype=jnp.float32)[None],
                        (num_views, 1, 1))
    cfg = FrameworkConfig()
    cfg.model.max_num_gaussians = 128
    cfg.model.tile_gaussian_capacity = 64
    # full DP loss surface, deterministic strategies for the oracle test
    plc = cfg.training.loss.projection_losses
    plc.loss_before_alternating = "whole"
    plc.start_alternating_at_epoch = 0      # alternate from epoch 1 on
    plc.less_freq_loss = "whole"
    plc.more_freq_loss = "weighted"
    plc.sampling_whole_num_epochs_ratio = 2
    olc = cfg.training.loss.orientation_losses
    olc.start_dir_loss_at_epoch = 0          # dir/ratio from epoch 1 on
    olc.start_ratio_loss_at_epoch = 0
    ts = trainer.init_train_state(seeds, cfg)
    return cfg, ts, images, edge_masks, viewmats, Ks, width, height


def _oracle_batch_step(cfg, W, H, ts, epoch, images, edge_masks,
                       viewmats, Ks):
    """Single-device re-implementation of the documented DP batch
    semantics (parallel/train_dp.py dp_step), sequential over views."""
    plc = cfg.training.loss.projection_losses
    olc = cfg.training.loss.orientation_losses
    nv = images.shape[0]
    key, k_step = jax.random.split(ts.key)
    lrs = optim.all_lrs(cfg.training.optim, epoch)
    lambda_proj = optim.annealed(
        plc.lambda_start, plc.lambda_end, plc.lambda_annealing, epoch,
        cfg.training.num_epochs)

    sampling_ratio = max(int(plc.sampling_whole_num_epochs_ratio), 1)
    strat = {"whole": 0, "bg_edge_ratio": 1, "weighted": 2}
    alt = (strat[plc.less_freq_loss]
           if int(ts.step) % sampling_ratio == 0
           else strat[plc.more_freq_loss])
    strategy_idx = (alt if int(epoch) > plc.start_alternating_at_epoch
                    else strat[plc.loss_before_alternating])

    gs = ts.gaussians
    gsum = jax.tree.map(jnp.zeros_like, gs.params)
    loss_sum = jnp.float32(0.0)
    asum = jnp.zeros((gs.capacity,), jnp.float32)
    for v in range(nv):
        def loss_fn(p, sink, v=v):
            out = render_view(p, gs.alive, viewmats[v], Ks[v], W, H,
                              capacity=cfg.model.tile_gaussian_capacity,
                              backend="jax", absgrad_sink=sink)
            pred = jnp.clip(out.image, 0.0, 1.0)
            if strategy_idx == 0:
                return losses.projection_loss_whole(pred, images[v],
                                                    plc.loss_type)
            assert strategy_idx == 2
            return losses.projection_loss_weighted(
                pred, images[v], losses.compute_weight_mask(edge_masks[v]))

        sink0 = jnp.zeros((gs.capacity, 2), jnp.float32)
        l, (g, gsink) = jax.value_and_grad(
            loss_fn, argnums=(0, 1))(gs.params, sink0)
        gsum = jax.tree.map(jnp.add, gsum, g)
        loss_sum = loss_sum + l
        asum = asum + jnp.linalg.norm(gsink, axis=-1)

    grads = jax.tree.map(lambda g: lambda_proj * g / nv, gsum)
    params, opt = optim.apply_updates(gs.params, grads, ts.opt, lrs)
    step = ts.step + 1

    fire = int(step) % 5 == 0
    geo_groups = ("means", "scales", "quats")
    if fire and int(epoch) > olc.start_dir_loss_at_epoch:
        nn_idx = losses.update_nearest_neighbors(
            params.means, gs.alive, olc.dir_loss_num_nn,
            olc.dir_loss_enforce_method, approx=cfg.training.approx_knn)

        def dloss(p):
            return losses.direction_loss(
                p.means, jnp.exp(p.scales), p.quats, nn_idx, gs.alive,
                olc.dir_loss_num_nn, olc.dir_loss_enforce_method)

        dval, dgrads = jax.value_and_grad(dloss)(params)
        lam = (loss_sum * olc.dir_loss_scale_factor) / \
            jnp.maximum(dval, 1e-12)
        dgrads = jax.tree.map(lambda g: lam * g, dgrads)
        params, opt = optim.apply_updates(params, dgrads, opt, lrs,
                                          geo_groups)
    if fire and int(epoch) > olc.start_ratio_loss_at_epoch:
        def rloss(p):
            return losses.ratio_loss(jnp.exp(p.scales), gs.alive)

        rval, rgrads = jax.value_and_grad(rloss)(params)
        lam = (loss_sum * olc.ratio_loss_scale_factor) / \
            jnp.maximum(rval, 1e-12)
        rgrads = jax.tree.map(lambda g: lam * g, rgrads)
        params, opt = optim.apply_updates(params, rgrads, opt, lrs,
                                          geo_groups)

    gs = gs._replace(
        params=params,
        absgrads=gs.absgrads + asum * lambda_proj / nv,
        absgrad_count=gs.absgrad_count + 1.0)
    return TrainState(gaussians=gs, opt=opt, step=step, key=key), \
        loss_sum / nv


def test_dp_multi_epoch_matches_batch_oracle():
    """8-device DP over 7 batch steps (crossing the step-5 dir/ratio
    firing and both alternation phases) tracks the hand-rolled
    single-device batch oracle."""
    cfg, ts0, images, edge_masks, viewmats, Ks, W, H = _setup()
    mesh = mesh_mod.make_mesh(view_axis=8, tile_axis=1)
    dp_step = train_dp.make_dp_train_step(cfg, W, H, "jax", mesh)

    ts_dp, ts_or = ts0, ts0
    for epoch in range(7):
        with mesh:
            ts_dp, loss_dp, _ = dp_step(ts_dp, jnp.int32(epoch), images,
                                        edge_masks, viewmats, Ks)
        ts_or, loss_or = _oracle_batch_step(cfg, W, H, ts_or,
                                            jnp.int32(epoch), images,
                                            edge_masks, viewmats, Ks)
        assert np.isclose(float(loss_dp), float(loss_or), rtol=1e-4), \
            (epoch, float(loss_dp), float(loss_or))

    assert int(ts_dp.step) == 7
    np.testing.assert_allclose(np.array(ts_dp.gaussians.params.means),
                               np.array(ts_or.gaussians.params.means),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(np.array(ts_dp.gaussians.params.scales),
                               np.array(ts_or.gaussians.params.scales),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(np.array(ts_dp.gaussians.absgrads),
                               np.array(ts_or.gaussians.absgrads),
                               atol=1e-4, rtol=1e-3)


def test_dp_composed_matches_flat_trajectory():
    """Hierarchical 2x4 (views x tiles) DP follows the 2x1 DP-only
    trajectory over multiple epochs, including the bg_edge_ratio
    sampler (same per-view fold_in keys on both meshes)."""
    cfg, ts0, images, edge_masks, viewmats, Ks, W, H = _setup(num_views=4)
    plc = cfg.training.loss.projection_losses
    plc.loss_before_alternating = "bg_edge_ratio"
    plc.start_alternating_at_epoch = 1
    plc.more_freq_loss = "bg_edge_ratio"

    mesh_c = mesh_mod.make_mesh(view_axis=2, tile_axis=4)
    mesh_f = mesh_mod.make_mesh(view_axis=2, tile_axis=1,
                                devices=jax.devices()[:2])
    step_c = train_dp.make_dp_train_step(cfg, W, H, "jax", mesh_c)
    step_f = train_dp.make_dp_train_step(cfg, W, H, "jax", mesh_f)

    ts_c, ts_f = ts0, ts0
    for epoch in range(6):
        with mesh_c:
            ts_c, loss_c, _ = step_c(ts_c, jnp.int32(epoch), images,
                                     edge_masks, viewmats, Ks)
        with mesh_f:
            ts_f, loss_f, _ = step_f(ts_f, jnp.int32(epoch), images,
                                     edge_masks, viewmats, Ks)
        assert np.isclose(float(loss_c), float(loss_f), rtol=1e-4), \
            (epoch, float(loss_c), float(loss_f))

    np.testing.assert_allclose(np.array(ts_c.gaussians.params.means),
                               np.array(ts_f.gaussians.params.means),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(np.array(ts_c.gaussians.absgrads),
                               np.array(ts_f.gaussians.absgrads),
                               atol=1e-4, rtol=1e-3)


def test_dp_tp_composed_matches_flat_trajectory():
    """Hierarchical 2x4 (views x GAUSS) DP x TP — each view row projects
    Gaussian shards, all-gathers packed rows, composites tile bands
    (parallel/train_dp.py composed-TP mode) — follows the 2x1 DP-only
    trajectory over multiple epochs, including the bg_edge_ratio sampler
    and a dir/ratio firing (VERDICT r4 #7: the large-capacity multi-host
    recipe of SCALING §4)."""
    cfg, ts0, images, edge_masks, viewmats, Ks, W, H = _setup(num_views=4)
    plc = cfg.training.loss.projection_losses
    plc.loss_before_alternating = "bg_edge_ratio"
    plc.start_alternating_at_epoch = 1
    plc.more_freq_loss = "bg_edge_ratio"

    mesh_c = mesh_mod.make_views_gauss_mesh(2, 4)
    mesh_f = mesh_mod.make_mesh(view_axis=2, tile_axis=1,
                                devices=jax.devices()[:2])
    step_c = train_dp.make_dp_train_step(cfg, W, H, "jax", mesh_c)
    step_f = train_dp.make_dp_train_step(cfg, W, H, "jax", mesh_f)

    ts_c, ts_f = ts0, ts0
    for epoch in range(6):
        with mesh_c:
            ts_c, loss_c, _ = step_c(ts_c, jnp.int32(epoch), images,
                                     edge_masks, viewmats, Ks)
        with mesh_f:
            ts_f, loss_f, _ = step_f(ts_f, jnp.int32(epoch), images,
                                     edge_masks, viewmats, Ks)
        assert np.isclose(float(loss_c), float(loss_f), rtol=1e-4), \
            (epoch, float(loss_c), float(loss_f))

    np.testing.assert_allclose(np.array(ts_c.gaussians.params.means),
                               np.array(ts_f.gaussians.params.means),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(np.array(ts_c.gaussians.params.quats),
                               np.array(ts_f.gaussians.params.quats),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(np.array(ts_c.gaussians.absgrads),
                               np.array(ts_f.gaussians.absgrads),
                               atol=1e-4, rtol=1e-3)


def test_dp_tp_composed_seg_kernel_step():
    """DP x TP with the shipped seg kernel: one composed batch step
    matches the flat-DP seg step's loss and pair watermark semantics."""
    cfg, ts0, images, edge_masks, viewmats, Ks, W, H = _setup(num_views=4)
    cfg.model.tile_dense_capacity = 32
    cfg.model.tile_pair_budget = 4096
    cfg.model.tile_pair_kernel = "seg"
    mesh_c = mesh_mod.make_views_gauss_mesh(2, 4)
    mesh_f = mesh_mod.make_mesh(view_axis=2, tile_axis=1,
                                devices=jax.devices()[:2])
    step_c = train_dp.make_dp_train_step(cfg, W, H, "interpret",
                                          mesh_c)
    step_f = train_dp.make_dp_train_step(cfg, W, H, "interpret",
                                          mesh_f)
    with mesh_c:
        ts_c, loss_c, mp_c = step_c(ts0, jnp.int32(0), images, edge_masks,
                                    viewmats, Ks)
    with mesh_f:
        ts_f, loss_f, mp_f = step_f(ts0, jnp.int32(0), images, edge_masks,
                                    viewmats, Ks)
    assert np.isclose(float(loss_c), float(loss_f), rtol=1e-4)
    assert 0 < int(mp_c) <= int(mp_f)
    np.testing.assert_allclose(np.array(ts_c.gaussians.params.means),
                               np.array(ts_f.gaussians.params.means),
                               atol=5e-4, rtol=1e-3)


def test_dp_tp_indivisible_capacity_raises():
    """Capacity not divisible by the 'gauss' axis must fail loudly at
    trace time, not silently floor-divide the shard reassembly."""
    cfg, ts0, images, edge_masks, viewmats, Ks, W, H = _setup(num_views=4)
    cfg.model.max_num_gaussians = 96          # 96 % 7 != 0... use axis 7?
    mesh_c = mesh_mod.make_views_gauss_mesh(1, 5)
    ts = trainer.init_train_state(
        np.asarray(ts0.gaussians.params.means)[:64], cfg)
    step = train_dp.make_dp_train_step(cfg, W, H, "jax", mesh_c)
    with pytest.raises(Exception, match="not divisible"):
        with mesh_c:
            step(ts, jnp.int32(0), images, edge_masks, viewmats, Ks)


def test_dp_composed_seg_kernel_matches_flat_trajectory():
    """The PRODUCTION multi-host configuration — hierarchical views x
    tiles DP with the segmented pair kernel (what every shipped config
    selects: tile_pair_kernel='seg') — follows the flat views x 1
    seg-kernel trajectory over multiple epochs, including a dir/ratio
    firing. Mirrors test_train_sharded's band-sharded seg parity for the
    composed-DP path."""
    cfg, ts0, images, edge_masks, viewmats, Ks, W, H = _setup(num_views=4)
    cfg.model.tile_dense_capacity = 32
    cfg.model.tile_pair_budget = 4096
    cfg.model.tile_pair_kernel = "seg"

    mesh_c = mesh_mod.make_mesh(view_axis=2, tile_axis=4)
    mesh_f = mesh_mod.make_mesh(view_axis=2, tile_axis=1,
                                devices=jax.devices()[:2])
    step_c = train_dp.make_dp_train_step(cfg, W, H, "interpret",
                                          mesh_c)
    step_f = train_dp.make_dp_train_step(cfg, W, H, "interpret",
                                          mesh_f)

    ts_c, ts_f = ts0, ts0
    for epoch in range(5):
        with mesh_c:
            ts_c, loss_c, mp_c = step_c(ts_c, jnp.int32(epoch), images,
                                        edge_masks, viewmats, Ks)
        with mesh_f:
            ts_f, loss_f, mp_f = step_f(ts_f, jnp.int32(epoch), images,
                                        edge_masks, viewmats, Ks)
        assert np.isclose(float(loss_c), float(loss_f), rtol=1e-4), \
            (epoch, float(loss_c), float(loss_f))
        assert 0 < int(mp_c) <= int(mp_f)

    np.testing.assert_allclose(np.array(ts_c.gaussians.params.means),
                               np.array(ts_f.gaussians.params.means),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(np.array(ts_c.gaussians.params.scales),
                               np.array(ts_f.gaussians.params.scales),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(np.array(ts_c.gaussians.absgrads),
                               np.array(ts_f.gaussians.absgrads),
                               atol=1e-4, rtol=1e-3)


def test_dp_composed_pair_watermark():
    """Composed mode reports the busiest band's (tile, Gaussian) pair
    count; flat DP reports the per-view count — both nonzero with the
    pair-prefix path on, and the composed watermark cannot exceed the
    flat one (bands partition each view's pairs)."""
    cfg, ts0, images, edge_masks, viewmats, Ks, W, H = _setup(num_views=4)
    cfg.model.tile_dense_capacity = 32
    cfg.model.tile_pair_budget = 4096
    mesh_c = mesh_mod.make_mesh(view_axis=2, tile_axis=4)
    mesh_f = mesh_mod.make_mesh(view_axis=2, tile_axis=1,
                                devices=jax.devices()[:2])
    step_c = train_dp.make_dp_train_step(cfg, W, H, "jax", mesh_c)
    step_f = train_dp.make_dp_train_step(cfg, W, H, "jax", mesh_f)
    with mesh_c:
        _, _, mp_c = step_c(ts0, jnp.int32(0), images, edge_masks,
                            viewmats, Ks)
    with mesh_f:
        _, _, mp_f = step_f(ts0, jnp.int32(0), images, edge_masks,
                            viewmats, Ks)
    assert int(mp_f) > 0
    assert 0 < int(mp_c) <= int(mp_f), (int(mp_c), int(mp_f))
