"""Gaussian-axis (tensor-parallel) sharding equivalence (VERDICT r1 item 3).

The TP epoch (parallel/train_tp.py) shards projection over parameter
shards and compositing over tile bands; its trajectory must match the
single-device epoch on the virtual CPU mesh, including at a
DTU-representative Gaussian count (>=32k).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from edgegaussians_tpu.config import FrameworkConfig
from edgegaussians_tpu.parallel import train_tp
from edgegaussians_tpu.train import trainer

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _scene(num_views, width, height, n_seed, seed=0):
    r = np.random.default_rng(seed)
    seeds = r.uniform(-0.5, 0.5, (n_seed, 3)).astype(np.float32)
    seeds[:, 2] += 2.0
    images = jnp.asarray(r.random((num_views, height, width)), jnp.float32)
    edge_masks = images > 0.5
    f = width * 0.9
    Ks = jnp.tile(jnp.array([[[f, 0, width / 2], [0, f, height / 2],
                              [0, 0, 1]]], jnp.float32), (num_views, 1, 1))
    viewmats = jnp.tile(jnp.eye(4, dtype=jnp.float32)[None],
                        (num_views, 1, 1))
    return seeds, images, edge_masks, viewmats, Ks


def test_tp_epoch_tracks_single_device_trajectory():
    seeds, images, edge_masks, vms, Ks = _scene(4, 64, 80, 64)
    cfg = FrameworkConfig()
    cfg.model.max_num_gaussians = 128
    cfg.model.tile_gaussian_capacity = 32
    plc = cfg.training.loss.projection_losses
    plc.loss_before_alternating = "bg_edge_ratio"
    plc.start_alternating_at_epoch = 1
    olc = cfg.training.loss.orientation_losses
    olc.start_dir_loss_at_epoch = 0
    olc.start_ratio_loss_at_epoch = 0
    W, H = images.shape[2], images.shape[1]
    mesh = Mesh(np.array(jax.devices()[:4]), ("gauss",))

    ts_r = trainer.init_train_state(seeds, cfg)
    ts_t = ts_r
    ep_ref = trainer.make_epoch_fn(cfg, W, H, "jax")
    ep_tp = train_tp.make_tp_epoch_fn(cfg, W, H, "jax", mesh)
    for ep in range(3):
        ts_r, st_r = ep_ref(ts_r, jnp.int32(ep), images, edge_masks,
                            vms, Ks)
        ts_t, st_t = ep_tp(ts_t, jnp.int32(ep), images, edge_masks,
                           vms, Ks)
        assert np.isclose(float(st_r.avg_loss), float(st_t.avg_loss),
                          rtol=1e-5), ep
    np.testing.assert_allclose(np.array(ts_t.gaussians.params.means),
                               np.array(ts_r.gaussians.params.means),
                               atol=2e-6)
    np.testing.assert_allclose(np.array(ts_t.gaussians.absgrads),
                               np.array(ts_r.gaussians.absgrads),
                               atol=1e-7)


def test_tp_proj_grad_large_n_equivalence():
    """N=32768 (DTU-representative): TP loss and grads match the
    single-device proj-grad."""
    n = 32768
    seeds, images, edge_masks, vms, Ks = _scene(1, 64, 64, n)
    cfg = FrameworkConfig()
    cfg.model.max_num_gaussians = n
    cfg.model.tile_gaussian_capacity = 64
    cfg.model.max_tiles_per_gaussian = 8
    W, H = images.shape[2], images.shape[1]
    mesh = Mesh(np.array(jax.devices()[:8]), ("gauss",))
    ts = trainer.init_train_state(seeds, cfg)

    tp = train_tp.make_tp_proj_grad_fn(cfg, W, H, "jax", mesh)
    sd = trainer.make_proj_grad_fn(cfg, W, H, "jax")
    args = (ts.gaussians.params, ts.gaussians.alive, vms[0], Ks[0],
            images[0], edge_masks[0], jnp.int32(0), jnp.float32(1.0),
            jax.random.PRNGKey(0))
    l_t, st_t, g_t, gs_t = jax.jit(tp)(*args)
    l_r, st_r, g_r, gs_r = jax.jit(sd)(*args)

    assert np.isclose(float(l_t), float(l_r), rtol=1e-5)
    assert int(st_t.max_tile) == int(st_r.max_tile)
    for name in ("means", "scales", "quats", "opacities"):
        got = np.array(getattr(g_t, name))
        ref = np.array(getattr(g_r, name))
        big = np.abs(ref) > 1e-6
        if big.any():
            np.testing.assert_allclose(got[big] / ref[big], 1.0,
                                       rtol=1e-2,
                                       err_msg=f"tp grad scale {name}")
        np.testing.assert_allclose(got, ref, atol=5e-6)
    np.testing.assert_allclose(np.array(gs_t), np.array(gs_r), atol=1e-6)


def test_tp_proj_grad_seg_pair_kernel_equivalence():
    """TP band rendering with the segmented pair compositor
    (tile_pair_kernel="seg", kernels interpreted) matches the
    single-device render — the Gaussian-sharded path a DTU config +
    --mesh_gauss runs."""
    import dataclasses
    n = 2048
    seeds, images, edge_masks, vms, Ks = _scene(1, 64, 64, n)
    cfg = FrameworkConfig()
    cfg.model.max_num_gaussians = n
    cfg.model = dataclasses.replace(
        cfg.model, tile_gaussian_capacity=64, max_tiles_per_gaussian=8,
        tile_pair_budget=8192, tile_pair_kernel="seg")
    W, H = images.shape[2], images.shape[1]
    mesh = Mesh(np.array(jax.devices()[:4]), ("gauss",))
    ts = trainer.init_train_state(seeds, cfg)

    tp = train_tp.make_tp_proj_grad_fn(cfg, W, H, "interpret", mesh)
    sd = trainer.make_proj_grad_fn(cfg, W, H, "interpret")
    args = (ts.gaussians.params, ts.gaussians.alive, vms[0], Ks[0],
            images[0], edge_masks[0], jnp.int32(0), jnp.float32(1.0),
            jax.random.PRNGKey(0))
    l_t, st_t, g_t, gs_t = jax.jit(tp)(*args)
    l_r, st_r, g_r, gs_r = jax.jit(sd)(*args)

    assert np.isclose(float(l_t), float(l_r), rtol=1e-5)
    for name in ("means", "scales", "quats", "opacities"):
        np.testing.assert_allclose(
            np.array(getattr(g_t, name)), np.array(getattr(g_r, name)),
            atol=5e-6, err_msg=f"tp+seg grad {name}")
    np.testing.assert_allclose(np.array(gs_t), np.array(gs_r), atol=1e-6)
