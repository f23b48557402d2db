"""Full-semantics tile-sharded training equivalence (VERDICT r1 item 2).

The sharded epoch program (parallel/train_sharded.py) must follow the
single-device trajectory — same per-view SGD cadence, loss alternation,
direction/ratio losses, absgrad accumulation, and density control — to f32
reduction-order noise, on the virtual 8-device CPU mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from edgegaussians_tpu.config import FrameworkConfig
from edgegaussians_tpu.parallel import train_sharded
from edgegaussians_tpu.train import trainer

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _scene(num_views=6, width=64, height=80, n_seed=64, seed=0):
    r = np.random.default_rng(seed)
    seeds = r.uniform(-0.5, 0.5, (n_seed, 3)).astype(np.float32)
    seeds[:, 2] += 2.0
    images = jnp.asarray(r.random((num_views, height, width)), jnp.float32)
    edge_masks = images > 0.5
    f = 60.0
    Ks = jnp.tile(jnp.array([[[f, 0, width / 2], [0, f, height / 2],
                              [0, 0, 1]]], jnp.float32), (num_views, 1, 1))
    viewmats = jnp.tile(jnp.eye(4, dtype=jnp.float32)[None],
                        (num_views, 1, 1))
    return seeds, images, edge_masks, viewmats, Ks


def _full_cfg():
    cfg = FrameworkConfig()
    cfg.model.max_num_gaussians = 128
    cfg.model.tile_gaussian_capacity = 32
    cfg.training.num_epochs = 8
    plc = cfg.training.loss.projection_losses
    plc.loss_before_alternating = "bg_edge_ratio"
    plc.start_alternating_at_epoch = 1
    plc.less_freq_loss = "whole"
    plc.more_freq_loss = "weighted"
    olc = cfg.training.loss.orientation_losses
    olc.start_dir_loss_at_epoch = 0
    olc.start_ratio_loss_at_epoch = 0
    return cfg


def test_sharded_epoch_tracks_single_device_trajectory():
    """4 epochs with strategy alternation + dir/ratio losses: params and
    absgrads must match the single-device run almost bitwise."""
    seeds, images, edge_masks, vms, Ks = _scene()
    cfg = _full_cfg()
    W, H = images.shape[2], images.shape[1]
    mesh = Mesh(np.array(jax.devices()[:4]), ("tiles",))

    ts_r = trainer.init_train_state(seeds, cfg)
    ts_s = ts_r
    ep_ref = trainer.make_epoch_fn(cfg, W, H, "jax")
    ep_sh = train_sharded.make_sharded_epoch_fn(cfg, W, H, "jax", mesh)

    for ep in range(4):
        ts_r, st_r = ep_ref(ts_r, jnp.int32(ep), images, edge_masks,
                            vms, Ks)
        ts_s, st_s = ep_sh(ts_s, jnp.int32(ep), images, edge_masks,
                           vms, Ks)
        assert np.isclose(float(st_r.avg_loss), float(st_s.avg_loss),
                          rtol=1e-5), ep
        assert int(st_r.max_tile_count) == int(st_s.max_tile_count)

    np.testing.assert_allclose(np.array(ts_s.gaussians.params.means),
                               np.array(ts_r.gaussians.params.means),
                               atol=2e-6)
    np.testing.assert_allclose(np.array(ts_s.gaussians.absgrads),
                               np.array(ts_r.gaussians.absgrads),
                               atol=1e-7)
    assert int(ts_s.step) == int(ts_r.step)


def test_sharded_training_with_density_control():
    """Multi-epoch run through run_density_control (duplication + cull)
    stays on the single-device trajectory: alive sets identical, params
    within noise."""
    seeds, images, edge_masks, vms, Ks = _scene()
    cfg = _full_cfg()
    cfg.model.if_duplicate_high_pos_grad = True
    cfg.model.dup_high_pos_grads_at_epoch = [2]
    cfg.model.if_cull_low_opacity = True
    cfg.model.cull_opacity_at_epoch = [4]
    W, H = images.shape[2], images.shape[1]
    mesh = Mesh(np.array(jax.devices()[:8]), ("tiles",))

    ep_ref = trainer.make_epoch_fn(cfg, W, H, "jax")
    ep_sh = train_sharded.make_sharded_epoch_fn(cfg, W, H, "jax", mesh)
    density_fn = trainer.make_density_fn(cfg)

    def run(epoch_fn):
        ts = trainer.init_train_state(seeds, cfg)
        key = jax.random.PRNGKey(cfg.training.seed + 1)
        for ep in range(6):
            ts, stats = epoch_fn(ts, jnp.int32(ep), images, edge_masks,
                                 vms, Ks)
            key, sub = jax.random.split(key)
            ts, _ = trainer.run_density_control(
                ts, ep, cfg, vms, Ks, edge_masks, sub,
                density_fn=density_fn)
        return ts

    ts_r = run(ep_ref)
    ts_s = run(ep_sh)

    alive_r = np.array(ts_r.gaussians.alive)
    alive_s = np.array(ts_s.gaussians.alive)
    assert alive_r.sum() > 64, "duplication must have fired"
    np.testing.assert_array_equal(alive_s, alive_r)
    np.testing.assert_allclose(
        np.array(ts_s.gaussians.params.means)[alive_r],
        np.array(ts_r.gaussians.params.means)[alive_r], atol=5e-6)


def test_sharded_epoch_uneven_tile_rows():
    """Height whose tile rows don't divide the mesh axis (5 rows over 8
    shards) pads correctly — losses identical to single-device."""
    seeds, images, edge_masks, vms, Ks = _scene(height=80)
    cfg = _full_cfg()
    W, H = images.shape[2], images.shape[1]
    mesh = Mesh(np.array(jax.devices()[:8]), ("tiles",))
    ts = trainer.init_train_state(seeds, cfg)
    ep_ref = trainer.make_epoch_fn(cfg, W, H, "jax")
    ep_sh = train_sharded.make_sharded_epoch_fn(cfg, W, H, "jax", mesh)
    _, st_r = ep_ref(ts, jnp.int32(0), images, edge_masks, vms, Ks)
    _, st_s = ep_sh(ts, jnp.int32(0), images, edge_masks, vms, Ks)
    assert np.isclose(float(st_r.avg_loss), float(st_s.avg_loss),
                      rtol=1e-5)


def test_sharded_pair_watermark_is_per_band_max():
    """Each band independently enjoys the full pair_budget, so the
    reported num_pairs must be the busiest band's count (pmax), NOT the
    cross-band total (psum) — a summed count can exceed the budget when
    no band overflowed (VERDICT r2 weak #2)."""
    import dataclasses
    seeds, images, edge_masks, vms, Ks = _scene(num_views=2)
    cfg = _full_cfg()
    cfg.model = dataclasses.replace(
        cfg.model, tile_gaussian_capacity=64, tile_dense_capacity=16,
        tile_overflow_tiles=4, tile_pair_budget=4096)
    W, H = images.shape[2], images.shape[1]
    mesh = Mesh(np.array(jax.devices()[:4]), ("tiles",))
    ts = trainer.init_train_state(seeds, cfg)

    ep_ref = trainer.make_epoch_fn(cfg, W, H, "jax")
    ep_sh = train_sharded.make_sharded_epoch_fn(cfg, W, H, "jax", mesh)
    _, st_r = ep_ref(ts, jnp.int32(0), images, edge_masks, vms, Ks)
    _, st_s = ep_sh(ts, jnp.int32(0), images, edge_masks, vms, Ks)

    total = int(st_r.max_pairs)
    band_max = int(st_s.max_pairs)
    assert total > 0 and band_max > 0
    # Gaussians spread over the whole image land in >1 band, so the
    # busiest band holds strictly fewer pairs than the global total (a
    # psum regression would report >= total) but at least total/4.
    assert band_max < total, (band_max, total)
    assert band_max * 4 >= total, (band_max, total)


def test_sharded_pair_overflow_fallback(tmp_path):
    """Overflow fallback rebuilds the MESH epoch program (dense path) and
    training completes — the host-side action composes with sharding."""
    import dataclasses

    from edgegaussians_tpu.cameras import Camera, stack_cameras
    from edgegaussians_tpu.data.parsers import SceneViews

    r = np.random.default_rng(0)
    W = H = 48
    f = 40.0
    cams = []
    for i in range(2):
        K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
        R = np.eye(3); t = np.array([0.0, 0.0, 2.0 + 0.1 * i])
        cams.append(Camera.from_opencv(H, W, K, R, t))
    Ks, vms, h, w = stack_cameras(cams)
    images = r.random((2, H, W)).astype(np.float32)
    scene = SceneViews(images=images, Ks=Ks, viewmats=vms, height=h,
                      width=w, cameras=cams)

    cfg = _full_cfg()
    cfg.model = dataclasses.replace(
        cfg.model, tile_dense_capacity=16, tile_overflow_tiles=4,
        tile_pair_budget=4, tile_pair_overflow_action="fallback")
    cfg.training = dataclasses.replace(cfg.training, num_epochs=3)

    seeds = r.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:2]), ("tiles",))
    msgs = []
    ts = trainer.train(scene, seeds, cfg, backend="jax",
                       log_fn=msgs.append, mesh=mesh)
    assert int(ts.step) == 3 * 2
    assert sum("dense frame path" in m for m in msgs) == 1, msgs


def test_sharded_pallas_matches_xla_per_render():
    """Per-render parity between the XLA backend and the Pallas seg
    compositor (interpret mode) under the same tile-sharded mesh; both run
    under the checked shard_map (ops.vma.shard_map)."""
    import dataclasses
    seeds, images, edge_masks, vms, Ks = _scene(num_views=1)
    cfg = _full_cfg()
    cfg.model = dataclasses.replace(
        cfg.model, tile_gaussian_capacity=32, tile_dense_capacity=16,
        tile_overflow_tiles=4, tile_pair_budget=4096, tile_pair_kernel="seg")
    W, H = images.shape[2], images.shape[1]
    mesh = Mesh(np.array(jax.devices()[:4]), ("tiles",))
    ts = trainer.init_train_state(seeds, cfg)

    args = (ts.gaussians.params, ts.gaussians.alive, vms[0], Ks[0],
            images[0], edge_masks[0], jnp.int32(1), jnp.float32(1.0),
            jax.random.PRNGKey(3))
    f_x = jax.jit(train_sharded.make_sharded_proj_grad_fn(
        cfg, W, H, "jax", mesh))
    f_p = jax.jit(train_sharded.make_sharded_proj_grad_fn(
        cfg, W, H, "interpret", mesh))
    loss_x, _, g_x, s_x = f_x(*args)
    loss_p, _, g_p, s_p = f_p(*args)
    assert np.isclose(float(loss_x), float(loss_p), rtol=1e-5)
    for name in ("means", "scales", "quats", "opacities"):
        np.testing.assert_allclose(
            np.asarray(getattr(g_p, name)), np.asarray(getattr(g_x, name)),
            atol=3e-5, rtol=1e-3, err_msg=f"pallas-vs-xla sharded {name}")
    np.testing.assert_allclose(np.asarray(s_p), np.asarray(s_x),
                               atol=3e-5, rtol=1e-3)


@pytest.mark.parametrize("backend", ["interpret", "jax"])
def test_sharded_pair_kernel_matches_reference(backend):
    """Tile-band sharding of a seg configuration — the path an ABC config
    + --mesh_tiles runs, on the seg kernel or the XLA backend — must match
    the unsharded dense render per-render."""
    import dataclasses
    seeds, images, edge_masks, vms, Ks = _scene(num_views=1)
    cfg = _full_cfg()
    cfg.model = dataclasses.replace(
        cfg.model, tile_gaussian_capacity=32, tile_dense_capacity=16,
        tile_overflow_tiles=4, tile_pair_budget=4096,
        tile_pair_kernel="seg")
    cfg_ref = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, tile_pair_budget=0,
                                       tile_pair_kernel=False))
    W, H = images.shape[2], images.shape[1]
    mesh = Mesh(np.array(jax.devices()[:4]), ("tiles",))
    ts = trainer.init_train_state(seeds, cfg)

    args = (ts.gaussians.params, ts.gaussians.alive, vms[0], Ks[0],
            images[0], edge_masks[0], jnp.int32(0), jnp.float32(1.0),
            jax.random.PRNGKey(5))
    f_pair = jax.jit(train_sharded.make_sharded_proj_grad_fn(
        cfg, W, H, backend, mesh))
    loss_p, _, g_p, s_p = f_pair(*args)

    proj_ref = trainer.make_proj_grad_fn(cfg_ref, W, H, "jax")
    loss_r, _, g_r, s_r = jax.jit(proj_ref)(*args)
    assert np.isclose(float(loss_p), float(loss_r), rtol=1e-5), \
        (float(loss_p), float(loss_r))
    for name in ("means", "scales", "quats", "opacities"):
        np.testing.assert_allclose(
            np.asarray(getattr(g_p, name)), np.asarray(getattr(g_r, name)),
            atol=3e-5, rtol=1e-3, err_msg=f"band+pair-kernel {name}")
    np.testing.assert_allclose(np.asarray(s_p), np.asarray(s_r),
                               atol=3e-5, rtol=1e-3)
