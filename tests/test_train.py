"""End-to-end training smoke tests on a tiny synthetic scene.

The integration analog of the reference's manual end-to-end verification
(SURVEY §4): render a known Gaussian configuration into GT edge maps, then
train a fresh model against them and check the loss drops substantially.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from edgegaussians_tpu.config import (FrameworkConfig, ModelConfig,
                                      OptimConfig, OptimGroupConfig,
                                      TrainingConfig)
from edgegaussians_tpu.data.parsers import SceneViews
from edgegaussians_tpu.cameras import Camera, stack_cameras
from edgegaussians_tpu.models.gaussians import init_state, render_view
from edgegaussians_tpu.train import trainer


def _make_scene(n_views=4, width=48, height=48):
    """Cameras on a circle looking at a small Gaussian cluster at origin."""
    f = 0.5 * width / math.tan(math.radians(45) / 2)
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]])
    cams = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        center = np.array([2.5 * np.sin(ang), 0.0, -2.5 * np.cos(ang)])
        # look-at origin
        z = -center / np.linalg.norm(center)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R_c2w = np.stack([x, y, z], axis=1)
        R = R_c2w.T
        t = -R @ center
        cams.append(Camera.from_opencv(height, width, K, R, t))
    return cams, K


def _gt_images(cams, width, height):
    """Render GT edge maps from a known 'edge' of Gaussians along a line."""
    n = 16
    means = np.stack([np.linspace(-0.4, 0.4, n), np.zeros(n), np.zeros(n)],
                     axis=1).astype(np.float32)
    quats = np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32)
    scales = np.tile([0.06, 0.015, 0.015], (n, 1)).astype(np.float32)
    opac = np.full((n,), 0.9, np.float32)

    from edgegaussians_tpu.ops.rasterize_ref import rasterize_reference
    imgs = []
    for c in cams:
        img = rasterize_reference(
            jnp.asarray(means), jnp.asarray(quats), jnp.asarray(scales),
            jnp.asarray(opac), jnp.asarray(c.viewmat, dtype=jnp.float32),
            jnp.asarray(c.K, dtype=jnp.float32), width, height)
        imgs.append(np.clip(np.array(img), 0, 1))
    return np.stack(imgs)


def _tiny_config():
    cfg = FrameworkConfig()
    cfg.model = ModelConfig(
        init_scales_val=0.02, init_opacity_val=0.3,
        init_min_num_gaussians=64,
        if_duplicate_high_pos_grad=True,
        dup_threshold_type="absolute", dup_threshold_value=0.5,
        dup_factor=2, dup_high_pos_grads_at_epoch=[2],
        if_cull_low_opacity=True, cull_opacity_type="absolute",
        cull_opacity_value=0.01, cull_opacity_at_epoch=[3],
        if_cull_gaussians_not_projecting=False,
        if_cull_wayward=False, if_reset_opacity=False,
        max_num_gaussians=256, tile_gaussian_capacity=64, tile_size=16)
    cfg.training = TrainingConfig(num_epochs=6, seed=0)
    cfg.training.optim = OptimConfig(
        means=OptimGroupConfig(type="step", start_lr=5e-3,
                               milestones=[4], gamma=0.5),
        scales=OptimGroupConfig(start_lr=2e-3, start_at_epoch=1),
        quats=OptimGroupConfig(start_lr=2e-3, start_at_epoch=1),
        opacities=OptimGroupConfig(start_lr=0.05, start_at_epoch=0))
    cfg.training.loss.orientation_losses.start_dir_loss_at_epoch = 3
    cfg.training.loss.orientation_losses.start_ratio_loss_at_epoch = 3
    cfg.training.loss.projection_losses.start_alternating_at_epoch = 2
    return cfg


@pytest.fixture(scope="module")
def scene_and_cfg():
    width = height = 48
    cams, K = _make_scene(width=width, height=height)
    images = _gt_images(cams, width, height)
    Ks, viewmats, h, w = stack_cameras(cams)
    scene = SceneViews(images=images, Ks=Ks, viewmats=viewmats,
                       height=h, width=w, cameras=cams)
    return scene, _tiny_config()


def test_training_reduces_loss(scene_and_cfg):
    scene, cfg = scene_and_cfg
    # disable strategy alternation so per-epoch losses are comparable
    # (bg_edge_ratio has a different scale than 'whole')
    cfg = dataclasses.replace(cfg)
    cfg.training = dataclasses.replace(cfg.training)
    cfg.training.loss = dataclasses.replace(cfg.training.loss)
    cfg.training.loss.projection_losses = dataclasses.replace(
        cfg.training.loss.projection_losses, start_alternating_at_epoch=999)

    rng = np.random.default_rng(0)
    seeds = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)

    first_losses = []

    def log_fn(msg):
        first_losses.append(msg)

    ts = trainer.train(scene, seeds, cfg, backend="jax", log_fn=log_fn)
    assert int(ts.gaussians.num_alive()) > 0
    assert int(ts.step) == cfg.training.num_epochs * scene.num_views

    # parse logged losses
    vals = [float(m.split("loss=")[1].split()[0]) for m in first_losses
            if "loss=" in m]
    assert vals[-1] < vals[0] * 0.8, vals


def test_density_fires_during_training(scene_and_cfg):
    scene, cfg = scene_and_cfg
    rng = np.random.default_rng(1)
    seeds = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    msgs = []
    ts = trainer.train(scene, seeds, cfg, backend="jax", log_fn=msgs.append)
    counts = [int(m.split("alive=")[1].split()[0]) for m in msgs
              if "alive=" in m]
    # duplication at epoch 2 must have increased the count at some point
    assert max(counts) > 64 or counts[-1] != 64


def test_checkpoint_roundtrip(tmp_path, scene_and_cfg):
    scene, cfg = scene_and_cfg
    seeds = np.random.default_rng(2).uniform(-0.5, 0.5, (64, 3)) \
        .astype(np.float32)
    ts = trainer.init_train_state(seeds, cfg)
    path = trainer.save_checkpoint(ts, str(tmp_path), 0)
    ts2 = trainer.load_checkpoint(path, ts)
    np.testing.assert_allclose(np.array(ts.gaussians.params.means),
                               np.array(ts2.gaussians.params.means))
    assert int(ts2.step) == int(ts.step)


def test_grow_capacity_preserves_state(scene_and_cfg):
    scene, cfg = scene_and_cfg
    seeds = np.random.default_rng(3).uniform(-0.5, 0.5, (64, 3)) \
        .astype(np.float32)
    ts = trainer.init_train_state(seeds, cfg, capacity=128)
    ts = ts._replace(gaussians=ts.gaussians._replace(
        absgrads=jnp.arange(128, dtype=jnp.float32)))
    grown = trainer.grow_capacity(ts, 256)
    assert grown.gaussians.capacity == 256
    assert int(grown.gaussians.num_alive()) == int(ts.gaussians.num_alive())
    np.testing.assert_allclose(
        np.array(grown.gaussians.params.means[:128]),
        np.array(ts.gaussians.params.means))
    np.testing.assert_allclose(
        np.array(grown.gaussians.absgrads[:128]), np.arange(128))
    assert not bool(grown.gaussians.alive[128:].any())
    # moments padded with zeros
    mu, nu = grown.opt.moments.means
    assert mu.shape[0] == 256 and float(jnp.abs(mu[128:]).max()) == 0.0
    # no-op when target <= current
    same = trainer.grow_capacity(ts, 64)
    assert same.gaussians.capacity == 128


def test_staged_capacity_training_matches_behavior(scene_and_cfg):
    """Staged growth trains end-to-end and ends at a grown capacity."""
    scene, cfg = scene_and_cfg
    cfg = dataclasses.replace(cfg)
    cfg.model = dataclasses.replace(
        cfg.model, staged_capacity=True,
        staged_capacity_start_factor=1.2,
        staged_capacity_grow_threshold=0.8,
        init_min_num_gaussians=900, max_num_gaussians=4096)
    rng = np.random.default_rng(4)
    seeds = rng.uniform(-0.5, 0.5, (900, 3)).astype(np.float32)
    msgs = []
    ts = trainer.train(scene, seeds, cfg, backend="jax", log_fn=msgs.append)
    # started at 1024 (next pow2 >= 1.2*900); the epoch-2 duplication wants
    # 2x alive > 0.8*1024 so a growth stage must have fired
    assert ts.gaussians.capacity > 1024
    assert any("capacity" in m and "->" in m for m in msgs), msgs
    assert int(ts.gaussians.num_alive()) >= 900


def test_program_memo_reuses_epoch_fn():
    """Sweeps over same-geometry scenes must reuse compiled programs
    (fresh jax.jit wrappers per scene = a full recompile per scene)."""
    import copy

    from edgegaussians_tpu.config import FrameworkConfig
    from edgegaussians_tpu.train import trainer

    cfg = FrameworkConfig()
    f1 = trainer.make_epoch_fn(cfg, 64, 48, "jax")
    f2 = trainer.make_epoch_fn(copy.deepcopy(cfg), 64, 48, "jax")
    assert f1 is f2
    assert trainer.make_epoch_fn(cfg, 64, 64, "jax") is not f1

    d1 = trainer.make_density_fn(cfg)
    d2 = trainer.make_density_fn(copy.deepcopy(cfg))
    assert d1 is d2

    cfg2 = copy.deepcopy(cfg)
    cfg2.model.tile_size = 8
    assert trainer.make_epoch_fn(cfg2, 64, 48, "jax") is not f1

    # runtime-only knobs (RNG seed, output paths) never reach a program
    cfg3 = copy.deepcopy(cfg)
    cfg3.training.seed = 123
    cfg3.output.output_dir = "/elsewhere/"
    assert trainer.make_epoch_fn(cfg3, 64, 48, "jax") is f1
    assert trainer.make_density_fn(cfg3) is d1

    # density-only fields don't invalidate the epoch program (strategy
    # sweeps reuse the expensive epoch executable) but do rebuild the
    # density program; optimizer changes do the opposite
    cfg4 = copy.deepcopy(cfg)
    cfg4.model.dup_threshold_type = "top_fraction"
    cfg4.model.dup_threshold_value = 0.2
    assert trainer.make_epoch_fn(cfg4, 64, 48, "jax") is f1
    assert trainer.make_density_fn(cfg4) is not d1

    cfg5 = copy.deepcopy(cfg)
    cfg5.training.optim.means.start_lr = 1e-2
    assert trainer.make_epoch_fn(cfg5, 64, 48, "jax") is not f1
    assert trainer.make_density_fn(cfg5) is d1

    # num_epochs IS read by the epoch program (annealing denominators)
    cfg6 = copy.deepcopy(cfg)
    cfg6.training.num_epochs = cfg.training.num_epochs + 7
    assert trainer.make_epoch_fn(cfg6, 64, 48, "jax") is not f1


def test_checkpoint_schema_named_fields(tmp_path):
    """Schema-1 checkpoints store leaves by pytree key path; loading
    verifies field names (no positional leaf_{i} silently permuting after
    a TrainState refactor) and legacy positional files still load."""
    import jax
    import numpy as np
    from edgegaussians_tpu.config import FrameworkConfig
    from edgegaussians_tpu.train import trainer

    cfg = FrameworkConfig()
    cfg.model.max_num_gaussians = 32
    seeds = np.random.default_rng(0).uniform(
        -0.5, 0.5, (16, 3)).astype(np.float32)
    ts = trainer.init_train_state(seeds, cfg)

    path = trainer.save_checkpoint(ts, str(tmp_path), 3)
    data = np.load(path)
    assert int(data["__schema__"]) == trainer.CHECKPOINT_SCHEMA
    named = [k for k in data.files if k.startswith("f:")]
    assert any("means" in k for k in named)

    ts2 = trainer.load_checkpoint(path, ts)
    np.testing.assert_array_equal(np.array(ts2.gaussians.params.means),
                                  np.array(ts.gaussians.params.means))

    # legacy positional file loads through the shim
    legacy = tmp_path / "legacy.npz"
    leaves, _ = jax.tree.flatten(ts)
    np.savez(legacy, **{f"leaf_{i}": np.asarray(x)
                        for i, x in enumerate(leaves)})
    ts3 = trainer.load_checkpoint(str(legacy), ts)
    np.testing.assert_array_equal(np.array(ts3.gaussians.params.quats),
                                  np.array(ts.gaussians.params.quats))

    # a renamed/missing field must fail loudly, not permute silently
    bad = {k: data[k] for k in data.files}
    means_key = [k for k in named if "means" in k][0]
    bad[means_key.replace("means", "renamed")] = bad.pop(means_key)
    badpath = tmp_path / "bad.npz"
    np.savez(badpath, **bad)
    import pytest as _pytest
    with _pytest.raises(KeyError):
        trainer.load_checkpoint(str(badpath), ts)


def _pair_overflow_cfg(scene_cfg, action):
    """Tiny pair budget that every render exceeds, to exercise the
    tile_pair_overflow_action dispatch (config.py)."""
    cfg = dataclasses.replace(scene_cfg)
    cfg.model = dataclasses.replace(
        cfg.model, tile_dense_capacity=32, tile_overflow_tiles=4,
        tile_pair_budget=8, tile_pair_overflow_action=action)
    cfg.training = dataclasses.replace(cfg.training, num_epochs=3)
    return cfg


def test_pair_overflow_error_action(scene_and_cfg):
    scene, base_cfg = scene_and_cfg
    cfg = _pair_overflow_cfg(base_cfg, "error")
    seeds = np.random.default_rng(0).uniform(-0.5, 0.5, (64, 3)) \
        .astype(np.float32)
    with pytest.raises(RuntimeError, match="tile_pair_budget"):
        trainer.train(scene, seeds, cfg, backend="jax", log_fn=lambda m: None)


def test_pair_overflow_fallback_action(scene_and_cfg):
    """Overflow under 'fallback' (the default) switches the remaining
    epochs to the exact dense frame path and finishes training."""
    scene, base_cfg = scene_and_cfg
    cfg = _pair_overflow_cfg(base_cfg, "fallback")
    seeds = np.random.default_rng(0).uniform(-0.5, 0.5, (64, 3)) \
        .astype(np.float32)
    msgs = []
    ts = trainer.train(scene, seeds, cfg, backend="jax", log_fn=msgs.append)
    assert int(ts.step) == cfg.training.num_epochs * scene.num_views
    switched = [m for m in msgs if "dense frame path" in m]
    assert len(switched) == 1, msgs
    # epochs after the switch run the dense path: no further warnings
    assert not any("DROPPED" in m for m in msgs[msgs.index(switched[0]) + 1:])


def test_view_batch_step_mode(scene_and_cfg):
    """step_mode='view_batch' trains via the DP batch step end-to-end
    (VERDICT r2 item 8's mode, config-reachable): loss decreases and
    step counts batches, not views."""
    scene, base_cfg = scene_and_cfg
    cfg = dataclasses.replace(base_cfg)
    cfg.training = dataclasses.replace(
        base_cfg.training, step_mode="view_batch", view_batch_size=2,
        num_epochs=4)
    cfg.training.loss = dataclasses.replace(cfg.training.loss)
    cfg.training.loss.projection_losses = dataclasses.replace(
        cfg.training.loss.projection_losses, start_alternating_at_epoch=999)
    seeds = np.random.default_rng(0).uniform(-0.5, 0.5, (64, 3)) \
        .astype(np.float32)
    msgs = []
    ts = trainer.train(scene, seeds, cfg, backend="jax", log_fn=msgs.append)
    nb = scene.num_views // 2
    assert int(ts.step) == cfg.training.num_epochs * nb
    vals = [float(m.split("loss=")[1].split()[0]) for m in msgs
            if "loss=" in m]
    assert vals[-1] < vals[0], vals
