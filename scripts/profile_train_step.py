"""Per-component timing of the FULL in-train view step (VERDICT r2 #7).

bench.py times the bare render fwd+bwd; the training step also runs the
projection-loss machinery, Adam on four groups, and — every 5th render —
the kNN refresh + direction loss + ratio loss (train/trainer.py
view_step; reference cadence train_gaussians.py:108-131). This script
times each component at the REAL trained-workload shapes (bench fixture
model inside the in-train capacity padding) and prints the expected
steady-state step time

    t_step = t_proj_grad + t_adam + (t_knn + t_dir + t_ratio) / 5 + eps

so the next optimization targets the real bottleneck of the ~40% of the
step the render does not explain.

Usage (GPU):
    python scripts/profile_train_step.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from edgegaussians_tpu.config import FrameworkConfig, load_config
from edgegaussians_tpu.models import losses
from edgegaussians_tpu.models.gaussians import GaussianParams
from edgegaussians_tpu.train import optim, trainer

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench_fixture", "abc_00004926.npz")


def timed(fn, *args, iters=20):
    out = fn(*args)
    jax.block_until_ready(jax.tree.leaves(out)[0])
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(jax.tree.leaves(out)[0])
    return (time.perf_counter() - t0) / iters * 1e3


def main():
    cfg = load_config("configs/ABC_DexiNed.json")
    d = np.load(FIXTURE)
    n = d["means"].shape[0]
    cap = cfg.model.max_num_gaussians         # in-train padding (16384)
    W, H = int(d["width"]), int(d["height"])
    from edgegaussians_tpu.ops.rasterize import resolve_backend
    backend = resolve_backend("auto")

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return jnp.asarray(out)

    quats = np.zeros((cap, 4), np.float32)
    quats[:, 0] = 1.0
    quats[:n] = d["quats"]
    params = GaussianParams(
        means=pad(d["means"]), scales=pad(np.log(d["scales"])),
        quats=jnp.asarray(quats),
        opacities=pad(np.log(d["opacities"].reshape(-1, 1)
                             / (1 - d["opacities"].reshape(-1, 1)))))
    alive = jnp.asarray(np.arange(cap) < n)
    vm, K = jnp.asarray(d["viewmats"][0]), jnp.asarray(d["Ks"][0])
    gt = jnp.zeros((H, W), jnp.float32)
    em = gt > 0.5
    key = jax.random.PRNGKey(0)

    res = {}
    # 1. projection loss + grad (render fwd+bwd + loss machinery)
    pg = jax.jit(trainer.make_proj_grad_fn(cfg, W, H, backend))
    res["proj_grad_ms"] = timed(
        pg, params, alive, vm, K, gt, em, jnp.int32(0), jnp.float32(1.0),
        key)
    res["proj_grad_bg_ratio_ms"] = timed(
        pg, params, alive, vm, K, gt, em, jnp.int32(1), jnp.float32(4.0),
        key)

    # 2. Adam on all four groups
    opt = optim.init_opt_state(params)
    lrs = optim.all_lrs(cfg.training.optim, jnp.int32(100))
    _, _, grads, _ = pg(params, alive, vm, K, gt, em, jnp.int32(0),
                        jnp.float32(1.0), key)
    adam = jax.jit(lambda p, g, o: optim.apply_updates(p, g, o, lrs))
    res["adam_ms"] = timed(adam, params, grads, opt)

    # 3. kNN refresh + direction loss grad + geo update
    ol = cfg.training.loss.orientation_losses
    num_nn, enforce = ol.dir_loss_num_nn, ol.dir_loss_enforce_method

    knn = jax.jit(lambda p: losses.update_nearest_neighbors(
        p.means, alive, num_nn, enforce, approx=cfg.training.approx_knn))
    res["knn_ms"] = timed(knn, params)
    nn_idx = knn(params)

    def dloss(p):
        return losses.direction_loss(p.means, jnp.exp(p.scales), p.quats,
                                     nn_idx, alive, num_nn, enforce)

    dgrad = jax.jit(jax.value_and_grad(dloss))
    res["dir_loss_ms"] = timed(dgrad, params)

    def rloss(p):
        return losses.ratio_loss(jnp.exp(p.scales), alive)

    rgrad = jax.jit(jax.value_and_grad(rloss))
    res["ratio_loss_ms"] = timed(rgrad, params)

    geo = ("means", "scales", "quats")
    geo_adam = jax.jit(lambda p, g, o: optim.apply_updates(p, g, o, lrs,
                                                           geo))
    res["geo_adam_ms"] = timed(geo_adam, params, dgrad(params)[1], opt)

    every5 = (res["knn_ms"] + res["dir_loss_ms"] + res["ratio_loss_ms"]
              + 2 * res["geo_adam_ms"])
    expected = (res["proj_grad_ms"] + res["adam_ms"] + every5 / 5.0)
    res["every5_total_ms"] = round(every5, 3)
    res["expected_step_ms"] = round(expected, 3)
    res["expected_in_train_mpx_s"] = round(W * H / expected / 1e3, 1)
    res = {k: (round(v, 3) if isinstance(v, float) else v)
           for k, v in res.items()}
    res["platform"] = jax.default_backend()
    res["capacity"] = cap
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
