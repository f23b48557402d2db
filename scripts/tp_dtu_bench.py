"""TP-vs-replicated step time + device memory at DTU scale (VERDICT r2 #1).

The Gaussian-axis TP strategy (parallel/train_tp.py) exists to divide the
per-chip projection/binning work and memory at DTU/Replica's 131072-Gaussian
capacity (reference param store edge_gs.py:96-103 at configs/DTU.json
shapes). This bench builds a synthetic 131k cloud at DTU's 1600x1200 pixel
geometry and times one full projection-loss+grad render (the trainer
proj-grad contract: fwd render + backward to all four parameter groups +
absgrad sink) for:

  - ``ref``: the replicated single-device path (trainer.make_proj_grad_fn),
  - ``tp``:  the Gaussian-axis-sharded path on an n-device ('gauss',) mesh.

It reports ms/render and the device's peak memory. Each mode runs in its
own process (peak-memory counters are cumulative per process):

    python scripts/tp_dtu_bench.py --mode ref
    python scripts/tp_dtu_bench.py --mode tp --mesh 1

On the single available chip, --mesh 1 measures TP's sharding overhead
(all-gather + grad reassembly at axis size 1); per-chip memory/work wins
at d>1 are validated relatively on the virtual CPU mesh (--platform cpu
--mesh 8) and follow from the sharded [N/d] projection shapes.
"""

import argparse
import json
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["ref", "tp"], required=True)
    ap.add_argument("--mesh", type=int, default=1)
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--height", type=int, default=1200)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--platform", type=str, default=None)
    ap.add_argument("--backend", type=str, default="auto")
    args = ap.parse_args()

    import os
    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from edgegaussians_tpu.config import FrameworkConfig
    from edgegaussians_tpu.models.gaussians import GaussianParams
    from edgegaussians_tpu.parallel import train_tp
    from edgegaussians_tpu.train import trainer

    from edgegaussians_tpu.ops.rasterize import resolve_backend
    backend = resolve_backend(args.backend)

    W, H, n = args.width, args.height, args.n
    cfg = FrameworkConfig()
    cfg.model.max_num_gaussians = n
    # DTU.json tile geometry at PidiNet-like splat mass
    cfg.model.tile_gaussian_capacity = 1024
    cfg.model.tile_dense_capacity = 128
    cfg.model.tile_overflow_tiles = 512
    cfg.model.max_tiles_per_gaussian = 16

    r = np.random.default_rng(0)
    means = r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    means[:, 2] += 2.0
    params = GaussianParams(
        means=jnp.asarray(means),
        scales=jnp.asarray(np.log(r.uniform(0.002, 0.02, (n, 3))
                                  .astype(np.float32))),
        quats=jnp.asarray(r.normal(size=(n, 4)).astype(np.float32)),
        opacities=jnp.asarray(
            np.log(1 / r.uniform(0.2, 0.9, (n, 1)).astype(np.float32) - 1)
            * -1.0))
    alive = jnp.ones((n,), bool)
    f = 2000.0
    K = jnp.asarray(np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]],
                             np.float32))
    vm = jnp.eye(4, dtype=jnp.float32)
    gt = jnp.zeros((H, W), jnp.float32)
    edge_mask = gt > 0.5
    key = jax.random.PRNGKey(0)
    sidx = jnp.int32(0)
    bg = jnp.float32(1.0)

    if args.mode == "ref":
        fn = jax.jit(trainer.make_proj_grad_fn(cfg, W, H, backend))
        label = "replicated"
    else:
        mesh = Mesh(np.array(jax.devices()[:args.mesh]), ("gauss",))
        fn = jax.jit(train_tp.make_tp_proj_grad_fn(cfg, W, H, backend,
                                                   mesh))
        label = f"tp@{args.mesh}"

    def run():
        return fn(params, alive, vm, K, gt, edge_mask, sidx, bg, key)

    t_c0 = time.time()
    out = run()
    jax.block_until_ready(out[0])
    compile_s = time.time() - t_c0
    t0 = time.time()
    for _ in range(args.iters):
        out = run()
    jax.block_until_ready(out[0])
    dt = (time.time() - t0) / args.iters

    stats = jax.local_devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    print(json.dumps({
        "mode": label, "platform": jax.default_backend(),
        "backend": backend, "n": n, "width": W, "height": H,
        "ms_per_render": round(dt * 1e3, 2),
        "mpx_per_s": round(W * H / dt / 1e6, 1),
        "compile_s": round(compile_s, 1),
        "peak_device_mem_gib": (round(peak / 2**30, 3)
                                if peak is not None else None),
        "loss": float(out[0])}))


if __name__ == "__main__":
    main()
