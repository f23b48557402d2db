"""Scaling-efficiency harness: tiles/s at mesh sizes 1/2/4/8.

Measures the two scale-out strategies against BASELINE.md's ">=85%
tiles/s scaling efficiency at 2 hosts" target:

- ``sharded``: the full-semantics tile-band-sharded epoch
  (parallel/train_sharded.py) — exact per-view SGD trajectory,
- ``dp``: the view-data-parallel batch step (parallel/train_dp.py).

Per mesh size it runs warm steps, reports px/s + tiles/s and the
efficiency vs the 1-device run (eff = rate_n / (n * rate_1)). On real
multi-chip hardware this is the scoreboard; on a virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8) it validates the
machinery and the collective layout, not absolute rates — CPU "devices"
share host cores, so CPU efficiencies are meaningless as hardware claims
and the JSON marks the platform.

Usage:
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/scaling_efficiency.py --mesh-sizes 1,2,4,8 \
        --out docs/scaling_cpu.json

Multi-host: set JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
JAX_PROCESS_ID — initialize() wires jax.distributed and the same mesh
code spans every host's devices.
"""

import argparse
import json
import sys
import time

sys.path.insert(0, "/root/repo")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh-sizes", type=str, default="1,2,4,8")
    ap.add_argument("--mode", choices=["sharded", "dp", "tp", "all"],
                    default="all")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--gaussians", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=5,
                    help="timed epochs/steps per size (after 1 warmup)")
    ap.add_argument("--backend", type=str, default="auto")
    ap.add_argument("--platform", type=str, default=None,
                    help="force a jax platform (e.g. 'cpu' for the virtual "
                         "8-device mesh)")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    import os
    if args.platform:
        os.environ["JAX_PLATFORMS"] = args.platform
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp
    import numpy as np

    from jax.sharding import Mesh

    from edgegaussians_tpu.config import FrameworkConfig
    from edgegaussians_tpu.parallel import distributed, train_dp, \
        train_sharded, train_tp
    from edgegaussians_tpu.parallel import mesh as mesh_mod
    from edgegaussians_tpu.train import trainer

    distributed.initialize()   # no-op single-process

    from edgegaussians_tpu.ops.rasterize import resolve_backend
    backend = resolve_backend(args.backend)

    sizes = [int(s) for s in args.mesh_sizes.split(",")]
    sizes = [s for s in sizes if s <= len(jax.devices())]

    W, H, nv, n = args.width, args.height, args.views, args.gaussians
    r = np.random.default_rng(0)
    seeds = r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    seeds[:, 2] += 2.0
    images = jnp.asarray(r.random((nv, H, W)), jnp.float32)
    edge_masks = images > 0.5
    f = W * 0.9
    Ks = jnp.tile(jnp.array([[[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]]],
                            jnp.float32), (nv, 1, 1))
    vms = jnp.tile(jnp.eye(4, dtype=jnp.float32)[None], (nv, 1, 1))

    cfg = FrameworkConfig()
    cfg.model.max_num_gaussians = n
    cfg.model.tile_gaussian_capacity = 256
    cfg.model.tile_dense_capacity = 128
    cfg.training.num_epochs = 100

    from edgegaussians_tpu.ops.tiles import tile_grid
    tiles_per_view = tile_grid(W, H, cfg.model.tile_size)[2]
    px_per_epoch = nv * W * H

    results = {"platform": jax.default_backend(), "backend": backend,
               "width": W, "height": H, "views": nv, "gaussians": n,
               "modes": {}}

    def time_fn(fn, *fargs):
        out = fn(*fargs)                      # warmup/compile
        jax.block_until_ready(jax.tree.leaves(out)[0])
        t0 = time.time()
        for _ in range(args.steps):
            out = fn(*fargs)
        jax.block_until_ready(jax.tree.leaves(out)[0])
        return (time.time() - t0) / args.steps

    modes = (["sharded", "dp", "tp"] if args.mode in ("both", "all")
             else [args.mode])
    for mode in modes:
        rows = []
        for size in sizes:
            ts = trainer.init_train_state(seeds, cfg)
            if mode == "sharded":
                mesh = distributed.tiles_mesh(size)
                epoch_fn = train_sharded.make_sharded_epoch_fn(
                    cfg, W, H, backend, mesh)
                dt = time_fn(epoch_fn, ts, jnp.int32(0), images,
                             edge_masks, vms, Ks)
            elif mode == "tp":
                if ts.gaussians.capacity % size:
                    continue
                mesh = Mesh(np.array(jax.devices()[:size]), ("gauss",))
                epoch_fn = train_tp.make_tp_epoch_fn(cfg, W, H, backend,
                                                     mesh)
                dt = time_fn(epoch_fn, ts, jnp.int32(0), images,
                             edge_masks, vms, Ks)
            else:
                if nv % size:
                    continue
                mesh = mesh_mod.make_mesh(view_axis=size, tile_axis=1,
                                          devices=jax.devices()[:size])
                step = train_dp.make_dp_train_step(cfg, W, H, backend,
                                                   mesh)
                with mesh:
                    dt = time_fn(step, ts, jnp.int32(0), images,
                                 edge_masks, vms, Ks)
            rows.append({
                "devices": size,
                "sec_per_epoch": round(dt, 5),
                "px_per_s": round(px_per_epoch / dt, 1),
                "tiles_per_s": round(tiles_per_view * nv / dt, 1)})
            print(f"{mode} x{size}: {dt*1e3:.1f} ms/epoch "
                  f"({px_per_epoch/dt/1e6:.2f} Mpx/s)")
        if rows:
            base = rows[0]
            for row in rows:
                row["efficiency_vs_1dev"] = round(
                    row["px_per_s"] / (row["devices"] * base["px_per_s"]),
                    4)
        results["modes"][mode] = rows

    print(json.dumps(results))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)


if __name__ == "__main__":
    main()
