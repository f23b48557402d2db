"""One process of a multi-process (multi-controller) training run.

Validates the DCN/coordination path end-to-end for EVERY sharded strategy
(VERDICT r2 item 2, extended r4 item 4): N processes — each owning a
subset of devices — jointly run a sharded training program over ONE global
mesh, with its collectives crossing the process boundary (Gloo on CPU;
ICI/DCN on a real pod). The reference has no multi-process anything
(train_gaussians.py:290 picks a single torch device), so the oracle is our
own single-process trajectory: every process must end bit-for-bit (to f32
reduction noise) where the single-process run of the identical program
ends.

Strategies (``--strategy``):

- ``tiles``  — full-semantics tile-band epoch (per-render grad psums;
  parallel/train_sharded.py),
- ``tp``     — Gaussian-axis tensor-parallel epoch: the per-render
  all-gather of packed rows, its reduce-scatter transpose, and the
  full-grad reassembly psum all cross the process boundary
  (parallel/train_tp.py),
- ``dp``     — view-DP batch steps (per-batch grad psum;
  parallel/train_dp.py),
- ``dp_tiles`` — the hierarchical composition: a (views x tiles) mesh
  laid out so the 'views' axis spans PROCESSES and the 'tiles' axis stays
  process-local — DP across "hosts", tile-band inside each — the
  multi-host production recipe of docs/SCALING.md §4.

Per-epoch wall times are recorded (first epoch = compile, excluded from
the steady mean) so multi-controller collective cost is a measured
number, not an inference from d=1.

Launched by tests/test_multiprocess.py (2 processes x 2 virtual CPU
devices) or by hand:

    XLA_FLAGS=--xla_force_host_platform_device_count=2 JAX_PLATFORMS=cpu \
    python scripts/multiprocess_worker.py --coordinator 127.0.0.1:9733 \
        --num_processes 2 --process_id <i> --strategy tp --out /tmp/mp_out

On a multi-host cluster each host runs this pattern via cli/train.py, which calls
distributed.initialize() unconditionally (env-var driven, no-op when
single-process).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_scene(num_views=6, width=64, height=80, n_seed=64, seed=0):
    """Deterministic scene every process rebuilds identically."""
    import jax.numpy as jnp
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


def build_cfg():
    from edgegaussians_tpu.config import FrameworkConfig
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


DP_BATCH = 4    # views per DP batch step (divides both dp mesh layouts)


def build_mesh_and_step(strategy, cfg, W, H):
    """(mesh, run_one(ts, step_idx, data) -> (ts, loss)) for a strategy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from edgegaussians_tpu.parallel import (distributed, mesh as mesh_mod,
                                            train_dp, train_sharded,
                                            train_tp)

    if strategy == "tiles":
        mesh = distributed.tiles_mesh()
        epoch_fn = train_sharded.make_sharded_epoch_fn(cfg, W, H, "jax",
                                                       mesh)

        def run_one(ts, i, data):
            images, edge_masks, vms, Ks, ep = data(i)
            ts, stats = epoch_fn(ts, ep, images, edge_masks, vms, Ks)
            return ts, stats.avg_loss
        return mesh, run_one

    if strategy == "tp":
        mesh = Mesh(np.array(jax.devices()), ("gauss",))
        epoch_fn = train_tp.make_tp_epoch_fn(cfg, W, H, "jax", mesh)

        def run_one(ts, i, data):
            images, edge_masks, vms, Ks, ep = data(i)
            ts, stats = epoch_fn(ts, ep, images, edge_masks, vms, Ks)
            return ts, stats.avg_loss
        return mesh, run_one

    n = jax.device_count()
    if strategy == "dp":
        mesh = mesh_mod.make_mesh(view_axis=n, tile_axis=1,
                                  devices=jax.devices())
    elif strategy == "dp_tiles":
        # 'views' axis spans processes (devices of one process are
        # contiguous in jax.devices()), 'tiles' stays process-local: DP
        # across hosts x tile-band inside a host
        per_proc = jax.local_device_count()
        mesh = mesh_mod.make_mesh(view_axis=n // per_proc,
                                  tile_axis=per_proc,
                                  devices=jax.devices())
    elif strategy == "dp_gauss":
        # DP across processes x Gaussian-axis TP inside each: the
        # per-render all-gather of packed rows stays process-local while
        # the batch grad psum crosses processes (SCALING §4's
        # large-capacity recipe; parallel/train_dp.py composed-TP mode)
        per_proc = jax.local_device_count()
        mesh = mesh_mod.make_views_gauss_mesh(n // per_proc, per_proc,
                                              devices=jax.devices())
    else:
        raise SystemExit(f"unknown strategy {strategy}")
    dp_step = train_dp.make_dp_train_step(cfg, W, H, "jax", mesh)

    def run_one(ts, i, data):
        images, edge_masks, vms, Ks, ep = data(i)
        sl = slice(0, DP_BATCH)
        ts, loss, _ = dp_step(ts, ep, images[sl], edge_masks[sl],
                              vms[sl], Ks[sl])
        return ts, loss
    return mesh, run_one


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--strategy", default="tiles",
                    choices=["tiles", "tp", "dp", "dp_tiles", "dp_gauss"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--capacity", type=int, default=128,
                    help="Gaussian capacity (131072 = DTU shape; scales "
                         "TP's all-gather/reduce-scatter wire bytes)")
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--size", type=int, default=0,
                    help="override square image size (0 = 64x80 default)")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")

    from edgegaussians_tpu.parallel import distributed
    ok = distributed.initialize(args.coordinator, args.num_processes,
                                args.process_id)
    assert ok == (args.num_processes > 1), "initialize() mode mismatch"
    pid = jax.process_index()
    print(f"[p{pid}] processes={jax.process_count()} "
          f"local_devices={jax.local_device_count()} "
          f"global_devices={jax.device_count()}", flush=True)
    assert jax.process_count() == args.num_processes

    import jax.numpy as jnp

    from edgegaussians_tpu.train import trainer

    kw = dict(num_views=args.views)
    if args.size:
        kw.update(width=args.size, height=args.size)
    seeds, images, edge_masks, vms, Ks = build_scene(**kw)
    cfg = build_cfg()
    if args.capacity != 128:
        cfg.model.max_num_gaussians = args.capacity
        cfg.model.init_min_num_gaussians = min(args.capacity, 4096)
    W, H = images.shape[2], images.shape[1]

    mesh, run_one = build_mesh_and_step(args.strategy, cfg, W, H)

    ts = trainer.init_train_state(seeds, cfg)
    # promote process-local values to fully-replicated global arrays
    ts = distributed.replicate(ts, mesh)
    images, edge_masks, vms, Ks = distributed.replicate(
        (images, edge_masks, vms, Ks), mesh)

    def data(i):
        return (images, edge_masks, vms, Ks,
                distributed.replicate(jnp.int32(i), mesh))

    loss, times = None, []
    for ep in range(args.epochs):
        t0 = time.perf_counter()
        ts, loss_arr = run_one(ts, ep, data)
        jax.block_until_ready(loss_arr)
        times.append(time.perf_counter() - t0)
        loss = float(loss_arr)
        print(f"[p{pid}] {args.strategy} step {ep}: loss={loss:.6f} "
              f"t={times[-1]*1e3:.1f}ms", flush=True)

    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, f"proc{pid}.npz"),
             means=np.asarray(ts.gaussians.params.means),
             opacities=np.asarray(ts.gaussians.params.opacities),
             absgrads=np.asarray(ts.gaussians.absgrads),
             loss=np.float32(loss), step=np.asarray(ts.step),
             epoch_times=np.asarray(times, np.float64))
    print(f"[p{pid}] done", flush=True)


if __name__ == "__main__":
    main()
