"""Training CLI — the counterpart of the reference's train_gaussians.py.

Usage:
    python -m edgegaussians_tpu.cli.train --config_file configs/ABC_DexiNed.json \
        --scene_name 00004926 [--force_rerun] [--ckpt_path ...]

Reproduces the reference's run layout (train_gaussians.py:225-346): outputs
to ``<output_dir>/<exp_name>_<detector>/<scene>/`` with ``gaussians_all.ply``,
a final checkpoint, and ``time.txt``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from edgegaussians_tpu.cameras import max_pairwise_center_distance
from edgegaussians_tpu.config import load_config
from edgegaussians_tpu.data import parsers, seed_points as seeds_mod
from edgegaussians_tpu.models.gaussians import export_as_ply
from edgegaussians_tpu.train import trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_file", type=str, required=True)
    ap.add_argument("--scene_name", type=str, default=None)
    ap.add_argument("--ckpt_path", type=str, default=None)
    ap.add_argument("--force_rerun", action="store_true")
    ap.add_argument("--backend", type=str, default="auto",
                    choices=["auto", "gpu", "interpret", "jax"],
                    help="render backend (ops/rasterize.py resolve_backend): "
                         "'auto' = the config's rasterizer_backend, 'gpu' "
                         "on a GPU and 'jax' elsewhere; 'gpu' = compiled "
                         "GPU compositor; 'interpret' = the same kernels "
                         "on the Pallas interpreter; 'jax' = plain XLA")
    ap.add_argument("--profile_dir", type=str, default=None,
                    help="dump a jax.profiler trace of steady-state epochs "
                         "here (view in TensorBoard's trace viewer)")
    ap.add_argument("--profile_epochs", type=int, default=1,
                    help="number of steady-state epochs to trace")
    ap.add_argument("--mesh_tiles", type=int, default=0,
                    help="shard every render+backward across this many "
                         "devices on a 'tiles' mesh axis (0 = single "
                         "device); semantics identical to single-device "
                         "training (parallel/train_sharded.py)")
    ap.add_argument("--mesh_gauss", type=int, default=0,
                    help="shard the N-Gaussian projection/compositing work "
                         "across this many devices on a 'gauss' mesh axis "
                         "(0 = single device); exact single-device "
                         "semantics, the per-chip memory/work axis for "
                         "DTU/Replica-scale capacities "
                         "(parallel/train_tp.py)")
    ap.add_argument("--mesh_views", type=int, default=0,
                    help="data-parallel view batches over this many "
                         "devices (implies step_mode='view_batch'; "
                         "large-batch throughput semantics, "
                         "parallel/train_dp.py). view_batch_size must "
                         "divide by this. COMPOSABLE with --mesh_tiles: "
                         "a views x tiles mesh runs hierarchical DP "
                         "across the 'views' axis with every render "
                         "tile-band-sharded across 'tiles' (the "
                         "multi-host recipe, docs/SCALING.md §4)")
    args = ap.parse_args(argv)
    if args.mesh_gauss and args.mesh_tiles:
        raise SystemExit("--mesh_gauss cannot combine with --mesh_tiles "
                         "(pick ONE per-render sharding axis; either "
                         "composes with --mesh_views)")

    from edgegaussians_tpu.parallel import distributed
    distributed.initialize()   # no-op single-process (multi-host: env vars)

    from edgegaussians_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    cfg = load_config(args.config_file)
    scene_name = args.scene_name

    # seed points (train_gaussians.py:246-257)
    rng = np.random.default_rng(cfg.training.seed)
    _, _, seed_path = parsers.get_paths_from_data_config(cfg.data, scene_name)
    if cfg.model.init_random_init:
        seed_pts = seeds_mod.init_seed_points_random(
            cfg.model.init_min_num_gaussians,
            cfg.model.random_init_box_center,
            cfg.model.random_init_box_size, rng)
    else:
        seed_pts = seeds_mod.init_seed_points_from_file(
            seed_path, cfg.model.init_min_num_gaussians, rng)

    scene = parsers.load_scene(cfg.data, scene_name)

    # optional scene-unit scaling (train_gaussians.py:269-284)
    if cfg.data.scale_scene_unit:
        scale = max_pairwise_center_distance(scene.cameras)
        if seed_pts is not None and len(seed_pts):
            scale = max(scale, seeds_mod.get_scale_from_points(
                seed_pts, 0.05, 0.95))
        seed_pts = seed_pts / scale
        scene = scene.scale_translations(1.0 / scale)

    exp_name = f"{cfg.output.exp_name}_{cfg.data.edge_detection_method}"
    output_dir = os.path.join(cfg.output.output_dir, exp_name, scene_name)
    final_ckpt = os.path.join(
        output_dir, f"epoch{cfg.training.num_epochs - 1}.npz")
    if os.path.exists(final_ckpt) and not args.force_rerun:
        print(f"Model already trained for {cfg.training.num_epochs} epochs. "
              "Exiting")
        return 0

    os.makedirs(output_dir, exist_ok=True)
    log_dir = os.path.join(cfg.output.log_dir, exp_name, scene_name)

    # optional resume: unlike the reference (params only, schedules restart —
    # SURVEY §3.5), our checkpoints restore optimizer state and step too.
    initial_state = None
    if args.ckpt_path is not None:
        template = trainer.init_train_state(seed_pts, cfg)
        initial_state = trainer.load_checkpoint(args.ckpt_path, template)
        print(f"Resumed from {args.ckpt_path}")

    mesh, mesh_strategy = None, "tiles"
    inner_axis = max(args.mesh_tiles or args.mesh_gauss, 1)
    n_mesh = (args.mesh_views * inner_axis if args.mesh_views
              else args.mesh_tiles or args.mesh_gauss)
    if n_mesh > 0:
        import jax
        from jax.sharding import Mesh
        devs = jax.devices()
        if len(devs) < n_mesh:
            raise SystemExit(f"mesh size {n_mesh} exceeds "
                             f"{len(devs)} available devices")
        if args.mesh_views:
            from edgegaussians_tpu.parallel import mesh as mesh_mod
            if args.mesh_gauss:
                mesh = mesh_mod.make_views_gauss_mesh(
                    args.mesh_views, inner_axis, devices=devs[:n_mesh])
                print(f"hierarchical view-DP x Gaussian-TP training over "
                      f"{args.mesh_views}x{inner_axis} devices")
            else:
                mesh = mesh_mod.make_mesh(view_axis=args.mesh_views,
                                          tile_axis=inner_axis,
                                          devices=devs[:n_mesh])
                if inner_axis > 1:
                    print(f"hierarchical view-DP x tile-band training "
                          f"over {args.mesh_views}x{inner_axis} devices")
                else:
                    print(f"view-DP training over {args.mesh_views} "
                          "devices")
            cfg.training.step_mode = "view_batch"
        else:
            mesh_strategy = "gauss" if args.mesh_gauss else "tiles"
            mesh = Mesh(np.array(devs[:n_mesh]), (mesh_strategy,))
            print(f"{mesh_strategy}-sharded training over {n_mesh} devices")

    t0 = time.time()
    ts = trainer.train(scene, seed_pts, cfg, backend=args.backend,
                       log_dir=log_dir,
                       initial_state=initial_state,
                       checkpoint_dir=(output_dir
                                       if cfg.training.checkpoint_interval
                                       else None),
                       profile_dir=args.profile_dir,
                       profile_epochs=args.profile_epochs,
                       mesh=mesh, mesh_strategy=mesh_strategy)
    elapsed = time.time() - t0
    print(f"Training took {elapsed} seconds")
    with open(os.path.join(output_dir, "time.txt"), "w") as f:
        f.write(f"Training took {elapsed} seconds")

    trainer.save_checkpoint(ts, output_dir, cfg.training.num_epochs - 1)
    if cfg.output.export_ply:
        n = export_as_ply(ts.gaussians,
                          os.path.join(output_dir, "gaussians_all.ply"))
        print(f"Exported {n} Gaussians to gaussians_all.ply")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
