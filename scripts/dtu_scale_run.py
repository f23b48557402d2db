"""DTU-scale end-to-end run on a synthetic scene (VERDICT r1 item 6).

The DTU workload (configs/DTU.json) differs from ABC in every scaling
dimension: 1600x1200 images, 20k SfM seed points, 131072 max capacity with
staged growth, 500 epochs. Real DTU data is not bundled, so this script
generates a DTU-shaped synthetic scan (edge wireframe rendered to
detector-style edge maps + exact parametric GT), writes the DTU-layout
``sparse_sfm_points.txt``, patches configs/DTU.json onto it, and drives
train -> fit_edges -> evaluate. Records wall-clock + metrics for
docs/RESULTS.md.

Usage (GPU):
    python scripts/dtu_scale_run.py [--epochs 500] [--views 30]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")

BASE = "synthetic_data/DTU_synth"
SCAN = "dtu_s0"


def generate(args, base, scan, dataset_name="DTU"):
    from edgegaussians_tpu.data import synthetic
    from edgegaussians_tpu.io import ply as ply_io

    paths = synthetic.generate_scene(
        base, scan, seed=7, n_views=args.views, width=args.width,
        height=args.height, n_lines=args.lines, n_curves=args.curves,
        edge_detector="PidiNet", sigma_px=1.2)

    # sparse SfM seeds sampled from the GT edge cloud + noise, written in
    # the dataset's expected layout (parsers.get_paths_from_data_config):
    # DTU = whitespace xyz .txt; ABC/Replica = colmap/sparse/sparse.ply
    gt_ply = paths["gt_ply"] if "gt_ply" in paths else os.path.join(
        base, "groundtruth", "sampled_pts", f"{scan}_0.005.ply")
    pts = ply_io.read_point_cloud(gt_ply)
    rng = np.random.default_rng(11)
    take = rng.choice(len(pts), size=min(4000, len(pts)), replace=True)
    seeds = pts[take] + rng.normal(0, 0.01, (len(take), 3))
    if dataset_name == "DTU":
        np.savetxt(os.path.join(base, "data", scan,
                                "sparse_sfm_points.txt"),
                   seeds, fmt="%.6f")
    else:
        sp = os.path.join(base, "data", scan, "colmap", "sparse")
        os.makedirs(sp, exist_ok=True)
        ply_io.write_point_cloud(os.path.join(sp, "sparse.ply"),
                                 seeds.astype(np.float32))
    return paths


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--views", type=int, default=30)
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--height", type=int, default=1200)
    ap.add_argument("--lines", type=int, default=16)
    ap.add_argument("--curves", type=int, default=8)
    ap.add_argument("--skip-generate", action="store_true")
    ap.add_argument("--backend", type=str, default="auto")
    ap.add_argument("--mesh_gauss", type=int, default=0,
                    help="train with the Gaussian-axis TP epoch over this "
                         "many devices (parallel/train_tp.py)")
    ap.add_argument("--pair_budget", type=int, default=-1,
                    help="override tile_pair_budget (-1 = shipped value)")
    ap.add_argument("--pair_kernel", type=str, default="-1",
                    help="override tile_pair_kernel (0/seg; "
                         "-1 = shipped)")
    ap.add_argument("--train_seed", type=int, default=-1,
                    help="override training.seed (trajectory spread runs; "
                         "-1 = shipped value)")
    ap.add_argument("--log_interval", type=int, default=0,
                    help="override trainer log cadence (1 = every-epoch "
                         "pair watermark for budget audits)")
    ap.add_argument("--skip-eval", action="store_true",
                    help="stop after training (timing/memory runs)")
    ap.add_argument("--config", default="configs/DTU.json",
                    help="config to drive (configs/Replica.json runs the "
                         "Replica recipe on a Replica-layout synthetic "
                         "scene)")
    args = ap.parse_args()

    cfg = json.load(open(args.config))
    dataset = cfg["data"].get("dataset_name", "DTU")
    name = os.path.splitext(os.path.basename(args.config))[0]
    base = BASE if dataset == "DTU" else f"synthetic_data/{name}_synth"
    scan = SCAN if dataset == "DTU" else f"{name.lower()}_s0"

    if not args.skip_generate:
        print(f"generating {dataset}-shaped synthetic scan...")
        generate(args, base, scan, dataset)

    cfg["data"]["base_dir"] = f"{base}/data/"
    cfg["data"]["edge_detection_method"] = "PidiNet"
    cfg["training"]["num_epochs"] = args.epochs
    cfg["output"]["output_dir"] = f"output_synth/{name}_synth/"
    if args.pair_budget >= 0:
        cfg["model"]["tile_pair_budget"] = args.pair_budget
    if args.pair_kernel != "-1":
        cfg["model"]["tile_pair_kernel"] = {"0": False}.get(
            args.pair_kernel, args.pair_kernel)
    if args.log_interval:
        cfg["training"]["log_interval"] = args.log_interval
    if args.train_seed >= 0:
        cfg["training"]["seed"] = args.train_seed
    cfg_path = "/tmp/dtu_synth_cfg.json"
    json.dump(cfg, open(cfg_path, "w"))

    from edgegaussians_tpu.cli import evaluate as eval_cli
    from edgegaussians_tpu.cli import fit_edges as fit_cli
    from edgegaussians_tpu.cli import train as train_cli

    train_args = ["--config_file", cfg_path, "--scene_name", scan,
                  "--force_rerun", "--backend", args.backend]
    if args.mesh_gauss:
        train_args += ["--mesh_gauss", str(args.mesh_gauss)]
    t0 = time.time()
    train_cli.main(train_args)
    t_train = time.time() - t0
    print(f"[dtu_scale] training wall-clock: {t_train:.1f} s")
    try:
        import jax
        stats = jax.local_devices()[0].memory_stats() or {}
        if "peak_bytes_in_use" in stats:
            print(f"[dtu_scale] peak device memory: "
                  f"{stats['peak_bytes_in_use'] / 2**30:.2f} GiB")
    except Exception:
        pass
    if args.skip_eval:
        return

    fit_cli.main(["--config_file", cfg_path, "--scene_name", scan])
    exp = f"{cfg['output']['exp_name']}_PidiNet"
    eval_cli.main(["--scan_names", scan,
                   "--gt_base_dir", f"{base}/groundtruth",
                   "--output_base_dir",
                   os.path.join(cfg["output"]["output_dir"], exp),
                   "--use_parametric_edges"])
    print(f"[dtu_scale] done; train={t_train:.1f}s")


if __name__ == "__main__":
    main()
