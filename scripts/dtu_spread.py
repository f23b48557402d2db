"""DTU-scale run-to-run spread over multiple scenes (VERDICT r2 item 9).

Only one real scan is bundled (ABC 00004926) and no real DTU data, so
quality claims at DTU scale rest on single runs. This script generates
several DTU-shaped synthetic scenes (1600x1200, 30 views, PidiNet-style
edge maps WITH detector noise — per-view dropout, spurious blobs,
response jitter) and drives the full shipped DTU pipeline
(train -> fit_edges -> evaluate) on each, bounding the run-to-run spread
at that scale.

Usage (GPU):
    python scripts/dtu_spread.py [--scenes 3] [--epochs 500]
        [--pair_budget -1]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np

BASE = "synthetic_data/DTU_spread"


def generate(scan, seed, args):
    from edgegaussians_tpu.data import synthetic
    from edgegaussians_tpu.io import ply as ply_io

    synthetic.generate_scene(
        BASE, scan, seed=seed, n_views=args.views, width=args.width,
        height=args.height, n_lines=16, n_curves=8,
        edge_detector="PidiNet", sigma_px=1.2,
        noise_dropout=0.15, noise_spurious=10,
        noise_intensity_jitter=0.05)
    gt_ply = os.path.join(BASE, "groundtruth", "sampled_pts",
                          f"{scan}_0.005.ply")
    pts = ply_io.read_point_cloud(gt_ply)
    rng = np.random.default_rng(seed + 100)
    take = rng.choice(len(pts), size=min(4000, len(pts)), replace=True)
    seeds = pts[take] + rng.normal(0, 0.01, (len(take), 3))
    np.savetxt(os.path.join(BASE, "data", scan, "sparse_sfm_points.txt"),
               seeds, fmt="%.6f")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--views", type=int, default=30)
    ap.add_argument("--width", type=int, default=1600)
    ap.add_argument("--height", type=int, default=1200)
    ap.add_argument("--pair_budget", type=int, default=-1,
                    help="override tile_pair_budget (-1 = shipped value)")
    ap.add_argument("--skip-generate", action="store_true")
    args = ap.parse_args()

    cfg = json.load(open("configs/DTU.json"))
    cfg["data"]["base_dir"] = f"{BASE}/data/"
    cfg["data"]["edge_detection_method"] = "PidiNet"
    cfg["training"]["num_epochs"] = args.epochs
    cfg["output"]["output_dir"] = "output_synth/DTU_spread/"
    if args.pair_budget >= 0:
        cfg["model"]["tile_pair_budget"] = args.pair_budget
    cfg_path = "/tmp/dtu_spread_cfg.json"
    json.dump(cfg, open(cfg_path, "w"))

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _common import extract_and_eval

    from edgegaussians_tpu.cli import train as train_cli
    from edgegaussians_tpu.config import load_config

    lcfg = load_config(cfg_path)
    exp = f"{cfg['output']['exp_name']}_PidiNet"
    rows = []
    for i in range(args.scenes):
        scan = f"dtu_sp{i}"
        if not args.skip_generate:
            print(f"[spread] generating {scan}...", flush=True)
            generate(scan, 20 + i, args)
        t0 = time.time()
        train_cli.main(["--config_file", cfg_path, "--scene_name", scan,
                        "--force_rerun"])
        wall = time.time() - t0
        run_dir = os.path.join(cfg["output"]["output_dir"], exp, scan)
        ply = os.path.join(run_dir, "gaussians_all.ply")
        res = extract_and_eval(ply, lcfg, run_dir, scan=scan,
                               gt_base=f"{BASE}/groundtruth",
                               extraction_seeds=1)
        row = {"scan": scan, "wall_s": round(wall, 1),
               "chamfer": round(float(np.mean(res["chamfer"])), 5),
               "f5": round(float(np.mean(res["f5"])), 4),
               "f10": round(float(np.mean(res["f10"])), 4)}
        rows.append(row)
        print(f"[spread] {row}", flush=True)
    ch = [r["chamfer"] for r in rows]
    f10 = [r["f10"] for r in rows]
    print(json.dumps({"rows": rows,
                      "chamfer_mean": round(float(np.mean(ch)), 5),
                      "chamfer_std": round(float(np.std(ch)), 5),
                      "f10_mean": round(float(np.mean(f10)), 4),
                      "f10_std": round(float(np.std(f10)), 4)}))


if __name__ == "__main__":
    main()
