"""Quality cost of the view-DP large-batch mode (VERDICT r2 item 8).

The DP batch step (parallel/train_dp.py; ``step_mode: "view_batch"``)
takes one Adam step per view batch instead of the reference's one step per
view (train_gaussians.py:71-106) — a documented throughput-mode semantics
divergence. This script measures what that trajectory costs in final
quality: it trains the shipped ABC config in DP mode on the bundled scan,
runs extraction + eval, and prints chamfer/F against the recorded per-view
SGD distribution (docs/RESULTS.md: chamfer 0.0106 +- 0.0002, F@10mm
0.964-0.974 with the reference duplication rule).

Usage (GPU):  python scripts/dp_quality_run.py [--batch 10] [--epochs 400]
"""

import argparse
import json
import os
import time

import numpy as np

from _common import SCAN, extract_and_eval, scene_run_dir


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/ABC_DexiNed.json")
    ap.add_argument("--batch", type=int, default=10,
                    help="view batch size per Adam step (50 views => "
                         "50/batch steps per epoch)")
    ap.add_argument("--epochs", type=int, default=0,
                    help="override num_epochs (0 = shipped value)")
    ap.add_argument("--out_root", default="/tmp/dp_quality")
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()

    with open(args.config) as f:
        raw = json.load(f)
    raw["training"]["step_mode"] = "view_batch"
    raw["training"]["view_batch_size"] = args.batch
    if args.epochs:
        raw["training"]["num_epochs"] = args.epochs
    raw["output"]["output_dir"] = os.path.join(args.out_root, "ABC") + "/"
    raw["output"]["log_dir"] = os.path.join(args.out_root, "logs") + "/"
    os.makedirs(args.out_root, exist_ok=True)
    cfg_path = os.path.join(args.out_root, "dp_config.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f, indent=1)

    from edgegaussians_tpu.cli import train as train_cli
    from edgegaussians_tpu.config import load_config

    t0 = time.time()
    rc = train_cli.main(["--config_file", cfg_path, "--scene_name", SCAN,
                         "--force_rerun"])
    wall = time.time() - t0
    assert rc == 0, "training failed"

    cfg = load_config(cfg_path)
    run_dir = scene_run_dir(cfg, args.out_root)
    ply = os.path.join(run_dir, "gaussians_all.ply")
    res = extract_and_eval(ply, cfg, run_dir, extraction_seeds=args.seeds)

    print("\n=== DP-mode quality run ===")
    print(f"batch={args.batch} epochs={raw['training']['num_epochs']} "
          f"wall={wall:.1f}s")
    print(f"chamfer: {np.mean(res['chamfer']):.4f} "
          f"+- {np.std(res['chamfer']):.4f}")
    for k in ("f5", "f10", "f20"):
        print(f"{k}: {np.mean(res[k]):.3f} +- {np.std(res[k]):.3f}")
    print(json.dumps({"mode": "view_batch", "batch": args.batch,
                      "wall_s": round(wall, 1),
                      "chamfer": round(float(np.mean(res["chamfer"])), 5),
                      "f10": round(float(np.mean(res["f10"])), 4)}))


if __name__ == "__main__":
    main()
