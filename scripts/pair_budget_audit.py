"""Audit tile_pair_budget on a full real-scan training run.

The sorted-pair-prefix path (ops/tiles.py pair mode; KERNELS.md §5.2) cuts
the backward scatter + frame gathers from the dense frame-row count (~402k
at ABC geometry) to a static pair budget B — measured 68 -> 96 Mpx/s on the
trained-scene fixture with occupancy sorting. Pairs past B are DROPPED from
renders, so shipping a budget in a config requires knowing the peak
per-view pair count over a whole training run, not just the final model.

This script trains the shipped config with a deliberately generous budget,
collects the per-epoch `pairs=` watermark from the trainer log, runs
extraction + eval, and reports:

  - the peak (tile, Gaussian) pair count over all epochs x views,
  - training wall-clock (vs the dense-path baseline),
  - chamfer / F-scores (must match the dense-path distribution).

Usage (GPU):  python scripts/pair_budget_audit.py [--budget 98304]
              [--config configs/ABC_DexiNed.json] [--epochs 400]
"""

import argparse
import contextlib
import io
import json
import os
import re
import time

import numpy as np

from _common import SCAN, extract_and_eval, scene_run_dir


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/ABC_DexiNed.json")
    ap.add_argument("--budget", type=int, default=98304)
    ap.add_argument("--epochs", type=int, default=0,
                    help="override num_epochs (0 = shipped value)")
    ap.add_argument("--out_root", default="/tmp/pair_audit")
    ap.add_argument("--log_interval", type=int, default=1,
                    help="trainer log cadence (0 = keep the shipped "
                         "value; 1 gives an every-epoch pair watermark "
                         "but adds a host sync per epoch)")
    ap.add_argument("--seeds", type=int, default=3,
                    help="extraction seeds for the quality check")
    args = ap.parse_args()

    with open(args.config) as f:
        raw = json.load(f)
    raw["model"]["tile_pair_budget"] = args.budget
    if args.log_interval:
        raw["training"]["log_interval"] = args.log_interval
    if args.epochs:
        raw["training"]["num_epochs"] = args.epochs
    raw["output"]["output_dir"] = os.path.join(args.out_root, "ABC") + "/"
    raw["output"]["log_dir"] = os.path.join(args.out_root, "logs") + "/"
    os.makedirs(args.out_root, exist_ok=True)
    cfg_path = os.path.join(args.out_root, "audit_config.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f, indent=1)

    from edgegaussians_tpu.cli import train as train_cli
    from edgegaussians_tpu.config import load_config

    # capture the trainer's per-epoch log lines to mine the pair watermark
    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            buf.write(s)
            return __import__("sys").__stdout__.write(s)

        def flush(self):
            __import__("sys").__stdout__.flush()

    t0 = time.time()
    with contextlib.redirect_stdout(Tee()):
        rc = train_cli.main(["--config_file", cfg_path,
                             "--scene_name", SCAN, "--force_rerun"])
    wall = time.time() - t0
    assert rc == 0, "training failed"
    log = buf.getvalue()

    pairs = [int(m.group(1)) for m in
             re.finditer(r"pairs=(\d+)/", log)]
    warns = len(re.findall(r"exceed tile_pair_budget", log))
    assert pairs, "no pairs= watermark in the log — pair mode not active?"
    peak = max(pairs)

    cfg = load_config(cfg_path)
    run_dir = scene_run_dir(cfg, args.out_root)
    ply = os.path.join(run_dir, "gaussians_all.ply")
    res = extract_and_eval(ply, cfg, run_dir, extraction_seeds=args.seeds)

    print("\n=== pair-budget audit ===")
    cadence = args.log_interval or "shipped config value"
    print(f"pair watermark mined from trainer logs at log_interval="
          f"{cadence}; with a cadence > 1 the reported peak only covers "
          "logged epochs (run with --log_interval 1 for the true "
          "whole-run peak)")
    print(f"budget={args.budget} peak_pairs={peak} "
          f"({peak / args.budget:.2f}x of budget) overflow_warnings={warns}")
    print(f"pairs trajectory: first={pairs[0]} "
          f"p50={int(np.median(pairs))} p90={int(np.percentile(pairs, 90))} "
          f"last={pairs[-1]}")
    print(f"train wall: {wall:.1f} s")
    print(f"chamfer: {np.mean(res['chamfer']):.4f} "
          f"+- {np.std(res['chamfer']):.4f}")
    for k in ("f5", "f10", "f20"):
        print(f"{k}: {np.mean(res[k]):.3f} +- {np.std(res[k]):.3f}")
    print(json.dumps({"budget": args.budget, "peak_pairs": peak,
                      "overflow_warnings": warns, "wall_s": round(wall, 1),
                      "chamfer": round(float(np.mean(res["chamfer"])), 5),
                      "f10": round(float(np.mean(res["f10"])), 4)}))


if __name__ == "__main__":
    main()
