"""A/B spread experiment: 'absolute' vs 'top_fraction' duplication.

The reference's 'absolute' duplication rule (edge_gs.py:559-568: min-max-
normalized absgrads > 0.5) selects wildly varying fractions per event
(5.6%-54% measured on one trajectory) because the cutoff sits on a knife
edge of the normalized scale. This trains the shipped ABC config over
several training seeds for both strategies in ONE process (the program
memo is seed-insensitive, so seeds after the first run compile-free) and
reports final-quality spread per arm.

The training half needs a GPU; extraction/eval run on CPU.

    python scripts/dup_spread_ab.py --seeds 3
"""

import argparse
import json
import os
import time

import numpy as np

from _common import SCAN, extract_and_eval


def train_one(cfg, seed, out_dir):
    from edgegaussians_tpu.data import parsers, seed_points as seeds_mod
    from edgegaussians_tpu.models.gaussians import export_as_ply
    from edgegaussians_tpu.train import trainer

    if not hasattr(train_one, "_scene"):
        train_one._scene = parsers.load_scene(cfg.data, SCAN)
    scene = train_one._scene

    cfg.training.seed = seed
    rng = np.random.default_rng(seed)
    pts = seeds_mod.init_seed_points_random(
        cfg.model.init_min_num_gaussians,
        cfg.model.random_init_box_center,
        cfg.model.random_init_box_size, rng)
    t0 = time.time()
    ts = trainer.train(scene, pts, cfg, log_fn=lambda *_: None)
    wall = time.time() - t0
    os.makedirs(out_dir, exist_ok=True)
    ply = os.path.join(out_dir, "gaussians_all.ply")
    n = export_as_ply(ts.gaussians, ply)
    print(f"  trained seed={seed}: {wall:.1f}s, {n} Gaussians", flush=True)
    return ply, n, wall, scene


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--fraction", type=float, default=0.2)
    ap.add_argument("--config", default="configs/ABC_DexiNed.json")
    ap.add_argument("--out_root", default="/tmp/dup_ab")
    args = ap.parse_args()

    from edgegaussians_tpu.config import load_config

    arms = {
        "absolute": {},
        "top_fraction": {"dup_threshold_type": "top_fraction",
                         "dup_threshold_value": args.fraction},
    }
    results = {}
    for arm, overrides in arms.items():
        print(f"=== arm {arm} {overrides}", flush=True)
        cfg = load_config(args.config)
        for k, v in overrides.items():
            setattr(cfg.model, k, v)
        rows = []
        for seed in range(args.seeds):
            out_dir = os.path.join(args.out_root, arm, f"seed{seed}", SCAN)
            ply, n, wall, scene = train_one(cfg, seed, out_dir)
            m = extract_and_eval(ply, cfg, out_dir, scene=scene)
            chamfer = float(np.mean(m["chamfer"]))
            f10 = float(np.mean(m["f10"]))
            rows.append({"seed": seed, "gaussians": n, "wall_s": wall,
                         "chamfer": chamfer, "f10": f10})
            print(f"  seed={seed} gaussians={n} chamfer={chamfer:.4f} "
                  f"F@10={f10:.3f}", flush=True)
        results[arm] = rows
        c = [r["chamfer"] for r in rows]
        f = [r["f10"] for r in rows]
        g = [r["gaussians"] for r in rows]
        print(f"  {arm}: chamfer {np.mean(c):.4f} +- {np.std(c):.4f}  "
              f"F@10 {np.mean(f):.3f} +- {np.std(f):.3f}  "
              f"gaussians {np.mean(g):.0f} +- {np.std(g):.0f}", flush=True)

    out = os.path.join(args.out_root, "dup_ab_results.json")
    with open(out, "w") as fh:
        json.dump(results, fh, indent=1)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
