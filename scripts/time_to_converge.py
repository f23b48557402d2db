"""Time-to-converge experiment: quality vs. training epoch on one scan.

The BASELINE.md north star is "time-to-converge on ABC scan 00004926", but
the reference always trains the full scheduled 400 epochs
(train_gaussians.py:164 — no early stop, no intermediate eval). This script
measures where quality actually saturates: train the shipped config once
with periodic checkpoints, then run the full extraction + eval pipeline on
every checkpoint and print quality-vs-wall-clock.

Stage `train` needs a GPU; stage `eval` is CPU/NumPy. Example:

    python scripts/time_to_converge.py --stage train
    python scripts/time_to_converge.py --stage eval --seeds 3
"""

import argparse
import glob
import json
import os
import re
import time

import numpy as np

from _common import SCAN, extract_and_eval, scene_run_dir


def derive_config(base_config: str, out_root: str, interval: int) -> str:
    with open(base_config) as f:
        cfg = json.load(f)
    cfg["training"]["checkpoint_interval"] = interval
    cfg["output"]["output_dir"] = os.path.join(out_root, "ABC") + "/"
    cfg["output"]["log_dir"] = os.path.join(out_root, "logs") + "/"
    path = os.path.join(out_root, "ttc_config.json")
    os.makedirs(out_root, exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path


def stage_train(args) -> int:
    cfg_path = derive_config(args.config, args.out_root, args.interval)
    from edgegaussians_tpu.cli import train as train_cli
    from edgegaussians_tpu.config import load_config
    # a stale run's epochN.npz would make save_checkpoint fall back to
    # timestamped names that stage_eval ignores (and mtime-based wall
    # times would mix runs) — start clean
    run_dir = scene_run_dir(load_config(cfg_path), args.out_root)
    for old in glob.glob(os.path.join(run_dir, "epoch*.npz")):
        os.remove(old)
    t0 = time.time()
    rc = train_cli.main(["--config_file", cfg_path, "--scene_name", SCAN,
                         "--force_rerun"])
    with open(os.path.join(args.out_root, "t_start.txt"), "w") as f:
        f.write(str(t0))
    return rc


def checkpoints(run_dir: str):
    eps = {}
    for name in os.listdir(run_dir):
        m = re.fullmatch(r"epoch(\d+)\.npz", name)
        if m:
            eps[int(m.group(1))] = os.path.join(run_dir, name)
    return dict(sorted(eps.items()))


def stage_eval(args) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from edgegaussians_tpu.config import load_config
    from edgegaussians_tpu.data import parsers, seed_points as seeds_mod
    from edgegaussians_tpu.models.gaussians import export_as_ply
    from edgegaussians_tpu.train import trainer

    cfg_path = os.path.join(args.out_root, "ttc_config.json")
    cfg = load_config(cfg_path)
    with open(os.path.join(args.out_root, "t_start.txt")) as f:
        t0 = float(f.read())

    # identical seed-point draw as cli.train (same RNG stream) so the
    # checkpoint template has matching shapes
    rng = np.random.default_rng(cfg.training.seed)
    seed_pts = seeds_mod.init_seed_points_random(
        cfg.model.init_min_num_gaussians,
        cfg.model.random_init_box_center,
        cfg.model.random_init_box_size, rng)
    template = trainer.init_train_state(seed_pts, cfg)

    scene = None
    if cfg.filtering.filter_by_projection:
        scene = parsers.load_scene(cfg.data, SCAN)

    rows = []
    for epoch, ckpt in checkpoints(scene_run_dir(cfg, args.out_root)).items():
        wall = os.path.getmtime(ckpt) - t0
        ts = trainer.load_checkpoint(ckpt, template)
        ep_dir = os.path.join(args.out_root, "eval", f"ep{epoch:04d}", SCAN)
        os.makedirs(ep_dir, exist_ok=True)
        ply = os.path.join(ep_dir, "gaussians_all.ply")
        n_alive = export_as_ply(ts.gaussians, ply)

        m = extract_and_eval(ply, cfg, ep_dir, scene=scene,
                             extraction_seeds=args.seeds)
        if not m["chamfer"]:
            print(f"epoch {epoch}: extraction produced no edges")
            continue
        row = {
            "epoch": epoch, "wall_s": round(wall, 1), "alive": n_alive,
            "chamfer": float(np.mean(m["chamfer"])),
            "f5": float(np.mean(m["f5"])),
            "f10": float(np.mean(m["f10"])),
            "f10_min": float(np.min(m["f10"])),
            "f20": float(np.mean(m["f20"])),
        }
        rows.append(row)
        print(f"epoch {row['epoch']:4d}  wall {row['wall_s']:7.1f}s  "
              f"alive {row['alive']:6d}  chamfer {row['chamfer']:.4f}  "
              f"F@5 {row['f5']:.3f}  F@10 {row['f10']:.3f} "
              f"(min {row['f10_min']:.3f})  F@20 {row['f20']:.3f}")

    out = os.path.join(args.out_root, "ttc_results.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"wrote {out}")
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", choices=["train", "eval"], required=True)
    ap.add_argument("--config", default="configs/ABC_DexiNed.json")
    ap.add_argument("--out_root", default="/tmp/ttc")
    ap.add_argument("--interval", type=int, default=25)
    ap.add_argument("--seeds", type=int, default=3,
                    help="extraction seeds per checkpoint (averages out "
                         "clustering stochasticity — README.md:84)")
    args = ap.parse_args()
    if args.stage == "train":
        return stage_train(args)
    return stage_eval(args)


if __name__ == "__main__":
    raise SystemExit(main())
