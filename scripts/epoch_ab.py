"""In-program component costs of the training step via epoch-level A/B.

Standalone per-op timings (profile_train_step.py) carry ~1.5-2 ms of
remote-dispatch overhead per call, so the true in-epoch cost of the
non-render components is measured here by differencing steady-state
epoch times of variant programs on the real scene:

  A: shipped config            -> t_A = render + adam + every5/5 + eps
  B: dir/ratio disabled        -> t_B = render + adam + eps
  A - B                        -> (kNN + dir + ratio + 2 geo-Adam) / 5

Each variant trains `--epochs` epochs from the same trained-model
checkpoint shapes (capacity 16384 steady state) on the bundled scan;
steady epoch time = median of the post-compile epochs.

Usage (GPU): python scripts/epoch_ab.py [--epochs 10]
"""

import argparse
import json
import os
import re
import time

import numpy as np

from _common import SCAN


def run_variant(tag, mutate, epochs, out_root):
    import contextlib
    import io

    with open("configs/ABC_DexiNed.json") as f:
        raw = json.load(f)
    raw["training"]["num_epochs"] = epochs
    raw["training"]["log_interval"] = 1
    # steady-state from epoch 0: no density events in the window
    raw["model"]["dup_high_pos_grads_at_epoch"] = []
    raw["model"]["cull_opacity_at_epoch"] = []
    raw["model"]["cull_gaussians_not_projecting_at_epoch"] = []
    raw["model"]["reset_opacity_at_epoch"] = []
    mutate(raw)
    raw["output"]["output_dir"] = os.path.join(out_root, tag, "ABC") + "/"
    raw["output"]["log_dir"] = os.path.join(out_root, tag, "logs") + "/"
    cfg_path = os.path.join(out_root, f"{tag}.json")
    os.makedirs(out_root, exist_ok=True)
    with open(cfg_path, "w") as f:
        json.dump(raw, f)

    from edgegaussians_tpu.cli import train as train_cli

    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            buf.write(s)
            return __import__("sys").__stdout__.write(s)

        def flush(self):
            __import__("sys").__stdout__.flush()

    with contextlib.redirect_stdout(Tee()):
        rc = train_cli.main(["--config_file", cfg_path, "--scene_name",
                             SCAN, "--force_rerun"])
    assert rc == 0
    # per-epoch px/s -> ms/view from the trainer log; drop compile epochs
    rates = [float(m.group(1)) for m in
             re.finditer(r"px/s=([0-9.]+)M", buf.getvalue())]
    views = 50
    ms = [800 * 800 * views / (r * 1e6) / views * 1e3 for r in rates
          if r > 5]
    return float(np.median(ms[2:])) if len(ms) > 4 else float("nan")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--out_root", default="/tmp/epoch_ab")
    args = ap.parse_args()

    def full(raw):
        # fire dir/ratio from epoch 0 so the A window includes them
        raw["training"]["loss"]["orientation_losses"][
            "start_dir_loss_at_epoch"] = -1
        raw["training"]["loss"]["orientation_losses"][
            "start_ratio_loss_at_epoch"] = -1

    def no_orient(raw):
        raw["training"]["loss"]["orientation_losses"][
            "start_dir_loss_at_epoch"] = 99999
        raw["training"]["loss"]["orientation_losses"][
            "start_ratio_loss_at_epoch"] = 99999

    t_a = run_variant("full", full, args.epochs, args.out_root)
    t_b = run_variant("noorient", no_orient, args.epochs, args.out_root)
    print(json.dumps({
        "t_full_ms_per_view": round(t_a, 3),
        "t_noorient_ms_per_view": round(t_b, 3),
        "every5_block_ms": round((t_a - t_b) * 5, 3),
        "note": "every5 = kNN + dir + ratio + 2 geo-Adam, in-program"}))


if __name__ == "__main__":
    main()
