"""Evaluation CLI — the counterpart of the reference's eval.py.

Per scan: load GT sampled points (cached PLY under
``<gt_base_dir>/sampled_pts/<scan>_<res>.ply`` or computed from the CAD
features), load predictions (filtered Gaussians / sampled parametric edges),
and report chamfer / accuracy / completeness plus PR/F/IoU at
{5, 10, 20} mm (reference: eval.py:12-201).
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from edgegaussians_tpu.eval import gt as gt_mod
from edgegaussians_tpu.eval import metrics as metrics_mod
from edgegaussians_tpu.io import ply as ply_io


def evaluate_scan(scan_name: str, gt_base_dir: str, output_dir: str,
                  metrics_pr, use_filtered_points=False,
                  use_parametric_edges=True, sample_resolution=0.005,
                  scale_points=1.0):
    """Evaluate one scan; returns per-scan chamfer metrics dict or None."""
    ply_path = os.path.join(gt_base_dir, "sampled_pts",
                            f"{scan_name}_{sample_resolution}.ply")
    if os.path.exists(ply_path):
        gt_points = ply_io.read_point_cloud(ply_path)
    else:
        _, gt_points, _ = gt_mod.get_gt_points(
            scan_name, edge_type="all", interval=sample_resolution,
            data_base_dir=gt_base_dir)
        if gt_points is None:
            return None

    pts = None
    if use_filtered_points:
        f = os.path.join(output_dir, scan_name, "gaussians_filtered.ply")
        if os.path.exists(f):
            pts = ply_io.read_point_cloud(f)
    elif use_parametric_edges:
        f = os.path.join(output_dir, scan_name,
                         f"edge_sampled_points_{sample_resolution}.ply")
        if os.path.exists(f):
            pts = ply_io.read_point_cloud(f)
        else:
            pj = os.path.join(output_dir, scan_name, "parametric_edges.json")
            if os.path.exists(pj):
                cp, lp, _, _ = gt_mod.sample_parametric_edges_file(
                    pj, sample_resolution)
                pts = np.concatenate([cp, lp], axis=0)

    if pts is None or len(pts) == 0:
        print(f"{scan_name}: predictions not found")
        return None

    pts = pts * scale_points
    pts32 = pts.astype(np.float32)
    gt32 = gt_points.astype(np.float32)
    chamfer, acc, comp = metrics_mod.chamfer_distance(pts32, gt32)
    metrics_mod.compute_precision_recall_IOU(
        pts32, gt32, metrics_pr, thresh_list=[0.005, 0.01, 0.02])
    return {"chamfer_dist": chamfer, "acc": acc, "comp": comp}


def main(argv=None):
    ap = argparse.ArgumentParser(description="evaluate the results")
    ap.add_argument("--dataset", type=str, default="ABC")
    ap.add_argument("--scan_names", type=str, required=True)
    ap.add_argument("--use_parametric_edges", action="store_true")
    ap.add_argument("--use_filtered_points", action="store_true")
    ap.add_argument("--version", type=str, default="release")
    ap.add_argument("--edge_detector", type=str, default="DexiNed")
    ap.add_argument("--scale_points", type=float, default=1.0)
    ap.add_argument("--gt_base_dir", type=str, required=True)
    ap.add_argument("--sample_resolution", type=float, default=0.005)
    ap.add_argument("--output_base_dir", type=str, default=None)
    ap.add_argument("--write_metrics", action="store_true")
    ap.add_argument("--write_metrics_dir", type=str, default="metrics/ABC")
    args = ap.parse_args(argv)

    output_base = args.output_base_dir or \
        f"output/ABC/{args.version}_{args.edge_detector}"
    if args.scan_names == "all":
        scan_names = sorted(os.listdir(output_base))
    else:
        scan_names = args.scan_names.split(",")

    metrics_pr = metrics_mod.empty_metrics()
    per_scan = {}
    for scan in scan_names:
        print(f"Evaluating {scan}")
        res = evaluate_scan(
            scan, args.gt_base_dir, output_base, metrics_pr,
            use_filtered_points=args.use_filtered_points,
            use_parametric_edges=(args.use_parametric_edges
                                  or not args.use_filtered_points),
            sample_resolution=args.sample_resolution,
            scale_points=args.scale_points)
        if res is not None:
            per_scan[scan] = {"edgegaussians": res}

    for key, vals in metrics_pr.items():
        if vals:
            print(f"{key}: {np.mean(vals)}")
    agg = {}
    for scan, d in per_scan.items():
        for k, v in d["edgegaussians"].items():
            agg.setdefault(k, []).append(v)
    for k, vals in agg.items():
        print(f"{k}: {np.mean(vals)}")

    if args.write_metrics:
        out_dir = os.path.join(args.write_metrics_dir, args.version,
                               args.edge_detector)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "pr.pkl"), "wb") as f:
            pickle.dump(metrics_pr, f)
        with open(os.path.join(out_dir, "acc_comp_chamfer.pkl"), "wb") as f:
            pickle.dump(per_scan, f)
    if not per_scan:
        print("no scan had predictions to evaluate")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
