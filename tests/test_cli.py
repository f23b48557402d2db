"""CLI integration tests on a fabricated miniature EMAP dataset.

Builds a tiny ABC-style scene on disk (meta_data.json + edge PNGs), then
drives the train -> fit_edges pipeline through the real CLI entry points —
the closest CPU-runnable analog of the reference's end-to-end usage
(README.md:44-81).
"""

import json
import os

import numpy as np
import pytest
from edgegaussians_tpu.io.png import write_png

from edgegaussians_tpu.cli import fit_edges as fit_cli
from edgegaussians_tpu.cli import train as train_cli


@pytest.fixture
def mini_dataset(tmp_path):
    """Two-view 48x48 EMAP scene with a bright edge band."""
    scene = tmp_path / "data" / "SCENE01"
    edge_dir = scene / "edge_DexiNed"
    edge_dir.mkdir(parents=True)

    w = h = 48
    f = 40.0
    frames = []
    rng = np.random.default_rng(0)
    for i in range(2):
        img = np.zeros((h, w), np.uint8)
        img[22:26, 8:40] = 255          # horizontal edge band
        name = f"{i}_colors.png"
        write_png(edge_dir / name, img)
        ang = 0.15 * i
        c2w = np.eye(4)
        c2w[:3, 3] = [0.5 + 0.1 * np.sin(ang), 0.5, 0.5 - 2.0]
        frames.append({
            "rgb_path": name,
            "camtoworld": c2w.tolist(),
            "intrinsics": [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
        })
    meta = {"camera_model": "OPENCV", "height": h, "width": w,
            "frames": frames}
    (scene / "meta_data.json").write_text(json.dumps(meta))

    cfg = {
        "model": {
            "init_random_init": True, "init_min_num_gaussians": 64,
            "random_init_box_center": 0.5, "random_init_box_size": 1.0,
            "init_scales_val": 0.02, "init_opacity_val": 0.2,
            "if_duplicate_high_pos_grad": False,
            "if_cull_low_opacity": False, "if_cull_wayward": False,
            "if_cull_gaussians_not_projecting": False,
            "max_num_gaussians": 128, "tile_gaussian_capacity": 64,
            "tile_dense_capacity": 0, "tile_size": 16,
        },
        "training": {
            "num_epochs": 2,
            "optim": {
                "means": {"type": "step", "start_lr": 5e-3,
                          "milestones": [], "gamma": 1.0},
                "scales": {"type": "start_at", "start_lr": 1e-3,
                           "start_at_epoch": 0},
                "quats": {"type": "start_at", "start_lr": 1e-3,
                          "start_at_epoch": 0},
                "opacities": {"type": "start_at", "start_lr": 0.03,
                              "start_at_epoch": 0},
            },
            "loss": {
                "orientation_losses": {"start_dir_loss_at_epoch": 99,
                                       "start_ratio_loss_at_epoch": 99},
                "projection_losses": {"start_alternating_at_epoch": 99},
            },
        },
        "data": {"parser_type": "emap", "dataset_name": "ABC",
                 "base_dir": str(tmp_path / "data") + "/",
                 "edge_detection_method": "DexiNed",
                 "image_res_scaling_factor": 1, "scale_scene_unit": False},
        "output": {"output_dir": str(tmp_path / "out") + "/",
                   "export_ply": True,
                   "log_dir": str(tmp_path / "logs") + "/",
                   "exp_name": "t"},
        "filtering": {"filter_by_opacity": True, "filter_opacity_min": 0.01,
                      "filter_stat_outliers": False,
                      "filter_by_projection": False},
        "parametric_fitting": {"angle_thresh": 0.6,
                               "line_ransac_thresh": 0.02,
                               "line_curve_residual_comp_factor": 0.4,
                               "min_cluster_size": 3},
    }
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    return str(cfg_path), tmp_path


def test_train_cli_end_to_end(mini_dataset):
    cfg_path, tmp = mini_dataset
    rc = train_cli.main(["--config_file", cfg_path,
                         "--scene_name", "SCENE01", "--backend", "jax"])
    assert rc == 0
    out_dir = tmp / "out" / "t_DexiNed" / "SCENE01"
    assert (out_dir / "gaussians_all.ply").exists()
    assert (out_dir / "time.txt").exists()
    assert (out_dir / "epoch1.npz").exists()

    # skip-if-trained guard (train_gaussians.py:325-329)
    rc2 = train_cli.main(["--config_file", cfg_path,
                          "--scene_name", "SCENE01", "--backend", "jax"])
    assert rc2 == 0

    # fit_edges consumes the trained PLY via the same config
    rc3 = fit_cli.main(["--config_file", cfg_path,
                        "--scene_name", "SCENE01", "--save_filtered"])
    assert rc3 == 0
    assert (out_dir / "parametric_edges.json").exists()
    data = json.loads((out_dir / "parametric_edges.json").read_text())
    assert "curves_ctl_pts" in data and "lines_end_pts" in data


def test_evaluate_cli(tmp_path):
    """evaluate CLI end-to-end with cached GT samples and parametric edges."""
    import numpy as np

    from edgegaussians_tpu.cli import evaluate as eval_cli
    from edgegaussians_tpu.io.ply import write_point_cloud

    # cached GT sample cloud
    gt_dir = tmp_path / "gt" / "sampled_pts"
    gt_dir.mkdir(parents=True)
    t = np.linspace(0, 1, 200)
    gt_pts = np.stack([t, np.zeros_like(t), np.zeros_like(t)], axis=1)
    write_point_cloud(str(gt_dir / "SCAN1_0.005.ply"), gt_pts)

    # predicted parametric edges: the same line
    out_dir = tmp_path / "out" / "SCAN1"
    out_dir.mkdir(parents=True)
    (out_dir / "parametric_edges.json").write_text(
        '{"curves_ctl_pts": [], "lines_end_pts": [[0,0,0,1,0,0]]}')

    metrics = {}
    res = eval_cli.evaluate_scan(
        "SCAN1", str(tmp_path / "gt"), str(tmp_path / "out"),
        __import__("edgegaussians_tpu.eval.metrics",
                   fromlist=["empty_metrics"]).empty_metrics(),
        use_parametric_edges=True)
    assert res is not None
    # same line, different sample spacings -> chamfer ~ half a sample step
    assert res["chamfer_dist"] < 5e-3
    assert res["acc"] < 5e-3 and res["comp"] < 5e-3

    rc = eval_cli.main([
        "--scan_names", "SCAN1", "--gt_base_dir", str(tmp_path / "gt"),
        "--output_base_dir", str(tmp_path / "out"),
        "--use_parametric_edges", "--write_metrics",
        "--write_metrics_dir", str(tmp_path / "metrics")])
    assert rc == 0
    assert (tmp_path / "metrics" / "release" / "DexiNed" / "pr.pkl").exists()


def test_sweep_cli(mini_dataset):
    """sweep CLI trains every scene of a config and writes the summary."""
    import shutil

    from edgegaussians_tpu.cli import sweep as sweep_cli

    cfg_path, tmp = mini_dataset
    # second scene: copy of the first
    shutil.copytree(tmp / "data" / "SCENE01", tmp / "data" / "SCENE02")
    rc = sweep_cli.main(["--config_file", cfg_path, "--scene_names", "all",
                         "--backend", "jax"])
    assert rc == 0
    out = tmp / "out" / "t_DexiNed"
    for scene in ("SCENE01", "SCENE02"):
        assert (out / scene / "gaussians_all.ply").exists()
    summary = json.loads((out / "sweep_p0.json").read_text())
    assert set(summary) == {"SCENE01", "SCENE02"}
    assert all(v["gaussians"] > 0 for v in summary.values())


def test_precompute_gt_cli(tmp_path):
    """precompute_gt samples fabricated ABC GT edges to a PLY."""
    from edgegaussians_tpu.cli import precompute_gt
    from edgegaussians_tpu.io.ply import read_point_cloud

    scan = "12345678"
    objs = tmp_path / "obj"
    objs.mkdir()
    (objs / f"{scan}_abc.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n")
    (tmp_path / "chunk_0000_feats.json").write_text(json.dumps({scan: [
        {"type": "Line", "sharp": True, "vert_indices": [0, 1]},
        {"type": "Line", "sharp": True, "vert_indices": [1, 2]},
        {"type": "BSpline", "sharp": False, "vert_indices": [2, 3]},
    ]}))
    (tmp_path / "chunk_0000_stats.json").write_text(json.dumps(
        {scan: {"bbox": [0, 0, 0, 1, 1, 1, 1, 1, 1]}}))

    rc = precompute_gt.main(["--gt_base_dir", str(tmp_path),
                             "--scan_names", scan])
    assert rc == 0
    out = tmp_path / "sampled_pts" / f"{scan}_0.005.ply"
    assert out.exists()
    pts = read_point_cloud(str(out))
    # two unit edges at 5 mm spacing, normalized into the 0.5^3 box
    assert 300 < len(pts) < 500
    assert pts.min() >= -0.01 and pts.max() <= 1.01


def test_visualize_cli(tmp_path):
    """visualize CLI renders a dirs-PLY to a PNG."""
    import numpy as np

    from edgegaussians_tpu.cli import (
        visualize_points_with_major_dirs as vis_cli)
    from edgegaussians_tpu.io.ply import write_pts_with_major_dirs_as_ply

    r = np.random.default_rng(0)
    pos = r.uniform(0, 1, (50, 3)).astype(np.float32)
    dirs = r.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ply = tmp_path / "dirs.ply"
    write_pts_with_major_dirs_as_ply(pos, dirs, str(ply))
    png = tmp_path / "vis.png"
    rc = vis_cli.main(["--dirs_ply", str(ply), "--save_path", str(png)])
    assert rc == 0
    assert png.exists() and png.stat().st_size > 0


def test_colmap_parser_train_cli(tmp_path):
    """parser_type=colmap scene loads and trains end-to-end (the COLMAP
    branch of the data layer — reference dataparsers.py:38-93)."""
    import numpy as np

    from edgegaussians_tpu.cli import train as train_cli
    from edgegaussians_tpu.io.ply import write_point_cloud

    scene = tmp_path / "data" / "SCENEC"
    colmap = scene / "colmap"
    edge_dir = scene / "edge_DexiNed"
    colmap.mkdir(parents=True)
    edge_dir.mkdir()

    w = h = 48
    f = 40.0
    # cameras.txt: one shared PINHOLE camera
    (colmap / "cameras.txt").write_text(
        f"# cameras\n1 PINHOLE {w} {h} {f} {f} {w/2} {h/2}\n")
    # images.txt: 2 views, identity-ish poses (qvec wxyz, tvec), 2-line recs
    lines = ["# images"]
    for i in range(2):
        tx = 0.5 + 0.05 * i
        lines.append(f"{i+1} 1 0 0 0 {-tx} -0.5 2.0 1 {i}_colors.png")
        lines.append("")  # empty POINTS2D line
    (colmap / "images.txt").write_text("\n".join(lines) + "\n")
    # seed points
    rng = np.random.default_rng(0)
    write_point_cloud(str(colmap / "sparse.ply"),
                      rng.uniform(0.3, 0.7, (64, 3)))
    for i in range(2):
        img = np.zeros((h, w), np.uint8)
        img[22:26, 8:40] = 255
        write_png(edge_dir / f"{i}_colors.png", img)

    cfg = {
        "model": {
            "init_random_init": False, "init_min_num_gaussians": 64,
            "init_scales_val": 0.02, "init_opacity_val": 0.2,
            "if_duplicate_high_pos_grad": False,
            "if_cull_low_opacity": False, "if_cull_wayward": False,
            "if_cull_gaussians_not_projecting": False,
            "max_num_gaussians": 128, "tile_gaussian_capacity": 64,
            "tile_dense_capacity": 0, "tile_size": 16,
        },
        "training": {
            "num_epochs": 2,
            "optim": {
                "means": {"type": "step", "start_lr": 5e-3,
                          "milestones": [], "gamma": 1.0},
                "scales": {"type": "start_at", "start_lr": 1e-3,
                           "start_at_epoch": 0},
                "quats": {"type": "start_at", "start_lr": 1e-3,
                          "start_at_epoch": 0},
                "opacities": {"type": "start_at", "start_lr": 0.03,
                              "start_at_epoch": 0},
            },
            "loss": {
                "orientation_losses": {"start_dir_loss_at_epoch": 99,
                                       "start_ratio_loss_at_epoch": 99},
                "projection_losses": {"start_alternating_at_epoch": 99},
            },
        },
        "data": {"parser_type": "colmap", "dataset_name": "ABC",
                 "base_dir": str(tmp_path / "data") + "/",
                 "edge_detection_method": "DexiNed",
                 "image_res_scaling_factor": 1, "scale_scene_unit": False},
        "output": {"output_dir": str(tmp_path / "out") + "/",
                   "export_ply": True,
                   "log_dir": str(tmp_path / "logs") + "/",
                   "exp_name": "t"},
        "filtering": {}, "parametric_fitting": {},
    }
    cfg_path = tmp_path / "cfgc.json"
    cfg_path.write_text(json.dumps(cfg))

    rc = train_cli.main(["--config_file", str(cfg_path),
                         "--scene_name", "SCENEC", "--backend", "jax"])
    assert rc == 0
    assert (tmp_path / "out" / "t_DexiNed" / "SCENEC"
            / "gaussians_all.ply").exists()


def test_bench_fixture_traces():
    """The committed real-workload bench fixture loads and its fwd+bwd
    program traces (bench.py's default mode)."""
    import jax
    import jax.numpy as jnp

    import bench
    from edgegaussians_tpu.ops.rasterize import rasterize

    (means, quats, scales, opac, viewmats, Ks, w, h, tiles,
     metric) = bench.fixture_scene()
    assert metric == "edge_splat_px_per_s_fwd_bwd"
    assert means.shape[0] == quats.shape[0] == scales.shape[0] \
        == opac.shape[0]
    assert opac.ndim == 1 and viewmats.shape[1:] == (4, 4)

    def loss_fn(m, q, s, o):
        out = rasterize(m, q, s, o, viewmats[0], Ks[0], w, h,
                        backend="jax", **tiles)
        return jnp.mean(out.image)

    g = jax.eval_shape(jax.value_and_grad(loss_fn, argnums=(0, 1, 2, 3)),
                       means, quats, scales, opac)
    assert g[1][0].shape == means.shape


@pytest.mark.skipif(
    __import__("jax").device_count() < 4, reason="needs 4 virtual devices")
def test_train_cli_mesh_gauss(mini_dataset):
    """--mesh_gauss trains on a ('gauss',) mesh with exact single-device
    semantics: the final PLY matches the unsharded run's (VERDICT r2
    item 1)."""
    from edgegaussians_tpu.io.ply import read_gaussian_params_from_ply

    cfg_path, tmp = mini_dataset
    rc = train_cli.main(["--config_file", cfg_path, "--scene_name",
                         "SCENE01", "--backend", "jax"])
    assert rc == 0
    out_dir = tmp / "out" / "t_DexiNed" / "SCENE01"
    ref_pos, _, _, ref_opac = read_gaussian_params_from_ply(
        str(out_dir / "gaussians_all.ply"))

    rc = train_cli.main(["--config_file", cfg_path, "--scene_name",
                         "SCENE01", "--backend", "jax", "--force_rerun",
                         "--mesh_gauss", "4"])
    assert rc == 0
    tp_pos, _, _, tp_opac = read_gaussian_params_from_ply(
        str(out_dir / "gaussians_all.ply"))
    np.testing.assert_allclose(tp_pos, ref_pos, atol=5e-6)
    np.testing.assert_allclose(tp_opac, ref_opac, atol=5e-6)


@pytest.mark.skipif(
    __import__("jax").device_count() < 2, reason="needs 2 virtual devices")
def test_train_cli_mesh_views_dp(mini_dataset):
    """--mesh_views trains the DP batch step over a 'views' mesh; the
    2-device trajectory matches the 1-device DP trajectory (grad psum over
    views == local average)."""
    import json as _json

    from edgegaussians_tpu.io.ply import read_gaussian_params_from_ply

    cfg_path, tmp = mini_dataset
    cfg = _json.loads(open(cfg_path).read())
    cfg["training"]["step_mode"] = "view_batch"
    cfg["training"]["view_batch_size"] = 2
    dp_cfg = tmp / "dp_cfg.json"
    dp_cfg.write_text(_json.dumps(cfg))

    out_dir = tmp / "out" / "t_DexiNed" / "SCENE01"
    rc = train_cli.main(["--config_file", str(dp_cfg), "--scene_name",
                         "SCENE01", "--backend", "jax", "--force_rerun"])
    assert rc == 0
    ref_pos, _, _, _ = read_gaussian_params_from_ply(
        str(out_dir / "gaussians_all.ply"))

    rc = train_cli.main(["--config_file", str(dp_cfg), "--scene_name",
                         "SCENE01", "--backend", "jax", "--force_rerun",
                         "--mesh_views", "2"])
    assert rc == 0
    dp_pos, _, _, _ = read_gaussian_params_from_ply(
        str(out_dir / "gaussians_all.ply"))
    np.testing.assert_allclose(dp_pos, ref_pos, atol=5e-6)


@pytest.mark.skipif(
    __import__("jax").device_count() < 4, reason="needs 4 virtual devices")
def test_train_cli_mesh_views_gauss_composed(mini_dataset):
    """--mesh_views N --mesh_gauss M trains the DP x TP composed step
    over a ('views','gauss') mesh (VERDICT r4 #7); the 2x2 trajectory
    matches the flat 2-view DP trajectory."""
    import json as _json

    from edgegaussians_tpu.io.ply import read_gaussian_params_from_ply

    cfg_path, tmp = mini_dataset
    cfg = _json.loads(open(cfg_path).read())
    cfg["training"]["step_mode"] = "view_batch"
    cfg["training"]["view_batch_size"] = 2
    dp_cfg = tmp / "dp_tp_cfg.json"
    dp_cfg.write_text(_json.dumps(cfg))

    out_dir = tmp / "out" / "t_DexiNed" / "SCENE01"
    rc = train_cli.main(["--config_file", str(dp_cfg), "--scene_name",
                         "SCENE01", "--backend", "jax", "--force_rerun",
                         "--mesh_views", "2"])
    assert rc == 0
    ref_pos, _, _, _ = read_gaussian_params_from_ply(
        str(out_dir / "gaussians_all.ply"))

    rc = train_cli.main(["--config_file", str(dp_cfg), "--scene_name",
                         "SCENE01", "--backend", "jax", "--force_rerun",
                         "--mesh_views", "2", "--mesh_gauss", "2"])
    assert rc == 0
    vg_pos, _, _, _ = read_gaussian_params_from_ply(
        str(out_dir / "gaussians_all.ply"))
    np.testing.assert_allclose(vg_pos, ref_pos, atol=5e-6)


def _bench():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench


def test_bench_refuses_without_gpu():
    """bench.py measures the GPU or nothing: no CPU fallback."""
    bench = _bench()
    with pytest.raises(RuntimeError, match="needs a GPU"):
        bench.device_info()
    with pytest.raises(RuntimeError, match="needs a GPU"):
        bench.main([])


def test_bench_summarize():
    s = _bench().summarize([3.0, 1.0, 2.0, 5.0, 4.0])
    assert s["median_ms"] == 3.0
    assert (s["min_ms"], s["max_ms"]) == (1.0, 5.0)
    assert s["blocks_ms"] == [3.0, 1.0, 2.0, 5.0, 4.0]
