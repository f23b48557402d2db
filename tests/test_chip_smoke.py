"""chip_smoke.py: its refusal to run without a GPU, and its phase
functions at tiny size on the CPU (kernels interpreted)."""

import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_gpu():
    r = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_refuses_without_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path, str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phase_device_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.phase_device()


def test_phase_render_tiny():
    res, ref = cs.phase_render(backend="interpret", scale=0.5, views=1,
                               ref_crop=32)
    assert res["pixels"] == 400 * 400
    assert res["flip_pixels"] == 0
    assert ref["ref_flip_pixels"] == 0


# A 6-epoch 96x96 drive fits edges only when every parameter group learns
# from epoch 0 and the fit keeps faint, small clusters; its edges are far
# from the ground truth, so the chamfer bound is the unit box.
TINY_FIT = {
    "training": {"optim": {g: {"start_at_epoch": 0}
                           for g in ("scales", "quats", "opacities")}},
    "filtering": {"filter_opacity_min": 0.05, "filter_stat_outliers": False,
                  "filter_by_projection": False},
    "parametric_fitting": {"min_cluster_size": 3}}


def test_phase_train_tiny(tmp_path):
    rows = cs.phase_train(str(tmp_path), backend="interpret", n_views=6,
                          width=96, height=96, epochs=6, dup_epoch=3,
                          overrides=TINY_FIT, max_chamfer=1.0)
    assert [r[0] for r in rows] == list(range(6))
    assert rows[4][2] > rows[3][2]                    # duplication fired
    assert sum(cs.fitted_edges(str(
        tmp_path / "train" / "release_DexiNed"))) > 0
    assert (tmp_path / "metrics" / "smoke" / "DexiNed"
            / "acc_comp_chamfer.pkl").exists()


def test_write_train_config_merges_overrides(tmp_path):
    path, cfg = cs.write_train_config(
        str(tmp_path), "scan", epochs=3, dup_epoch=1,
        overrides={"training": {"step_mode": "view_batch"},
                   "filtering": {"filter_opacity_min": 0.1}})
    assert cfg["training"]["num_epochs"] == 3
    assert cfg["training"]["step_mode"] == "view_batch"
    assert cfg["training"]["optim"]["means"]["start_lr"] == 0.002  # kept
    assert cfg["filtering"]["filter_opacity_min"] == 0.1
    assert cfg["filtering"]["filter_by_projection"] is True         # kept
    assert cfg["model"]["dup_high_pos_grads_at_epoch"] == [1]


def _edges_json(run_dir, curves, lines):
    d = run_dir / cs.SCAN
    d.mkdir(parents=True)
    (d / "parametric_edges.json").write_text(json.dumps(
        {"curves_ctl_pts": curves, "lines_end_pts": lines}))


def test_fitted_edges(tmp_path):
    _edges_json(tmp_path, [], [[0, 0, 0, 1, 0, 0]])
    assert cs.fitted_edges(str(tmp_path)) == (0, 1)


def test_fitted_edges_refuses_an_empty_fit(tmp_path):
    _edges_json(tmp_path, [], [])
    with pytest.raises(AssertionError, match="no curve or line"):
        cs.fitted_edges(str(tmp_path))


def _metrics(tmp_path, per_scan, fscore=0.9):
    with open(tmp_path / "acc_comp_chamfer.pkl", "wb") as f:
        pickle.dump(per_scan, f)
    with open(tmp_path / "pr.pkl", "wb") as f:
        pickle.dump({"fscore_0.01": [fscore], "recall_0.01": [0.5]}, f)
    return str(tmp_path)


@pytest.mark.parametrize("chamfer,fscore,why", [
    (5e-3, 0.9, None),
    (float("nan"), 0.9, "non-finite"),
    (5e-3, float("inf"), "non-finite"),
    (0.05, 0.9, "chamfer"),
], ids=["ok", "nan_chamfer", "inf_fscore", "far"])
def test_eval_metrics(tmp_path, chamfer, fscore, why):
    d = _metrics(tmp_path, {cs.SCAN: {"edgegaussians": {
        "chamfer_dist": chamfer, "acc": 1e-3, "comp": 1e-3}}}, fscore)
    if why is None:
        res = cs.eval_metrics(d)
        assert res["chamfer_dist"] == chamfer and res["fscore_0.01"] == 0.9
        assert "recall_0.01" not in res
    else:
        with pytest.raises(AssertionError, match=why):
            cs.eval_metrics(d)


def test_eval_metrics_refuses_a_missing_scan(tmp_path):
    with pytest.raises(AssertionError, match="no metrics"):
        cs.eval_metrics(_metrics(tmp_path, {}))


def test_evaluate_cli_fails_without_predictions(tmp_path):
    """evaluate exits non-zero when no requested scan had predictions."""
    from edgegaussians_tpu.cli import evaluate
    from edgegaussians_tpu.io.ply import write_point_cloud

    gt = tmp_path / "gt" / "sampled_pts"
    gt.mkdir(parents=True)
    write_point_cloud(str(gt / "S_0.005.ply"), np.zeros((4, 3)))
    (tmp_path / "out" / "S").mkdir(parents=True)
    assert evaluate.main(["--scan_names", "S", "--gt_base_dir",
                          str(tmp_path / "gt"), "--output_base_dir",
                          str(tmp_path / "out")]) == 1


def test_compare_four_grads_tiny():
    """The per-render gradient comparison of the four-GPU phase, on four
    virtual CPU devices with the kernels interpreted."""
    import jax

    res = cs.compare_four_grads(jax.devices()[:4], "interpret", scale=0.25,
                                views=1, n_gauss=2000)
    assert set(res) == {"tiles", "views_tiles", "gauss"}
    assert all(len(r) == 1 + len(cs.GRAD_NAMES) for r in res.values())
    cs.check_four_grads(res)


@pytest.mark.parametrize("key,value,why", [
    ("grad_l2rel_means", 1e-6, None),
    ("grad_l2rel_means", 3.0, "tiles grad_l2rel_means"),  # a 4x psum
    ("grad_l2rel_absgrad", float("nan"), "grad_l2rel_absgrad"),
    ("loss_maxabs", 2e-4, "loss_maxabs"),
], ids=["ok", "scaled_grad", "nan_absgrad", "loss"])
def test_check_four_grads(key, value, why):
    res = {"tiles": {"loss_maxabs": 0.0, "grad_l2rel_means": 0.0,
                     "grad_l2rel_absgrad": 0.0}}
    res["tiles"][key] = value
    if why is None:
        cs.check_four_grads(res)
    else:
        with pytest.raises(AssertionError, match=why):
            cs.check_four_grads(res)


LOG = ("epoch 0: loss=0.03000 alive=100 max_tile=5 ovf=0/8 trunc=0 "
       "pairs=10/64 px/s=1.0M t=1.500s\n"
       "epoch 1: loss=0.02900 alive=100 max_tile=5 ovf=0/8 trunc=0 "
       "pairs=12/64 px/s=1.0M t=2.000s\n"
       "epoch 2: loss=0.03100 alive=180 max_tile=7 ovf=0/8 trunc=0 "
       "pairs=20/64 px/s=1.0M t=2.400s\n"
       "epoch 3: loss=0.03050 alive=180 max_tile=7 ovf=0/8 trunc=0 "
       "px/s=1.0M t=2.900s\n")


def test_parse_epochs():
    rows = cs.parse_epochs(LOG)
    assert [r[0] for r in rows] == [0, 1, 2, 3]
    assert rows[0] == (0, 0.03, 100, 10, 64, 1.5)
    assert rows[3][3] is None and rows[3][4] is None
    first, steady = cs.epoch_seconds(rows)
    assert first == 1.5 and steady == pytest.approx(0.5)


@pytest.mark.parametrize("text,why", [
    (LOG, None),
    (LOG.replace("loss=0.02900", "loss=0.03500"), "did not fall"),
    (LOG.replace("loss=0.03050", "loss=nan"), "non-finite"),
    (LOG.replace("alive=180", "alive=100"), "did not grow"),
    (LOG.replace("pairs=20/64", "pairs=70/64"), "pair overflow"),
    ("", "no epoch lines"),
], ids=["ok", "loss_rises", "nan", "no_growth", "overflow", "empty"])
def test_check_training(text, why):
    rows = cs.parse_epochs(text)
    if why is None:
        cs.check_training(rows, text, dup_epoch=1)
    else:
        with pytest.raises(AssertionError, match=why):
            cs.check_training(rows, text, dup_epoch=1)


def _res(**kw):
    base = {"img_maxabs": 1e-6, "img_maxabs_unflipped": 1e-6,
            "flip_pixels": 0, "flip_maxabs": 0.0, "pixels": 1_000_000,
            "grad_l2rel_means": 1e-5, "grad_l2rel_absgrad": 1e-5}
    base.update(kw)
    return base


@pytest.mark.parametrize("res,why", [
    (_res(), None),
    (_res(flip_pixels=1, flip_maxabs=0.0038, img_maxabs=0.0038), None),
    (_res(img_maxabs_unflipped=5e-5), "image max-abs"),
    (_res(flip_pixels=50, flip_maxabs=0.003), "cutoff pixels"),
    (_res(flip_pixels=1, flip_maxabs=0.02), "more than one alpha cutoff"),
    (_res(grad_l2rel_means=2e-4), "grad_l2rel_means"),
    (_res(grad_l2rel_absgrad=float("nan")), "grad_l2rel_absgrad"),
], ids=["ok", "one_cutoff_pixel", "image", "many_flips", "big_flip",
        "grad", "nan_grad"])
def test_check_agreement(res, why):
    if why is None:
        cs.check_agreement(res, "x")
    else:
        with pytest.raises(AssertionError, match=why):
            cs.check_agreement(res, "x")


def test_flipped_pixels_leave_the_gradient_comparison(monkeypatch):
    """A pixel that differs by one alpha cutoff is counted, and gets loss
    weight 0 for both renders in the second (gradient) pass."""
    h = w = 4
    img = np.full((h, w), 0.5, np.float32)
    grads = [np.ones((3, 2), np.float32)] * 5
    weights_seen = []

    def fake_run(step, scene, target, weights):
        weights_seen.append(np.asarray(weights).copy())
        out = img.copy()
        if step == "test" and len(weights_seen) == 1:
            out[1, 2] += 0.003                     # one cutoff pixel
        return [(out, grads)]

    monkeypatch.setattr(cs, "make_step", lambda w_, h_, kw: kw["name"])
    monkeypatch.setattr(cs, "_run_views", fake_run)
    scene = (None,) * 4 + (np.zeros((1, 4, 4)), None)
    res = cs.compare_to_oracle(scene, w, h, {"name": "test"},
                               {"name": "oracle"})
    assert res["flip_pixels"] == 1
    assert res["flip_maxabs"] == pytest.approx(0.003, rel=1e-3)
    assert res["img_maxabs_unflipped"] == 0.0
    assert len(weights_seen) == 4                  # two passes, two renders
    for wts in weights_seen[2:]:
        assert wts[0, 1, 2] == 0.0 and wts.sum() == h * w - 1
    cs.check_agreement(res, "x")
