"""Smoke test of the main path on an NVIDIA GPU.

    python chip_smoke.py [--four] [--out DIR]

Runs, in one process and through the normal entry points:

1. device — refuses to run unless JAX's first device is a GPU, and prints
   the card's name and power limit (``nvidia-smi``);
2. render — the trained ABC fixture (bench_fixture/abc_00004926.npz:
   12,740 Gaussians, 5 cameras, 800x800) at the shipped ABC geometry, jitted
   forward + backward on the compiled GPU compositor, compared on the card
   with the XLA single-level oracle (``composite.tile_render``) and once
   with the per-pixel reference (``ops/rasterize_ref.py``);
3. train — a seeded ABC-shaped scan (50 views, 800x800) through
   ``cli.make_synthetic``, ``cli.train`` (configs/ABC_DexiNed.json, 50
   epochs), ``cli.fit_edges`` (at least one edge) and ``cli.evaluate``
   (finite metrics against the scan's ground truth).

``--four`` runs only the four-GPU phase instead: per-render loss,
gradients and absgrad of the tile-, views x tiles- and Gaussian-sharded
proj-grad functions on the fixture against one GPU, then 2 epochs of the
same scan under ``--mesh_tiles 4``, ``--mesh_views 2 --mesh_tiles 2`` and
``--mesh_gauss 4``, each compared with a single-GPU run of the same step
mode. Any failed check exits non-zero; the last line of a passing run is
one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "bench_fixture", "abc_00004926.npz")
CONFIG = os.path.join(REPO, "configs", "ABC_DexiNed.json")
SCAN = "synth_abc"
ABC_GEOMETRY = dict(tile_size=16, capacity=768, max_tiles_per_gaussian=16)
PAIR_BUDGET = 49152

# Image: f32 with a different association of the transmittance products
# (per-chunk log-sum vs cumprod) moves a pixel by < 1e-6; 2e-5 leaves room
# for the f32 rounding of log-alpha's terms (up to ~4e-5 relative on the
# fixture, measured in f64). Gradients: XLA's scatter-add runs as atomics
# on the GPU, so the summation order of the pair -> Gaussian reduction
# varies from run to run.
IMG_ATOL = 2e-5
GRAD_RTOL = 1e-4
# gsplat's 1/255 alpha cutoff and 1e-4 transmittance stop are
# discontinuities: where a Gaussian's alpha lies within f32 rounding of the
# cutoff, two correct evaluations of the same sum include it or not, and
# the pixel moves by at most ALPHA_THRESHOLD (the included alpha times a
# transmittance <= 1). Such isolated pixels are counted, bounded, and left
# out of the gradient comparison (their loss weight is set to zero for
# both renders). On one H100 the fixture showed none or one such pixel,
# depending on the GEMM algorithm XLA's autotuner picked for the oracle.
MAX_FLIP_PIXELS = 2
# Training depth: the ABC recipe keeps opacities fixed until epoch 20 and
# scales and quaternions until epoch 30, and fit_edges drops Gaussians
# below opacity 0.2, so no edge is fitted before about epoch 34. Epoch 49
# is the last before the loss alternation starts (epoch 50).
TRAIN_EPOCHS = 50
# The generated scan's ground truth: 50 epochs fit it to ~5e-3 chamfer on
# one H100; 2e-2 fails a broken fit or evaluation, not a weaker one.
MAX_CHAMFER = 2e-2
# Loss, multi-GPU vs one GPU (epoch-0 training loss and per-render loss):
# band partials summed by psum reassociate f32 sums of ~1e-2.
LOSS_ATOL_FOUR = 1e-4


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    """``name, power.limit`` of every card, from nvidia-smi (a child
    process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().replace("\n", "; ")


# --- phase 1 ----------------------------------------------------------------

def phase_device(count: int = 1):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's first device is {devs[0]!r} "
                           f"(platform {devs[0].platform!r})")
    if len(devs) < count:
        raise RuntimeError(f"need {count} GPUs, JAX sees {len(devs)}")
    log(f"[device] card: {card_line()}")
    log(f"[device] jax {jax.__version__}: platform={devs[0].platform} "
        f"kind={devs[0].device_kind!r} count={len(devs)}")
    return devs


# --- phase 2 ----------------------------------------------------------------

def make_step(width, height, render_kwargs):
    """Jitted fwd+bwd: (loss, image) and grads of the four parameter groups
    plus the absgrad sink, for a weighted L1 loss against ``target``."""
    import jax
    import jax.numpy as jnp

    from edgegaussians_tpu.ops.rasterize import rasterize

    def loss(m, q, s, o, sink, vm, K, target, weight):
        out = rasterize(m, q, s, o, vm, K, width, height,
                        absgrad_sink=sink, **render_kwargs)
        err = jnp.abs(jnp.clip(out.image, 0.0, 1.0) - target)
        return jnp.sum(weight * err) / err.size, out.image

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                      has_aux=True))


def _run_views(step, scene, target, weights):
    import numpy as np
    means, quats, scales, opac, vms, Ks = scene
    sink = np.zeros((means.shape[0], 2), np.float32)
    outs = []
    for v in range(vms.shape[0]):
        (_, img), grads = step(means, quats, scales, opac, sink, vms[v],
                               Ks[v], target, weights[v])
        outs.append((np.asarray(img), [np.asarray(g) for g in grads]))
    return outs


def compare_to_oracle(scene, width, height, test_kwargs, oracle_kwargs,
                      seed=0):
    """Render every view with both configurations; return the image and
    gradient agreement (see IMG_ATOL / GRAD_RTOL / MAX_FLIP_PIXELS)."""
    import numpy as np

    nv = scene[4].shape[0]
    target = np.random.default_rng(seed).random(
        (height, width)).astype(np.float32)
    ones = np.ones((nv, height, width), np.float32)
    test = make_step(width, height, test_kwargs)
    oracle = make_step(width, height, oracle_kwargs)
    t_out = _run_views(test, scene, target, ones)
    o_out = _run_views(oracle, scene, target, ones)
    diffs = [np.abs(t[0] - o[0]) for t, o in zip(t_out, o_out)]
    flips = [d > IMG_ATOL for d in diffs]
    n_flip = int(sum(f.sum() for f in flips))
    res = {"img_maxabs": float(max(d.max() for d in diffs)),
           "img_maxabs_unflipped": float(max(
               np.where(f, 0.0, d).max() for d, f in zip(diffs, flips))),
           "flip_pixels": n_flip,
           "flip_maxabs": float(max(np.where(f, d, 0.0).max()
                                    for d, f in zip(diffs, flips))),
           "pixels": int(nv * height * width)}
    if n_flip:
        weights = np.stack([np.where(f, 0.0, 1.0) for f in flips]
                           ).astype(np.float32)
        t_out = _run_views(test, scene, target, weights)
        o_out = _run_views(oracle, scene, target, weights)
    names = ["means", "quats", "scales", "opacities", "absgrad"]
    for k, name in enumerate(names):
        num = np.sqrt(sum(np.sum((t[1][k] - o[1][k]) ** 2)
                          for t, o in zip(t_out, o_out)))
        den = np.sqrt(sum(np.sum(o[1][k] ** 2) for o in o_out))
        res[f"grad_l2rel_{name}"] = float(num / max(den, 1e-30))
    return res


def check_agreement(res, what):
    from edgegaussians_tpu.ops.projection import ALPHA_THRESHOLD
    bad = []
    if res["img_maxabs_unflipped"] > IMG_ATOL:
        bad.append(f"image max-abs {res['img_maxabs_unflipped']:.3g} > "
                   f"{IMG_ATOL}")
    if res["flip_pixels"] > MAX_FLIP_PIXELS:
        bad.append(f"{res['flip_pixels']} cutoff pixels")
    if res["flip_maxabs"] > ALPHA_THRESHOLD + IMG_ATOL:
        bad.append(f"a pixel moved {res['flip_maxabs']:.3g}, more than one "
                   "alpha cutoff")
    bad += [f"{k} {v:.3g} > {GRAD_RTOL}" for k, v in res.items()
            if k.startswith("grad_l2rel") and not v <= GRAD_RTOL]
    if bad:
        raise AssertionError(f"{what}: " + "; ".join(bad))


def load_fixture(path=FIXTURE, scale=1.0, views=None):
    """The fixture's Gaussians and cameras; ``scale`` shrinks the image
    (intrinsics and size), ``views`` keeps the first few cameras."""
    import jax.numpy as jnp
    import numpy as np
    d = np.load(path)
    sl = slice(None) if views is None else slice(0, views)
    Ks = d["Ks"][sl] * np.asarray([[scale], [scale], [1.0]], np.float32)
    scene = (jnp.asarray(d["means"]), jnp.asarray(d["quats"]),
             jnp.asarray(d["scales"]),
             jnp.asarray(d["opacities"]).reshape(-1),
             jnp.asarray(d["viewmats"][sl]), jnp.asarray(Ks))
    return scene, int(d["width"] * scale), int(d["height"] * scale)


def reference_check(scene, view, x0, y0, size, render_kwargs):
    """A ``size`` x ``size`` crop of one view (origin x0, y0; multiples of
    the tile size, so the crop's tiles are the full render's tiles),
    rendered by ``render_kwargs`` and by the O(N * pixels) per-pixel
    reference."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from edgegaussians_tpu.ops.rasterize import rasterize
    from edgegaussians_tpu.ops.rasterize_ref import rasterize_reference

    means, quats, scales, opac, vms, Ks = scene
    K = Ks[view].at[0, 2].add(-x0).at[1, 2].add(-y0)
    args = (means, quats, scales, opac, vms[view], K)
    out = jax.jit(lambda *a: rasterize(*a, size, size, **render_kwargs))(
        *args)
    ref = jax.jit(lambda *a: rasterize_reference(*a, size, size))(*args)
    img, ref = np.asarray(out.image), np.asarray(ref)
    d = np.abs(img - ref)
    over = d > IMG_ATOL + 1e-4 * np.abs(ref)
    return {"ref_crop": [x0, y0, size], "ref_max_tile": int(
                jnp.max(out.tile_counts)),
            "ref_maxabs": float(d.max()),
            "ref_maxabs_unflipped": float(np.where(over, 0.0, d).max()),
            "ref_flip_pixels": int(over.sum()),
            "ref_flip_maxabs": float(np.where(over, d, 0.0).max()),
            "pixels": size * size}


def check_reference(res, capacity):
    from edgegaussians_tpu.ops.projection import ALPHA_THRESHOLD
    bad = []
    if res["ref_max_tile"] > capacity:
        bad.append(f"crop tiles hold {res['ref_max_tile']} Gaussians, more "
                   f"than the capacity {capacity} the reference ignores")
    if res["ref_flip_pixels"] > MAX_FLIP_PIXELS:
        bad.append(f"{res['ref_flip_pixels']} cutoff pixels")
    if res["ref_flip_maxabs"] > ALPHA_THRESHOLD + IMG_ATOL:
        bad.append(f"a pixel moved {res['ref_flip_maxabs']:.3g}")
    if bad:
        raise AssertionError("render vs per-pixel reference: "
                             + "; ".join(bad))


def phase_render(backend="gpu", scale=1.0, views=None, ref_crop=128):
    import jax
    import numpy as np

    scene, width, height = load_fixture(FIXTURE, scale, views)
    test_kwargs = dict(ABC_GEOMETRY, pair_budget=PAIR_BUDGET,
                       pair_kernel="seg", backend=backend)
    oracle_kwargs = dict(ABC_GEOMETRY, backend="jax")
    step = make_step(width, height, test_kwargs)
    args = (scene[0], scene[1], scene[2], scene[3],
            np.zeros((scene[0].shape[0], 2), np.float32), scene[4][0],
            scene[5][0], np.zeros((height, width), np.float32),
            np.ones((height, width), np.float32))
    t0 = time.perf_counter()
    compiled = step.lower(*args).compile()
    log(f"[render] compiled fwd+bwd step in {time.perf_counter() - t0:.2f}"
        f" s; memory_analysis: {compiled.memory_analysis()}")
    res = compare_to_oracle(scene, width, height, test_kwargs, oracle_kwargs)
    log(f"[render] {scene[4].shape[0]} views {width}x{height}, "
        f"{scene[0].shape[0]} Gaussians, backend={backend} vs XLA oracle: "
        + json.dumps(res))
    check_agreement(res, "render vs oracle")
    ts = ABC_GEOMETRY["tile_size"]
    x0 = (width - ref_crop) // 2 // ts * ts
    y0 = (height - ref_crop) // 2 // ts * ts
    ref = reference_check(scene, 0, x0, y0, ref_crop, test_kwargs)
    log(f"[render] vs per-pixel reference: {json.dumps(ref)}")
    check_reference(ref, ABC_GEOMETRY["capacity"])
    jax.clear_caches()
    return res, ref


# --- phase 3 ----------------------------------------------------------------

class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_cli(main, argv):
    """Run a CLI ``main(argv)`` in-process; returns its printed output
    (also echoed). A non-zero return raises."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = main(argv)
    if rc not in (0, None):
        raise RuntimeError(f"{main.__module__} returned {rc}")
    return buf.getvalue()


def make_scan(out_dir, n_views=50, width=800, height=800):
    from edgegaussians_tpu.cli import make_synthetic
    base = os.path.join(out_dir, "scan")
    run_cli(make_synthetic.main, [
        "--base_dir", base, "--scan_names", SCAN, "--seed", "0",
        "--n_views", str(n_views), "--width", str(width),
        "--height", str(height)])
    return base


def _merge(cfg, overrides):
    for k, v in overrides.items():
        if isinstance(v, dict):
            _merge(cfg.setdefault(k, {}), v)
        else:
            cfg[k] = v


def write_train_config(out_dir, base, epochs=TRAIN_EPOCHS, dup_epoch=8,
                       name="train", overrides=None):
    """The ABC config with the smoke's changes; ``overrides`` is a nested
    dict merged into it last."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    run_dir = os.path.join(out_dir, name)
    cfg["data"]["base_dir"] = os.path.join(base, "data") + os.sep
    cfg["training"]["num_epochs"] = epochs
    cfg["model"]["dup_high_pos_grads_at_epoch"] = [dup_epoch]
    ol = cfg["training"]["loss"]["orientation_losses"]
    ol["start_dir_loss_at_epoch"] = 0
    ol["start_ratio_loss_at_epoch"] = 0
    cfg["output"].update(output_dir=run_dir + os.sep,
                         checkpoint_dir=os.path.join(run_dir, "ckpt"),
                         log_dir=os.path.join(run_dir, "logs"))
    _merge(cfg, overrides or {})
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
    return path, cfg


_EPOCH_RE = re.compile(
    r"epoch (\d+): loss=(\S+) alive=(\d+) .*?(?:pairs=(\d+)/(\d+) )?"
    r"px/s=\S+ t=([\d.]+)s")


def parse_epochs(text):
    """[(epoch, loss, alive, pairs, budget, t)] from the trainer's log."""
    rows = []
    for m in _EPOCH_RE.finditer(text):
        e, loss, alive, pairs, budget, t = m.groups()
        rows.append((int(e), float(loss), int(alive),
                     int(pairs) if pairs else None,
                     int(budget) if budget else None, float(t)))
    return rows


def check_training(rows, text, dup_epoch):
    import math
    bad = []
    if not rows:
        bad.append("no epoch lines")
    else:
        losses = {r[0]: r[1] for r in rows}
        # duplication adds Gaussians and raises the loss once; it must fall
        # before the event and again after it
        spans = [(0, dup_epoch), (dup_epoch + 1, rows[-1][0])]
        if not all(math.isfinite(v) for v in losses.values()):
            bad.append(f"non-finite loss {losses}")
        elif not all(losses[b] < losses[a] for a, b in spans
                     if a in losses and b in losses and b > a):
            bad.append(f"loss did not fall: {losses}")
        alive = {r[0]: r[2] for r in rows}
        if dup_epoch + 1 in alive and not alive[dup_epoch + 1] > \
                alive[dup_epoch]:
            bad.append(f"alive did not grow at epoch {dup_epoch}: {alive}")
        if any(r[3] is not None and r[3] > r[4] for r in rows) or \
                "exceed tile_pair_budget" in text:
            bad.append("pair overflow")
    if bad:
        raise AssertionError("train: " + "; ".join(bad))


def epoch_seconds(rows):
    """(first-epoch seconds incl. compilation, median later epoch)."""
    ts = [r[5] for r in rows]
    steps = sorted(b - a for a, b in zip(ts, ts[1:]))
    return ts[0], (steps[len(steps) // 2] if steps else float("nan"))


def fitted_edges(run_dir):
    """(curves, lines) that fit_edges wrote for the scan; none raises."""
    with open(os.path.join(run_dir, SCAN, "parametric_edges.json")) as f:
        edges = json.load(f)
    n = (len(edges["curves_ctl_pts"]), len(edges["lines_end_pts"]))
    if not sum(n):
        raise AssertionError("fit_edges: no curve or line was fitted")
    return n


def eval_metrics(metrics_dir, max_chamfer=MAX_CHAMFER):
    """The scan's chamfer metrics and mean F-scores that evaluate wrote
    (``--write_metrics``); missing or non-finite metrics, or a chamfer
    distance past ``max_chamfer``, raise."""
    import math
    import pickle

    with open(os.path.join(metrics_dir, "acc_comp_chamfer.pkl"), "rb") as f:
        per_scan = pickle.load(f)
    with open(os.path.join(metrics_dir, "pr.pkl"), "rb") as f:
        pr = pickle.load(f)
    if SCAN not in per_scan:
        raise AssertionError(f"evaluate: no metrics for {SCAN}")
    res = {k: float(v) for k, v in per_scan[SCAN]["edgegaussians"].items()}
    res.update({k: float(sum(v) / len(v)) for k, v in pr.items()
                if k.startswith("fscore") and v})
    if not all(math.isfinite(v) for v in res.values()):
        raise AssertionError(f"evaluate: non-finite metrics {res}")
    if not res["chamfer_dist"] <= max_chamfer:
        raise AssertionError(f"evaluate: chamfer {res['chamfer_dist']:.4g} "
                             f"> {max_chamfer}")
    return res


def phase_train(out_dir, backend="gpu", n_views=50, width=800, height=800,
                epochs=TRAIN_EPOCHS, dup_epoch=8, overrides=None,
                max_chamfer=MAX_CHAMFER):
    from edgegaussians_tpu.cli import evaluate, fit_edges, train

    base = make_scan(out_dir, n_views, width, height)
    cfg_path, cfg = write_train_config(out_dir, base, epochs, dup_epoch,
                                       overrides=overrides)
    text = run_cli(train.main, ["--config_file", cfg_path, "--scene_name",
                                SCAN, "--force_rerun", "--backend", backend])
    rows = parse_epochs(text)
    check_training(rows, text, dup_epoch)
    run_dir = os.path.join(cfg["output"]["output_dir"],
                           f"{cfg['output']['exp_name']}_"
                           f"{cfg['data']['edge_detection_method']}")
    ply = os.path.join(run_dir, SCAN, "gaussians_all.ply")
    if not os.path.exists(ply):
        raise AssertionError(f"train: {ply} was not written")
    log(f"[train] {len(rows)} epochs, loss {rows[0][1]:.7f} -> "
        f"{rows[-1][1]:.7f}, alive {rows[0][2]} -> {rows[-1][2]}")
    run_cli(fit_edges.main, ["--config_file", cfg_path,
                             "--scene_name", SCAN, "--seed", "0"])
    curves, lines = fitted_edges(run_dir)
    metrics_dir = os.path.join(out_dir, "metrics")
    run_cli(evaluate.main, [
        "--scan_names", SCAN, "--gt_base_dir",
        os.path.join(base, "groundtruth"), "--output_base_dir", run_dir,
        "--use_parametric_edges", "--write_metrics", "--write_metrics_dir",
        metrics_dir, "--version", "smoke"])
    metrics = eval_metrics(os.path.join(metrics_dir, "smoke", "DexiNed"),
                           max_chamfer)
    log(f"[train] fit_edges: {curves} curves and {lines} lines; evaluate "
        f"vs the scan's ground truth: {json.dumps(metrics)}")
    return rows


# --- phase 4 ----------------------------------------------------------------

FOUR_LAYOUTS = (["--mesh_tiles", "4"],
                ["--mesh_views", "2", "--mesh_tiles", "2"],
                ["--mesh_gauss", "4"])
GRAD_NAMES = ("means", "scales", "quats", "opacities", "absgrad")


def four_grad_fns(cfg, width, height, backend, devs):
    """The proj-grad functions of the multi-device layouts (trainer
    contract, ``trainer.make_proj_grad_fn``) and the single-device one."""
    import numpy as np
    from jax.sharding import Mesh

    from edgegaussians_tpu.parallel.mesh import make_mesh
    from edgegaussians_tpu.parallel.train_sharded import \
        make_sharded_proj_grad_fn
    from edgegaussians_tpu.parallel.train_tp import make_tp_proj_grad_fn
    from edgegaussians_tpu.train.trainer import make_proj_grad_fn

    d4 = np.array(devs[:4])
    return {
        "one": make_proj_grad_fn(cfg, width, height, backend),
        "tiles": make_sharded_proj_grad_fn(cfg, width, height, backend,
                                           Mesh(d4, ("tiles",))),
        # a ('views', 'tiles') mesh: bands over 'tiles', 'views' replicates
        "views_tiles": make_sharded_proj_grad_fn(
            cfg, width, height, backend, make_mesh(2, 2, devs[:4])),
        "gauss": make_tp_proj_grad_fn(cfg, width, height, backend,
                                      Mesh(d4, ("gauss",))),
    }


def compare_four_grads(devs, backend="gpu", scale=1.0, views=None,
                       n_gauss=None):
    """Per-render loss, parameter gradients and absgrad (the sink's
    cotangent) of every multi-device layout against one device, on the
    fixture at the ABC config, for the 'whole' and 'bg_edge_ratio' losses
    of every view. A gradient scaled by the device count, or reduced
    twice, shows here (Adam's update and the normalised absgrad would hide
    it from the loss)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from edgegaussians_tpu.config import load_config
    from edgegaussians_tpu.models.gaussians import GaussianParams

    cfg = load_config(CONFIG)
    (means, quats, scales, opac, vms, Ks), width, height = load_fixture(
        FIXTURE, scale, views)
    n = means.shape[0] if n_gauss is None else n_gauss
    params = GaussianParams(
        means=means[:n], scales=jnp.log(scales[:n]), quats=quats[:n],
        opacities=jnp.log(opac[:n] / (1.0 - opac[:n]))[:, None])
    alive = jnp.ones((n,), bool)
    target = jnp.asarray(np.random.default_rng(0).random((height, width)),
                         jnp.float32)
    edge = target >= cfg.model.edge_detection_threshold
    key = jax.random.PRNGKey(0)
    outs = {}
    for name, fn in four_grad_fns(cfg, width, height, backend,
                                  devs).items():
        f = jax.jit(fn)
        outs[name] = []
        for v in range(vms.shape[0]):
            for strategy in (0, 1):          # whole, bg_edge_ratio
                loss, _, g, gsink = f(params, alive, vms[v], Ks[v], target,
                                      edge, jnp.int32(strategy),
                                      jnp.float32(1.0), key)
                outs[name].append((float(loss), [np.asarray(x) for x in g]
                                   + [np.asarray(gsink)]))
    res = {}
    ref = outs.pop("one")
    for name, rows in outs.items():
        r = {"loss_maxabs": max(abs(a[0] - b[0]) for a, b in zip(rows, ref))}
        for k, gname in enumerate(GRAD_NAMES):
            num = np.sqrt(sum(np.sum((a[1][k] - b[1][k]) ** 2)
                              for a, b in zip(rows, ref)))
            den = np.sqrt(sum(np.sum(b[1][k] ** 2) for b in ref))
            r[f"grad_l2rel_{gname}"] = float(num / max(den, 1e-30))
        res[name] = r
    return res


def check_four_grads(res):
    bad = [f"{name} {k} {v:.3g}" for name, r in res.items()
           for k, v in r.items()
           if not v <= (LOSS_ATOL_FOUR if k == "loss_maxabs"
                        else GRAD_RTOL)]
    if bad:
        raise AssertionError("four: multi-device gradients differ from one "
                             "device: " + "; ".join(bad))


def phase_four(out_dir, backend="gpu", n_views=50, width=800, height=800,
               epochs=2, grad_scale=1.0, grad_views=None, grad_n_gauss=None):
    import jax

    from edgegaussians_tpu.cli import train

    res = compare_four_grads(jax.devices(), backend, grad_scale, grad_views,
                             grad_n_gauss)
    for name, r in res.items():
        log(f"[four] {name} vs one device, per-render grads: "
            + json.dumps(r))
    check_four_grads(res)
    jax.clear_caches()
    base = make_scan(out_dir, n_views, width, height)
    losses = {}
    for name, mesh_args, step_mode in (
            [("one_per_view", [], "per_view"),
             ("one_view_batch", [], "view_batch")]
            + [("_".join(a[::2]).replace("--mesh_", ""), a, None)
               for a in FOUR_LAYOUTS]):
        cfg_path, _ = write_train_config(
            out_dir, base, epochs, epochs, name=name,
            overrides={"training": {"step_mode": step_mode}}
            if step_mode else None)
        text = run_cli(train.main, ["--config_file", cfg_path,
                                    "--scene_name", SCAN, "--force_rerun",
                                    "--backend", backend] + mesh_args)
        rows = parse_epochs(text)
        if not rows:
            raise AssertionError(f"four: {name} logged no epochs")
        losses[name] = rows[0][1]
    refs = {"views_tiles": "one_view_batch"}
    worst = 0.0
    for name, loss in losses.items():
        if name.startswith("one_"):
            continue
        ref = losses[refs.get(name, "one_per_view")]
        worst = max(worst, abs(loss - ref))
        log(f"[four] {name}: epoch-0 loss {loss:.7f} vs one device "
            f"{ref:.7f} (|diff| {abs(loss - ref):.2e})")
    if not worst <= LOSS_ATOL_FOUR:
        raise AssertionError(f"four: epoch-0 losses differ by {worst:.3g}")
    return res, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phase")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "chip_smoke"))
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    from edgegaussians_tpu.utils.cache import enable_compilation_cache

    devs = phase_device(4 if args.four else 1)
    log(f"[device] compile cache: {enable_compilation_cache()}")
    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    if args.four:
        phase_four(os.path.join(args.out, "four"))
    else:
        phase_render()
        rows = phase_train(os.path.join(args.out, "train"))
        first, steady = epoch_seconds(rows)
        log(f"[train] epoch 0 with compilation {first:.3f} s, steady epoch "
            f"{steady:.3f} s on {card_line()} (information only)")
    log(f"[done] {time.time() - t0:.1f} s; card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
