"""Parity tests for the segmented pair compositor (ops/segpair.py,
pair_kernel="seg").

The seg path must reproduce the dense single-level XLA oracle (same
compositing semantics): forward image, all four packed-row gradient
groups, and the absgrad sink cotangent. Exercised here: runs longer than
one CHUNK (the carried transmittance), chunk-boundary and empty runs,
budgets that are not a multiple of CHUNK, budget overflow, empty scenes,
and the algebraic backward rule against autodiff. The kernels run on the
Pallas interpreter here; chip_smoke.py's render phase checks the compiled
kernels on the GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from edgegaussians_tpu.ops.rasterize import rasterize


def _scene(n=300, width=64, height=48, seed=0):
    r = np.random.default_rng(seed)
    means = r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    means[:, 2] += 2.0
    quats = r.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(r.uniform(np.log(0.01), np.log(0.06), (n, 3))) \
        .astype(np.float32)
    opac = r.uniform(0.2, 0.9, n).astype(np.float32)
    f = 55.0
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                 np.float32)
    vm = np.eye(4, dtype=np.float32)
    return tuple(jnp.asarray(a) for a in
                 (means, quats, scales, opac, vm, K)) + (width, height)


def _cluster_scene(n=400, width=48, height=32, seed=2):
    """Most Gaussians piled on one tile -> runs spanning many bricks."""
    r = np.random.default_rng(seed)
    means = r.normal(0, 0.02, (n, 3)).astype(np.float32)  # one hot spot
    means[:, 2] += 2.0 + r.uniform(0, 1, n).astype(np.float32)
    quats = r.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(r.uniform(np.log(0.01), np.log(0.04), (n, 3))) \
        .astype(np.float32)
    opac = r.uniform(0.05, 0.4, n).astype(np.float32)
    f = 40.0
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                 np.float32)
    vm = np.eye(4, dtype=np.float32)
    return tuple(jnp.asarray(a) for a in
                 (means, quats, scales, opac, vm, K)) + (width, height)


def _loss_fn(vm, K, width, height, kwargs):
    def f(m, q, s, o, sink):
        out = rasterize(m, q, s, o, vm, K, width, height,
                        tile_size=16, absgrad_sink=sink, **kwargs)
        img = jnp.clip(out.image, 0, 1)
        w = (jnp.arange(img.size, dtype=jnp.float32)
             .reshape(img.shape) % 7) / 7.0 + 0.3
        return jnp.sum(img * w), out
    return f


def _compare(scene, budget=8192, cap=256, atol_img=2e-5, atol_g=3e-4,
             rtol_g=2e-3):
    *args, width, height = scene
    means, quats, scales, opac, vm, K = args
    sink0 = jnp.zeros((means.shape[0], 2), jnp.float32)
    dense = _loss_fn(vm, K, width, height,
                     dict(capacity=cap, backend="jax"))
    seg = _loss_fn(vm, K, width, height,
                   dict(capacity=cap, dense_capacity=32, overflow_tiles=8,
                        pair_budget=budget, pair_kernel="seg",
                        backend="interpret"))
    (l1, out1), g1 = jax.value_and_grad(dense, argnums=(0, 1, 2, 3, 4),
                                        has_aux=True)(
        means, quats, scales, opac, sink0)
    (l2, out2), g2 = jax.value_and_grad(seg, argnums=(0, 1, 2, 3, 4),
                                        has_aux=True)(
        means, quats, scales, opac, sink0)
    assert int(out2.num_pairs) > 0
    assert int(out2.num_pairs) <= budget, "budget must cover the scene"
    np.testing.assert_allclose(np.asarray(out2.image),
                               np.asarray(out1.image), atol=atol_img)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    names = ["means", "quats", "scales", "opacities", "absgrad"]
    for a, b, name in zip(g1, g2, names):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=atol_g, rtol=rtol_g,
                                   err_msg=f"segpair grads {name}")


def test_segpair_matches_dense_forward_and_grads():
    _compare(_scene())


def test_segpair_long_runs_cross_brick_carries():
    # runs of several hundred pairs on one tile: the transmittance /
    # contribution-prefix carries cross many brick boundaries
    _compare(_cluster_scene(), budget=16384, cap=512)


def test_segpair_non_brick_multiple_budget():
    _compare(_scene(seed=5), budget=4100)


def test_segpair_respects_capacity_truncation():
    *args, width, height = _scene(n=400, seed=3)
    means, quats, scales, opac, vm, K = args

    def render(kwargs):
        return rasterize(means, quats, scales, opac, vm, K, width,
                         height, tile_size=16, **kwargs)

    dense = render(dict(capacity=8, backend="jax"))
    seg = render(dict(capacity=8, dense_capacity=4, overflow_tiles=4,
                      pair_budget=8192, pair_kernel="seg",
                      backend="interpret"))
    np.testing.assert_allclose(np.asarray(seg.image),
                               np.asarray(dense.image), atol=2e-5)


def test_segpair_matches_v4_pair_kernel():
    """Seg kernel vs the dense single-level XLA oracle at the settings the
    removed block-window kernel was checked at."""
    *args, width, height = _scene(n=350, seed=9)
    means, quats, scales, opac, vm, K = args
    sink0 = jnp.zeros((means.shape[0], 2), jnp.float32)
    dense = _loss_fn(vm, K, width, height, dict(capacity=256, backend="jax"))
    seg = _loss_fn(vm, K, width, height,
                   dict(capacity=256, dense_capacity=32, overflow_tiles=8,
                        pair_budget=8192, pair_kernel="seg",
                        backend="interpret"))
    (l1, _), g1 = jax.value_and_grad(dense, argnums=(0, 1, 2, 3, 4),
                                     has_aux=True)(
        means, quats, scales, opac, sink0)
    (l2, _), g2 = jax.value_and_grad(seg, argnums=(0, 1, 2, 3, 4),
                                     has_aux=True)(
        means, quats, scales, opac, sink0)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=3e-4, rtol=2e-3)


def _overflow_scene(width=64, height=64, sparse_per_tile=10, pile=120,
                    seed=11):
    """15 low-id tiles with ``sparse_per_tile`` Gaussians each plus a
    high-occupancy pile on the LARGEST tile id (bottom-right): its sort-1
    run starts last, so a small pair budget zeroes its kept count while
    its raw occupancy is the maximum — the exact overflow shape that broke
    the raw-count frame ordering (ADVICE r4 high)."""
    r = np.random.default_rng(seed)
    pts = []
    for ty in range(4):
        for tx in range(4):
            if (ty, tx) == (3, 3):
                continue
            pts.append(np.stack([
                tx * 16 + r.uniform(4, 12, sparse_per_tile),
                ty * 16 + r.uniform(4, 12, sparse_per_tile)], axis=1))
    pts.append(np.stack([r.uniform(52, 60, pile),
                         r.uniform(52, 60, pile)], axis=1))
    px = np.concatenate(pts).astype(np.float32)
    n = px.shape[0]
    f, z = 64.0, 2.0
    means = np.concatenate(
        [(px - 32.0) * (z / f), np.full((n, 1), z, np.float32)],
        axis=1).astype(np.float32)
    quats = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (n, 1))
    scales = np.full((n, 3), 0.015, np.float32)
    opac = np.full((n,), 0.5, np.float32)
    K = np.array([[f, 0, 32], [0, f, 32], [0, 0, 1]], np.float32)
    vm = np.eye(4, dtype=np.float32)
    return tuple(jnp.asarray(a) for a in
                 (means, quats, scales, opac, vm, K)) + (width, height)


def test_segpair_budget_overflow_matches_v4():
    # budget < num_pairs (pairs past it are dropped, trainer-audited): seg
    # must stay FINITE and reproduce the dense XLA frame path with the same
    # sort-prefix budget (two-level pair-prefix tables: at this scene every
    # kept tile run is below the dense capacity, so both keep exactly the
    # same pairs). Regression for the NaN a raw-count frame ordering
    # produced on mid-stream zero-kept rows.
    *args, width, height = _overflow_scene()
    means, quats, scales, opac, vm, K = args
    sink0 = jnp.zeros((means.shape[0], 2), jnp.float32)
    budget = 64
    common = dict(capacity=256, dense_capacity=32, overflow_tiles=8,
                  pair_budget=budget)
    dense = _loss_fn(vm, K, width, height,
                     dict(common, pair_kernel=False, backend="jax"))
    seg = _loss_fn(vm, K, width, height,
                   dict(common, pair_kernel="seg", backend="interpret"))
    (l1, out1), g1 = jax.value_and_grad(dense, argnums=(0, 1, 2, 3, 4),
                                        has_aux=True)(
        means, quats, scales, opac, sink0)
    (l2, out2), g2 = jax.value_and_grad(seg, argnums=(0, 1, 2, 3, 4),
                                        has_aux=True)(
        means, quats, scales, opac, sink0)
    assert int(out2.num_pairs) > budget, "scene must overflow the budget"
    assert np.isfinite(np.asarray(out2.image)).all()
    np.testing.assert_allclose(np.asarray(out2.image),
                               np.asarray(out1.image), atol=2e-5)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    for a, b in zip(g1, g2):
        assert np.isfinite(np.asarray(b)).all()
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=3e-4, rtol=2e-3)


def test_seg_tables_zero_kept_rows_are_last():
    # table-level invariant the kernel depends on: counts_f (kept run
    # lengths in frame order) must be nonincreasing-to-zero — no zero-kept
    # row may precede a nonzero one, for ANY budget
    from edgegaussians_tpu.ops.projection import project_gaussians
    from edgegaussians_tpu.ops.tiles import bin_pairs_frame_order
    *args, width, height = _overflow_scene(seed=3)
    means, quats, scales, opac, vm, K = args
    proj = project_gaussians(means, quats, scales, opac, vm, K,
                             width, height)
    for budget in (16, 64, 256, 4096):
        pbins = bin_pairs_frame_order(proj, width, height, 16, 256,
                                      budget)
        cf = np.asarray(pbins.counts_f)
        nz = cf > 0
        first_zero = int(np.argmin(nz)) if not nz.all() else len(cf)
        assert not nz[first_zero:].any(), \
            (budget, cf.tolist())
        assert int(nz.sum()) == int((cf > 0).sum())


def test_segpair_empty_scene():
    n, width, height = 32, 64, 48
    means = jnp.full((n, 3), 100.0)          # far outside every frustum
    quats = jnp.tile(jnp.asarray([1.0, 0, 0, 0]), (n, 1))
    scales = jnp.full((n, 3), 0.01)
    opac = jnp.full((n,), 0.5)
    f = 55.0
    K = jnp.asarray([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                    jnp.float32)
    vm = jnp.eye(4, dtype=jnp.float32)
    out = rasterize(means, quats, scales, opac, vm, K, width, height,
                    tile_size=16, capacity=64, dense_capacity=16,
                    overflow_tiles=4, pair_budget=1024,
                    pair_kernel="seg", backend="interpret")
    np.testing.assert_allclose(np.asarray(out.image), 0.0)


def _run_features(counts, seed, opacity):
    """Random pair features for tiles with the given run lengths, laid out
    both as the seg kernel's pair stream and as the oracle's dense frame."""
    from edgegaussians_tpu.ops.tiles import build_tile_features
    r = np.random.default_rng(seed)
    counts = np.asarray(counts, np.int32)
    T, K = len(counts), max(int(counts.max()), 1)
    rows = np.zeros((T, K, 8), np.float32)
    a = r.uniform(0.02, 0.3, (T, K))
    c = r.uniform(0.02, 0.3, (T, K))
    b = r.uniform(-0.5, 0.5, (T, K)) * np.sqrt(a * c)
    rows[..., 0], rows[..., 1], rows[..., 2] = a, b, c
    rows[..., 3:5] = r.uniform(-4, 20, (T, K, 2))
    rows[..., 5] = np.log(r.uniform(*opacity, (T, K)))
    rows[..., 6] = 1.0
    validf = (np.arange(K)[None, :] < counts[:, None]).astype(np.float32)
    origins = np.zeros((T, 2), np.float32)
    frame = build_tile_features(jnp.asarray(rows), jnp.asarray(origins),
                                jnp.asarray(validf))
    stream = np.concatenate([np.asarray(frame[t, :n]) for t, n in
                             enumerate(counts)] + [np.zeros((0, 8))])
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    return frame, jnp.asarray(stream, jnp.float32), jnp.asarray(starts), \
        jnp.asarray(counts)


RUN_LENGTHS = {
    "empty_and_single": [0, 1, 0, 2],
    "chunk_edges": [15, 16, 17, 31, 32, 33],
    "long": [200, 3, 77],
}


@pytest.mark.parametrize("lengths", list(RUN_LENGTHS.values()),
                         ids=list(RUN_LENGTHS))
@pytest.mark.parametrize("opacity", [(0.02, 0.15), (0.5, 0.99)],
                         ids=["translucent", "saturating"])
def test_kernel_matches_oracle_per_run(lengths, opacity):
    """Forward image and the backward kernel's per-pair gradient rows
    (the algebraic rule) against autodiff of the XLA segment compositor,
    tile by tile, for runs shorter than, equal to and longer than a
    CHUNK, empty runs, and runs that saturate (early stop)."""
    from edgegaussians_tpu.ops import composite, segpair
    from edgegaussians_tpu.ops.tiles import pixel_basis
    frame, stream, starts, counts = _run_features(lengths, 7, opacity)
    basis = pixel_basis(16)
    T, P = frame.shape[0], basis.shape[1]
    ones = jnp.ones((T, P), jnp.float32)
    img_ref, vjp = jax.vjp(
        lambda f: composite._composite_jax_seg(f, basis, ones)[0], frame)
    feats_t = segpair._feature_major(stream)
    img = segpair._seg_fwd(starts, counts, feats_t, basis, True)
    np.testing.assert_allclose(np.asarray(img), np.asarray(img_ref),
                               atol=2e-5)

    g = jnp.asarray(np.random.default_rng(1).normal(size=(T, P)),
                    jnp.float32)
    (dframe,) = vjp(g)
    d6 = segpair._seg_bwd(starts, counts, feats_t, basis, g * (1.0 - img),
                          True)
    # per-tile l2-relative: the 1e-4 transmittance stop is a discontinuity,
    # and a pair whose transmittance lies within f32 rounding of it (the
    # kernel scans log(1 - alpha), the oracle multiplies) is kept by one
    # evaluation only; its gradient row is O(1e-4) of the run's
    for t, n in enumerate(lengths):
        got = np.asarray(d6[:, int(starts[t]):int(starts[t]) + n]).T
        want = np.asarray(dframe[t, :n, :6])
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
        assert err < 2e-3, f"tile {t} (run length {n}): l2rel {err:.2e}"


@pytest.mark.parametrize("n,opacity", [(8, 0.3), (40, 0.5), (300, 0.95)])
def test_algebraic_rule_matches_autodiff(n, opacity):
    """dL/dalpha_l = g (1 - total) / (1 - alpha_l) on kept pairs (and 0
    past the transmittance stop) equals autodiff of the front-to-back sum
    with the keep mask held fixed."""
    from edgegaussians_tpu.ops.projection import TRANSMITTANCE_EPS
    r = np.random.default_rng(n)
    alpha = jnp.asarray(r.uniform(0.0, opacity, n), jnp.float32)

    def image(a, keep):
        t_inc = jnp.cumprod(1.0 - a)
        return jnp.sum(a * (t_inc / (1.0 - a)) * keep)

    keep = jnp.cumprod(1.0 - alpha) >= TRANSMITTANCE_EPS
    total, grad = jax.value_and_grad(image)(alpha, keep)
    rule = jnp.where(keep, (1.0 - total) / (1.0 - alpha), 0.0)
    np.testing.assert_allclose(np.asarray(rule), np.asarray(grad),
                               rtol=1e-4, atol=1e-6)
