"""Rasterizer correctness: tile pipeline vs. per-pixel oracle, gradients.

The oracle (rasterize_ref) implements gsplat compositing semantics exactly
(call contract: edge_gs.py:250-268); the tile rasterizer must agree to
float tolerance whenever no tile overflows its capacity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from edgegaussians_tpu.ops.rasterize import rasterize
from edgegaussians_tpu.ops.rasterize_ref import rasterize_reference
from edgegaussians_tpu.ops.projection import project_gaussians


def _render_args(scene):
    means, quats, scales, opac, viewmat, K = scene
    return (jnp.array(means), jnp.array(quats), jnp.array(scales),
            jnp.array(opac), jnp.array(viewmat), jnp.array(K))


def test_projection_basic(test_scene):
    means, quats, scales, opac, viewmat, K = _render_args(test_scene)
    proj = project_gaussians(means, quats, scales, opac, viewmat, K, 64, 48)
    assert bool(jnp.all(proj.depths > 0))
    assert int(jnp.sum(proj.valid)) > 0
    # centered cloud should project near the principal point
    assert 0 < float(jnp.median(proj.means2d[:, 0])) < 64


def test_tile_matches_oracle(test_scene):
    args = _render_args(test_scene)
    W, H = 64, 48
    ref = rasterize_reference(*args, W, H)
    out = rasterize(*args, W, H, tile_size=16, capacity=64, backend="jax")
    np.testing.assert_allclose(np.array(out.image), np.array(ref),
                               atol=2e-5, rtol=1e-4)
    assert out.image.shape == (H, W)


def test_tile_size_invariance(test_scene):
    """Different tile sizes must produce the same image."""
    args = _render_args(test_scene)
    W, H = 64, 48
    img8 = rasterize(*args, W, H, tile_size=8, capacity=64).image
    img16 = rasterize(*args, W, H, tile_size=16, capacity=64).image
    np.testing.assert_allclose(np.array(img8), np.array(img16),
                               atol=2e-5, rtol=1e-4)


def test_nondivisible_image_size(test_scene):
    """Padding tiles on ragged edges must not corrupt the image."""
    args = _render_args(test_scene)
    ref = rasterize_reference(*args, 60, 44)
    out = rasterize(*args, 60, 44, tile_size=16, capacity=64).image
    np.testing.assert_allclose(np.array(out), np.array(ref),
                               atol=2e-5, rtol=1e-4)


def test_antialiased_compensation_changes_image(test_scene):
    args = _render_args(test_scene)
    img_aa = rasterize(*args, 64, 48, capacity=64, antialiased=True).image
    img_cl = rasterize(*args, 64, 48, capacity=64, antialiased=False).image
    assert not np.allclose(np.array(img_aa), np.array(img_cl))
    # antialiased compensation only shrinks opacity
    assert float(jnp.sum(img_aa)) <= float(jnp.sum(img_cl)) + 1e-4


def test_gradients_match_oracle(test_scene):
    """Parameter gradients of the tile path vs. the oracle path."""
    means, quats, scales, opac, viewmat, K = _render_args(test_scene)
    W, H = 64, 48
    target = jnp.zeros((H, W))

    def loss_tile(m, q, s, o):
        img = rasterize(m, q, s, o, viewmat, K, W, H, capacity=64).image
        return jnp.mean(jnp.abs(img - target))

    def loss_ref(m, q, s, o):
        img = rasterize_reference(m, q, s, o, viewmat, K, W, H)
        return jnp.mean(jnp.abs(img - target))

    g_tile = jax.grad(loss_tile, argnums=(0, 1, 2, 3))(
        means, quats, scales, opac)
    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2, 3))(
        means, quats, scales, opac)
    for gt, gr, name in zip(g_tile, g_ref,
                            ["means", "quats", "scales", "opac"]):
        np.testing.assert_allclose(
            np.array(gt), np.array(gr), atol=5e-5, rtol=5e-3,
            err_msg=f"gradient mismatch for {name}")


def test_absgrad_sink(test_scene):
    """The sink cotangent must deliver per-Gaussian |d means2d| sums."""
    means, quats, scales, opac, viewmat, K = _render_args(test_scene)
    W, H = 64, 48
    n = means.shape[0]
    sink = jnp.zeros((n, 2))

    def loss(m, sink):
        img = rasterize(m, quats, scales, opac, viewmat, K, W, H,
                        capacity=64, absgrad_sink=sink).image
        return jnp.mean(jnp.abs(img - 0.5))

    gm, gsink = jax.grad(loss, argnums=(0, 1))(means, sink)
    gsink = np.array(gsink)
    assert gsink.shape == (n, 2)
    assert np.all(gsink >= 0)           # it is a sum of absolute values
    assert gsink.max() > 0
    # absgrad upper-bounds the net gradient magnitude componentwise
    # (sum of abs >= abs of sum across tiles)
    # project net gradient to 2D is not directly comparable; check scale sanity
    assert np.isfinite(gsink).all()


def test_alive_mask(test_scene):
    """Dead capacity slots must not render."""
    means, quats, scales, opac, viewmat, K = _render_args(test_scene)
    n = means.shape[0]
    alive = jnp.arange(n) < (n // 2)
    img_half = rasterize(means, quats, scales, opac, viewmat, K, 64, 48,
                         capacity=64, alive=alive).image
    img_manual = rasterize(means[: n // 2], quats[: n // 2],
                           scales[: n // 2], opac[: n // 2],
                           viewmat, K, 64, 48, capacity=64).image
    np.testing.assert_allclose(np.array(img_half), np.array(img_manual),
                               atol=2e-5, rtol=1e-4)


def test_empty_scene():
    z = jnp.zeros
    out = rasterize(z((4, 3)), jnp.ones((4, 4)), jnp.full((4, 3), 0.01),
                    z((4,)), jnp.eye(4), jnp.eye(3) * 50, 32, 32,
                    capacity=8)
    np.testing.assert_allclose(np.array(out.image), 0.0)


def test_two_level_matches_single_level(test_scene):
    """Two-level capacity path must reproduce the single-level images and
    gradients (dense K1 + overflow budget covering every tile)."""
    means, quats, scales, opac, viewmat, K = map(jnp.array, test_scene)
    W, H = 64, 48
    kwargs = dict(tile_size=16, capacity=64, backend="jax")
    img_1l = rasterize(means, quats, scales, opac, viewmat, K, W, H,
                       **kwargs).image
    img_2l = rasterize(means, quats, scales, opac, viewmat, K, W, H,
                       dense_capacity=16, overflow_tiles=12, **kwargs).image
    np.testing.assert_allclose(np.array(img_2l), np.array(img_1l),
                               atol=2e-5, rtol=1e-4)

    def loss(two_level):
        def f(m, q, s, o):
            extra = (dict(dense_capacity=16, overflow_tiles=12)
                     if two_level else {})
            img = rasterize(m, q, s, o, viewmat, K, W, H, **kwargs,
                            **extra).image
            return jnp.mean(jnp.abs(img - 0.25))
        return f

    g1 = jax.grad(loss(False), argnums=(0, 1, 2, 3))(
        means, quats, scales, opac)
    g2 = jax.grad(loss(True), argnums=(0, 1, 2, 3))(
        means, quats, scales, opac)
    for a, b, name in zip(g2, g1, ["means", "quats", "scales", "opac"]):
        np.testing.assert_allclose(
            np.array(a), np.array(b), atol=5e-5, rtol=5e-3,
            err_msg=f"two-level gradient mismatch for {name}")


def test_two_level_truncates_beyond_budget(test_scene):
    """With a tiny overflow budget the busiest tiles lose tail Gaussians —
    images must still be finite and close below the single-level result."""
    means, quats, scales, opac, viewmat, K = map(jnp.array, test_scene)
    W, H = 64, 48
    img_full = rasterize(means, quats, scales, opac, viewmat, K, W, H,
                         tile_size=16, capacity=64, backend="jax").image
    img_tr = rasterize(means, quats, scales, opac, viewmat, K, W, H,
                       tile_size=16, capacity=64, dense_capacity=16,
                       overflow_tiles=1, backend="jax").image
    assert np.isfinite(np.array(img_tr)).all()
    # truncation can only remove light
    assert float(jnp.sum(img_tr)) <= float(jnp.sum(img_full)) + 1e-3


def test_two_level_absgrad(test_scene):
    means, quats, scales, opac, viewmat, K = map(jnp.array, test_scene)
    W, H = 64, 48
    n = means.shape[0]

    def loss(m, sink, two_level):
        extra = (dict(dense_capacity=16, overflow_tiles=12)
                 if two_level else {})
        img = rasterize(m, quats, scales, opac, viewmat, K, W, H,
                        capacity=64, backend="jax", absgrad_sink=sink,
                        **extra).image
        return jnp.mean(jnp.abs(img - 0.5))

    sink = jnp.zeros((n, 2))
    _, gs1 = jax.grad(lambda m, s: loss(m, s, False),
                      argnums=(0, 1))(means, sink)
    _, gs2 = jax.grad(lambda m, s: loss(m, s, True),
                      argnums=(0, 1))(means, sink)
    np.testing.assert_allclose(np.array(gs2), np.array(gs1),
                               atol=5e-5, rtol=5e-3)


def test_pair_prefix_matches_plain_two_level(test_scene):
    """The sorted-pair-prefix frame build + backward reduction must
    reproduce the plain two-level images exactly and gradients (incl. the
    absgrad sink) to reassociation tolerance."""
    means, quats, scales, opac, viewmat, K = map(jnp.array, test_scene)
    W, H = 64, 48
    n = means.shape[0]
    kwargs = dict(tile_size=16, capacity=64, dense_capacity=16,
                  overflow_tiles=4, backend="jax")

    def loss(pb):
        def f(m, q, s, o, sink):
            out = rasterize(m, q, s, o, viewmat, K, W, H,
                            pair_budget=pb, absgrad_sink=sink, **kwargs)
            return jnp.mean(jnp.abs(out.image - 0.25)), out
        return f

    sink = jnp.zeros((n, 2))
    (_, out0), g0 = jax.value_and_grad(
        loss(0), argnums=(0, 1, 2, 3, 4), has_aux=True)(
        means, quats, scales, opac, sink)
    (_, out1), g1 = jax.value_and_grad(
        loss(4096), argnums=(0, 1, 2, 3, 4), has_aux=True)(
        means, quats, scales, opac, sink)

    assert int(out1.num_pairs) == int(out0.num_pairs) > 0
    np.testing.assert_array_equal(np.array(out1.image), np.array(out0.image))
    for a, b, name in zip(g1, g0, ["means", "quats", "scales", "opac",
                                   "absgrad"]):
        np.testing.assert_allclose(
            np.array(a), np.array(b), atol=5e-6, rtol=1e-4,
            err_msg=f"pair-prefix gradient mismatch for {name}")


def test_pair_prefix_budget_exceeded_drops_tail(test_scene):
    """Pairs past the budget drop deterministically (like the overflow-tile
    budget): finite image with no more light, audited via num_pairs."""
    means, quats, scales, opac, viewmat, K = map(jnp.array, test_scene)
    W, H = 64, 48
    kwargs = dict(tile_size=16, capacity=64, dense_capacity=16,
                  overflow_tiles=4, backend="jax")
    full = rasterize(means, quats, scales, opac, viewmat, K, W, H,
                     pair_budget=4096, **kwargs)
    assert int(full.num_pairs) > 16

    small = rasterize(means, quats, scales, opac, viewmat, K, W, H,
                      pair_budget=16, **kwargs)
    assert int(small.num_pairs) == int(full.num_pairs)  # audit: true count
    img = np.array(small.image)
    assert np.isfinite(img).all()
    assert img.sum() <= np.array(full.image).sum() + 1e-3

    def loss(m):
        out = rasterize(m, quats, scales, opac, viewmat, K, W, H,
                        pair_budget=16, **kwargs)
        return jnp.mean(out.image)

    assert np.isfinite(np.array(jax.grad(loss)(means))).all()


def test_band_rendering_matches_full_rows():
    """Band mode (the tile-sharding unit) reproduces the corresponding
    rows of a full render bitwise, across all three render paths."""
    import jax.numpy as jnp
    from edgegaussians_tpu.ops.rasterize import rasterize

    r = np.random.default_rng(5)
    n, W, H = 128, 64, 80   # 5 tile rows
    means = r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    means[:, 2] += 2.0
    quats = r.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(r.uniform(np.log(0.01), np.log(0.05),
                              (n, 3))).astype(np.float32)
    opac = r.uniform(0.2, 0.9, n).astype(np.float32)
    f = 55.0
    K = jnp.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], jnp.float32)
    vm = jnp.eye(4, dtype=jnp.float32)
    args = (jnp.asarray(means), jnp.asarray(quats), jnp.asarray(scales),
            jnp.asarray(opac), vm, K, W, H)

    for kw in [dict(capacity=64),
               dict(capacity=64, dense_capacity=32, overflow_tiles=8),
               dict(capacity=64, dense_capacity=32, overflow_tiles=8,
                    pair_budget=2048)]:
        full = rasterize(*args, tile_size=16, backend="jax", **kw)
        bands = [np.array(rasterize(*args, tile_size=16, backend="jax",
                                    band_row0=jnp.int32(r0),
                                    band_tile_rows=1, **kw).image)
                 for r0 in range(5)]
        np.testing.assert_array_equal(np.concatenate(bands, axis=0),
                                      np.array(full.image))


def test_occupancy_sort_parity():
    """Occupancy-sorted frame rows produce identical images, parameter
    grads, and absgrad sinks (plain + pair-prefix two-level paths)."""
    import jax
    import jax.numpy as jnp
    from edgegaussians_tpu.ops.rasterize import rasterize

    r = np.random.default_rng(0)
    n, W, H = 256, 96, 80
    means = r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    means[:, 2] += 2.0
    quats = r.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(r.uniform(np.log(0.01), np.log(0.06),
                              (n, 3))).astype(np.float32)
    opac = r.uniform(0.2, 0.9, n).astype(np.float32)
    f = 80.0
    K = jnp.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], jnp.float32)
    vm = jnp.eye(4, dtype=jnp.float32)
    A = tuple(map(jnp.asarray, (means, quats, scales, opac)))
    tgt = jnp.asarray(r.random((H, W)), jnp.float32)

    for kw in [dict(capacity=128, dense_capacity=64, overflow_tiles=8),
               dict(capacity=128, dense_capacity=64, overflow_tiles=8,
                    pair_budget=4096)]:
        def run(occ):
            def f_(m, sink):
                out = rasterize(m, *A[1:], vm, K, W, H, tile_size=16,
                                backend="jax", occupancy_sort=occ,
                                absgrad_sink=sink, **kw)
                return (jnp.mean(jnp.abs(jnp.clip(out.image, 0, 1)
                                         - tgt)), out.image)
            (l, img), (gm, gs) = jax.value_and_grad(
                f_, argnums=(0, 1), has_aux=True)(
                A[0], jnp.zeros((n, 2)))
            return np.array(img), np.array(gm), np.array(gs)
        i0, g0, s0 = run(False)
        i1, g1, s1 = run(True)
        np.testing.assert_array_equal(i0, i1)
        np.testing.assert_allclose(g0, g1, atol=2e-9)
        np.testing.assert_allclose(s0, s1, atol=1e-10)


def test_tile_run_starts_matches_searchsorted():
    """The histogram-bracketed run-start search (tiles._tile_run_starts)
    must equal jnp.searchsorted on the tile-prefix boundaries for any
    sorted key distribution — empty tiles, runs >128, sentinel tails,
    lengths off the 128 stride."""
    import numpy as np
    from edgegaussians_tpu.ops import tiles as tiles_mod

    rng = np.random.default_rng(0)
    for T, nk in [(13, 40), (64, 1000), (257, 8192), (100, 130)]:
        tiles_ids = np.sort(rng.integers(0, T, size=nk))
        # heavy tail: pile half the keys on one tile; sprinkle sentinels
        tiles_ids[nk // 2:3 * nk // 4] = tiles_ids[nk // 2]
        ranks = rng.integers(0, 1 << 10, size=nk)
        keys = np.sort((tiles_ids.astype(np.int64) << tiles_mod.RANK_BITS)
                       | ranks).astype(np.int32)
        keys[-max(nk // 10, 1):] = 2 ** 31 - 1          # sentinel tail
        keys = np.sort(keys)
        pad8 = (-len(keys)) % 8
        keys = np.pad(keys, (0, pad8), constant_values=2 ** 31 - 1)
        boundaries = (np.arange(T + 1, dtype=np.int32)
                      << tiles_mod.RANK_BITS)
        want = np.searchsorted(keys, boundaries)
        got = np.asarray(tiles_mod._tile_run_starts(
            jnp.asarray(keys), T))
        np.testing.assert_array_equal(got, want, err_msg=f"T={T} nk={nk}")
