"""Per-tile front-to-back alpha compositing with a custom VJP (pure XLA).

The differentiable boundary of the dense-frame rasterizer paths: given
gathered per-tile Gaussian data, produce per-tile pixel intensities. These
chunked, rematerialized XLA compositors are CPU-testable and serve as the
parity oracle for the GPU pair compositor (ops/segpair.py).

The custom VJP additionally produces the *absgrad* signal driving
densification — the per-Gaussian sum over tiles of the absolute screen-space
position gradient (the reference reads gsplat's ``means2d.absgrad``:
edge_gs.py:607-613). It is exposed through a gradient *sink*: a zeros [N,2]
input whose cotangent the backward pass fills with the scatter-added
|d means2d| per tile — so ``jax.grad`` w.r.t. the sink yields absgrad with
no side channels.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from edgegaussians_tpu.ops.projection import (
    ALPHA_CLAMP, ALPHA_THRESHOLD, SIGMA_GUARD_EPS, TRANSMITTANCE_EPS)
from edgegaussians_tpu.ops.tiles import build_tile_features, scatter_rows


def _render_impl(gathered, slot_validf, origins, basis):
    """Single-level oracle: the product-space segment compositor with a
    fresh (all-ones) carried transmittance — one numerics for every
    level combination."""
    feats = build_tile_features(gathered, origins, slot_validf)
    ones = jnp.ones((feats.shape[0], basis.shape[1]), jnp.float32)
    img, _ = _composite_jax_seg(feats, basis, ones)
    return img


@jax.custom_vjp
def tile_render(gathered, slot_validf, origins, basis, ranks, order, sink):
    """Render all tiles: gathered per-tile Gaussians -> [T, P] intensities.

    Args:
      gathered:    [T,K,8] gathered packed rows (pack_gaussian_render_data,
                   depth-sorted frame; differentiable).
      slot_validf: [T,K]   float 0/1 bin-slot validity.
      origins:     [T,2]   tile origins (constant).
      basis:       [8,P]   tile-local pixel monomial basis (constant).
      ranks:       [T,K]   int32 depth ranks (for the absgrad scatter).
      order:       [N]     int32 rank -> Gaussian id permutation.
      sink:        [N,2]   zeros; its gradient receives the per-Gaussian
                   accumulated |d means2d| (absgrad).
    """
    return _render_impl(gathered, slot_validf, origins, basis)


def _tile_render_fwd(gathered, slot_validf, origins, basis, ranks, order,
                     sink):
    out = _render_impl(gathered, slot_validf, origins, basis)
    return out, (gathered, slot_validf, origins, basis, ranks, order,
                 sink.shape[0])


def _tile_render_bwd(res, g):
    gathered, slot_validf, origins, basis, ranks, order, n = res
    _, vjp_fn = jax.vjp(
        lambda ga: _render_impl(ga, slot_validf, origins, basis), gathered)
    (dgathered,) = vjp_fn(g)

    # absgrad: per-Gaussian sum over tiles of |d means2d| (gsplat absgrad
    # semantics; consumed by duplicate_high_pos_gradients — edge_gs.py:544).
    # Columns 3:5 of the packed rows are the screen-space center. Accumulate
    # in the depth-sorted frame (ranks), then unpermute via order.
    contrib = jnp.abs(dgathered[..., 3:5]) * slot_validf[..., None]
    sorted_sink = jnp.zeros((n, 2), dtype=dgathered.dtype).at[
        ranks.reshape(-1)].add(contrib.reshape(-1, 2), mode="drop")
    dsink = jnp.zeros((n, 2), dtype=dgathered.dtype).at[order].add(
        sorted_sink, mode="drop")

    zero_ranks = np.zeros(ranks.shape, dtype=jax.dtypes.float0)
    zero_order = np.zeros(order.shape, dtype=jax.dtypes.float0)
    return (dgathered, jnp.zeros_like(slot_validf),
            jnp.zeros_like(origins), jnp.zeros_like(basis), zero_ranks,
            zero_order, dsink)


tile_render.defvjp(_tile_render_fwd, _tile_render_bwd)


# --- two-level capacity rendering -------------------------------------------
#
# Real edge scenes are sparse: median tile occupancy is ~0 while a few tiles
# hold hundreds of Gaussians, so a dense [T, K] frame wastes ~K/mean-count of
# all gather/scatter/composite work. The two-level path renders every tile's
# first K1 slots densely, then finishes only a static budget of the
# highest-occupancy tiles over the remaining capacity, compositing the
# carried transmittance. Its backward is autodiff of the same XLA
# compositor, so the level-1 gradients account for level-2 contributions
# exactly.


def _composite_tile_seg(feats, t_in, basis):
    """One tile segment in product space: [K,8], [P] -> ([P], [P] t_out)."""
    logalpha = jnp.dot(feats, basis, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
    logop = feats[:, 6:7]
    alpha = jnp.exp(logalpha)
    ok = (logalpha <= logop + SIGMA_GUARD_EPS) & (alpha >= ALPHA_THRESHOLD)
    alpha = jnp.where(ok, jnp.minimum(alpha, ALPHA_CLAMP), 0.0)

    om = 1.0 - alpha
    t_inc = t_in[None, :] * jnp.cumprod(om, axis=0)
    keep = t_inc >= TRANSMITTANCE_EPS
    t_prev = t_inc / om
    img = jnp.sum(alpha * t_prev * keep, axis=0)
    k = feats.shape[0]
    return img, t_inc[k - 1]


def _composite_jax_seg(feats, basis, t_in, chunk: int = 64):
    """Chunked segment compositor (pure XLA, autodiff oracle)."""
    T = feats.shape[0]
    pad = (-T) % chunk
    if pad:
        feats = jnp.pad(feats, ((0, pad), (0, 0), (0, 0)))
        t_in = jnp.pad(t_in, ((0, pad), (0, 0)), constant_values=1.0)
    n_chunks = feats.shape[0] // chunk

    tile_fn = jax.checkpoint(
        jax.vmap(_composite_tile_seg, in_axes=(0, 0, None)))

    def chunk_fn(args):
        f, t0 = args
        return tile_fn(f, t0, basis)

    img, tout = jax.lax.map(chunk_fn, (
        feats.reshape(n_chunks, chunk, *feats.shape[1:]),
        t_in.reshape(n_chunks, chunk, t_in.shape[1])))
    p = basis.shape[1]
    return img.reshape(-1, p)[:T], tout.reshape(-1, p)[:T]


def _gather_frame(packed_sorted, bins2, k1: int, k2: int):
    """Build the dense [T,k1,8] + [t2,k2,8] frame from packed rows.

    Plain mode gathers every frame slot through the decoded rank tables.
    Pair-prefix mode instead gathers only the B real pairs and scatters
    them to their frame rows (unique by construction); un-hit slots stay
    all-zero, whose packed validity column 6 is 0, so build_tile_features
    forces their alpha to exactly 0 — identical downstream semantics with
    ~8x fewer rows touched on real edge scenes.
    """
    T = bins2.counts.shape[0]
    t2 = bins2.ovf_ids.shape[0]
    if bins2.pair_rows is not None:
        n = packed_sorted.shape[0]
        rows = T * k1 + t2 * k2
        src = packed_sorted[jnp.clip(bins2.pair_ranks, 0, n - 1)]  # [B,8]
        frame = jnp.zeros((rows, packed_sorted.shape[1]),
                          packed_sorted.dtype).at[bins2.pair_rows].set(
            src, mode="drop", unique_indices=True)
        g1 = frame[:T * k1].reshape(T, k1, -1)
        g2 = frame[T * k1:].reshape(t2, k2, -1)
        return g1, g2
    return packed_sorted[bins2.ranks1], packed_sorted[bins2.ranks2]


def _frame_shape(bins2, k1: int, k2: int):
    if bins2.pair_rows is not None:
        if not (k1 > 0 and k2 > 0):
            raise ValueError("pair-prefix bins need static k1/k2 at the "
                             "render call")
        return k1, k2
    return bins2.ranks1.shape[1], bins2.ranks2.shape[1]


def _ovf_take(x, bins2):
    """Level-2 rows of a FRAME-ordered [T,...] array: under occupancy
    sorting the overflow tiles are the first t2 frame rows (contiguous
    slice); otherwise gather by original tile id."""
    t2 = bins2.ovf_ids.shape[0]
    if bins2.tile_perm is not None:
        return x[:t2]
    return x[bins2.ovf_ids]


def _ovf_add(images, img2, bins2):
    t2 = bins2.ovf_ids.shape[0]
    if bins2.tile_perm is not None:
        return images.at[:t2].add(img2)
    return images.at[bins2.ovf_ids].add(img2)


def _two_level_images(g1, g2, bins2, origins, basis):
    """Two-level composite of gathered frames -> (images, level-1 frame
    features' validity masks)."""
    counts1, counts2 = bins2.counts1, bins2.counts2
    k1, k2 = g1.shape[1], g2.shape[1]
    validf1 = (jnp.arange(k1, dtype=jnp.int32)[None, :]
               < counts1[:, None]).astype(jnp.float32)
    validf2 = (jnp.arange(k2, dtype=jnp.int32)[None, :]
               < counts2[:, None]).astype(jnp.float32)
    feats1 = build_tile_features(g1, origins, validf1)
    feats2 = build_tile_features(g2, _ovf_take(origins, bins2), validf2)
    ones = jnp.ones((counts1.shape[0], basis.shape[1]), jnp.float32)
    img1, tout1 = _composite_jax_seg(feats1, basis, ones)
    img2, _ = _composite_jax_seg(feats2, basis, _ovf_take(tout1, bins2))
    return _ovf_add(img1, img2, bins2), validf1, validf2


@functools.partial(jax.custom_vjp, nondiff_argnums=(6, 7))
def tile_render_two_level(packed_sorted, bins2, origins, basis,
                          order, sink, k1: int = 0, k2: int = 0):
    """Two-level tile rendering: [N,8] packed rows -> [T,P] intensities.

    Args mirror :func:`tile_render` but take pre-decoded two-level bins
    (``TileBinsTwoLevel``): every tile composites its first k1 slots, and
    the ``t2`` busiest tiles composite k2 more (tiles beyond the budget are
    truncated at k1 — monitor RenderResult counts). Gathers touch only
    T*k1 + t2*k2 rows — or only the pair budget B when ``bins2`` carries
    pair-prefix tables (then the static k1/k2 are required).

    ``origins`` must be FRAME-row-ordered (``origins[tile_perm]`` under
    occupancy sorting); the returned images are frame-ordered too — the
    caller unpermutes (ops/rasterize.py).
    """
    k1, k2 = _frame_shape(bins2, k1, k2)
    g1, g2 = _gather_frame(packed_sorted, bins2, k1, k2)
    return _two_level_images(g1, g2, bins2, origins, basis)[0]


def _tl_fwd(packed_sorted, bins2, origins, basis, order, sink, k1, k2):
    k1, k2 = _frame_shape(bins2, k1, k2)
    g1, g2 = _gather_frame(packed_sorted, bins2, k1, k2)
    images, validf1, validf2 = _two_level_images(g1, g2, bins2, origins,
                                                 basis)
    return images, (packed_sorted.shape[0], bins2, origins, basis,
                    order, g1, g2, validf1, validf2)


def _tl_bwd(k1, k2, saved, g):
    n, bins2, origins, basis, order, g1, g2, validf1, validf2 = saved
    _, vjp_fn = jax.vjp(
        lambda a1, a2: _two_level_images(a1, a2, bins2, origins, basis)[0],
        g1, g2)
    dg1, dg2 = vjp_fn(g)

    # ONE scatter for dpacked (8 cols) + absgrad (2 cols): the |d means2d|
    # columns ride on the dpacked rows.
    if bins2.pair_rows is not None:
        # pair-prefix reduction: gather the B real pairs' gradient rows out
        # of the frame and scatter them by depth rank — B rows instead of
        # T*k1 + t2*k2. Gathered rows are valid slots by construction, so
        # no validf masking is needed.
        frame = jnp.concatenate([dg1.reshape(-1, dg1.shape[-1]),
                                 dg2.reshape(-1, dg2.shape[-1])], axis=0)
        r_rows = frame.shape[0]
        rows8 = frame[jnp.clip(bins2.pair_rows, 0, r_rows - 1)]
        rows = jnp.concatenate([rows8, jnp.abs(rows8[:, 3:5])], axis=-1)
        idx = jnp.where(bins2.pair_rows < r_rows, bins2.pair_ranks, n)
    else:
        c1 = jnp.abs(dg1[..., 3:5]) * validf1[..., None]
        c2 = jnp.abs(dg2[..., 3:5]) * validf2[..., None]
        rows = jnp.concatenate([
            jnp.concatenate([dg1, c1], axis=-1).reshape(-1, 10),
            jnp.concatenate([dg2, c2], axis=-1).reshape(-1, 10)], axis=0)
        idx = jnp.concatenate([bins2.ranks1.reshape(-1),
                               bins2.ranks2.reshape(-1)])
    acc = scatter_rows(idx, rows, n)
    dpacked = acc[:, :8]
    # absgrad: sorted frame -> original ids (order is a permutation)
    dsink = jnp.zeros((n, 2), dtype=dg1.dtype).at[order].set(
        acc[:, 8:10], mode="drop", unique_indices=True)

    f0 = lambda a: np.zeros(a.shape, dtype=jax.dtypes.float0)
    zero_bins = jax.tree.map(f0, bins2)
    return (dpacked, zero_bins, jnp.zeros_like(origins),
            jnp.zeros_like(basis), f0(order), dsink)


tile_render_two_level.defvjp(_tl_fwd, _tl_bwd)
