"""Training losses (pure JAX, jit-safe).

Re-implements the reference's loss surface:

- projection losses with the three pixel-sampling strategies ``whole`` /
  ``bg_edge_ratio`` / ``weighted`` (reference: edge_gs.py:288-324,
  losses.py:5-11),
- the geometric edge priors: direction loss (major-axis vs. neighbor
  alignment, ``enforce_full`` / ``enforce_half`` — edge_gs.py:346-373) and
  scale-ratio loss (needle regularization — edge_gs.py:375-380).

Dynamic-count masked means are expressed as sum/count so every strategy is
static-shape. The ``bg_edge_ratio`` background sampler reproduces the
reference's *flat-index* quirk (SURVEY.md §6.5.2): it samples ``num_bg``
distinct flat indices uniformly from [0, #bg) and unravels them over the full
image — i.e. arbitrary pixels from the top of the image, not verified
background pixels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from edgegaussians_tpu.ops.knn import knn
from edgegaussians_tpu.ops.transforms import major_directions


def masked_l1(pred: jnp.ndarray, target: jnp.ndarray,
              mask: jnp.ndarray) -> jnp.ndarray:
    """Mean |pred-target| over mask (reference MaskedL1Loss, losses.py:5-7)."""
    m = mask.astype(pred.dtype)
    total = jnp.sum(jnp.abs(pred - target) * m)
    return total / jnp.maximum(jnp.sum(m), 1.0)


def weighted_l1(pred: jnp.ndarray, target: jnp.ndarray,
                weights: jnp.ndarray) -> jnp.ndarray:
    """Mean of weights * |pred-target| (reference WeightedL1Loss)."""
    return jnp.mean(weights * jnp.abs(pred - target))


def compute_edge_mask(gt_image: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Binary edge mask at the detection threshold (edge_gs.py:154-161)."""
    return gt_image >= threshold


def compute_weight_mask(edge_mask: jnp.ndarray) -> jnp.ndarray:
    """Inverse-frequency class weights (edge_gs.py:177-193)."""
    num_edge = jnp.sum(edge_mask)
    num_bg = jnp.sum(~edge_mask)
    total = num_edge + num_bg
    edge_w = num_bg / total
    bg_w = num_edge / total
    return jnp.where(edge_mask, edge_w, bg_w).astype(jnp.float32)


def projection_loss_whole(pred, gt, loss_type: str = "l1"):
    """'whole' strategy (edge_gs.py:290-296)."""
    if loss_type == "l1":
        return jnp.mean(jnp.abs(pred - gt))
    if loss_type == "l2":
        return jnp.mean((pred - gt) ** 2)
    raise ValueError(f"Unknown loss_type {loss_type}")


def _kth_smallest(scores: jnp.ndarray, k: jnp.ndarray,
                  iters: int = 40) -> jnp.ndarray:
    """Smallest f32 t with ``count(scores <= t) >= k`` — the k-th order
    statistic — by scalar bisection over [0, 2].

    Each iteration is one streaming count over ``scores``; after ``iters``
    halvings the bracket is below one f32 ulp, so the returned upper bound
    selects exactly the same set as sorting would. If ``k`` exceeds the
    support size the bound converges to the interval top (2.0 here),
    selecting everything — matching ``sorted[clip(k-1)]`` semantics.
    """
    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        enough = jnp.sum(scores <= mid) >= k
        return (jnp.where(enough, lo, mid), jnp.where(enough, mid, hi))

    # under shard_map the bracket inherits the scores' varying axes; the
    # initial carry must be declared varying to match (no-op otherwise)
    from edgegaussians_tpu.ops.vma import match_vma
    _, hi = jax.lax.fori_loop(
        0, iters, body, (match_vma(jnp.float32(0.0), scores, k),
                         match_vma(jnp.float32(2.0), scores, k)))
    return hi


def projection_loss_bg_edge_ratio(pred, gt, edge_mask, bg_edge_pixel_ratio,
                                  key) -> jnp.ndarray:
    """'bg_edge_ratio' strategy (edge_gs.py:298-314), bug-faithful.

    edge term: masked L1 over edge pixels. bg term: masked L1 over
    ``ratio * #edge`` random *flat* indices drawn without replacement from
    [0, #bg) — the reference's unravel-over-full-image behavior.
    """
    h, w = pred.shape
    num_edge = jnp.sum(edge_mask)
    num_bg_all = h * w - num_edge
    num_bg_sample = (bg_edge_pixel_ratio * num_edge).astype(jnp.int32)

    edge_loss = masked_l1(pred, gt, edge_mask)

    # exact without-replacement sampling of the first num_bg_all flat pixels:
    # random scores, keep those below the num_bg_sample-th smallest. The
    # k-th order statistic is found by scalar bisection (40 streaming count
    # passes) rather than a full 640k-pixel sort: the selected set is
    # identical (the bisection interval shrinks below one f32 ulp) with
    # far less compiled code than the sort.
    flat = jnp.arange(h * w)
    scores = jax.random.uniform(key, (h * w,))
    scores = jnp.where(flat < num_bg_all, scores, 2.0)   # restrict support
    kth = _kth_smallest(scores, num_bg_sample)
    sample_mask = ((scores <= kth) & (flat < num_bg_all)
                   & (num_bg_sample > 0)).reshape(h, w)

    bg_loss = masked_l1(pred, gt, sample_mask)
    return edge_loss + bg_loss


def projection_loss_weighted(pred, gt, weight_mask) -> jnp.ndarray:
    """'weighted' strategy (edge_gs.py:316-319)."""
    return weighted_l1(pred, gt, weight_mask)


def direction_loss(means: jnp.ndarray,          # [N,3]
                   scales: jnp.ndarray,         # [N,3] linear
                   quats: jnp.ndarray,          # [N,4]
                   nn_indices: jnp.ndarray,     # [N,knn] precomputed neighbors
                   alive: jnp.ndarray,          # [N] bool
                   num_nn: int,
                   enforce_method: str = "enforce_full") -> jnp.ndarray:
    """Major-axis vs. neighbor-direction alignment (edge_gs.py:346-373).

    ``nn_indices`` carries k+1 neighbors for enforce_full and 2k+1 for
    enforce_half, mirroring update_nearest_neighbors (edge_gs.py:326-344)
    which drops the closest of the fetched neighbors.
    """
    majors = major_directions(scales, quats)                     # [N,3]
    # Per-neighbor unrolled 2-D gathers: m separate [N,3] row gathers with
    # 2-D reductions compute the same values as one [N,m,3] gather plus a
    # minor-dim reduce, without rank-3 relayouts.
    m_fetch = nn_indices.shape[1]
    aligns = []
    for k in range(m_fetch):
        neigh_k = means[nn_indices[:, k]]                        # [N,3]
        d = means - neigh_k
        norm = jnp.sqrt(jnp.sum(d * d, axis=-1))
        d = d / jnp.maximum(norm, 1e-12)[:, None]
        aligns.append(jnp.abs(jnp.sum(majors * d, axis=-1)))
    align = jnp.stack(aligns, axis=-1)                           # [N,m]

    if enforce_method == "enforce_half":
        align_sorted = jnp.sort(align, axis=-1)[:, ::-1]
        mean_align = jnp.mean(align_sorted[:, :num_nn], axis=-1)
    else:
        mean_align = jnp.mean(align, axis=-1)

    af = alive.astype(jnp.float32)
    mean_align_alive = jnp.sum(mean_align * af) / jnp.maximum(jnp.sum(af), 1.0)
    return 1.0 - mean_align_alive


def ratio_loss(scales: jnp.ndarray, alive: jnp.ndarray) -> jnp.ndarray:
    """Second-largest / largest scale ratio (edge_gs.py:375-380).

    Drives Gaussians toward 1-D needles. ``scales`` are linear. The
    largest/median of the 3 scales are taken with max/sum identities
    rather than ``jnp.sort``: same values, but the sort and its VJP
    compiled to 2.4 MB of epoch-program code (vs ~0.1 MB for this form)
    and the gradient is identical wherever the scales are distinct.
    """
    s_max = jnp.max(scales, axis=-1)
    s_min = jnp.min(scales, axis=-1)
    s_med = jnp.sum(scales, axis=-1) - s_max - s_min
    ratio = s_med / jnp.maximum(s_max, 1e-12)
    af = alive.astype(jnp.float32)
    return jnp.sum(ratio * af) / jnp.maximum(jnp.sum(af), 1.0)


def update_nearest_neighbors(means: jnp.ndarray, alive: jnp.ndarray,
                             num_nn: int,
                             enforce_method: str = "enforce_full",
                             approx: bool = False) -> jnp.ndarray:
    """Neighbor indices for the direction loss (edge_gs.py:326-344).

    Fetches k+1 (or 2k+1 for enforce_half) nearest and drops the closest,
    exactly as the reference slices ``indices[:, 1:]``. ``approx`` switches
    to ``lax.approx_max_k`` (ops/knn.py APPROX_RECALL) — the alignment loss
    is insensitive to occasional rank swaps among near-equidistant
    neighbors.
    """
    k = num_nn
    fetch = (2 * k + 1) if enforce_method == "enforce_half" else (k + 1)
    _, idx = knn(means, fetch, mask=alive, approx=approx)
    return idx[:, 1:]
