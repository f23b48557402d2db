"""Adaptive density control as jit-safe masked buffer operations.

Re-designs the reference's reallocation-based duplicate/cull machinery
(edge_gs.py:383-613) for fixed-capacity arrays: culling clears the alive
mask; duplication scatters clones into free (dead) slots. Optimizer-state
semantics are preserved exactly — survivors keep their Adam moments, clones
start with zeroed moments (edge_gs.py:431-457) — by zeroing the moment rows
of every written slot.

Bug-faithful behaviors (SURVEY.md §6.5) intentionally mirrored:
- ``cull_gaussians`` clamps *all* opacity logits to ``reset_opacity_value``
  on every cull (``reset_rest=True`` default — edge_gs.py:412-429);
- ``duplicate_high_pos_gradients`` with ``percentile_top`` compares min-max
  normalized grads against an unnormalized quantile (edge_gs.py:559-568);
- ``cull_wayward`` computes its mask but applies nothing unless this
  framework's ``cull_wayward_apply`` flag is set (reference never calls the cull —
  edge_gs.py:498-542).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from edgegaussians_tpu.config import ModelConfig
from edgegaussians_tpu.models.gaussians import GaussianParams, GaussianState
from edgegaussians_tpu.ops.knn import knn


class AdamMoments(NamedTuple):
    """First/second Adam moments per parameter group, aligned to capacity."""
    means: Tuple[jnp.ndarray, jnp.ndarray]
    scales: Tuple[jnp.ndarray, jnp.ndarray]
    quats: Tuple[jnp.ndarray, jnp.ndarray]
    opacities: Tuple[jnp.ndarray, jnp.ndarray]


def masked_quantile(values: jnp.ndarray, mask: jnp.ndarray, q,
                    method: str = "linear") -> jnp.ndarray:
    """Quantile over the masked subset (dead slots excluded), jit-safe.

    method='linear' matches torch.quantile default; 'lower' matches
    interpolation='lower' (used at edge_gs.py:534,551,564).
    """
    n = values.shape[0]
    big = jnp.float32(3.4e38)
    vals = jnp.where(mask, values.astype(jnp.float32), big)
    s = jnp.sort(vals)
    cnt = jnp.sum(mask.astype(jnp.int32))
    pos = q * (cnt.astype(jnp.float32) - 1.0)
    lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, n - 1)
    hi = jnp.clip(lo + 1, 0, n - 1)
    if method == "lower":
        return s[lo]
    frac = pos - lo.astype(jnp.float32)
    v_lo = s[lo]
    v_hi = jnp.where(hi < cnt, s[hi], v_lo)
    return v_lo + frac * (v_hi - v_lo)


def _masked_min_max(values, mask):
    big = jnp.float32(3.4e38)
    v = values.astype(jnp.float32)
    vmin = jnp.min(jnp.where(mask, v, big))
    vmax = jnp.max(jnp.where(mask, v, -big))
    return vmin, vmax


def _zero_moment_rows(moments: AdamMoments, slot_mask: jnp.ndarray
                      ) -> AdamMoments:
    """Zero mu/nu rows at the given slots (clone init — edge_gs.py:435-448)."""
    def z(t):
        mu, nu = t
        keep = ~slot_mask
        shape = (-1,) + (1,) * (mu.ndim - 1)
        kf = keep.reshape(shape)
        return (mu * kf, nu * kf)
    return AdamMoments(z(moments.means), z(moments.scales),
                       z(moments.quats), z(moments.opacities))


def reset_opacities(params: GaussianParams, reset_value: float
                    ) -> GaussianParams:
    """Clamp opacity logits to reset_value — bug-faithfully in logit space
    (edge_gs.py:425-429 clamps ``opacities.data`` which is pre-sigmoid)."""
    return params._replace(
        opacities=jnp.minimum(params.opacities, reset_value))


def cull(state: GaussianState, moments: AdamMoments, cull_mask: jnp.ndarray,
         config: ModelConfig, reset_rest: bool = True
         ) -> Tuple[GaussianState, AdamMoments]:
    """Apply a cull mask (edge_gs.py:412-423): clear alive; optionally clamp
    all remaining opacities; culled slots' absgrads are irrelevant once dead.

    Moments of dead slots are left stale — they are zeroed on reuse, which
    reproduces the reference's remove-rows semantics exactly.
    """
    cull_mask = cull_mask & state.alive
    params = state.params
    if reset_rest:
        params = reset_opacities(params, config.reset_opacity_value)
    return (state._replace(params=params, alive=state.alive & ~cull_mask),
            moments)


def cull_low_opacity(state: GaussianState, moments: AdamMoments,
                     config: ModelConfig):
    """edge_gs.py:477-488."""
    opac = jax.nn.sigmoid(state.params.opacities[:, 0])
    if config.cull_opacity_type == "percentile":
        thresh = masked_quantile(opac, state.alive, config.cull_opacity_value)
    else:
        thresh = jnp.float32(config.cull_opacity_value)
    return cull(state, moments, opac < thresh, config)


def cull_not_projecting(state: GaussianState, moments: AdamMoments,
                        config: ModelConfig,
                        viewmats: jnp.ndarray,     # [V,4,4]
                        Ks: jnp.ndarray,           # [V,3,3]
                        edge_masks: jnp.ndarray,   # [V,H,W] bool
                        ):
    """Cull Gaussians whose means hit edge pixels in too few views
    (edge_gs.py:578-601). Out-of-image projections count as not-on-edge."""
    v, h, w = edge_masks.shape
    means_h = jnp.concatenate(
        [state.params.means, jnp.ones((state.capacity, 1))], axis=1)  # [N,4]
    P = jnp.einsum("vij,vjk->vik", Ks, viewmats[:, :3, :4],
                   precision=jax.lax.Precision.HIGHEST)               # [V,3,4]
    # Three [N,4] @ [4,V] matmuls in 2-D shapes. HIGHEST precision: pixel
    # coordinates reach O(800), and reduced-precision (bf16 / TF32)
    # multiplies would quantize them by +-2 px.
    hp = jax.lax.Precision.HIGHEST
    px = jnp.matmul(means_h, P[:, 0, :].T, precision=hp)              # [N,V]
    py = jnp.matmul(means_h, P[:, 1, :].T, precision=hp)
    pw = jnp.matmul(means_h, P[:, 2, :].T, precision=hp)
    # torch .round() rounds half to even; jnp.rint matches
    xr = jnp.rint(px / pw).astype(jnp.int32)                          # [N,V]
    yr = jnp.rint(py / pw).astype(jnp.int32)
    good = (xr >= 0) & (xr < w) & (yr >= 0) & (yr < h)
    flat = jnp.clip(yr, 0, h - 1) * w + jnp.clip(xr, 0, w - 1)        # [N,V]
    # Per-view lax.scan for the mask lookups: the scan body holds ONE
    # [N]-element gather, compiled once.
    def view_hits(hits, args):
        mask_v, flat_v, good_v = args                # [H*W], [N], [N]
        return hits + (mask_v[flat_v] & good_v).astype(jnp.float32), None

    hits, _ = jax.lax.scan(
        view_hits, jnp.zeros((flat.shape[0],), jnp.float32),
        (edge_masks.reshape(v, -1), flat.T, good.T))
    visib = hits / v                                                  # [N]
    thresh = config.cull_gaussians_not_projecting_threshold
    return cull(state, moments, visib < thresh, config)


def wayward_mask(state: GaussianState, config: ModelConfig) -> jnp.ndarray:
    """Outlier mask from kNN distances / PCA ratio (edge_gs.py:498-542)."""
    k = config.cull_wayward_num_neighbors
    dists, idx = knn(state.params.means, k, mask=state.alive)

    if config.cull_wayward_method == "pca_ratio":
        d = state.params.means[:, None, :] - state.params.means[idx]
        d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
        d = d - jnp.mean(d, axis=1, keepdims=True)
        # HIGHEST: a default-precision f32 contraction may run in TF32 on
        # the GPU, and the 3rd/2nd singular-value ratio of a thin cluster
        # is far below TF32's ~1e-3 resolution
        cov = jnp.einsum("nki,nkj->nij", d, d,
                         precision=jax.lax.Precision.HIGHEST) / k
        evals = jnp.linalg.eigvalsh(cov)              # ascending
        s = jnp.sqrt(jnp.maximum(evals, 0.0))
        cns = s[:, 0] / jnp.maximum(s[:, 1], 1e-12)   # 3rd/2nd singular value
        q = config.cull_wayward_threshold_value
        thresh = masked_quantile(cns, state.alive, q)
        return cns <= thresh
    if config.cull_wayward_method == "max_distance":
        d = jnp.max(dists, axis=-1)
    else:                                             # mean_distance
        d = jnp.mean(dists, axis=-1)
    if config.cull_wayward_threshold_type == "percentile_top":
        q = 1.0 - config.cull_wayward_threshold_value
        thresh = masked_quantile(d, state.alive, q, method="lower")
        return d > thresh
    return d > config.cull_wayward_threshold_value


def cull_wayward(state: GaussianState, moments: AdamMoments,
                 config: ModelConfig):
    """Reference computes the mask but never culls (SURVEY §6.5.1); the
    intended behavior is opt-in via ``cull_wayward_apply``."""
    if not config.cull_wayward_apply:
        return state, moments
    return cull(state, moments, wayward_mask(state, config), config)


def duplicate_high_pos_gradients(state: GaussianState, moments: AdamMoments,
                                 config: ModelConfig, key: jnp.ndarray):
    """Absgrad-driven densification (edge_gs.py:544-576).

    grads = absgrads / normalize_factor; min-max normalize over alive rows;
    threshold per dup_threshold_type; clone each selected Gaussian
    (dup_factor - 1) times with mean noise, zeroed clone moments.
    """
    grads = state.absgrads / state.absgrad_count
    gmin, gmax = _masked_min_max(grads, state.alive)
    grads_n = (grads - gmin) / jnp.maximum(gmax - gmin, 1e-12)

    if config.dup_threshold_type == "percentile_top":
        # bug-faithful: unnormalized quantile vs normalized grads
        num_q = int(round(1.0 / config.dup_threshold_value))
        thresh = masked_quantile(grads, state.alive,
                                 (num_q - 1) / num_q, method="lower")
        dup_mask = (grads_n > thresh) & state.alive
    elif config.dup_threshold_type == "top_fraction":
        # this framework's addition: duplicate the top `dup_threshold_value`
        # fraction of alive Gaussians by absgrad. Count-deterministic,
        # unlike 'absolute', whose cutoff on min-max-normalized grads
        # sits on a knife edge where toolchain-level numeric shifts move
        # scheduled dup counts by thousands (docs/RESULTS.md).
        thresh = masked_quantile(grads, state.alive,
                                 1.0 - config.dup_threshold_value,
                                 method="lower")
        dup_mask = (grads > thresh) & state.alive
    else:
        thresh = jnp.float32(config.dup_threshold_value)
        dup_mask = (grads_n > thresh) & state.alive
    state, moments = _duplicate(state, moments, dup_mask,
                                config.dup_factor,
                                config.init_dup_rand_noise_scale, key)
    # reset_absgrads follows every duplication (edge_gs.py:576)
    return (state._replace(
        absgrads=jnp.zeros_like(state.absgrads),
        absgrad_count=jnp.ones_like(state.absgrad_count)), moments)


def duplicate_all(state: GaussianState, moments: AdamMoments,
                  config: ModelConfig, key: jnp.ndarray):
    """edge_gs.py:491-496."""
    return _duplicate(state, moments, state.alive, config.dup_factor,
                      config.init_dup_rand_noise_scale, key)


def _duplicate(state: GaussianState, moments: AdamMoments,
               dup_mask: jnp.ndarray, dup_factor: int, noise_scale: float,
               key: jnp.ndarray) -> Tuple[GaussianState, AdamMoments]:
    """Scatter (dup_factor-1) noisy clones of each masked Gaussian into free
    slots (edge_gs.py:460-474). Clones beyond capacity are dropped.
    """
    cap = state.capacity
    n_copies = dup_factor - 1
    if n_copies <= 0:
        return state, moments

    # free slots in ascending order (False sorts before True)
    free_order = jnp.argsort(state.alive.astype(jnp.int32),
                             stable=True)                     # dead first
    n_free = cap - jnp.sum(state.alive.astype(jnp.int32))

    sel_rank = jnp.cumsum(dup_mask.astype(jnp.int32)) - 1     # rank if selected
    n_sel = jnp.sum(dup_mask.astype(jnp.int32))

    params = state.params
    alive = state.alive
    written = jnp.zeros((cap,), dtype=bool)

    src_ids = jnp.arange(cap, dtype=jnp.int32)
    # ONE RNG draw for all copies: per-copy draws inside this unrolled loop
    # would multiply the compiled RNG code by dup_factor. A leading-axis
    # slice per copy is layout-free.
    noise_all = noise_scale * jax.random.normal(key, (n_copies, cap, 3))
    for r in range(n_copies):
        free_rank = r * n_sel + sel_rank
        ok = dup_mask & (free_rank < n_free)
        target = jnp.where(ok, free_order[jnp.clip(free_rank, 0, cap - 1)],
                           cap)                               # cap = dropped
        noise = noise_all[r]

        def scatter(dst, src_vals):
            return dst.at[target].set(src_vals, mode="drop")

        params = GaussianParams(
            means=scatter(params.means, state.params.means + noise),
            scales=scatter(params.scales, state.params.scales),
            quats=scatter(params.quats, state.params.quats),
            opacities=scatter(params.opacities, state.params.opacities))
        alive = alive.at[target].set(True, mode="drop")
        written = written.at[target].set(True, mode="drop")

    moments = _zero_moment_rows(moments, written)
    absgrads = jnp.where(written, 0.0, state.absgrads)
    return (state._replace(params=params, alive=alive, absgrads=absgrads),
            moments)
