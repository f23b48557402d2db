"""Segmented pair compositor: the render path of ``tile_pair_kernel="seg"``.

Binning (``tiles.bin_pairs_frame_order``) delivers every tile's composited
(tile, Gaussian) pairs as one contiguous depth-ordered run of a pair stream,
with frame rows ordered by descending run length. This module composites
those runs front to back and differentiates the result:

- the forward is one program per tile (frame row), vectorised over the
  tile's ``tile_size**2`` pixels. The program loads its run start and
  length, walks the run in ``CHUNK``-pair steps and stops as soon as every
  pixel's transmittance is below ``TRANSMITTANCE_EPS`` (gsplat's per-tile
  early stop). Log-alpha is 5 fused multiply-adds per (pair, pixel)
  against the tile-local pixel basis (tiles.py module docstring). Within a
  chunk the transmittance is an inclusive scan of log(1 - alpha)
  (alpha <= 0.999, so the logarithm is finite); across chunks it is
  carried as a product.
- the backward uses the algebraic rule of the all-ones-colour compositor:
  contributions telescope within a run (contrib_l = t_prev_l - t_inc_l),
  so for every kept pair ``dL/dalpha_l = g * (1 - total) / (1 - alpha_l)``
  with ``total`` the forward image. The kernel recomputes alpha and the
  keep mask in the forward order and writes one gradient row per pair.
  Each pair belongs to exactly one tile, so no atomics are needed; rows of
  pairs after an early stop are written as zeros. Rows outside every run
  are never written and are masked by pair validity afterwards.
- the pair -> Gaussian reduction (gradient rows plus the absgrad sink
  columns) is one XLA scatter-add by depth rank.

Blocks run in any order and carry no state between them. Kernels are
Pallas on the Triton route (``backend="triton"``); ``interpret=True`` runs
the same kernels on the CPU for tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from edgegaussians_tpu.ops import vma
from edgegaussians_tpu.ops.projection import (
    ALPHA_CLAMP, ALPHA_THRESHOLD, SIGMA_GUARD_EPS, TRANSMITTANCE_EPS)
from edgegaussians_tpu.ops.tiles import (
    PairBins, build_pair_features, scatter_rows, step_over_pairs)

CHUNK = 16       # pairs per loop step (a power of two, as Triton requires)
NUM_WARPS = 4    # 128 threads over a 16x16 tile: 2 pixels per thread
_NEG = -1e30     # constant-slot value of padding pairs: alpha underflows to 0


def _load_chunk(feats_ref, j0, live):
    """Features 0..6 of pairs [j0, j0+CHUNK): seven [CHUNK] vectors.
    Pairs past the run get a -1e30 constant slot (alpha exactly 0)."""
    sl = pl.ds(j0, CHUNK)
    return [plgpu.load(feats_ref.at[k, sl], mask=live,
                       other=_NEG if k == 5 else 0.0) for k in range(7)]


def _fma(x, y, z):
    """x * y + z with one rounding (PTX ``fma.rn.f32``)."""
    return plgpu.elementwise_inline_asm(
        "fma.rn.f32 $0, $1, $2, $3;", args=[x, y, z],
        constraints="=f,f,f,f", pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(x.shape, x.dtype)])[0]


def _chunk_alpha(f, b, fused):
    """[P, CHUNK] masked alpha (pixels x pairs) and its 'ok' mask (gsplat
    clamp/skip rules, same numerics and term order as
    composite._composite_tile_seg's dot).

    The log-alpha sum cancels large terms for thin Gaussians, so its f32
    rounding shows in the image. Compiled (``fused``), it is the explicit
    chain of fused multiply-adds that XLA's f32 GEMM performs over the
    contraction, in the same order, which keeps the kernel within f32
    noise of the oracle; the interpreter (no inline PTX) multiplies and
    adds."""
    shape = (b[0].shape[0], f[0].shape[0])
    logalpha = b[0][:, None] * f[0][None, :]
    for k in range(1, 5):
        if fused:
            logalpha = _fma(jnp.broadcast_to(b[k][:, None], shape),
                            jnp.broadcast_to(f[k][None, :], shape), logalpha)
        else:
            logalpha = logalpha + b[k][:, None] * f[k][None, :]
    logalpha = logalpha + f[5][None, :]
    ok = logalpha <= f[6][None, :] + SIGMA_GUARD_EPS
    alpha = jnp.exp(jnp.where(ok, logalpha, _NEG))
    ok = ok & (alpha >= ALPHA_THRESHOLD)
    alpha = jnp.where(ok, jnp.minimum(alpha, ALPHA_CLAMP), 0.0)
    return alpha, ok


def _chunk_transmittance(alpha, t):
    """(t_prev, keep, t_next) for one [P, CHUNK] chunk given the carried
    [P] transmittance ``t``; the scan runs along the pair (last) axis."""
    lom = jnp.log(1.0 - alpha)
    cs = jnp.cumsum(lom, axis=1)
    t_inc = t[:, None] * jnp.exp(cs)
    t_prev = t[:, None] * jnp.exp(cs - lom)
    keep = t_inc >= TRANSMITTANCE_EPS
    return t_prev, keep, t * jnp.exp(jnp.sum(lom, axis=1))


def _run(starts_ref, counts_ref):
    """This program's run start and length (as one-element loads reduced
    to scalars)."""
    sl = pl.ds(pl.program_id(0), 1)
    return (jnp.sum(plgpu.load(starts_ref.at[sl])),
            jnp.sum(plgpu.load(counts_ref.at[sl])))


def _basis_rows(basis_ref):
    return [basis_ref[k, :] for k in range(5)]


def _fwd_kernel(starts_ref, counts_ref, feats_ref, basis_ref, out_ref, *,
                fused):
    start, count = _run(starts_ref, counts_ref)
    b = _basis_rows(basis_ref)
    lane = jnp.arange(CHUNK, dtype=jnp.int32)
    p = out_ref.shape[-1]

    def cond(c):
        j, t, _ = c
        return (j < count) & (jnp.max(t) >= TRANSMITTANCE_EPS)

    def body(c):
        j, t, img = c
        f = _load_chunk(feats_ref, start + j, lane < count - j)
        alpha, _ = _chunk_alpha(f, b, fused)
        t_prev, keep, t_next = _chunk_transmittance(alpha, t)
        img = img + jnp.sum(jnp.where(keep, alpha * t_prev, 0.0), axis=1)
        return j + CHUNK, t_next, img

    _, _, img = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.ones((p,), jnp.float32),
                     jnp.zeros((p,), jnp.float32)))
    out_ref[...] = img


def _bwd_kernel(starts_ref, counts_ref, feats_ref, basis_ref, gt_ref,
                dfeats_ref, *, fused):
    start, count = _run(starts_ref, counts_ref)
    b = _basis_rows(basis_ref)
    gt = gt_ref[...]                                  # [P] g * (1 - total)
    lane = jnp.arange(CHUNK, dtype=jnp.int32)
    p = gt_ref.shape[-1]

    def cond(c):
        j, t = c
        return (j < count) & (jnp.max(t) >= TRANSMITTANCE_EPS)

    def body(c):
        j, t = c
        live = lane < count - j
        f = _load_chunk(feats_ref, start + j, live)
        alpha, ok = _chunk_alpha(f, b, fused)
        _, keep, t_next = _chunk_transmittance(alpha, t)
        dalpha = jnp.where(keep, gt[:, None] / (1.0 - alpha), 0.0)
        dla = jnp.where(ok & (alpha < ALPHA_CLAMP), alpha * dalpha, 0.0)
        sl = pl.ds(start + j, CHUNK)
        plgpu.store(dfeats_ref.at[5, sl], jnp.sum(dla, axis=0), mask=live)
        for k in range(5):
            plgpu.store(dfeats_ref.at[k, sl],
                        jnp.sum(dla * b[k][:, None], axis=0), mask=live)
        return j + CHUNK, t_next

    j_stop, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.ones((p,), jnp.float32)))

    # pairs after the early stop have keep = 0: their rows are zeros
    zero = jnp.zeros((CHUNK,), jnp.float32)

    def fill(j):
        sl = pl.ds(start + j, CHUNK)
        for k in range(6):
            plgpu.store(dfeats_ref.at[k, sl], zero, mask=lane < count - j)
        return j + CHUNK

    jax.lax.while_loop(lambda j: j < count, fill, j_stop)


def _compiler_params():
    return plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1)


@functools.partial(jax.jit, static_argnames=("interpret",))
def _seg_fwd(starts, counts, feats_t, basis, interpret: bool):
    t = starts.shape[0]
    p = basis.shape[1]
    return pl.pallas_call(
        functools.partial(_fwd_kernel, fused=not interpret),
        grid=(t,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 4,
        out_specs=pl.BlockSpec((None, p), lambda i: (i, 0)),
        out_shape=vma.out_struct((t, p), jnp.float32, starts, feats_t),
        compiler_params=_compiler_params(),
        interpret=interpret,
        name="segpair_fwd",
    )(starts, counts, feats_t, basis)


@functools.partial(jax.jit, static_argnames=("interpret",))
def _seg_bwd(starts, counts, feats_t, basis, gt, interpret: bool):
    t = starts.shape[0]
    p = basis.shape[1]
    return pl.pallas_call(
        functools.partial(_bwd_kernel, fused=not interpret),
        grid=(t,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 4
        + [pl.BlockSpec((None, p), lambda i: (i, 0))],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=vma.out_struct((6, feats_t.shape[1]), jnp.float32, gt,
                                 feats_t),
        compiler_params=_compiler_params(),
        interpret=interpret,
        name="segpair_bwd",
    )(starts, counts, feats_t, basis, gt)


# --- shared wrapper ----------------------------------------------------------

def _prep(packed_sorted, pbins: PairBins, origins):
    """Per-pair features [B,8] in the resorted stream, with the gathered
    packed rows and tile origins the backward differentiates through."""
    B = pbins.pair_ranks.shape[0]
    src = packed_sorted[pbins.pair_ranks]                 # [B,8] row gather
    org = origins[pbins.perm]                             # [T,2] frame order
    ox = step_over_pairs(pbins.s_f, org[:, 0], B)
    oy = step_over_pairs(pbins.s_f, org[:, 1], B)
    return src, ox, oy, build_pair_features(src, ox, oy)


def _feature_major(feats):
    """[B,8] -> [8, B + CHUNK]: the kernels load CHUNK consecutive pairs of
    one feature, so the last chunk of a run may read past B."""
    return jnp.pad(feats.T, ((0, 0), (0, CHUNK)))


@functools.partial(jax.custom_vjp, nondiff_argnums=(5,))
def segpair_render(packed_sorted, pbins: PairBins, origins, basis, sink,
                   interpret: bool = False):
    """Frame-ordered tile intensities [T,P] from the pair tables.

    Differentiable in ``packed_sorted``; ``sink``'s cotangent reports the
    per-Gaussian accumulated |d means2d| (absgrad). ``interpret`` runs the
    kernels on the Pallas interpreter (tests, CPU rehearsals)."""
    return _sp_fwd(packed_sorted, pbins, origins, basis, sink, interpret)[0]


def _sp_fwd(packed_sorted, pbins, origins, basis, sink, interpret):
    src, ox, oy, feats = _prep(packed_sorted, pbins, origins)
    feats_t = _feature_major(feats)
    img = _seg_fwd(pbins.s_f[:-1], pbins.counts_f, feats_t, basis,
                   interpret)
    return img, (packed_sorted.shape[0], pbins, origins, basis, src, ox, oy,
                 feats_t, img)


def _sp_bwd(interpret, saved, g):
    n, pbins, origins, basis, src, ox, oy, feats_t, img = saved
    B = pbins.pair_ranks.shape[0]
    gt = g * (1.0 - img)       # the only per-pixel input the rule needs
    d6 = _seg_bwd(pbins.s_f[:-1], pbins.counts_f, feats_t, basis, gt,
                  interpret)
    dfeats = jnp.pad(d6[:, :B].T, ((0, 0), (0, 2)))
    dfeats = jnp.where(pbins.pair_valid[:, None], dfeats, 0.0)
    _, fvjp = jax.vjp(lambda s: build_pair_features(s, ox, oy), src)
    (dsrc,) = fvjp(dfeats)                                # [B,8]
    rows = jnp.concatenate([dsrc, jnp.abs(dsrc[:, 3:5])], axis=-1)
    idx = jnp.where(pbins.pair_valid, pbins.pair_ranks, n)
    acc = scatter_rows(idx, rows, n)
    dsink = jnp.zeros((n, 2), dsrc.dtype).at[pbins.order].set(
        acc[:, 8:10], mode="drop", unique_indices=True)

    f0 = lambda a: np.zeros(a.shape, dtype=jax.dtypes.float0)
    return (acc[:, :8], jax.tree.map(f0, pbins), jnp.zeros_like(origins),
            jnp.zeros_like(basis), dsink)


segpair_render.defvjp(_sp_fwd, _sp_bwd)
