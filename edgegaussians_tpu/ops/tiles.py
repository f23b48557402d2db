"""Tile binning and screen-space feature construction.

The production rasterizer decomposes the image into ``ts x ts`` pixel tiles
(reference BLOCK_WIDTH=16 — edge_gs.py:233,260) and, per tile, composites a
fixed-capacity, depth-ordered list of intersecting Gaussians. The
variable-length per-tile lists of the CUDA design become static-shape
tables built with one fused-key sort + prefix sums — no dynamic shapes,
fully jit-safe.

The pixel-evaluation is phrased as a matmul: for conic (a,b,c), center
(mx,my) in TILE-LOCAL pixel coordinates and log-opacity lo,

    log alpha(px,py) = G . [px^2, px*py, py^2, px, py, 1, 0, 0]

with G = [-a/2, -b, -c/2, a*mx+b*my, b*mx+c*my,
          -(a*mx^2 + 2b*mx*my + c*my^2)/2 + lo, 0, 0].

so the hot per-(Gaussian, pixel) evaluation is a ``[K,8] @ [8,P]`` product
(or 5 FMAs per pixel in the GPU kernel), and tile-local coordinates keep the
quadratic terms small so f32 loses no precision to cancellation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from edgegaussians_tpu.ops.projection import ProjectedGaussians

NUM_FEATURES = 8   # 6 used + the log opacity (sigma guard) + 1 pad


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


class TileBins(NamedTuple):
    """Depth-ordered per-tile Gaussian lists (static shapes).

    Per-tile entries are *depth ranks* — positions in the global
    depth-ascending order — not raw Gaussian ids: consumers gather from
    rank-permuted arrays (``packed[order]``), and the rank->id unpermute is
    a cheap [N]-sized op where needed.
    """
    ranks: jnp.ndarray     # [T,K] int32 depth ranks (clipped)
    valid: jnp.ndarray     # [T,K] bool
    counts: jnp.ndarray    # [T] int32 true number of intersecting Gaussians
    order: jnp.ndarray     # [N] int32: order[rank] = gaussian id
    num_truncated: jnp.ndarray  # scalar int32: Gaussians whose tile box
                                # exceeded max_tiles_per_gaussian (their
                                # overflow tiles were dropped)


class TileBinsTwoLevel(NamedTuple):
    """Two-level per-tile lists: dense k1 slots everywhere + an overflow
    budget of ``t2`` busiest tiles carrying k2 more slots each.

    Decoding only T*k1 + t2*k2 entries (instead of T*(k1+k2)) keeps the
    rank-decode gather proportional to the work the compositor actually
    does.

    With a ``pair_budget`` B > 0 the decode is skipped entirely
    (``ranks1``/``ranks2`` are None) and the renderer works in the
    *sorted-pair prefix* domain instead: the first B positions of the fused
    key sort hold every real (tile, rank) pair (invalid keys sort to the
    tail), so one [B] row gather + one [B] row scatter builds the dense
    frame, and the backward reduction touches B rows instead of
    T*k1 + t2*k2. See ``_pair_prefix_tables``.
    """
    ranks1: jnp.ndarray    # [T,k1] int32 depth ranks (None in pair mode)
    counts: jnp.ndarray    # [T] int32 true per-tile occupancy (tile order)
    counts1: jnp.ndarray   # [T] int32 = min(counts, k1) (FRAME row order)
    ovf_ids: jnp.ndarray   # [t2] int32 busiest-tile indices (top-k counts)
    counts2: jnp.ndarray   # [t2] int32 = clip(counts[ovf] - k1, 0, k2)
    ranks2: jnp.ndarray    # [t2,k2] int32 depth ranks (None in pair mode)
    order: jnp.ndarray     # [N] int32: order[rank] = gaussian id
    num_truncated: jnp.ndarray  # scalar int32 (see TileBins)
    pair_rows: jnp.ndarray = None   # [B] int32 frame row of sorted pair p
                                    # (>= T*k1+t2*k2 for dropped pairs)
    pair_ranks: jnp.ndarray = None  # [B] int32 depth rank of sorted pair p
    num_pairs: jnp.ndarray = None   # scalar int32 true pair count (audit
                                    # vs the static B)
    tile_perm: jnp.ndarray = None   # [T] int32 occupancy sort: FRAME row i
                                    # holds tile perm[i] (None = frame rows
                                    # are tile order). The overflow list is
                                    # then exactly perm[:t2].


def tile_grid(width: int, height: int, tile_size: int):
    """(tiles_x, tiles_y, num_tiles)."""
    ntx, nty = cdiv(width, tile_size), cdiv(height, tile_size)
    return ntx, nty, ntx * nty


# Bits reserved for the depth rank inside the fused sort key. Capacity for
# 2^18 = 262144 Gaussians; tile ids must satisfy T < 2^31 / 2^18 = 8192.
RANK_BITS = 18
RANK_MASK = (1 << RANK_BITS) - 1
# Max tiles one Gaussian may cover (its 3-sigma box is truncated beyond
# this); 64 tiles = a 128px-radius footprint at 16px tiles.
MAX_TILES_PER_GAUSSIAN = 64


@functools.partial(jax.jit, static_argnames=(
    "width", "height", "tile_size", "capacity", "max_tiles_per_gaussian"))
def bin_gaussians(proj: ProjectedGaussians, width: int, height: int,
                  tile_size: int, capacity: int,
                  max_tiles_per_gaussian: int = MAX_TILES_PER_GAUSSIAN
                  ) -> TileBins:
    """Build depth-ordered fixed-capacity per-tile Gaussian lists.

    Matches the CUDA rasterizer's binning rule (square 3-sigma bounding box
    against the tile rectangle; tiles in [floor((m-r)/ts), ceil((m+r)/ts))),
    as ONE fused-key sort — no scatters, no per-tile loops:

    1. expand each depth-sorted Gaussian into <= M (tile, rank) pairs,
       encoded in a single int32 key ``tile_id << RANK_BITS | depth_rank``
       (invalid pairs get INT32_MAX and sort to the tail),
    2. ``lax.sort`` the [N*M] keys — per-tile runs come out contiguous and
       depth-ascending, with the payload embedded in the key,
    3. per-tile run starts via one batched searchsorted of T+1 boundaries,
       then a [T, K] gather decodes ranks back to Gaussian indices.

    Tiles whose membership exceeds ``capacity`` keep the nearest ``capacity``
    Gaussians (true sizes reported via ``counts``).
    """
    n = proj.depths.shape[0]
    capacity = min(capacity, n) if n > 0 else capacity
    sorted_keys, starts, counts, order, num_trunc = _sort_pairs(
        proj, width, height, tile_size, max_tiles_per_gaussian)

    kk = jnp.arange(capacity, dtype=jnp.int32)[None, :]
    gidx = starts[:-1, None] + kk                                 # [T,K]
    ranks = _decode_ranks(sorted_keys, gidx, n)
    slot_valid = kk < counts[:, None]
    return TileBins(ranks=ranks, valid=slot_valid, counts=counts,
                    order=order, num_truncated=num_trunc)


@functools.partial(jax.jit, static_argnames=(
    "width", "height", "tile_size", "k1", "k2", "t2",
    "max_tiles_per_gaussian", "pair_budget", "occupancy_sort"))
def bin_gaussians_two_level(proj: ProjectedGaussians, width: int,
                            height: int, tile_size: int, k1: int, k2: int,
                            t2: int,
                            max_tiles_per_gaussian: int = MAX_TILES_PER_GAUSSIAN,
                            pair_budget: int = 0,
                            occupancy_sort: bool = False
                            ) -> TileBinsTwoLevel:
    """Two-level binning: dense k1 ranks for every tile plus k2 overflow
    ranks for the ``t2`` busiest tiles (see :class:`TileBinsTwoLevel`).

    Same fused-key sort as :func:`bin_gaussians`; only the decode differs —
    overflow ranks are gathered straight from the sorted keys at
    ``starts[ovf] + k1``, so no [T, k1+k2] intermediate is ever built.

    With ``pair_budget`` B > 0 the per-slot rank decode is replaced by the
    sorted-pair-prefix tables (``pair_rows``/``pair_ranks``): renders touch
    B rows instead of T*k1 + t2*k2. B must cover every real pair
    (``num_pairs`` audits this); pairs past the budget are dropped from the
    render like tiles past the overflow budget.

    ``occupancy_sort`` orders the FRAME rows by descending per-tile count
    (``tile_perm``): the overflow list becomes the first t2 frame rows,
    making the level-2 transmittance hand-off a contiguous slice instead
    of a gather.
    """
    n = proj.depths.shape[0]
    T = tile_grid(width, height, tile_size)[2]
    sorted_keys, starts, counts, order, num_trunc = _sort_pairs(
        proj, width, height, tile_size, max_tiles_per_gaussian)

    if occupancy_sort:
        # descending-count permutation; its prefix IS the overflow list
        _, perm = jax.lax.sort_key_val(
            -counts, jnp.arange(T, dtype=jnp.int32))
        ovf_ids = perm[:t2]
        ovf_counts = counts[ovf_ids]
        starts_f = starts[:-1][perm]          # frame-row-ordered run starts
        counts_f = counts[perm]
        inv_perm = jnp.zeros((T,), jnp.int32).at[perm].set(
            jnp.arange(T, dtype=jnp.int32), unique_indices=True)
    else:
        perm = None
        ovf_counts, ovf_ids = jax.lax.top_k(counts, t2)
        ovf_ids = ovf_ids.astype(jnp.int32)
        starts_f = starts[:-1]
        counts_f = counts
        inv_perm = None

    counts2 = jnp.clip(ovf_counts - k1, 0, k2)
    common = dict(counts=counts, counts1=jnp.minimum(counts_f, k1),
                  ovf_ids=ovf_ids, counts2=counts2, order=order,
                  num_truncated=num_trunc,
                  num_pairs=starts[-1].astype(jnp.int32),
                  tile_perm=perm)

    if pair_budget > 0:
        pair_rows, pair_ranks, _ = _pair_prefix_tables(
            sorted_keys, starts, counts, ovf_ids, k1, k2, pair_budget,
            inv_perm=inv_perm)
        return TileBinsTwoLevel(
            ranks1=None, ranks2=None, pair_rows=pair_rows,
            pair_ranks=pair_ranks, **common)

    kk1 = jnp.arange(k1, dtype=jnp.int32)[None, :]
    ranks1 = _decode_ranks(sorted_keys, starts_f[:, None] + kk1, n)
    starts2 = starts[:-1][ovf_ids] + k1                           # [t2]
    kk2 = jnp.arange(k2, dtype=jnp.int32)[None, :]
    ranks2 = _decode_ranks(sorted_keys, starts2[:, None] + kk2, n)
    return TileBinsTwoLevel(ranks1=ranks1, ranks2=ranks2, **common)


# Sentinel frame-row offset for pairs that must not land in the frame
# (beyond a tile's composited capacity, beyond the pair budget, or invalid).
# Large enough that row = p + PAIR_DROP_OFF always exceeds any frame, small
# enough that the int32 add cannot overflow.
PAIR_DROP_OFF = jnp.int32(2 ** 30)


def _pair_prefix_tables(sorted_keys, starts, counts, ovf_ids,
                        k1: int, k2: int, budget: int, inv_perm=None):
    """Map each sorted-pair position p < budget to its dense-frame row.

    Within tile t's run [s_t, s_{t+1}) of the sorted keys, the frame row is
    p plus a per-segment constant (f(t) = the tile's frame row — t itself,
    or ``inv_perm[t]`` under occupancy sorting):

      slots [0, k1):        row = f(t)*k1 + (p - s_t)         -> p + offA_t
      slots [k1, k1+k2):    row = T*k1 + j*k2 + (p - s_t - k1)
                            (j = position in the overflow list; tiles not
                            in the list drop these pairs)  -> p + offB_t
      slots beyond k1+k2, pairs past the budget, invalid keys: dropped.

    The offset is therefore a step function of p whose breakpoints are the
    <= 3 segment starts of each tile — built with [T]-sized delta scatters
    and ONE cumsum over [budget], with no per-pair gathers. Deltas
    telescope, so
    coincident breakpoints (empty tiles) and non-monotonic offsets are both
    handled by plain scatter-add.
    """
    T = counts.shape[0]
    t2 = ovf_ids.shape[0]
    s = starts[:-1].astype(jnp.int32)                         # [T]
    total = starts[-1].astype(jnp.int32)
    B = budget

    tt = jnp.arange(T, dtype=jnp.int32)
    frame_of = tt if inv_perm is None else inv_perm
    off_a = frame_of * k1 - s
    if inv_perm is None:
        ovf_pos = jnp.full((T,), -1, jnp.int32).at[ovf_ids].set(
            jnp.arange(t2, dtype=jnp.int32), mode="drop")
        has_ovf = ovf_pos >= 0
    else:
        # occupancy sort: overflow list = frame rows [0, t2)
        has_ovf = frame_of < t2
        ovf_pos = jnp.where(has_ovf, frame_of, -1)
    off_b = jnp.where(has_ovf, T * k1 + ovf_pos * k2 - k1 - s,
                      PAIR_DROP_OFF)

    # final offset value of each tile's run (what the next tile's delta
    # telescopes against); the offset array implicitly starts at 0
    endv = jnp.where(counts <= k1, off_a,
                     jnp.where(~has_ovf, PAIR_DROP_OFF,
                               jnp.where(counts <= k1 + k2, off_b,
                                         PAIR_DROP_OFF)))
    prev_end = jnp.concatenate([jnp.zeros((1,), jnp.int32), endv[:-1]])

    pos1, d1 = s, off_a - prev_end
    pos2 = jnp.where(counts > k1, s + k1, B)                  # B -> dropped
    d2 = off_b - off_a
    pos3 = jnp.where(has_ovf & (counts > k1 + k2), s + k1 + k2, B)
    d3 = PAIR_DROP_OFF - off_b
    pos_f = total[None]                                       # pairs end
    d_f = (PAIR_DROP_OFF - endv[-1])[None]

    deltas = jnp.zeros((B,), jnp.int32).at[
        jnp.concatenate([pos1, pos2, pos3, pos_f])].add(
        jnp.concatenate([d1, d2, d3, d_f]), mode="drop")
    offsets = jnp.cumsum(deltas)

    keys = sorted_keys
    if keys.shape[0] < B:
        keys = jnp.pad(keys, (0, B - keys.shape[0]),
                       constant_values=2 ** 31 - 1)
    pk = jax.lax.slice_in_dim(keys, 0, B)
    pair_rows = jnp.arange(B, dtype=jnp.int32) + offsets
    pair_ranks = pk & RANK_MASK
    return pair_rows, pair_ranks, total


class PairBins(NamedTuple):
    """Frame-ordered pair tables for the segmented pair compositor
    (ops/segpair.py).

    The budget-B prefix of the fused-key sort is laid out again by frame
    row, where frame rows order tiles by descending kept run length, so
    every tile's composited pairs are one contiguous depth-ordered run of
    the pair stream and zero-length runs come last.

    Single-level semantics: every tile composites min(count, cap) pairs —
    strictly more complete than the two-level k1/t2/k2 truncation.
    """
    pair_ranks: jnp.ndarray   # [B] int32 depth rank of resorted pair p
    pair_valid: jnp.ndarray   # [B] bool (real pair, in budget, slot<cap)
    s_f: jnp.ndarray          # [T+1] int32 run start of frame row fr
    counts_f: jnp.ndarray     # [T] int32 composited pairs in FRAME order
    perm: jnp.ndarray         # [T] int32 frame row -> original tile id
    order: jnp.ndarray        # [N] int32 rank -> gaussian id
    counts: jnp.ndarray       # [T] int32 true occupancy (tile order)
    num_pairs: jnp.ndarray    # scalar int32 true pair count (audit vs B)
    num_truncated: jnp.ndarray


def step_over_pairs(pos: jnp.ndarray, vals: jnp.ndarray, budget: int,
                    dtype=jnp.float32) -> jnp.ndarray:
    """Stepwise-constant [budget] array: value ``vals[i]`` on
    [pos[i], pos[i+1]); 0 before pos[0] and after pos[len(vals)].

    Built with one [T]-sized delta scatter + one cumsum — no per-pair
    gathers. Coincident positions telescope.
    """
    vals = vals.astype(dtype)
    prev = jnp.concatenate([jnp.zeros((1,), dtype), vals])
    deltas = jnp.concatenate([vals, jnp.zeros((1,), dtype)]) - prev
    out = jnp.zeros((budget,), dtype).at[
        jnp.clip(pos, 0, budget)].add(deltas, mode="drop")
    return jnp.cumsum(out)


@functools.partial(jax.jit, static_argnames=(
    "width", "height", "tile_size", "cap", "budget",
    "max_tiles_per_gaussian"))
def bin_pairs_frame_order(proj: ProjectedGaussians, width: int,
                          height: int, tile_size: int, cap: int,
                          budget: int,
                          max_tiles_per_gaussian: int = MAX_TILES_PER_GAUSSIAN
                          ) -> PairBins:
    """Bin into frame-ordered pair runs (see :class:`PairBins`).

    The resorted stream is computed from the fused-key sort's outputs
    without a second sort: per-tile kept counts + cumsum give the run
    starts, a step function over the resorted index maps each position
    back to its sort-1 position, and one [budget] row-gather decodes the
    ranks. A pair at resorted position q in frame row fr sits at sort-1
    position s[perm[fr]] + (q - s_f[fr]). Per-tile kept counts replicate
    the prefix-budget semantics exactly: position p of tile t survives iff
    p < budget (prefix slice), p - s_t < cap (slot filter) and
    p - s_t < counts_t (real pair).
    """
    T = tile_grid(width, height, tile_size)[2]
    n = proj.depths.shape[0]
    sorted_keys, starts, counts, order, num_trunc = _sort_pairs(
        proj, width, height, tile_size, max_tiles_per_gaussian)
    total = starts[-1].astype(jnp.int32)

    s = starts[:-1].astype(jnp.int32)
    kept = jnp.minimum(jnp.minimum(counts, cap),
                       jnp.clip(budget - s, 0, None))
    # Frame rows ordered by descending KEPT run length — not raw
    # occupancy: under budget overflow a high-count tile whose sort-1 run
    # starts at s >= budget keeps zero pairs, and must sort with the other
    # empty rows at the end.
    _, perm = jax.lax.sort_key_val(-kept, jnp.arange(T, dtype=jnp.int32))
    kept_f = kept[perm]
    s_f = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                           jnp.cumsum(kept_f)])
    qq = jnp.arange(budget, dtype=jnp.int32)
    in_pos = qq + step_over_pairs(s_f, s[perm] - s_f[:-1], budget,
                                  jnp.int32)
    ranks_out = _decode_ranks(sorted_keys, in_pos[None, :], n)[0]
    pair_valid = qq < s_f[-1]
    return PairBins(
        pair_ranks=ranks_out, pair_valid=pair_valid,
        s_f=s_f, counts_f=kept_f, perm=perm, order=order,
        counts=counts, num_pairs=total, num_truncated=num_trunc)


def _tile_run_starts(sorted_keys: jnp.ndarray, num_tiles: int
                     ) -> jnp.ndarray:
    """[T+1] run starts of tile-prefix boundaries in a fused-key sort.

    Replaces ``jnp.searchsorted(sorted_keys, boundaries)``, which XLA
    lowers as a log2(len)-deep bisection loop of [T+1] scalar gathers.
    Because our boundaries are exactly the dense tile prefixes ``t << RANK_BITS``,
    the search collapses to exact arithmetic:

    1. downsample every ``stride``-th key; a [T]-histogram + cumsum of
       their tile ids gives, per boundary, how many downsampled keys
       precede it — which brackets its position to one stride-sized,
       row-aligned window,
    2. one [T+1, stride/8] 8-wide ROW gather fetches each boundary's
       window; counting window keys < boundary finishes the search.

    No bisection iterations, no scalar gathers; exact for any key
    distribution (sentinels included — they sort to the tail and only
    ever land in the histogram's overflow bucket).
    """
    stride = 128
    nk = sorted_keys.shape[0]
    pad = (-nk) % stride
    keys_p = jnp.pad(sorted_keys, (0, pad),
                     constant_values=2 ** 31 - 1) if pad else sorted_keys
    ds = keys_p[::stride]
    tds = jnp.clip(ds >> RANK_BITS, 0, num_tiles)
    hist = jnp.zeros((num_tiles + 1,), jnp.int32).at[tds].add(
        1, mode="drop")
    h = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                         jnp.cumsum(hist)])[:num_tiles + 1]
    w0 = jnp.maximum(h - 1, 0) * stride
    rows = (w0 // 8)[:, None] + jnp.arange(stride // 8,
                                           dtype=jnp.int32)[None, :]
    window = keys_p.reshape(-1, 8)[rows]             # [T+1, 16, 8]
    b = (jnp.arange(num_tiles + 1, dtype=jnp.int32) << RANK_BITS)
    lt = jnp.sum((window < b[:, None, None]).astype(jnp.int32),
                 axis=(1, 2))
    return w0 + lt


def _sort_pairs(proj: ProjectedGaussians, width: int, height: int,
                tile_size: int, m: int):
    """Expand Gaussians into (tile, depth-rank) pairs and sort by fused key.

    Returns (sorted_keys [N*M, 8-padded], starts [T+1], counts [T],
    order [N], num_truncated scalar)."""
    n = proj.depths.shape[0]
    ntx, nty, num_tiles = tile_grid(width, height, tile_size)
    if num_tiles << RANK_BITS >= 2 ** 31:
        raise ValueError(
            f"{num_tiles} tiles overflow the int32 fused sort key; "
            "raise tile_size or shard the image")
    if n > (1 << RANK_BITS):
        raise ValueError(f"{n} Gaussians exceed the {1 << RANK_BITS} "
                         "rank capacity of the fused sort key")

    # global depth-ascending order, invalid entries last
    order = jnp.argsort(jnp.where(proj.valid, proj.depths, jnp.inf))
    m2d = proj.means2d[order]
    radii = proj.radii[order].astype(jnp.float32)
    valid = proj.valid[order]

    inv_ts = 1.0 / tile_size
    tx0 = jnp.clip(jnp.floor((m2d[:, 0] - radii) * inv_ts), 0, ntx)
    tx1 = jnp.clip(jnp.ceil((m2d[:, 0] + radii) * inv_ts), 0, ntx)
    ty0 = jnp.clip(jnp.floor((m2d[:, 1] - radii) * inv_ts), 0, nty)
    ty1 = jnp.clip(jnp.ceil((m2d[:, 1] + radii) * inv_ts), 0, nty)
    tx0 = tx0.astype(jnp.int32); tx1 = tx1.astype(jnp.int32)
    ty0 = ty0.astype(jnp.int32); ty1 = ty1.astype(jnp.int32)
    span_x = jnp.maximum(tx1 - tx0, 0)
    span_y = jnp.maximum(ty1 - ty0, 0)

    # expand to [N, M] candidate tiles (row-major within the span box)
    mm = jnp.arange(m, dtype=jnp.int32)[None, :]
    sx = jnp.maximum(span_x, 1)[:, None]
    tx = tx0[:, None] + mm % sx
    ty = ty0[:, None] + mm // sx
    pair_valid = (valid[:, None] & (mm < (span_x * span_y)[:, None])
                  & (ty < nty))
    tile_id = ty * ntx + tx
    rank = jnp.arange(n, dtype=jnp.int32)[:, None]
    keys = jnp.where(pair_valid, (tile_id << RANK_BITS) | rank,
                     jnp.int32(2 ** 31 - 1))

    sorted_keys = jax.lax.sort(keys.reshape(-1))                  # [N*M]
    pad8 = (-sorted_keys.shape[0]) % 8
    if pad8:   # the row-gather decode reads 8-wide rows
        sorted_keys = jnp.pad(sorted_keys, (0, pad8),
                              constant_values=2 ** 31 - 1)

    # per-tile run boundaries (histogram-bracketed exact search — see
    # _tile_run_starts)
    starts = _tile_run_starts(sorted_keys, num_tiles)             # [T+1]
    counts = (starts[1:] - starts[:-1]).astype(jnp.int32)
    num_trunc = jnp.sum((valid & (span_x * span_y > m)).astype(jnp.int32))
    return (sorted_keys, starts, counts, order.astype(jnp.int32),
            num_trunc)


def _decode_ranks(sorted_keys: jnp.ndarray, gidx: jnp.ndarray,
                  n: int) -> jnp.ndarray:
    """Decode depth ranks at flat sorted-pair positions ``gidx``.

    Fetches 8-wide rows and selects the lane with a one-hot reduction
    instead of a scalar gather.
    """
    gidx = jnp.clip(gidx, 0, sorted_keys.shape[0] - 1)
    skeys_2d = sorted_keys.reshape(-1, 8)
    rows = skeys_2d[gidx >> 3]                                    # [...,8]
    onehot = (jnp.arange(8, dtype=jnp.int32)[None, None, :]
              == (gidx & 7)[..., None])
    entry = jnp.sum(jnp.where(onehot, rows, 0), axis=-1)
    return jnp.clip(entry & RANK_MASK, 0, max(n - 1, 0)).astype(jnp.int32)


def tile_origins(width: int, height: int, tile_size: int) -> jnp.ndarray:
    """[T,2] pixel coordinates of each tile's top-left corner."""
    ntx, nty, _ = tile_grid(width, height, tile_size)
    t = jnp.arange(ntx * nty, dtype=jnp.int32)
    return jnp.stack([(t % ntx) * tile_size, (t // ntx) * tile_size],
                     axis=-1).astype(jnp.float32)


def pixel_basis(tile_size: int) -> jnp.ndarray:
    """[NUM_FEATURES, P] per-pixel monomial basis in tile-local coordinates.

    Pixel centers at (col + 0.5, row + 0.5), row-major flattening.
    """
    r = jnp.arange(tile_size, dtype=jnp.float32)
    py, px = jnp.meshgrid(r + 0.5, r + 0.5, indexing="ij")
    px = px.reshape(-1)
    py = py.reshape(-1)
    zeros = jnp.zeros_like(px)
    return jnp.stack([px * px, px * py, py * py, px, py,
                      jnp.ones_like(px), zeros, zeros], axis=0)


def pack_gaussian_render_data(proj: ProjectedGaussians) -> jnp.ndarray:
    """Pack per-Gaussian screen data into one [N,8] row matrix.

    Columns: (a, b, c, mx, my, log_opacity, validf, 0). A single packed
    array turns the per-tile gather into ONE row gather instead of four.
    """
    logop = jnp.log(jnp.maximum(proj.opacities, 1e-12))
    return jnp.stack([
        proj.conics[:, 0], proj.conics[:, 1], proj.conics[:, 2],
        proj.means2d[:, 0], proj.means2d[:, 1], logop,
        proj.valid.astype(jnp.float32),
        jnp.zeros_like(logop)], axis=-1)


def build_tile_features(gathered: jnp.ndarray,     # [T,K,8] packed rows
                        origins: jnp.ndarray,      # [T,2]
                        slot_validf: jnp.ndarray,  # [T,K] 0/1 slot validity
                        ) -> jnp.ndarray:
    """Per-(tile, Gaussian) matmul features G (see module docstring).

    Slot layout: [0..4] = quadratic/linear conic terms, [5] = constant term
    (center quadform + log opacity; forced to -1e30 for invalid slots so
    their alpha underflows to exactly 0 and no masking is needed downstream),
    [6] = log opacity against a zero basis row (extracted inside the
    compositor for the sigma>=0 numerical guard), [7] = padding.
    """
    a = gathered[..., 0]
    b = gathered[..., 1]
    c = gathered[..., 2]
    mx = gathered[..., 3] - origins[:, None, 0]
    my = gathered[..., 4] - origins[:, None, 1]
    logop_g = gathered[..., 5]
    validf = slot_validf * gathered[..., 6]
    amx_bmy = a * mx + b * my
    bmx_cmy = b * mx + c * my
    const = -(0.5) * (amx_bmy * mx + bmx_cmy * my) + logop_g
    const = jnp.where(validf > 0, const, -1e30)
    zeros = jnp.zeros_like(mx)
    return jnp.stack([-0.5 * a, -b, -0.5 * c, amx_bmy, bmx_cmy, const,
                      logop_g, zeros], axis=-1)


def build_pair_features(src8: jnp.ndarray, ox: jnp.ndarray,
                        oy: jnp.ndarray) -> jnp.ndarray:
    """[B,8] packed rows + per-pair tile origins -> [B,8] features.

    Same G-row layout as :func:`build_tile_features` (slot 6 carries the
    log opacity for the sigma guard), per PAIR instead of per frame slot;
    validity is the compositor's business (pairs outside every run are
    never composited).
    """
    a, b, c = src8[:, 0], src8[:, 1], src8[:, 2]
    mx = src8[:, 3] - ox
    my = src8[:, 4] - oy
    lo = src8[:, 5]
    amx_bmy = a * mx + b * my
    bmx_cmy = b * mx + c * my
    const = -0.5 * (amx_bmy * mx + bmx_cmy * my) + lo
    z = jnp.zeros_like(a)
    return jnp.stack([-0.5 * a, -b, -0.5 * c, amx_bmy, bmx_cmy, const,
                      lo, z], axis=-1)


def scatter_rows(idx: jnp.ndarray, rows: jnp.ndarray, n: int) -> jnp.ndarray:
    """Accumulate ``rows`` [R,C] into ``[n,C]`` at row indices ``idx``
    (indices >= n are dropped)."""
    return jnp.zeros((n, rows.shape[1]), dtype=rows.dtype).at[idx].add(
        rows, mode="drop")


def assemble_image(tile_images: jnp.ndarray, width: int, height: int,
                   tile_size: int) -> jnp.ndarray:
    """[T,P] tile pixels -> [H,W] image (cropping any right/bottom padding)."""
    ntx, nty, _ = tile_grid(width, height, tile_size)
    img = tile_images.reshape(nty, ntx, tile_size, tile_size)
    img = img.transpose(0, 2, 1, 3).reshape(nty * tile_size, ntx * tile_size)
    return img[:height, :width]
