"""Brute-force k-nearest-neighbors in JAX (device-resident, jit-safe).

Replaces the reference's sklearn NearestNeighbors round trip
(edge_gs.py:135-151: GPU -> CPU -> sklearn kd-tree -> GPU, every 5 training
steps — SURVEY.md flags it as the known sore point). At the N ~ 1e4-1e5 scale
of this workload an O(N^2) masked distance sweep is a few Gflop and stays
on-device inside the jitted train step.

Distances are computed chunked via the |x|^2 + |y|^2 - 2 x.y expansion so the
pairwise term is a single [chunk,3] @ [3,N] matmul.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# approx_max_k recall target of the direction-loss neighbours: 0.95 was
# quality-neutral against 0.99 over three production training seeds
# (docs/RESULTS.md). On the GPU and the CPU approx_max_k lowers to an exact
# top-k, so there the value changes nothing.
APPROX_RECALL = 0.95


def knn(points: jnp.ndarray,            # [N,3]
        k: int,
        mask: jnp.ndarray | None = None,  # [N] bool; False rows excluded
        chunk: int = 1024,
        approx: bool = False):
    """k nearest neighbors of every point among the masked points.

    Returns (distances [N,k], indices [N,k]), self excluded — matching the
    reference's `k_nearest_sklearn` contract (edge_gs.py:135-151). Masked-out
    query rows return garbage neighbors (their mask should gate downstream
    use). NaN coordinates are treated as 0, mirroring the reference's NaN
    guard (edge_gs.py:330-333).

    ``approx=True`` uses ``jax.lax.approx_max_k`` (recall target
    APPROX_RECALL) — appropriate for the direction-loss neighbors where
    exactness is immaterial; exact top-k (the default) matches sklearn
    and is used everywhere correctness-sensitive.
    """
    return _knn_xla(points, k, mask, chunk, approx, APPROX_RECALL)


@functools.partial(jax.jit,
                   static_argnames=("k", "chunk", "approx", "recall"))
def _knn_xla(points, k, mask=None, chunk=1024, approx=False,
             recall=0.95):
    n = points.shape[0]
    pts = jnp.nan_to_num(points.astype(jnp.float32))
    if mask is None:
        mask = jnp.ones((n,), dtype=bool)

    sq = jnp.sum(pts * pts, axis=-1)                     # [N]
    big = jnp.float32(jnp.finfo(jnp.float32).max)

    pad = (-n) % chunk
    pts_p = jnp.pad(pts, ((0, pad), (0, 0)))
    n_chunks = (n + pad) // chunk
    row_ids = jnp.arange(n + pad, dtype=jnp.int32).reshape(n_chunks, chunk)

    def chunk_fn(args):
        q, qids = args                                   # [C,3], [C]
        d2 = (jnp.sum(q * q, axis=-1)[:, None] + sq[None, :]
              - 2.0 * jnp.matmul(q, pts.T,
                                 precision=jax.lax.Precision.HIGHEST))
        # exclude self and dead slots
        d2 = jnp.where(mask[None, :], d2, big)
        self_mask = qids[:, None] == jnp.arange(n, dtype=jnp.int32)[None, :]
        d2 = jnp.where(self_mask, big, d2)
        if approx:
            neg_d2, idx = jax.lax.approx_max_k(-d2, k,
                                               recall_target=recall)
        else:
            neg_d2, idx = jax.lax.top_k(-d2, k)
        return jnp.sqrt(jnp.maximum(-neg_d2, 0.0)), idx

    dists, idx = jax.lax.map(
        chunk_fn, (pts_p.reshape(n_chunks, chunk, 3), row_ids))
    return (dists.reshape(-1, k)[:n], idx.reshape(-1, k)[:n])
