"""Benchmark: differentiable edge-splat rasterization throughput on a GPU.

Times the training hot path — forward render + backward to all four
Gaussian parameter groups — and prints ONE JSON line naming the device.

Default workload: the trained 12740-Gaussian ABC-NEF model of scan
00004926 (shipped ABC_DexiNed config) rendered with the scan's own cameras
at 800x800, bundled as ``bench_fixture/abc_00004926.npz`` so the bench is
self-contained. ``--synthetic`` instead benches a uniform 20k-Gaussian
cloud — a much denser stress shape (~180 entries/tile vs ~10 for the real
scene).

The bench refuses to run without a GPU: a number from any other device is
not a measurement of this system. Usage:

    python bench.py [--synthetic] [--pair_kernel seg|0] [--blocks 5]
"""

import argparse
import json
import os
import subprocess
import time

import numpy as np

ITERS = 20     # steps per timed block

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "bench_fixture", "abc_00004926.npz")

# shipped ABC_DexiNed tile geometry (configs/ABC_DexiNed.json) on the
# segmented pair compositor; budget 49152 = 1.5x the fixture's 32788 pairs.
# --pair_kernel 0 selects the two-level dense-frame path.
ABC_TILES = dict(tile_size=16, capacity=768, dense_capacity=128,
                 overflow_tiles=128, max_tiles_per_gaussian=16,
                 pair_budget=49152, occupancy_sort=True,
                 pair_kernel="seg")
SYN_TILES = dict(tile_size=16, capacity=512, dense_capacity=128)


def synthetic_scene():
    import jax.numpy as jnp
    n, width, height = 20000, 800, 800
    r = np.random.default_rng(0)
    means = r.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    means[:, 2] += 2.0
    quats = r.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(r.uniform(np.log(0.003), np.log(0.03),
                              (n, 3))).astype(np.float32)
    opac = r.uniform(0.2, 0.95, n).astype(np.float32)
    f = 1111.0
    K = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                 np.float32)
    viewmats = np.eye(4, dtype=np.float32)[None]
    return (jnp.asarray(means), jnp.asarray(quats), jnp.asarray(scales),
            jnp.asarray(opac), jnp.asarray(viewmats),
            jnp.asarray(K[None]), width, height, SYN_TILES,
            "edge_splat_px_per_s_fwd_bwd_synthetic")


def fixture_scene():
    import jax.numpy as jnp
    d = np.load(FIXTURE)
    return (jnp.asarray(d["means"]), jnp.asarray(d["quats"]),
            jnp.asarray(d["scales"]),
            jnp.asarray(d["opacities"]).reshape(-1),
            jnp.asarray(d["viewmats"]), jnp.asarray(d["Ks"]),
            int(d["width"]), int(d["height"]), ABC_TILES,
            "edge_splat_px_per_s_fwd_bwd")


def device_info() -> dict:
    """Platform, kind and count of JAX's devices plus the card's name and
    power limit; raises unless the first device is a GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"bench.py needs a GPU; JAX's first device is "
                           f"{devs[0]!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card.strip().splitlines()[0]}


def summarize(block_ms) -> dict:
    """Median and spread of per-block times."""
    v = sorted(block_ms)
    return {"median_ms": v[len(v) // 2], "min_ms": v[0], "max_ms": v[-1],
            "blocks_ms": list(block_ms)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", action="store_true",
                    help="bench the dense synthetic cloud instead of the "
                         "trained ABC scene")
    ap.add_argument("--pair_kernel", type=str, default=None,
                    help="compositor: seg (segmented pair compositor) or 0 "
                         "(two-level dense-frame path)")
    ap.add_argument("--blocks", type=int, default=5)
    args = ap.parse_args(argv)

    device = device_info()
    import jax
    import jax.numpy as jnp

    from edgegaussians_tpu.ops.rasterize import rasterize, resolve_backend
    from edgegaussians_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    backend = resolve_backend("gpu")

    (means, quats, scales, opac, viewmats, Ks, width, height, tiles,
     metric) = synthetic_scene() if args.synthetic else fixture_scene()
    if args.pair_kernel is not None:
        tiles = dict(tiles, pair_kernel={"0": False}.get(
            args.pair_kernel, args.pair_kernel))
    target = jnp.zeros((height, width), jnp.float32)

    def loss_fn(m, q, s, o, viewmat, K):
        out = rasterize(m, q, s, o, viewmat, K, width, height,
                        backend=backend, **tiles)
        return jnp.mean(jnp.abs(jnp.clip(out.image, 0, 1) - target))

    step = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1, 2, 3)))
    n_views = viewmats.shape[0]
    t0 = time.perf_counter()
    for v in range(n_views):                      # compile + warm every view
        jax.block_until_ready(step(means, quats, scales, opac,
                                   viewmats[v], Ks[v]))
    warm_s = time.perf_counter() - t0

    blocks = []
    for _ in range(args.blocks):
        t0 = time.perf_counter()
        for i in range(ITERS):
            out = step(means, quats, scales, opac,
                       viewmats[i % n_views], Ks[i % n_views])
        jax.block_until_ready(out)
        blocks.append((time.perf_counter() - t0) / ITERS * 1e3)
    stats = summarize(blocks)
    print(json.dumps({"metric": metric,
                      "value": width * height / stats["median_ms"] * 1e3,
                      "unit": "px/s", "device": device, "backend": backend,
                      "pair_kernel": tiles.get("pair_kernel", False),
                      "compile_and_warmup_s": warm_s, **stats}))


if __name__ == "__main__":
    main()
