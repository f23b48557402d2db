"""Op-level trace of the tile-band-sharded render step on the real chip.

VERDICT r2 item 4 asks for committed profile evidence of the sharded
step (a 1-device mesh still shows the compiled program's op schedule;
collectives are no-ops at d=1 but the shard_map program structure is the
one that runs on a slice). Traces `make_sharded_proj_grad_fn` for a few
steps with jax.profiler, then parses the xplane proto with
tensorboard_plugin_profile into a top-op table for docs/SCALING.md.

Usage (GPU):
    python scripts/profile_sharded_trace.py [--out /tmp/shard_trace]
"""

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, "/root/repo")

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/shard_trace")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from edgegaussians_tpu.config import load_config
    from edgegaussians_tpu.parallel import train_sharded

    cfg = load_config("configs/ABC_DexiNed.json")
    d = np.load("bench_fixture/abc_00004926.npz")
    W, H = int(d["width"]), int(d["height"])
    from edgegaussians_tpu.ops.rasterize import resolve_backend
    backend = resolve_backend("auto")

    from edgegaussians_tpu.models.gaussians import GaussianParams
    n = d["means"].shape[0]
    params = GaussianParams(
        means=jnp.asarray(d["means"]),
        scales=jnp.asarray(np.log(d["scales"])),
        quats=jnp.asarray(d["quats"]),
        opacities=jnp.asarray(
            np.log(d["opacities"].reshape(-1, 1)
                   / (1 - d["opacities"].reshape(-1, 1)))))
    alive = jnp.ones((n,), bool)
    vm, K = jnp.asarray(d["viewmats"][0]), jnp.asarray(d["Ks"][0])
    gt = jnp.zeros((H, W), jnp.float32)
    em = gt > 0.5
    key = jax.random.PRNGKey(0)

    mesh = Mesh(np.array(jax.devices()[:1]), ("tiles",))
    fn = jax.jit(train_sharded.make_sharded_proj_grad_fn(
        cfg, W, H, backend, mesh))

    def run():
        return fn(params, alive, vm, K, gt, em, jnp.int32(0),
                  jnp.float32(1.0), key)

    out = run()
    jax.block_until_ready(out[0])
    os.makedirs(args.out, exist_ok=True)
    with jax.profiler.trace(args.out):
        for _ in range(args.steps):
            out = run()
        jax.block_until_ready(out[0])

    xplanes = glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                        recursive=True)
    print(f"trace written; xplane files: {xplanes}")
    if not xplanes:
        return
    try:
        from tensorboard_plugin_profile.convert import raw_to_tool_data
        data, _ = raw_to_tool_data.xspace_to_tool_data(
            [xplanes[-1]], "framework_op_stats", {})
        stats = json.loads(data) if isinstance(data, (str, bytes)) else data
        print(json.dumps(stats, indent=1)[:4000])
    except Exception as e:
        print(f"op-stats conversion failed ({e}); falling back to "
              "trace_viewer json sizes only")


if __name__ == "__main__":
    main()
