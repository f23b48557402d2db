"""EdgeGaussians in JAX: parametric 3D edge reconstruction via
edge-specialized Gaussian splatting.

Re-implements the full capability surface of kunalchelani/EdgeGaussians
(WACV 2025) as a brand-new JAX/XLA/Pallas framework:

- Differentiable tile-based Gaussian rasterization (a Pallas/Triton GPU
  compositor with a pure-JAX oracle), replacing the reference's external
  gsplat CUDA library
  (reference: edgegaussians/models/edge_gs.py:250-268).
- Functional, jit-compiled training with fixed-capacity masked Gaussian
  buffers, optax optimizers mirroring the reference's per-group schedules
  (reference: train_gaussians.py, edgegaussians/utils/train_utils.py).
- jit-safe adaptive density control (duplicate / cull as masked buffer ops;
  reference: edgegaussians/models/edge_gs.py:383-613).
- Multi-device scale-out via jax.sharding Mesh + shard_map (view, tile
  and Gaussian sharding; the reference is single-GPU only).
- CPU post-processing: filtering -> clustering -> parametric line/Bezier
  fitting -> evaluation, byte-compatible with the reference's PLY/JSON
  contracts (reference: fit_edges.py, eval.py).
"""

__version__ = "0.1.0"
