"""Perspective (EWA) projection of 3D Gaussians to 2D screen-space conics.

Fully differentiable JAX implementation of the projection stage of the
tile-based rasterizer, matching the semantics of the gsplat 1.0 CUDA
projection the reference relies on (call contract at
edgegaussians/models/edge_gs.py:250-268: ``near_plane=0.01, far_plane=1e10,
rasterize_mode="antialiased"``):

- camera-space transform and frustum depth cull,
- perspective Jacobian with the standard 1.3x-tan-FOV clamp,
- 2D covariance = J W Sigma W^T J^T + eps2d * I (eps2d = 0.3 low-pass),
- "antialiased" opacity compensation sqrt(det(cov)/det(cov_blurred)),
- 3-sigma screen-space radius from the larger eigenvalue,
- conic (inverse 2D covariance) for pixel evaluation.

This stage is pure XLA (no Pallas): it is O(N) elementwise work that XLA
fuses well, and keeping it in JAX gives gradients to means/quats/scales/
opacities for free via autodiff.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from edgegaussians_tpu.ops.transforms import covariance6_from_quat_scale

# Screen-space low-pass filter added to every 2D covariance (gsplat's eps2d).
EPS2D = 0.3
# Frustum tangent clamp factor for the projection Jacobian.
TAN_CLAMP = 1.3
# Minimum alpha for a Gaussian-pixel contribution to count (gsplat: 1/255).
ALPHA_THRESHOLD = 1.0 / 255.0
# Alpha ceiling per contribution.
ALPHA_CLAMP = 0.999
# Transmittance floor below which compositing terminates.
TRANSMITTANCE_EPS = 1e-4
# Slack on the sigma >= 0 skip rule in the tile path. The tile compositors
# reconstruct sigma as (log opacity - log alpha), the difference of two
# nearly-equal dot products; at a Gaussian's center pixel the true value is
# exactly 0 and f32 accumulation-order noise (~1e-5; matmul and
# elementwise evaluation orders differ) would otherwise flip the comparison — toggling that pixel's alpha
# between 0 and full opacity between backends. The slack is far above the
# matmul noise and far below any visible alpha change (< 0.1%); the
# per-pixel oracle (rasterize_ref.py) computes sigma from the quadratic
# form directly and needs no slack, matching gsplat's formulation.
SIGMA_GUARD_EPS = 1e-3


class ProjectedGaussians(NamedTuple):
    """Screen-space Gaussians for one camera."""
    means2d: jnp.ndarray    # [N,2] pixel coords
    conics: jnp.ndarray     # [N,3] upper-triangular inverse 2D covariance (a,b,c)
    depths: jnp.ndarray     # [N] camera-space z
    radii: jnp.ndarray      # [N] int32 3-sigma pixel radius (0 = culled)
    opacities: jnp.ndarray  # [N] effective opacity (compensation folded in)
    valid: jnp.ndarray      # [N] bool


def project_gaussians(
    means: jnp.ndarray,        # [N,3]
    quats: jnp.ndarray,        # [N,4] wxyz (not necessarily normalized)
    scales: jnp.ndarray,       # [N,3] linear stddevs
    opacities: jnp.ndarray,    # [N] linear opacity in [0,1]
    viewmat: jnp.ndarray,      # [4,4] world->camera
    K: jnp.ndarray,            # [3,3] intrinsics
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    antialiased: bool = True,
    alive: jnp.ndarray | None = None,   # [N] bool capacity mask
) -> ProjectedGaussians:
    """Project N Gaussians into one camera; invalid entries get radius 0."""
    f32 = jnp.float32
    means = means.astype(f32)
    R_cw = viewmat[:3, :3].astype(f32)
    t_cw = viewmat[:3, 3].astype(f32)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    # camera-space means
    p_cam = jnp.matmul(means, R_cw.T,
                       precision=jax.lax.Precision.HIGHEST) + t_cw  # [N,3]
    x, y, z = p_cam[:, 0], p_cam[:, 1], p_cam[:, 2]
    in_depth = (z > near_plane) & (z < far_plane)
    zs = jnp.where(in_depth, z, 1.0)               # safe divisor

    # projected centers (pixel coordinates)
    mx = fx * x / zs + cx
    my = fy * y / zs + cy
    means2d = jnp.stack([mx, my], axis=-1)

    # world covariance -> camera covariance, in scalar components: R_cw
    # entries are scalars, so Sigma_c = R Sigma R^T is 2 static 3x3
    # expansions of [N]-vector elementwise math — exact f32, no
    # reduced-precision matmul and no [N,3,3] relayouts.
    w00, w01, w02, w11, w12, w22 = covariance6_from_quat_scale(
        quats, scales.astype(f32))
    sigma_w = [[w00, w01, w02], [w01, w11, w12], [w02, w12, w22]]
    r = [[R_cw[i, k] for k in range(3)] for i in range(3)]
    # M = R Sigma  (3x3 of [N])
    M = [[r[i][0] * sigma_w[0][j] + r[i][1] * sigma_w[1][j]
          + r[i][2] * sigma_w[2][j] for j in range(3)] for i in range(3)]

    def sig_c(i, j):
        return M[i][0] * r[j][0] + M[i][1] * r[j][1] + M[i][2] * r[j][2]

    # perspective Jacobian with tan clamp (frustum-limited EWA)
    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x = TAN_CLAMP * tan_fovx
    lim_y = TAN_CLAMP * tan_fovy
    tx = zs * jnp.clip(x / zs, -lim_x, lim_x)
    ty = zs * jnp.clip(y / zs, -lim_y, lim_y)
    rz = 1.0 / zs
    rz2 = rz * rz
    # J = [[fx/z, 0, -fx tx/z^2], [0, fy/z, -fy ty/z^2]]
    j00 = fx * rz
    j02 = -fx * tx * rz2
    j11 = fy * rz
    j12 = -fy * ty * rz2

    # cov2d = J sigma_c J^T, expanded to avoid [N,2,3] temporaries
    s00 = sig_c(0, 0); s01 = sig_c(0, 1); s02 = sig_c(0, 2)
    s11 = sig_c(1, 1); s12 = sig_c(1, 2); s22 = sig_c(2, 2)
    c00 = j00 * (j00 * s00 + j02 * s02) + j02 * (j00 * s02 + j02 * s22)
    c01 = j00 * (j11 * s01 + j12 * s02) + j02 * (j11 * s12 + j12 * s22)
    c11 = j11 * (j11 * s11 + j12 * s12) + j12 * (j11 * s12 + j12 * s22)

    det_orig = c00 * c11 - c01 * c01
    b00 = c00 + EPS2D
    b11 = c11 + EPS2D
    det_blur = b00 * b11 - c01 * c01

    # antialiased opacity compensation (gsplat calc_compensations)
    compensation = jnp.sqrt(jnp.maximum(det_orig / det_blur, 0.0))

    det_safe = jnp.where(det_blur > 0, det_blur, 1.0)
    inv_det = 1.0 / det_safe
    conic_a = b11 * inv_det
    conic_b = -c01 * inv_det
    conic_c = b00 * inv_det
    conics = jnp.stack([conic_a, conic_b, conic_c], axis=-1)

    # 3-sigma radius from the larger eigenvalue of the blurred covariance
    mid = 0.5 * (b00 + b11)
    v1 = mid + jnp.sqrt(jnp.maximum(mid * mid - det_blur, 0.01))
    radius_f = jnp.ceil(3.0 * jnp.sqrt(v1))

    opac = opacities.astype(f32)
    if antialiased:
        opac = opac * compensation

    valid = in_depth & (det_blur > 0)
    # cull Gaussians whose 3-sigma box misses the image entirely
    valid &= (mx + radius_f > 0) & (mx - radius_f < width) \
        & (my + radius_f > 0) & (my - radius_f < height)
    if alive is not None:
        valid &= alive

    radii = jnp.where(valid, radius_f, 0.0).astype(jnp.int32)
    return ProjectedGaussians(
        means2d=means2d, conics=conics, depths=z,
        radii=radii, opacities=opac, valid=valid)
