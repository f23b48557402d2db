"""Quaternion / rotation utilities (JAX, batched, differentiable).

JAX counterparts of the reference's torch/numpy helpers
(reference: edgegaussians/utils/misc_utils.py:36-130). Quaternions are wxyz.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def normalize_quats(quats: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """L2-normalize [N,4] quaternions."""
    norm = jnp.linalg.norm(quats, axis=-1, keepdims=True)
    return quats / jnp.maximum(norm, eps)


def quats_to_rotmats(quats: jnp.ndarray) -> jnp.ndarray:
    """wxyz quaternions [N,4] -> rotation matrices [N,3,3].

    Matches quats_to_rotmats_tensor (misc_utils.py:53-94): inputs are
    normalized internally.
    """
    q = normalize_quats(quats)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack([
        jnp.stack([r00, r01, r02], axis=-1),
        jnp.stack([r10, r11, r12], axis=-1),
        jnp.stack([r20, r21, r22], axis=-1),
    ], axis=-2)


def major_directions(scales: jnp.ndarray, quats: jnp.ndarray) -> jnp.ndarray:
    """Unit direction of each Gaussian's largest principal axis.

    The major direction is the rotation-matrix column selected by the argmax
    of |scales| (reference: edge_gs.py:352-356, misc_utils.py:124-130).
    ``scales`` are linear (already exponentiated).

    The column select is a one-hot blend over vector arithmetic on the
    quaternion components — identical values and gradients to building
    [N,3,3] rotmats and take_along_axis, without rank-3 relayouts.
    """
    q = normalize_quats(quats)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    # columns of the rotation matrix (each [N, 3])
    col0 = jnp.stack([1 - 2 * (y * y + z * z),
                      2 * (x * y + w * z),
                      2 * (x * z - w * y)], axis=-1)
    col1 = jnp.stack([2 * (x * y - w * z),
                      1 - 2 * (x * x + z * z),
                      2 * (y * z + w * x)], axis=-1)
    col2 = jnp.stack([2 * (x * z + w * y),
                      2 * (y * z - w * x),
                      1 - 2 * (x * x + y * y)], axis=-1)
    amax = jnp.argmax(jnp.abs(scales), axis=-1)[:, None]    # [N,1]
    return jnp.where(amax == 0, col0,
                     jnp.where(amax == 1, col1, col2))


def rotmat_elements(quats: jnp.ndarray):
    """wxyz quaternions [N,4] -> the 9 rotation-matrix elements as a 3x3
    nested list of [N] arrays (row-major).

    Scalar-component form of :func:`quats_to_rotmats` for consumers that
    must avoid [N,3,3] tensors (ops that mix a size-3 minor dim compile to
    relayout code).
    """
    q = normalize_quats(quats)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]


def covariance6_from_quat_scale(quats: jnp.ndarray, scales: jnp.ndarray):
    """World covariance Sigma = R S S^T R^T as its 6 unique components.

    Returns (s00, s01, s02, s11, s12, s22), each [N] — the scalar-component
    counterpart of :func:`covariance_from_quat_scale` (no [N,3,3] tensors;
    pure VPU f32 arithmetic, exact).
    """
    r = rotmat_elements(quats)
    m = [[r[i][k] * scales[:, k] for k in range(3)] for i in range(3)]

    def dot(i, j):
        return m[i][0] * m[j][0] + m[i][1] * m[j][1] + m[i][2] * m[j][2]

    return dot(0, 0), dot(0, 1), dot(0, 2), dot(1, 1), dot(1, 2), dot(2, 2)


def covariance_from_quat_scale(quats: jnp.ndarray,
                               scales: jnp.ndarray) -> jnp.ndarray:
    """World-space 3x3 covariance Sigma = R S S^T R^T ([N,3,3]).

    ``scales`` are linear standard deviations along the principal axes —
    the 3DGS parameterization realized by the gsplat rasterizer the reference
    calls (edge_gs.py:250-268).
    """
    R = quats_to_rotmats(quats)                  # [N,3,3]
    M = R * scales[:, None, :]                   # R @ diag(s)
    # expanded M @ M^T (Sigma_ij = sum_k M[n,i,k] M[n,j,k]) elementwise: a
    # batched [3,3] matmul at default precision may run in TF32 or bf16;
    # elementwise f32 is exact here
    mi = [M[:, 0, :], M[:, 1, :], M[:, 2, :]]
    sig = [[jnp.sum(mi[i] * mi[j], axis=-1) for j in range(3)]
           for i in range(3)]
    return jnp.stack([jnp.stack(row, axis=-1) for row in sig], axis=-2)
