"""Camera models (host-side, NumPy).

Re-implements the reference camera semantics (reference:
edgegaussians/cameras/cameras.py) functionally: a camera is an immutable
record holding intrinsics K and a world-to-camera 4x4 view matrix. Batches of
cameras are stacked into arrays for device-side rendering — the render
path consumes ``Ks [V,3,3]`` and ``viewmats [V,4,4]``, never Python objects.

Conventions (matching the reference / COLMAP):
- quaternions are wxyz (reference: dataparsers.py:74 'w,x,y,z format'),
- viewmat = [[R | t], [0 0 0 1]] maps world -> camera,
- K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]].
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Sequence

import numpy as np


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """wxyz quaternion -> 3x3 rotation matrix (COLMAP convention).

    Matches the reference's qvec2rotmat
    (edgegaussians/utils/colmap_read_write_model.py:454-467).
    """
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ], dtype=np.float64)


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> wxyz quaternion (COLMAP convention).

    Matches edgegaussians/utils/colmap_read_write_model.py:469-479.
    """
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


@dataclass(frozen=True)
class Camera:
    """Pinhole camera with a world-to-camera pose.

    Constructors mirror the two reference camera classes:
    - :meth:`from_colmap` == ``Camera`` (cameras.py:64-101): wxyz quat + tvec,
      with an image-resolution scaling factor applied to intrinsics and size.
    - :meth:`from_opencv` == ``OpenCVCamera`` (cameras.py:103-140): K, R, t.
    """

    height: int
    width: int
    fx: float
    fy: float
    cx: float
    cy: float
    R: np.ndarray        # [3,3] world->camera rotation
    t: np.ndarray        # [3] world->camera translation

    @classmethod
    def from_colmap(cls, height, width, fx, fy, cx, cy, qvec, tvec,
                    scaling_factor: float = 1.0) -> "Camera":
        # ceil-rounding of the scaled size matches cameras.py:66-67
        return cls(
            height=int(math.ceil(height * scaling_factor)),
            width=int(math.ceil(width * scaling_factor)),
            fx=fx * scaling_factor, fy=fy * scaling_factor,
            cx=cx * scaling_factor, cy=cy * scaling_factor,
            R=qvec2rotmat(np.asarray(qvec, dtype=np.float64)),
            t=np.asarray(tvec, dtype=np.float64).reshape(3),
        )

    @classmethod
    def from_opencv(cls, height, width, K, R, t) -> "Camera":
        K = np.asarray(K, dtype=np.float64)
        return cls(
            height=int(height), width=int(width),
            fx=float(K[0, 0]), fy=float(K[1, 1]),
            cx=float(K[0, 2]), cy=float(K[1, 2]),
            R=np.asarray(R, dtype=np.float64).reshape(3, 3),
            t=np.asarray(t, dtype=np.float64).reshape(3),
        )

    @classmethod
    def from_camtoworld(cls, height, width, K, camtoworld) -> "Camera":
        """EMAP-style input: invert c2w -> w2c (dataparsers.py:110-118)."""
        c2w = np.asarray(camtoworld, dtype=np.float64)
        R_w2c = c2w[:3, :3].T
        t_w2c = -R_w2c @ c2w[:3, 3]
        return cls.from_opencv(height, width, K, R_w2c, t_w2c)

    @property
    def K(self) -> np.ndarray:
        return np.array([[self.fx, 0.0, self.cx],
                         [0.0, self.fy, self.cy],
                         [0.0, 0.0, 1.0]], dtype=np.float64)

    @property
    def viewmat(self) -> np.ndarray:
        vm = np.eye(4, dtype=np.float64)
        vm[:3, :3] = self.R
        vm[:3, 3] = self.t
        return vm

    @property
    def center(self) -> np.ndarray:
        """Camera center in world coordinates (-R^T t)."""
        return -self.R.T @ self.t

    def scale_translation(self, scaling_factor: float) -> "Camera":
        """Scene-unit rescale of the pose translation (cameras.py:24-27)."""
        return replace(self, t=self.t * scaling_factor)

    def rescale_resolution(self, scaling_factor: float,
                           rounding: str = "floor") -> "Camera":
        """Rescale output resolution (cameras.py:29-61)."""
        if rounding == "floor":
            h, w = int(self.height * scaling_factor), int(self.width * scaling_factor)
        elif rounding == "round":
            h = int(math.floor(0.5 + self.height * scaling_factor))
            w = int(math.floor(0.5 + self.width * scaling_factor))
        elif rounding == "ceil":
            h = int(math.ceil(self.height * scaling_factor))
            w = int(math.ceil(self.width * scaling_factor))
        else:
            raise ValueError("rounding must be 'floor', 'round' or 'ceil'")
        return replace(
            self, height=h, width=w,
            fx=self.fx * scaling_factor, fy=self.fy * scaling_factor,
            cx=self.cx * scaling_factor, cy=self.cy * scaling_factor)


def stack_cameras(cameras: Sequence[Camera]):
    """Stack cameras into (Ks [V,3,3] f32, viewmats [V,4,4] f32, H, W).

    All cameras must share a resolution — the batched render path keeps
    the pixel grid static per compile.
    """
    hs = {c.height for c in cameras}
    ws = {c.width for c in cameras}
    if len(hs) != 1 or len(ws) != 1:
        raise ValueError(f"cameras disagree on resolution: {hs}x{ws}")
    Ks = np.stack([c.K for c in cameras]).astype(np.float32)
    viewmats = np.stack([c.viewmat for c in cameras]).astype(np.float32)
    return Ks, viewmats, hs.pop(), ws.pop()


def max_pairwise_center_distance(cameras: Sequence[Camera]) -> float:
    """Scene scale from cameras: max pairwise camera-center distance
    (reference: data_utils.py:84-103)."""
    centers = np.stack([c.center for c in cameras])
    d = np.linalg.norm(centers[:, None, :] - centers[None, :, :], axis=-1)
    return float(d.max())
