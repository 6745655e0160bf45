"""Pinhole camera model with radial-tangential distortion (batched jnp).

JAX replacement for the reference's scattered intrinsics handling:
hardcoded fx/fy/cx/cy + 5 distortion coefficients in Tracking
(jni/ORB_SLAM2/src/Tracking.cc:76-105) plus OpenCV's ``undistortPoints``
(jni/ORB_SLAM2/src/Frame.cc:529-559) and the per-frame projection math
replicated across Frame::isInFrustum / ORBmatcher / Optimizer. Here it is a
single immutable struct with batched project/unproject/undistort ops.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils import struct


@struct.dataclass
class Camera:
    """Pinhole + radtan (k1, k2, p1, p2, k3) camera.

    All fields are scalars (0-d arrays) so the struct is a pytree that can be
    passed through jit with no retracing on value changes.
    """

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    k1: jnp.ndarray
    k2: jnp.ndarray
    p1: jnp.ndarray
    p2: jnp.ndarray
    k3: jnp.ndarray
    width: int = struct.field(static=True, default=640)
    height: int = struct.field(static=True, default=480)

    @classmethod
    def create(cls, fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
               width=640, height=480) -> "Camera":
        f = lambda v: jnp.asarray(v, dtype=jnp.float32)
        return cls(fx=f(fx), fy=f(fy), cx=f(cx), cy=f(cy), k1=f(k1), k2=f(k2),
                   p1=f(p1), p2=f(p2), k3=f(k3), width=int(width), height=int(height))

    @property
    def K(self) -> jnp.ndarray:
        one = jnp.ones_like(self.fx)
        zero = jnp.zeros_like(self.fx)
        return jnp.stack([
            jnp.stack([self.fx, zero, self.cx]),
            jnp.stack([zero, self.fy, self.cy]),
            jnp.stack([zero, zero, one]),
        ])

    def distort_normalized(self, xn: jnp.ndarray) -> jnp.ndarray:
        """Apply radtan distortion to normalized coords (..., 2)."""
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
        xd = x * radial + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        yd = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return jnp.stack([xd, yd], axis=-1)

    def project(self, X_cam: jnp.ndarray, distort: bool = False) -> jnp.ndarray:
        """Camera-frame 3D points (..., 3) -> pixel coords (..., 2).

        By default projects with the *undistorted* (rectified) model, which is
        the convention the reference uses everywhere after keypoint
        undistortion (all reprojection errors are in rectified pixels).
        """
        z = X_cam[..., 2]
        z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        xn = X_cam[..., :2] / z_safe[..., None]
        if distort:
            xn = self.distort_normalized(xn)
        u = self.fx * xn[..., 0] + self.cx
        v = self.fy * xn[..., 1] + self.cy
        return jnp.stack([u, v], axis=-1)

    def unproject(self, uv: jnp.ndarray, depth: jnp.ndarray) -> jnp.ndarray:
        """Rectified pixels (..., 2) + depth (...) -> camera-frame 3D (..., 3)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return jnp.stack([x * depth, y * depth, depth], axis=-1)

    def undistort_points(self, uv: jnp.ndarray, iters: int = 8) -> jnp.ndarray:
        """Distorted pixels (..., 2) -> rectified pixels (..., 2).

        Fixed-point iteration (the same scheme as OpenCV undistortPoints,
        fixed iteration count for jit). Replaces Frame::UndistortKeyPoints
        (jni/ORB_SLAM2/src/Frame.cc:529-559).
        """
        xd = (uv[..., 0] - self.cx) / self.fx
        yd = (uv[..., 1] - self.cy) / self.fy
        d = jnp.stack([xd, yd], axis=-1)
        x = d
        for _ in range(iters):
            # Invert: d = distort(x)  =>  x = (d - tangential(x)) / radial(x)
            xx, yy = x[..., 0], x[..., 1]
            r2 = xx * xx + yy * yy
            radial = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
            dx = 2.0 * self.p1 * xx * yy + self.p2 * (r2 + 2.0 * xx * xx)
            dy = self.p1 * (r2 + 2.0 * yy * yy) + 2.0 * self.p2 * xx * yy
            x = (d - jnp.stack([dx, dy], axis=-1)) / radial[..., None]
        u = self.fx * x[..., 0] + self.cx
        v = self.fy * x[..., 1] + self.cy
        return jnp.stack([u, v], axis=-1)

    def image_bounds(self) -> "jnp.ndarray":
        """Undistorted image bounds [min_x, max_x, min_y, max_y]
        (Frame::ComputeImageBounds, jni/ORB_SLAM2/src/Frame.cc:561-589):
        the four distorted-image corners mapped through the undistortion.
        With no distortion this is exactly [0, W, 0, H]. Used by every
        projection gate instead of the naive [0, 2cx]x[0, 2cy] box (which
        clips an edge band whenever cx != W/2)."""
        return undistorted_bounds(
            float(self.fx), float(self.fy), float(self.cx), float(self.cy),
            float(self.k1), float(self.k2), float(self.p1), float(self.p2),
            float(self.k3), self.width, self.height,
        )

    def in_image(self, uv: jnp.ndarray, margin: float = 0.0) -> jnp.ndarray:
        """Boolean mask for pixels inside the (rectified) image bounds."""
        return (
            (uv[..., 0] >= margin)
            & (uv[..., 0] < self.width - margin)
            & (uv[..., 1] >= margin)
            & (uv[..., 1] < self.height - margin)
        )


def undistorted_bounds(
    fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
    width=640, height=480,
):
    """Host-side Frame::ComputeImageBounds (src/Frame.cc:561-589): undistort
    the four image corners with the same fixed-point scheme as
    Camera.undistort_points and take the per-side extrema. Returns a numpy
    float32 (4,): [min_x, max_x, min_y, max_y]. Computed once per camera at
    session construction and baked into the traced programs."""
    import numpy as np

    if k1 == 0 and k2 == 0 and p1 == 0 and p2 == 0 and k3 == 0:
        return np.asarray([0.0, float(width), 0.0, float(height)], np.float32)
    corners = np.array(
        [[0, 0], [width, 0], [0, height], [width, height]], np.float64
    )
    xd = (corners[:, 0] - cx) / fx
    yd = (corners[:, 1] - cy) / fy
    x, y = xd.copy(), yd.copy()
    for _ in range(8):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    u = fx * x + cx
    v = fy * y + cy
    return np.asarray(
        [
            min(u[0], u[2]),   # mnMinX = min(topleft.x, bottomleft.x)
            max(u[1], u[3]),   # mnMaxX = max(topright.x, bottomright.x)
            min(v[0], v[1]),   # mnMinY = min(topleft.y, topright.y)
            max(v[2], v[3]),   # mnMaxY = max(bottomleft.y, bottomright.y)
        ],
        np.float32,
    )


def bounds_from_config(cam_cfg) -> "jnp.ndarray":
    """undistorted_bounds from a config.CameraConfig (static trace-time
    constant for programs whose cfg is a static jit argument)."""
    return undistorted_bounds(
        cam_cfg.fx, cam_cfg.fy, cam_cfg.cx, cam_cfg.cy,
        cam_cfg.k1, cam_cfg.k2, cam_cfg.p1, cam_cfg.p2, cam_cfg.k3,
        cam_cfg.width, cam_cfg.height,
    )


# The reference app's hardcoded Pixel-4 calibration
# (jni/ORB_SLAM2/src/Tracking.cc:76-105), kept as a ready-made config.
def pixel4_camera() -> Camera:
    return Camera.create(
        fx=526.69, fy=540.36, cx=313.07, cy=238.39,
        k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
        width=640, height=480,
    )
