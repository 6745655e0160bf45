"""SE(3) rigid-transform operations in tangent space.

JAX replacement for the reference's mixture of ``cv::Mat`` 4x4 pose
matrices and g2o ``SE3Quat`` (reference: jni/ORB_SLAM2/src/Converter.cc:37-109,
jni/Thirdparty/g2o/g2o/types/se3quat.h). All ops are pure jnp, broadcast over
leading batch dimensions, and are safe under ``jax.jit``/``vmap``/``grad``.

Conventions
-----------
* A pose is a 4x4 homogeneous matrix ``T`` mapping world -> camera when named
  ``Tcw`` (same convention as the reference).
* Tangent vectors are 6-vectors ``[upsilon, omega]`` = [translation, rotation],
  matching g2o's SE3Quat::exp ordering used by the reference optimizer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(omega: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix of a 3-vector. Batched over leading dims."""
    zeros = jnp.zeros_like(omega[..., 0])
    return jnp.stack(
        [
            jnp.stack([zeros, -omega[..., 2], omega[..., 1]], axis=-1),
            jnp.stack([omega[..., 2], zeros, -omega[..., 0]], axis=-1),
            jnp.stack([-omega[..., 1], omega[..., 0], zeros], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(omega: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues rotation: 3-vector -> 3x3 rotation matrix (batched)."""
    theta2 = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # Stable small-angle coefficients via series fallback.
    a = jnp.where(theta2 > _EPS, jnp.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = jnp.where(
        theta2 > _EPS, (1.0 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0
    )
    K = hat(omega)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> 3-vector (batched). Stable near identity."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    vee = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    # ||vee|| = 2 sin(theta); atan2 is well-conditioned for all theta < pi
    # (unlike arccos, whose derivative blows up near 0 and pi). The epsilon
    # inside the sqrt keeps the gradient finite at exactly-identity rotations
    # (pose-graph residuals start there and are differentiated by jacfwd).
    sin_theta = 0.5 * jnp.sqrt(jnp.sum(vee * vee, axis=-1) + _EPS * _EPS)
    theta = jnp.arctan2(sin_theta, cos_theta)
    # theta / (2 sin theta), with series fallback near 0.
    scale = jnp.where(
        sin_theta > _EPS,
        theta / (2.0 * jnp.maximum(sin_theta, _EPS)),
        0.5 + theta * theta / 12.0,
    )
    # For theta near pi the vee formula degrades; acceptable for SLAM increments
    # (optimizer steps are small). Clamp to avoid NaN.
    return vee * scale[..., None]


def _left_jacobian(omega: jnp.ndarray) -> jnp.ndarray:
    """SO(3) left Jacobian V such that exp([u,w]) has translation V @ u."""
    theta2 = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    K = hat(omega)
    b = jnp.where(
        theta2 > _EPS, (1.0 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0
    )
    c = jnp.where(
        theta2 > _EPS,
        (theta - jnp.sin(theta)) / (theta2 * theta),
        1.0 / 6.0 - theta2 / 120.0,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), K.shape)
    return eye + b[..., None, None] * K + c[..., None, None] * (K @ K)


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """SE(3) exponential: 6-vector [upsilon, omega] -> 4x4 matrix (batched)."""
    upsilon = xi[..., :3]
    omega = xi[..., 3:]
    R = so3_exp(omega)
    V = _left_jacobian(omega)
    t = jnp.einsum("...ij,...j->...i", V, upsilon)
    return from_rt(R, t)


def log(T: jnp.ndarray) -> jnp.ndarray:
    """SE(3) logarithm: 4x4 matrix -> 6-vector [upsilon, omega] (batched)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    omega = so3_log(R)
    V = _left_jacobian(omega)
    upsilon = jnp.linalg.solve(V, t[..., None])[..., 0]
    return jnp.concatenate([upsilon, omega], axis=-1)


def from_rt(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Assemble 4x4 from rotation (…,3,3) and translation (…,3)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,)
    )
    return jnp.concatenate([top, bottom[..., None, :]], axis=-2)


def identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.eye(4, dtype=dtype)


def inv(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of a rigid transform (batched)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return from_rt(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    return A @ B


def apply(T: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """Transform points: (…,4,4) x (…,3) -> (…,3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return jnp.einsum("...ij,...j->...i", R, X) + t


def retract(T: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Left-multiplicative manifold update: exp(xi) @ T.

    Matches g2o's ``VertexSE3Expmap::oplusImpl`` (update applied on the left of
    the estimate), which the reference optimizer relies on
    (jni/ORB_SLAM2/src/Optimizer.cc:239-451).
    """
    return exp(xi) @ T


def orthonormalize(T: jnp.ndarray, iters: int = 2) -> jnp.ndarray:
    """Project the rotation block back onto SO(3) (batched).

    Newton–Schulz iteration R <- R (3I - R^T R) / 2, valid for small
    orthonormality defects. Needed because the per-frame velocity feedback
    ``v = T_k T_{k-1}^-1`` with a transpose-based inverse *doubles* any
    defect every frame — fp32 drift compounds exponentially without this.
    """
    R = T[..., :3, :3]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), R.shape)
    for _ in range(iters):
        R = 0.5 * R @ (3.0 * eye - jnp.swapaxes(R, -1, -2) @ R)
    return from_rt(R, T[..., :3, 3])


def quat_from_rot(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> unit quaternion [qx, qy, qz, qw] (batched).

    Shepperd's method with branch selection done by jnp.where so it is
    jit-safe. Output order matches the reference's TUM export
    (jni/ORB_SLAM2/src/System.cc:445-449: "x y z qx qy qz qw").
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate constructions; pick the numerically best via where-chains.
    qw0 = jnp.sqrt(jnp.maximum(1.0 + tr, _EPS)) * 0.5
    s0 = 0.25 / jnp.maximum(qw0, _EPS)
    cand0 = jnp.stack(
        [(m21 - m12) * s0, (m02 - m20) * s0, (m10 - m01) * s0, qw0], axis=-1
    )

    qx1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, _EPS)) * 0.5
    s1 = 0.25 / jnp.maximum(qx1, _EPS)
    cand1 = jnp.stack(
        [qx1, (m01 + m10) * s1, (m02 + m20) * s1, (m21 - m12) * s1], axis=-1
    )

    qy2 = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, _EPS)) * 0.5
    s2 = 0.25 / jnp.maximum(qy2, _EPS)
    cand2 = jnp.stack(
        [(m01 + m10) * s2, qy2, (m12 + m21) * s2, (m02 - m20) * s2], axis=-1
    )

    qz3 = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, _EPS)) * 0.5
    s3 = 0.25 / jnp.maximum(qz3, _EPS)
    cand3 = jnp.stack(
        [(m02 + m20) * s3, (m12 + m21) * s3, qz3, (m10 - m01) * s3], axis=-1
    )

    use0 = (tr > 0.0)[..., None]
    use1 = ((m00 > m11) & (m00 > m22))[..., None]
    use2 = (m11 > m22)[..., None]
    q = jnp.where(use0, cand0, jnp.where(use1, cand1, jnp.where(use2, cand2, cand3)))
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def rot_from_quat(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion [qx,qy,qz,qw] -> rotation matrix (batched)."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = jnp.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], axis=-1
    )
    row1 = jnp.stack(
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], axis=-1
    )
    row2 = jnp.stack(
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], axis=-1
    )
    return jnp.stack([row0, row1, row2], axis=-2)
