"""Epipolar geometry helpers: F/E from relative poses, epipolar distances.

JAX replacement for ``LocalMapping::ComputeF12``
(jni/ORB_SLAM2/src/LocalMapping.cc:590-607) and
``ORBmatcher::CheckDistEpipolarLine`` (jni/ORB_SLAM2/src/ORBmatcher.cc:142-159).
"""

from __future__ import annotations

import jax.numpy as jnp

from . import se3


def fundamental_from_poses(
    T1w: jnp.ndarray, T2w: jnp.ndarray, K1: jnp.ndarray, K2: jnp.ndarray
) -> jnp.ndarray:
    """F12 such that x1^T F12 x2 = 0 for corresponding rectified pixels.

    Same construction as the reference: relative pose 1<-2, essential
    E = [t]x R, then F = K1^-T E K2^-1 (jni/ORB_SLAM2/src/LocalMapping.cc:590).
    """
    R1w = T1w[..., :3, :3]
    t1w = T1w[..., :3, 3]
    R2w = T2w[..., :3, :3]
    t2w = T2w[..., :3, 3]
    R12 = R1w @ jnp.swapaxes(R2w, -1, -2)
    t12 = -jnp.einsum("...ij,...j->...i", R12, t2w) + t1w
    E = se3.hat(t12) @ R12
    K1_inv_T = jnp.swapaxes(jnp.linalg.inv(K1), -1, -2)
    K2_inv = jnp.linalg.inv(K2)
    return K1_inv_T @ E @ K2_inv


def epipolar_dist_sq(
    uv1: jnp.ndarray, uv2: jnp.ndarray, F12: jnp.ndarray
) -> jnp.ndarray:
    """Squared distance of x1 from the epipolar line of x2 (batched).

    Matches CheckDistEpipolarLine's distance formula
    (jni/ORB_SLAM2/src/ORBmatcher.cc:142-159): line l1 = F12 @ x2h, distance
    of uv1 from l1 (note the reference computes the line in image 2 from kp1;
    this helper is symmetric in convention — pass the right F orientation).
    """
    x2h = jnp.concatenate([uv2, jnp.ones_like(uv2[..., :1])], axis=-1)
    line = jnp.einsum("...ij,...j->...i", F12, x2h)  # line in image 1
    num = (
        line[..., 0] * uv1[..., 0] + line[..., 1] * uv1[..., 1] + line[..., 2]
    )
    den = line[..., 0] ** 2 + line[..., 1] ** 2
    return num * num / jnp.maximum(den, 1e-12)
