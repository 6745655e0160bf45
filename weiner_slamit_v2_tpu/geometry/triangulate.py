"""Batched two-view triangulation (inhomogeneous DLT, closed form).

JAX replacement for ``Initializer::Triangulate``
(jni/ORB_SLAM2/src/Initializer.cc:743-805) and the SVD triangulation inside
``LocalMapping::CreateNewMapPoints`` (jni/ORB_SLAM2/src/LocalMapping.cc:221-505).
The reference solves the homogeneous 4x4 DLT with cv::SVD per
correspondence; here the homogeneous coordinate is fixed to 1 and the 4x3
least-squares system is solved with closed-form 3x3 normal equations —
branch-free elementwise arithmetic over the whole batch instead of
iterative small SVDs. The two solutions differ only for points near infinity, which
the downstream cheirality/parallax/chi2 gates reject in either case.
"""

from __future__ import annotations

import jax.numpy as jnp


def _projection_matrix(K: jnp.ndarray, Tcw: jnp.ndarray) -> jnp.ndarray:
    """P = K [R|t], shapes K (3,3), Tcw (...,4,4) -> (...,3,4)."""
    return jnp.einsum("ij,...jk->...ik", K, Tcw[..., :3, :4])


def triangulate_dlt(
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    P1: jnp.ndarray,
    P2: jnp.ndarray,
) -> jnp.ndarray:
    """Triangulate batched correspondences.

    Args:
      uv1, uv2: (..., 2) rectified pixel coordinates in views 1 and 2.
      P1, P2: (3, 4) or (..., 3, 4) projection matrices.

    Returns:
      (..., 3) world points (homogeneous DLT solution dehomogenized).
    """
    P1 = jnp.broadcast_to(P1, uv1.shape[:-1] + (3, 4))
    P2 = jnp.broadcast_to(P2, uv2.shape[:-1] + (3, 4))
    rows = jnp.stack(
        [
            uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ],
        axis=-2,
    )  # (..., 4, 4)
    # Inhomogeneous DLT: A[:, :3] X = -A[:, 3]; 3x3 normal equations with a
    # closed-form adjugate inverse (no SVD loops).
    B = rows[..., :3]                       # (..., 4, 3)
    a = rows[..., 3]                        # (..., 4)
    H = jnp.einsum("...ki,...kj->...ij", B, B)   # (..., 3, 3)
    g = -jnp.einsum("...ki,...k->...i", B, a)    # (..., 3)
    h00, h01, h02 = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    h11, h12, h22 = H[..., 1, 1], H[..., 1, 2], H[..., 2, 2]
    c00 = h11 * h22 - h12 * h12
    c01 = h02 * h12 - h01 * h22
    c02 = h01 * h12 - h02 * h11
    c11 = h00 * h22 - h02 * h02
    c12 = h01 * h02 - h00 * h12
    c22 = h00 * h11 - h01 * h01
    det = h00 * c00 + h01 * c01 + h02 * c02
    det = jnp.where(jnp.abs(det) < 1e-18, jnp.sign(det + 1e-30) * 1e-18, det)
    x = (c00 * g[..., 0] + c01 * g[..., 1] + c02 * g[..., 2]) / det
    y = (c01 * g[..., 0] + c11 * g[..., 1] + c12 * g[..., 2]) / det
    z = (c02 * g[..., 0] + c12 * g[..., 1] + c22 * g[..., 2]) / det
    return jnp.stack([x, y, z], axis=-1)


def depth_in_view(Tcw: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """z-coordinate of world points X (...,3) in camera frame of Tcw."""
    return (
        jnp.einsum("...j,...j->...", Tcw[..., 2, :3], X) + Tcw[..., 2, 3]
    )


def parallax_cos(C1: jnp.ndarray, C2: jnp.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """Cosine of the ray angle at X between camera centers C1, C2 (batched).

    Mirrors the parallax check in Initializer::CheckRT
    (jni/ORB_SLAM2/src/Initializer.cc:866-886).
    """
    n1 = X - C1
    n2 = X - C2
    d1 = jnp.linalg.norm(n1, axis=-1)
    d2 = jnp.linalg.norm(n2, axis=-1)
    return jnp.sum(n1 * n2, axis=-1) / jnp.maximum(d1 * d2, 1e-12)


def camera_center(Tcw: jnp.ndarray) -> jnp.ndarray:
    """World-frame camera center -R^T t of a world->camera pose (batched)."""
    R = Tcw[..., :3, :3]
    t = Tcw[..., :3, 3]
    return -jnp.einsum("...ji,...j->...i", R, t)
