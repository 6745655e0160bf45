"""RANSAC PnP for relocalization: vmapped minimal solves + inlier voting.

JAX replacement for ``PnPsolver`` (jni/ORB_SLAM2/src/PnPsolver.cc):
the reference iterates EPnP on 4-point sets with scalar linear algebra
(control points, betas, Gauss-Newton — PnPsolver.cc:383-867). Here every
RANSAC hypothesis is solved at once with a vmapped 6-point DLT
(projection-matrix null space + orthogonal Procrustes to extract R) — a
simpler minimal solver that maps better to batched SVD, with the same RANSAC
parameters (prob 0.99, 300 iters, chi2 5.991 — src/Tracking.cc:1694) and the
same role: a robust pose seed that is immediately refined by
``optimize_pose`` (as Relocalization does at src/Tracking.cc:1747).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry import se3

N_ITERS = 300        # Tracking.cc:1694 (RANSAC max iterations)
SAMPLE = 6           # 6-point DLT minimal set (ref uses 4-point EPnP)
CHI2 = 5.991         # th2 (Tracking.cc:1694)


def _solve_dlt(Xw: jnp.ndarray, xn: jnp.ndarray) -> jnp.ndarray:
    """6-point DLT for the projection matrix in normalized camera coords.

    Xw: (6, 3) world points; xn: (6, 2) normalized image coords (K^-1 uv).
    Returns Tcw (4, 4) with orthonormalized rotation.
    """
    zeros = jnp.zeros((SAMPLE, 4))
    Xh = jnp.concatenate([Xw, jnp.ones((SAMPLE, 1))], axis=1)  # (6, 4)
    rows_u = jnp.concatenate([Xh, zeros, -xn[:, 0:1] * Xh], axis=1)
    rows_v = jnp.concatenate([zeros, Xh, -xn[:, 1:2] * Xh], axis=1)
    A = jnp.concatenate([rows_u, rows_v], axis=0)  # (12, 12)
    _, _, vt = jnp.linalg.svd(A)
    P = vt[-1].reshape(3, 4)

    M = P[:, :3]
    U, S, Vt = jnp.linalg.svd(M)
    d = jnp.linalg.det(U @ Vt)
    R = U @ Vt
    R = jnp.where(d < 0, -R, R)
    scale = jnp.mean(S) * jnp.where(d < 0, -1.0, 1.0)
    t = P[:, 3] / jnp.where(jnp.abs(scale) < 1e-12, 1e-12, scale)

    # the signed scale resolves the DLT's global sign ambiguity, so no
    # separate cheirality flip is needed
    return se3.from_rt(R, t)


@partial(jax.jit, static_argnames=("n_iters",))
def ransac_pnp(
    X: jnp.ndarray,
    uv: jnp.ndarray,
    valid: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    K: jnp.ndarray,
    key: jnp.ndarray,
    n_iters: int = N_ITERS,
    chi2_th: float = CHI2,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """RANSAC pose from 2D-3D matches.

    X: (N, 3) world points, uv: (N, 2) rectified pixels, valid: (N,),
    inv_sigma2: (N,) per-match information.

    Returns (Tcw (4,4), inlier mask (N,), n_inliers ()). The caller applies
    the reference's acceptance gate (>= minInliers) and refines with
    optimize_pose.
    """
    N = X.shape[0]
    n_valid = jnp.maximum(valid.sum(), 1)
    order = jnp.argsort(~valid)
    draws = jax.random.randint(key, (n_iters, SAMPLE), 0, n_valid)
    sample_idx = order[draws]  # (iters, 6)

    Kinv = jnp.linalg.inv(K)
    uvh = jnp.concatenate([uv, jnp.ones((N, 1))], axis=1)
    xn = (uvh @ Kinv.T)[:, :2]

    Ts = jax.vmap(lambda si: _solve_dlt(X[si], xn[si]))(sample_idx)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def count_inliers(T):
        Pc = se3.apply(T, X)
        z = Pc[:, 2]
        zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = fx * Pc[:, 0] / zs + cx
        v = fy * Pc[:, 1] / zs + cy
        chi2 = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) * inv_sigma2
        inl = valid & (z > 0) & (chi2 < chi2_th)
        return inl, inl.sum()

    inls, counts = jax.vmap(count_inliers)(Ts)
    ok_T = jnp.all(jnp.isfinite(Ts.reshape(n_iters, -1)), axis=1)
    counts = jnp.where(ok_T, counts, -1)
    best = jnp.argmax(counts)
    return Ts[best], inls[best], jnp.maximum(counts[best], 0)
