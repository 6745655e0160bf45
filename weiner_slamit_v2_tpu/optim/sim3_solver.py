"""Sim3 estimation from 3D-3D correspondences: Horn's method + RANSAC.

JAX replacement for ``Sim3Solver`` (jni/ORB_SLAM2/src/Sim3Solver.cc):
the reference iterates 3-point RANSAC with scalar Horn solves
(Sim3Solver.cc:226-337, the 1987 closed form: centroids, M = Pr1 Pr2^T, 4x4
N-matrix eigendecomposition -> quaternion, scale from projections). Here all
RANSAC hypotheses are one vmapped batch of 4x4 ``eigh`` solves, and inlier
checking is the same mutual reprojection chi2 gate (Sim3Solver.cc:340-379).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry import se3, sim3

SAMPLE = 3            # 3-point minimal sets (Sim3Solver.cc:166)
N_ITERS = 300         # RANSAC budget (LoopClosing.cc:286: 300 iterations)
CHI2 = 9.210          # inlier gate per reprojection (Sim3Solver.cc:87-88)


def horn_sim3(
    P1: jnp.ndarray, P2: jnp.ndarray, fix_scale: bool = False
) -> jnp.ndarray:
    """Closed-form similarity aligning P2 -> P1 (both (N, 3)).

    Returns S12 (4, 4) with P1 ~= s R P2 + t. Horn (1987) quaternion method,
    the same algorithm as Sim3Solver::ComputeSim3.
    """
    O1 = P1.mean(axis=0)
    O2 = P2.mean(axis=0)
    Pr1 = P1 - O1
    Pr2 = P2 - O2

    M = Pr2.T @ Pr1  # (3, 3): correlation from frame-2 into frame-1
    Sxx, Sxy, Sxz = M[0, 0], M[0, 1], M[0, 2]
    Syx, Syy, Syz = M[1, 0], M[1, 1], M[1, 2]
    Szx, Szy, Szz = M[2, 0], M[2, 1], M[2, 2]
    N = jnp.array(
        [
            [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
            [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
            [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
            [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
        ]
    )
    vals, vecs = jnp.linalg.eigh(N)
    q = vecs[:, -1]  # largest eigenvalue -> [w, x, y, z]
    # rotation R12 (frame2 -> frame1) from quaternion (w,x,y,z)
    q_xyzw = jnp.array([q[1], q[2], q[3], q[0]])
    R = se3.rot_from_quat(q_xyzw)

    P3 = Pr2 @ R.T  # rotated Pr2
    if fix_scale:
        s = jnp.asarray(1.0)
    else:
        s = jnp.sum(Pr1 * P3) / jnp.maximum(jnp.sum(P3 * P3), 1e-12)
    t = O1 - s * (R @ O2)
    return sim3.from_rts(R, t, s)


@partial(jax.jit, static_argnames=("n_iters", "fix_scale"))
def ransac_sim3(
    X1: jnp.ndarray,
    X2: jnp.ndarray,
    valid: jnp.ndarray,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    inv_sigma2_1: jnp.ndarray,
    inv_sigma2_2: jnp.ndarray,
    K: jnp.ndarray,
    key: jnp.ndarray,
    n_iters: int = N_ITERS,
    fix_scale: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """RANSAC Sim3 between two keyframes' matched points.

    X1, X2: (N, 3) matched points in camera-1 / camera-2 frames; uv1, uv2:
    their (N, 2) observed keypoints; valid: (N,) match mask. Inliers require
    chi2 < 9.210 * sigma^2 of the *mutual* reprojections (project X2 through
    S12 into image 1 and X1 through S21 into image 2 — Sim3Solver::
    CheckInliers, Sim3Solver.cc:340-379).

    Returns (S12 (4,4), inliers (N,), n_inliers).
    """
    N = X1.shape[0]
    n_valid = jnp.maximum(valid.sum(), 1)
    order = jnp.argsort(~valid)
    draws = jax.random.randint(key, (n_iters, SAMPLE), 0, n_valid)
    sample = order[draws]

    Ss = jax.vmap(lambda si: horn_sim3(X1[si], X2[si], fix_scale))(sample)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def project(P):
        z = jnp.where(jnp.abs(P[:, 2]) < 1e-9, 1e-9, P[:, 2])
        return jnp.stack(
            [fx * P[:, 0] / z + cx, fy * P[:, 1] / z + cy], axis=1
        ), P[:, 2]

    def count(S12):
        S21 = sim3.inv(S12)
        p2_in_1, z1 = project(sim3.apply(S12, X2))
        p1_in_2, z2 = project(sim3.apply(S21, X1))
        e1 = jnp.sum((p2_in_1 - uv1) ** 2, axis=1) * inv_sigma2_1
        e2 = jnp.sum((p1_in_2 - uv2) ** 2, axis=1) * inv_sigma2_2
        inl = valid & (e1 < CHI2) & (e2 < CHI2) & (z1 > 0) & (z2 > 0)
        return inl, inl.sum()

    inls, counts = jax.vmap(count)(Ss)
    finite = jnp.all(jnp.isfinite(Ss.reshape(n_iters, -1)), axis=1)
    counts = jnp.where(finite, counts, -1)
    best = jnp.argmax(counts)
    return Ss[best], inls[best], jnp.maximum(counts[best], 0)


@partial(jax.jit, static_argnames=("n_iters", "fix_scale"))
def refine_sim3(
    S12: jnp.ndarray,
    X1: jnp.ndarray,
    X2: jnp.ndarray,
    valid: jnp.ndarray,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    inv_sigma2_1: jnp.ndarray,
    inv_sigma2_2: jnp.ndarray,
    K: jnp.ndarray,
    n_iters: int = 10,
    chi2_th: float = 10.0,
    fix_scale: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Gauss-Newton refinement of a Sim3 over forward+backward projections
    (Optimizer::OptimizeSim3, jni/ORB_SLAM2/src/Optimizer.cc:1046-1217):
    Huber(sqrt(10)), drop chi2 > 10 edges, need >= 10 survivors.

    Jacobians come from jax.jacfwd of the residual in the tangent space —
    the autodiff replacement for g2o's hand-derived EdgeSim3ProjectXYZ
    jacobians.
    """
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def residuals(xi, S):
        Sc = sim3.exp(xi) @ S
        S21 = sim3.inv(Sc)
        p1 = sim3.apply(Sc, X2)
        z1 = p1[:, 2]
        zs1 = jnp.where(jnp.abs(z1) < 1e-9, 1e-9, z1)
        r1 = jnp.stack(
            [fx * p1[:, 0] / zs1 + cx, fy * p1[:, 1] / zs1 + cy], axis=1
        ) - uv1
        p2 = sim3.apply(S21, X1)
        z2 = p2[:, 2]
        zs2 = jnp.where(jnp.abs(z2) < 1e-9, 1e-9, z2)
        r2 = jnp.stack(
            [fx * p2[:, 0] / zs2 + cx, fy * p2[:, 1] / zs2 + cy], axis=1
        ) - uv2
        return r1, r2, z1, z2

    def chi2s(S):
        r1, r2, z1, z2 = residuals(jnp.zeros(7), S)
        c1 = jnp.sum(r1 * r1, axis=1) * inv_sigma2_1
        c2 = jnp.sum(r2 * r2, axis=1) * inv_sigma2_2
        return c1, c2, z1, z2

    active = valid

    def gn_step(_, carry):
        S, active = carry
        J_fn = jax.jacfwd(
            lambda xi: jnp.concatenate(residuals(xi, S)[:2], axis=0)
        )
        J = J_fn(jnp.zeros(7))            # (2N, 2, 7)
        r1, r2, _, _ = residuals(jnp.zeros(7), S)
        r = jnp.concatenate([r1, r2], axis=0)
        w = jnp.concatenate([inv_sigma2_1, inv_sigma2_2]) * jnp.concatenate(
            [active, active]
        )
        Jw = J * w[:, None, None]
        H = jnp.einsum("nij,nik->jk", Jw, J) + 1e-5 * jnp.eye(7)
        b = -jnp.einsum("nij,ni->j", Jw, r)
        dx = jnp.linalg.solve(H, b)
        dx = jnp.where(fix_scale, dx.at[6].set(0.0), dx)
        S_new = sim3.exp(dx) @ S
        ok = jnp.all(jnp.isfinite(S_new))
        return jnp.where(ok, S_new, S), active

    # 5 iters -> drop bad edges -> 5 more (Optimizer.cc:1170-1209)
    S, active = jax.lax.fori_loop(0, n_iters // 2, gn_step, (S12, active))
    c1, c2, z1, z2 = chi2s(S)
    active = valid & (c1 <= chi2_th) & (c2 <= chi2_th) & (z1 > 0) & (z2 > 0)
    S, active = jax.lax.fori_loop(0, n_iters - n_iters // 2, gn_step, (S, active))
    c1, c2, z1, z2 = chi2s(S)
    inl = valid & (c1 <= chi2_th) & (c2 <= chi2_th) & (z1 > 0) & (z2 > 0)
    return S, inl, inl.sum()
