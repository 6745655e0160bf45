"""Motion-only pose optimization: Levenberg–Marquardt on SE(3).

JAX replacement for ``Optimizer::PoseOptimization``
(jni/ORB_SLAM2/src/Optimizer.cc:239-451): the reference builds a g2o graph
with one SE3 vertex and N monocular projection edges, runs 4 rounds x 10 LM
iterations with Huber (delta = sqrt(5.991)) and reclassifies inliers by chi2
between rounds, dropping the robust kernel for the final rounds.

Here the whole solve is one jit program. Residuals and Jacobians are kept
as struct-of-arrays — the Jacobian is two (6, N) row blocks, never an
(N, 2, 6) array of per-point matrices, so the normal equations are one
(6, N) @ (N, 6) contraction instead of a batch of tiny matmuls. The 6x6 normal system is solved by an
*unrolled* Cholesky (static scalar graph) instead of ``jnp.linalg.solve``,
whose LU pivoting lowers to XLA while-loops that both compile slowly and run
slowly inside the LM loop.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry import se3

CHI2_MONO = 5.991
CHI2_STEREO = 7.815     # 3-dof 95% gate (Optimizer.cc:310)
HUBER_MONO = 2.4476519  # sqrt(5.991), Optimizer.cc:287


def solve6(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve the SPD 6x6 system A x = b by fully unrolled Cholesky.

    All indexing is static, so this lowers to a branch-free scalar graph —
    no while-loops, no pivoting. A must be symmetric positive definite
    (guaranteed by the LM damping A = H + lam*diag(H) + eps*I).
    """
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = jnp.sqrt(jnp.maximum(s, 1e-20))
        for i in range(j + 1, n):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)


def _residuals_jacobian_soa(Tcw, X, uv, fx, fy, cx, cy, ur=None, bf=0.0):
    """Residuals + Jacobian rows in struct-of-arrays layout.

    Returns (ru (N,), rv (N,), Ju (6, N), Jv (6, N), z (N,)[, rur, Jur])
    where Ju/Jv are the per-observation gradient rows of u/v wrt the
    left-mult tangent [upsilon, omega]: J = dproj/dP · [I | -hat(P)].
    With ur (the observed stereo right-u, -1 = monocular feature) the third
    residual row u - bf/z - ur of EdgeStereoSE3ProjectXYZOnlyPose
    (Optimizer.cc:274-310) is returned too.
    """
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    # P = R X + t, computed row-wise to keep everything (N,)-shaped
    x = R[0, 0] * X[:, 0] + R[0, 1] * X[:, 1] + R[0, 2] * X[:, 2] + t[0]
    y = R[1, 0] * X[:, 0] + R[1, 1] * X[:, 1] + R[1, 2] * X[:, 2] + t[1]
    z = R[2, 0] * X[:, 0] + R[2, 1] * X[:, 1] + R[2, 2] * X[:, 2] + t[2]
    z_safe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    ru = fx * x * iz + cx - uv[:, 0]
    rv = fy * y * iz + cy - uv[:, 1]
    zero = jnp.zeros_like(x)
    # d(u)/d[t, omega] with P' = exp(xi)(RX+t): dP/dt = I, dP/domega = -hat(P)
    Ju = jnp.stack(
        [fx * iz, zero, -fx * x * iz2,
         -fx * x * y * iz2, fx * (1.0 + x * x * iz2), -fx * y * iz]
    )
    Jv = jnp.stack(
        [zero, fy * iz, -fy * y * iz2,
         -fy * (1.0 + y * y * iz2), fy * x * y * iz2, fy * x * iz]
    )
    if ur is None:
        return ru, rv, Ju, Jv, z
    # stereo right-u row: u_r = u - bf/z; d(u_r) = du + bf/z^2 · dz with
    # dz/d[t, omega] = [0, 0, 1, y, -x, 0]
    rur = (fx * x * iz + cx) - bf * iz - ur
    Jz = jnp.stack([zero, zero, jnp.ones_like(x), y, -x, zero])
    Jur = Ju + (bf * iz2) * Jz
    return ru, rv, Ju, Jv, z, rur, Jur


@partial(jax.jit, static_argnames=("n_rounds", "n_iters"))
def optimize_pose(
    Tcw0: jnp.ndarray,
    X: jnp.ndarray,
    uv: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    valid: jnp.ndarray,
    K: jnp.ndarray,
    n_rounds: int = 4,
    n_iters: int = 10,
    chi2_th: float = CHI2_MONO,
    lambda_init: float = 1e-3,
    ur: jnp.ndarray | None = None,
    bf: jnp.ndarray | float = 0.0,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Optimize a single camera pose against fixed 3D points.

    Args:
      Tcw0: (4,4) initial world->camera pose.
      X: (N,3) world points; uv: (N,2) observed rectified pixels.
      inv_sigma2: (N,) per-observation information (1/sigma^2 by octave).
      valid: (N,) observation mask.
      K: (3,3) intrinsics.
      ur: (N,) observed stereo right-u per feature, -1 = monocular feature
        (mvuRight). When given, features with ur >= 0 contribute the 3-dof
        stereo edge with chi2 gate 7.815 and Huber delta sqrt(7.815)
        (EdgeStereoSE3ProjectXYZOnlyPose, Optimizer.cc:274-310,390-420).
      bf: stereo baseline x fx (Camera.bf).

    Returns (Tcw (4,4), inliers (N,) bool, n_inliers ()).
    """
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    stereo = ur is not None
    if stereo:
        is_st = ur >= 0
        delta2 = jnp.where(is_st, CHI2_STEREO, CHI2_MONO)  # Huber delta^2
        th = jnp.where(is_st, CHI2_STEREO, chi2_th)
    else:
        delta2 = CHI2_MONO
        th = chi2_th

    def resid(Tcw):
        out = _residuals_jacobian_soa(
            Tcw, X, uv, fx, fy, cx, cy,
            ur=ur if stereo else None, bf=bf,
        )
        if stereo:
            ru, rv, Ju, Jv, z, rur, Jur = out
            rur = jnp.where(is_st, rur, 0.0)
        else:
            ru, rv, Ju, Jv, z = out
            rur, Jur = None, None
        return ru, rv, Ju, Jv, z, rur, Jur

    def chi2_of(Tcw):
        ru, rv, _, _, z, rur, _ = resid(Tcw)
        c = ru * ru + rv * rv
        if stereo:
            c = c + rur * rur
        return c * inv_sigma2, z

    def robust_cost(chi2, z, mask, robust):
        rho = jnp.where(
            (chi2 <= delta2) | ~robust,
            chi2,
            2.0 * jnp.sqrt(delta2 * jnp.maximum(chi2, 1e-12)) - delta2,
        )
        return jnp.sum(jnp.where(mask & (z > 0), rho, 0.0))

    def round_body(carry, robust):
        Tcw, inliers = carry

        def lm_step(_, state):
            Tcw, lam = state
            ru, rv, Ju, Jv, z, rur, Jur = resid(Tcw)
            chi2 = (ru * ru + rv * rv) * inv_sigma2
            if stereo:
                chi2 = chi2 + rur * rur * inv_sigma2
            # IRLS weight for the Huber kernel on chi2 = ||r||^2_Sigma
            wr = jnp.where(
                chi2 <= delta2,
                1.0,
                jnp.sqrt(delta2 / jnp.maximum(chi2, 1e-12)),
            )
            w = inv_sigma2 * jnp.where(robust, wr, 1.0)
            w = jnp.where(inliers & (z > 0), w, 0.0)
            # H = Ju W Ju^T + Jv W Jv^T (+ stereo row): (6, N) @ (N, 6)
            Juw = Ju * w
            Jvw = Jv * w
            H = Juw @ Ju.T + Jvw @ Jv.T
            b = -(Juw @ ru + Jvw @ rv)
            if stereo:
                Jurw = Jur * (w * is_st)
                H = H + Jurw @ Jur.T
                b = b - Jurw @ rur
            cost0 = robust_cost(chi2, z, inliers, robust)

            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6)
            dx = solve6(Hd, b)
            T_new = se3.retract(Tcw, dx)

            c_new, z_new = chi2_of(T_new)
            cost1 = robust_cost(c_new, z_new, inliers, robust)

            finite = jnp.isfinite(cost1) & jnp.all(jnp.isfinite(dx))
            accept = (cost1 < cost0) & finite
            Tcw = jnp.where(accept, T_new, Tcw)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-6, 1e3)
            return Tcw, lam

        Tcw, _ = jax.lax.fori_loop(0, n_iters, lm_step, (Tcw, lambda_init))
        # chi2 reclassification (both directions, like the reference's
        # setLevel dance at Optimizer.cc:390-420)
        chi2, z = chi2_of(Tcw)
        inliers = valid & (chi2 <= th) & (z > 0)
        return (Tcw, inliers), None

    Tcw, cur_inliers = Tcw0, valid
    # robust kernel on for rounds 0,1; off for 2,3 (Optimizer.cc:432:
    # e->setRobustKernel(0) at it==2)
    for rnd in range(n_rounds):
        robust = jnp.asarray(rnd < 2)
        (Tcw, cur_inliers), _ = round_body((Tcw, cur_inliers), robust)

    return se3.orthonormalize(Tcw), cur_inliers, cur_inliers.sum()
