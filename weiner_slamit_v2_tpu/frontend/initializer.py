"""Monocular two-view bootstrap: parallel H/F RANSAC + model select + SfM.

JAX replacement for ``Initializer`` (jni/ORB_SLAM2/src/Initializer.cc).
The reference runs two std::threads, each looping 200 RANSAC iterations with
scalar 8-point solves; here both models' 200 hypotheses are two vmapped
batches of small SVD solves evaluated in one shot, and the winner is chosen
with the same RH = SH/(SH+SF) > 0.40 rule (Initializer.cc:121-124).

Homography reconstruction implements the Faugeras & Lustman (1988) 8-solution
decomposition (the published algorithm the reference's ReconstructH follows);
fundamental reconstruction uses the standard 4-way essential decomposition.
Acceptance gates match the reference (Initializer.cc:503-528, 707-738).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry import se3, triangulate
from ..utils import struct

N_RANSAC = 200        # Initializer.cc:86-106
SAMPLE_SIZE = 8
SIGMA = 1.0
TH_H = 5.991          # symmetric-transfer chi2 for H (Initializer.cc:342)
TH_F = 3.841          # point-line chi2 for F (Initializer.cc:417)
TH_SCORE = 5.991      # score offset for F (Initializer.cc:418)
RH_THRESHOLD = 0.40   # model selection (Initializer.cc:121-124)
MIN_PARALLAX_DEG = 1.0
MIN_TRIANGULATED = 50
CHECK_RT_TH2 = 4.0    # reprojection gate 4*sigma^2 (Initializer.cc:866-910)


@struct.dataclass
class InitResult:
    success: jnp.ndarray        # () bool
    Tcw2: jnp.ndarray           # (4, 4) pose of frame 2 (frame 1 = identity)
    points: jnp.ndarray         # (M, 3) triangulated world points
    is_point: jnp.ndarray       # (M,) bool triangulation success per match
    n_good: jnp.ndarray         # () int32
    used_homography: jnp.ndarray  # () bool


def _normalize(uv: jnp.ndarray, valid: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Mean / mean-abs-dev normalization (Initializer.cc:758-804). Returns
    normalized points and the 3x3 transform T with x_norm = T @ x."""
    w = valid.astype(jnp.float32)
    n = jnp.maximum(w.sum(), 1.0)
    mean = (uv * w[:, None]).sum(0) / n
    dev = (jnp.abs(uv - mean) * w[:, None]).sum(0) / n
    s = 1.0 / jnp.maximum(dev, 1e-9)
    uvn = (uv - mean) * s
    T = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dtype=uv.dtype
    )
    T = T.at[0, 0].set(s[0]).at[1, 1].set(s[1])
    T = T.at[0, 2].set(-mean[0] * s[0]).at[1, 2].set(-mean[1] * s[1])
    return uvn, T


def _solve_h(uv1: jnp.ndarray, uv2: jnp.ndarray) -> jnp.ndarray:
    """DLT homography from 8 correspondences (x2 ~ H21 @ x1).
    uv1, uv2: (8, 2) -> (3, 3)."""
    x, y = uv1[:, 0], uv1[:, 1]
    u, v = uv2[:, 0], uv2[:, 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    rows_a = jnp.stack([z, z, z, -x, -y, -o, v * x, v * y, v], axis=1)
    rows_b = jnp.stack([x, y, o, z, z, z, -u * x, -u * y, -u], axis=1)
    A = jnp.concatenate([rows_a, rows_b], axis=0)  # (16, 9)
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    return vt[8].reshape(3, 3)


def _solve_f(uv1: jnp.ndarray, uv2: jnp.ndarray) -> jnp.ndarray:
    """8-point fundamental (x2^T F21 x1 = 0) with rank-2 projection."""
    x, y = uv1[:, 0], uv1[:, 1]
    u, v = uv2[:, 0], uv2[:, 1]
    o = jnp.ones_like(x)
    A = jnp.stack(
        [u * x, u * y, u, v * x, v * y, v, x, y, o], axis=1
    )  # (8, 9)
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    F = vt[8].reshape(3, 3)
    U, S, Vt = jnp.linalg.svd(F)
    S = S.at[2].set(0.0)
    return U @ jnp.diag(S) @ Vt


def _score_h(
    H21: jnp.ndarray, uv1: jnp.ndarray, uv2: jnp.ndarray, valid: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Symmetric transfer error scoring (Initializer.cc:314-397)."""
    H12 = jnp.linalg.inv(H21)

    def transfer(H, a, b):
        ah = jnp.concatenate([a, jnp.ones_like(a[:, :1])], axis=1)
        p = ah @ H.T
        w = jnp.where(jnp.abs(p[:, 2]) < 1e-9, 1e-9, p[:, 2])
        proj = p[:, :2] / w[:, None]
        return jnp.sum((proj - b) ** 2, axis=1)

    chi2_1 = transfer(H12, uv2, uv1) * inv_sigma2
    chi2_2 = transfer(H21, uv1, uv2) * inv_sigma2
    ok1 = chi2_1 < TH_H
    ok2 = chi2_2 < TH_H
    score = jnp.where(valid & ok1, TH_H - chi2_1, 0.0) + jnp.where(
        valid & ok2, TH_H - chi2_2, 0.0
    )
    return score.sum(), valid & ok1 & ok2


def _score_f(
    F21: jnp.ndarray, uv1: jnp.ndarray, uv2: jnp.ndarray, valid: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Point-to-epipolar-line chi2 scoring (Initializer.cc:399-477)."""

    def line_dist2(F, a, b):
        # distance of b from line F @ a
        ah = jnp.concatenate([a, jnp.ones_like(a[:, :1])], axis=1)
        l = ah @ F.T  # (M, 3) lines in image of b
        num = l[:, 0] * b[:, 0] + l[:, 1] * b[:, 1] + l[:, 2]
        den = l[:, 0] ** 2 + l[:, 1] ** 2
        return num * num / jnp.maximum(den, 1e-12)

    chi2_1 = line_dist2(F21, uv1, uv2) * inv_sigma2          # l2 = F21 x1
    chi2_2 = line_dist2(F21.T, uv2, uv1) * inv_sigma2        # l1 = F21^T x2
    ok1 = chi2_1 < TH_F
    ok2 = chi2_2 < TH_F
    score = jnp.where(valid & ok1, TH_SCORE - chi2_1, 0.0) + jnp.where(
        valid & ok2, TH_SCORE - chi2_2, 0.0
    )
    return score.sum(), valid & ok1 & ok2


def _check_rt(
    R: jnp.ndarray,
    t: jnp.ndarray,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    valid: jnp.ndarray,
    K: jnp.ndarray,
    sigma2: jnp.ndarray | float = 1.0,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Cheirality + reprojection + parallax check for one (R, t) hypothesis
    (Initializer.cc:807-916). Returns (n_good, parallax_deg, points, good)."""
    T1 = jnp.eye(4, dtype=R.dtype)
    T2 = se3.from_rt(R, t)
    P1 = triangulate._projection_matrix(K, T1)
    P2 = triangulate._projection_matrix(K, T2)
    X = triangulate.triangulate_dlt(uv1, uv2, P1, P2)
    finite = jnp.all(jnp.isfinite(X), axis=1)

    C1 = jnp.zeros(3, dtype=R.dtype)
    C2 = triangulate.camera_center(T2)
    cosp = triangulate.parallax_cos(C1, C2, X)

    z1 = X[:, 2]
    z2 = triangulate.depth_in_view(T2, X)
    enough_parallax = cosp < 0.99998
    cheirality = (z1 > 0) & (z2 > 0) | ~enough_parallax  # low-parallax points
    # reference: z<=0 rejects only when parallax is sufficient
    cheirality = jnp.where(enough_parallax, (z1 > 0) & (z2 > 0), True)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def reproj_err2(Xc, uv):
        zsafe = jnp.where(jnp.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
        u = fx * Xc[:, 0] / zsafe + cx
        v = fy * Xc[:, 1] / zsafe + cy
        return (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2

    err1 = reproj_err2(X, uv1)
    X2 = se3.apply(T2, X)
    err2 = reproj_err2(X2, uv2)
    th2 = CHECK_RT_TH2 * sigma2
    good = (
        valid & finite & cheirality & (err1 < th2) & (err2 < th2)
        & (z1 > 0) & (z2 > 0)
    )
    n_good = good.sum()

    # parallax of the 50th-best good point (Initializer.cc:906-910)
    cos_good = jnp.where(good, cosp, 1.0)
    cos_sorted = jnp.sort(cos_good)  # ascending: best parallax first
    idx = jnp.minimum(49, jnp.maximum(n_good - 1, 0))
    parallax_deg = jnp.degrees(jnp.arccos(jnp.clip(cos_sorted[idx], -1.0, 1.0)))
    parallax_deg = jnp.where(n_good > 0, parallax_deg, 0.0)
    return n_good, parallax_deg, X, good


def _decompose_e(E: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """4 (R, t) hypotheses from an essential matrix (Initializer.cc:918-940).
    Returns (Rs (4,3,3), ts (4,3))."""
    U, _, Vt = jnp.linalg.svd(E)
    # enforce proper rotations
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = jnp.where(jnp.linalg.det(R1) < 0, -R1, R1)
    R2 = jnp.where(jnp.linalg.det(R2) < 0, -R2, R2)
    t = U[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def _decompose_h(A: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Faugeras & Lustman 8-solution decomposition of A = K^-1 H K.

    Returns (Rs (8,3,3), ts (8,3)). Mirrors the reference's ReconstructH
    hypothesis generation (Initializer.cc:581-705), which implements the
    same published algorithm.
    """
    U, d, Vt = jnp.linalg.svd(A)
    V = Vt.T
    s = jnp.linalg.det(U) * jnp.linalg.det(V)
    d1, d2, d3 = d[0], d[1], d[2]

    denom = jnp.maximum(d1 * d1 - d3 * d3, 1e-12)
    aux1 = jnp.sqrt(jnp.maximum(d1 * d1 - d2 * d2, 0.0) / denom)
    aux3 = jnp.sqrt(jnp.maximum(d2 * d2 - d3 * d3, 0.0) / denom)
    x1s = jnp.array([aux1, aux1, -aux1, -aux1])
    x3s = jnp.array([aux3, -aux3, aux3, -aux3])

    # case d' > 0
    sin_th = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 + d3) * d2, 1e-12)
    cos_th = (d2 * d2 + d1 * d3) / jnp.maximum((d1 + d3) * d2, 1e-12)
    sin_ths = jnp.array([sin_th, -sin_th, -sin_th, sin_th])

    def make_pos(i):
        st = sin_ths[i]
        Rp = jnp.array(
            [
                [cos_th, 0.0, -st],
                [0.0, 1.0, 0.0],
                [st, 0.0, cos_th],
            ]
        )
        tp = jnp.array([x1s[i], 0.0, -x3s[i]]) * (d1 - d3)
        R = s * U @ Rp @ Vt
        t = U @ tp
        return R, t

    # case d' < 0
    sin_ph = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / jnp.maximum((d1 - d3) * d2, 1e-12)
    cos_ph = (d1 * d3 - d2 * d2) / jnp.maximum((d1 - d3) * d2, 1e-12)
    sin_phs = jnp.array([sin_ph, -sin_ph, -sin_ph, sin_ph])

    def make_neg(i):
        sp = sin_phs[i]
        Rp = jnp.array(
            [
                [cos_ph, 0.0, sp],
                [0.0, -1.0, 0.0],
                [sp, 0.0, -cos_ph],
            ]
        )
        tp = jnp.array([x1s[i], 0.0, x3s[i]]) * (d1 + d3)
        R = s * U @ Rp @ Vt
        t = U @ tp
        return R, t

    Rs, ts = [], []
    for i in range(4):
        R, t = make_pos(i)
        Rs.append(R)
        ts.append(t)
    for i in range(4):
        R, t = make_neg(i)
        Rs.append(R)
        ts.append(t)
    Rs = jnp.stack(Rs)
    ts = jnp.stack(ts)
    ts = ts / jnp.maximum(jnp.linalg.norm(ts, axis=1, keepdims=True), 1e-12)
    return Rs, ts


def _select_hypothesis(
    Rs: jnp.ndarray,
    ts: jnp.ndarray,
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    valid: jnp.ndarray,
    K: jnp.ndarray,
    n_inliers: jnp.ndarray,
    second_best_factor: float,
    sigma2: jnp.ndarray,
) -> InitResult:
    """Run CheckRT on every hypothesis and apply the reference's acceptance
    gates (clear winner, parallax, minimum good count)."""
    n_goods, parallaxes, Xs, goods = jax.vmap(
        lambda R, t: _check_rt(R, t, uv1, uv2, valid, K, sigma2)
    )(Rs, ts)

    best = jnp.argmax(n_goods)
    n_best = n_goods[best]
    n_second = jnp.max(jnp.where(jnp.arange(len(Rs)) == best, -1, n_goods))

    n_min = jnp.maximum(
        (0.9 * n_inliers).astype(jnp.int32), MIN_TRIANGULATED
    )
    ok = (
        (n_best >= n_min)
        & (n_second < second_best_factor * n_best)
        & (parallaxes[best] > MIN_PARALLAX_DEG)
    )
    Tcw2 = se3.from_rt(Rs[best], ts[best])
    return InitResult(
        success=ok,
        Tcw2=Tcw2,
        points=Xs[best],
        is_point=goods[best],
        n_good=n_best,
        used_homography=jnp.asarray(False),
    )


@partial(jax.jit, static_argnames=())
def initialize_two_view(
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    valid: jnp.ndarray,
    K: jnp.ndarray,
    key: jnp.ndarray,
    sigma2: jnp.ndarray | None = None,
) -> InitResult:
    """Full two-view bootstrap from matched rectified pixels.

    uv1, uv2: (M, 2) corresponding points; valid: (M,) mask; K: (3, 3).
    key: jax PRNG key (replaces DUtils::Random::SeedRandOnce(0),
    Initializer.cc:89 — fixed keys give the determinism the reference fakes
    with a global seed).
    sigma2: (M,) optional per-match noise scale (the octave sigma^2 of the
    coarser of the two keypoints). The reference hardcodes sigma=1 because
    it matches at octave 0 only; our initializer matches across octaves, so
    gates must scale with keypoint quantization error.
    """
    M = uv1.shape[0]
    if sigma2 is None:
        sigma2 = jnp.ones(M, dtype=uv1.dtype)
    inv_sigma2 = 1.0 / sigma2
    n_valid = valid.sum()

    # --- sample N_RANSAC 8-subsets of valid matches -----------------------
    order = jnp.argsort(~valid)  # valid indices first (stable)
    draws = jax.random.randint(
        key, (N_RANSAC, SAMPLE_SIZE), 0, jnp.maximum(n_valid, 1)
    )
    sample_idx = order[draws]  # (N_RANSAC, 8)

    uv1n, T1 = _normalize(uv1, valid)
    uv2n, T2 = _normalize(uv2, valid)

    s1 = uv1n[sample_idx]  # (N_RANSAC, 8, 2)
    s2 = uv2n[sample_idx]

    # --- vmapped model fits + scoring ------------------------------------
    Hn = jax.vmap(_solve_h)(s1, s2)
    Fn = jax.vmap(_solve_f)(s1, s2)
    T2inv = jnp.linalg.inv(T2)
    H21s = jax.vmap(lambda Hn_: T2inv @ Hn_ @ T1)(Hn)
    F21s = jax.vmap(lambda Fn_: T2.T @ Fn_ @ T1)(Fn)

    h_scores, h_masks = jax.vmap(lambda H: _score_h(H, uv1, uv2, valid, inv_sigma2))(H21s)
    f_scores, f_masks = jax.vmap(lambda F: _score_f(F, uv1, uv2, valid, inv_sigma2))(F21s)

    bh = jnp.argmax(h_scores)
    bf = jnp.argmax(f_scores)
    SH = h_scores[bh]
    SF = f_scores[bf]
    H21 = H21s[bh]
    F21 = F21s[bf]
    h_inliers = h_masks[bh]
    f_inliers = f_masks[bf]

    RH = SH / jnp.maximum(SH + SF, 1e-9)
    use_h = RH > RH_THRESHOLD

    # --- reconstruct both, select by RH (cheap enough to compute both) ----
    A = jnp.linalg.inv(K) @ H21 @ K
    Rs_h, ts_h = _decompose_h(A)
    res_h = _select_hypothesis(
        Rs_h, ts_h, uv1, uv2, h_inliers, K, h_inliers.sum(), 0.75, sigma2
    )

    E = K.T @ F21 @ K
    Rs_f, ts_f = _decompose_e(E)
    res_f = _select_hypothesis(
        Rs_f, ts_f, uv1, uv2, f_inliers, K, f_inliers.sum(), 0.7, sigma2
    )

    pick = lambda a, b: jnp.where(use_h, a, b)
    return InitResult(
        success=pick(res_h.success, res_f.success) & (n_valid >= SAMPLE_SIZE),
        Tcw2=pick(res_h.Tcw2, res_f.Tcw2),
        points=pick(res_h.points, res_f.points),
        is_point=pick(res_h.is_point, res_f.is_point),
        n_good=pick(res_h.n_good, res_f.n_good),
        used_homography=use_h,
    )
