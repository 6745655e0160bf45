"""Bundle adjustment: Levenberg–Marquardt with blocked Schur complement.

JAX replacement for g2o-based ``Optimizer::LocalBundleAdjustment`` /
``BundleAdjustment`` (jni/ORB_SLAM2/src/Optimizer.cc:453-778, :49-237). The
reference builds a sparse graph and factorizes with Eigen sparse Cholesky;
here the solver exploits the classic SfM structure with dense layouts (no
random gathers, no batched tiny matmuls):

  * every per-observation quantity (residuals, the 6 camera-Jacobian rows,
    the 3 point-Jacobian rows per residual row) is a flat (N_obs,) plane —
    pure elementwise work;
  * the per-observation camera pose "gather" is a one-hot (N_obs, C) @
    (C, 12) matmul;
  * point blocks Hpp are 3x3 closed-form inverses from summed planes;
  * the cross term is assembled once as U = Hcp in (6C, 3P) matmul layout,
    so the reduced camera system S = Hcc - U Hpp^-1 U^T is ONE
    (6C, 3P) @ (3P, 6C) contraction instead of an einsum of tiny blocks;
  * the 6Cx6C solve is a small dense Cholesky.

The observation layout is point-major (P, O): each point carries up to O
observations (cam slot, uv, information) — the array form of
MapPoint::mObservations. The same kernels serve local BA (fixed boundary
cams — Optimizer.cc:504-521), global BA (gauge fixed at kf0), and the
distributed variant (parallel/sharded_ba.py shards the point planes and
psums the reduced system across devices).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry import se3
from ..utils import struct

CHI2_MONO = 5.991
CHI2_STEREO = 7.815  # 3-dof 95% gate (EdgeStereoSE3ProjectXYZ, Optimizer.cc:295)
HUBER2 = 5.991  # Huber delta^2 (delta = sqrt(5.991), Optimizer.cc:536)
BA_LAMBDA_INIT = 1e-4  # LM damping seed (both phases; solve_ba/chunked alike)


@struct.dataclass
class BAProblem:
    """A fixed-shape bundle-adjustment problem extracted from the map."""

    cam_pose: jnp.ndarray      # (C, 4, 4) world->camera
    cam_fixed: jnp.ndarray     # (C,) bool — pose held constant
    cam_valid: jnp.ndarray     # (C,) bool — slot in use
    points: jnp.ndarray        # (P, 3)
    point_valid: jnp.ndarray   # (P,) bool
    obs_cam: jnp.ndarray       # (P, O) int32 cam slot or -1
    obs_uv: jnp.ndarray        # (P, O, 2) rectified pixels
    obs_inv_sigma2: jnp.ndarray  # (P, O)
    obs_valid: jnp.ndarray     # (P, O) bool
    K: jnp.ndarray             # (3, 3)
    # stereo observations (EdgeStereoSE3ProjectXYZ, Optimizer.cc:274-310):
    # right-image u coordinate per observation, -1/has=False for monocular.
    # None = all-mono problem (the stereo row is compiled out).
    obs_ur: jnp.ndarray | None = None        # (P, O)
    obs_has_ur: jnp.ndarray | None = None    # (P, O) bool
    bf: jnp.ndarray | None = None            # () baseline * fx


@struct.dataclass
class BAResult:
    cam_pose: jnp.ndarray      # (C, 4, 4) optimized
    points: jnp.ndarray        # (P, 3) optimized
    obs_inlier: jnp.ndarray    # (P, O) bool — chi2 <= th and positive depth
    final_cost: jnp.ndarray    # () robust cost on the final estimate


def _pose_rows_by_obs(cam_pose, obs_cam, C):
    """(N,12) per-observation [R row-major | t] via one-hot matmul."""
    N = obs_cam.size
    cam = jnp.maximum(obs_cam, 0).reshape(N)
    onehot = (cam[:, None] == jnp.arange(C)[None, :]).astype(jnp.float32)
    rows = cam_pose[:, :3, :4].reshape(C, 12)
    return onehot @ rows, onehot


def _project_planes(cam_pose, points, K, obs_cam, obs_uv, C,
                    obs_ur=None, bf=None):
    """Flat SoA projection: residuals + all Jacobian planes.

    Returns a dict of (N,) planes: ru rv z, Ju[6] Jv[6] (camera rows, tangent
    [upsilon, omega] of the left-mult update), Jpu[3] Jpv[3] (point rows) —
    plus rur/Jur/Jpur stereo right-u rows when obs_ur is given
    (u_r = u - bf/z; EdgeStereoSE3ProjectXYZ, Optimizer.cc:274-310).
    """
    P, O = obs_cam.shape
    N = P * O
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    T, onehot = _pose_rows_by_obs(cam_pose, obs_cam, C)
    # T layout: [R00 R01 R02 t0 | R10 R11 R12 t1 | R20 R21 R22 t2]
    R00, R01, R02, t0 = T[:, 0], T[:, 1], T[:, 2], T[:, 3]
    R10, R11, R12, t1 = T[:, 4], T[:, 5], T[:, 6], T[:, 7]
    R20, R21, R22, t2 = T[:, 8], T[:, 9], T[:, 10], T[:, 11]
    X0 = jnp.broadcast_to(points[:, 0:1], (P, O)).reshape(N)
    X1 = jnp.broadcast_to(points[:, 1:2], (P, O)).reshape(N)
    X2 = jnp.broadcast_to(points[:, 2:3], (P, O)).reshape(N)
    x = R00 * X0 + R01 * X1 + R02 * X2 + t0
    y = R10 * X0 + R11 * X1 + R12 * X2 + t1
    z = R20 * X0 + R21 * X1 + R22 * X2 + t2
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / zs
    iz2 = iz * iz
    uv = obs_uv.reshape(N, 2)
    ru = fx * x * iz + cx - uv[:, 0]
    rv = fy * y * iz + cy - uv[:, 1]
    zero = jnp.zeros(N)
    # camera rows: J = dproj/dP · [I | -hat(P)] (left-mult tangent)
    Ju = (fx * iz, zero, -fx * x * iz2,
          -fx * x * y * iz2, fx * (1.0 + x * x * iz2), -fx * y * iz)
    Jv = (zero, fy * iz, -fy * y * iz2,
          -fy * (1.0 + y * y * iz2), fy * x * y * iz2, fy * x * iz)
    # point rows: dproj/dP · R
    Jpu = (fx * iz * R00 - fx * x * iz2 * R20,
           fx * iz * R01 - fx * x * iz2 * R21,
           fx * iz * R02 - fx * x * iz2 * R22)
    Jpv = (fy * iz * R10 - fy * y * iz2 * R20,
           fy * iz * R11 - fy * y * iz2 * R21,
           fy * iz * R12 - fy * y * iz2 * R22)
    out = dict(ru=ru, rv=rv, z=z, Ju=Ju, Jv=Jv, Jpu=Jpu, Jpv=Jpv)
    if obs_ur is not None:
        # u_r = u - bf/z; d(u_r) = d(u) + (bf/z^2) dz, with
        # dz/dxi = (0, 0, 1, y, -x, 0) and dz/dX = R row 3
        rur = ru + obs_uv.reshape(N, 2)[:, 0] - bf * iz - obs_ur.reshape(N)
        # note: ru already contains (u_proj - u_obs); rur must be
        # (u_proj - bf/z) - ur_obs = ru + u_obs - bf/z - ur_obs
        g = bf * iz2
        Jur = (Ju[0], Ju[1], Ju[2] + g,
               Ju[3] + g * y, Ju[4] - g * x, Ju[5])
        Jpur = (Jpu[0] + g * R20, Jpu[1] + g * R21, Jpu[2] + g * R22)
        out.update(rur=rur, Jur=Jur, Jpur=Jpur)
    return out


def _chi2_planes(cam_pose, points, K, obs_cam, obs_uv, C,
                 obs_ur=None, obs_has_ur=None, bf=None):
    """(chi2/inv_sigma2 (P,O), z (P,O)) — cost-only projection (no
    Jacobians); includes the stereo right-u residual when given."""
    P, O = obs_cam.shape
    N = P * O
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    T, _ = _pose_rows_by_obs(cam_pose, obs_cam, C)
    X0 = jnp.broadcast_to(points[:, 0:1], (P, O)).reshape(N)
    X1 = jnp.broadcast_to(points[:, 1:2], (P, O)).reshape(N)
    X2 = jnp.broadcast_to(points[:, 2:3], (P, O)).reshape(N)
    x = T[:, 0] * X0 + T[:, 1] * X1 + T[:, 2] * X2 + T[:, 3]
    y = T[:, 4] * X0 + T[:, 5] * X1 + T[:, 6] * X2 + T[:, 7]
    z = T[:, 8] * X0 + T[:, 9] * X1 + T[:, 10] * X2 + T[:, 11]
    zs = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / zs
    uv = obs_uv.reshape(N, 2)
    ru = fx * x * iz + cx - uv[:, 0]
    rv = fy * y * iz + cy - uv[:, 1]
    r2 = ru * ru + rv * rv
    if obs_ur is not None:
        rur = (fx * x * iz + cx - bf * iz) - obs_ur.reshape(P * O)
        r2 = r2 + jnp.where(obs_has_ur.reshape(P * O), rur * rur, 0.0)
    return r2.reshape(P, O), z.reshape(P, O)


def _inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    # relative clamp: near-singular blocks (low-parallax depth directions)
    # must not overflow f32 in adj/det
    scale = jnp.maximum(jnp.abs(a) + jnp.abs(e) + jnp.abs(i), 1e-12)
    det_min = 1e-7 * scale * scale * scale
    det = jnp.where(jnp.abs(det) < det_min, jnp.sign(det + 1e-30) * det_min, det)
    adj = jnp.stack(
        [
            jnp.stack([A11, A12, A13], axis=-1),
            jnp.stack([A21, A22, A23], axis=-1),
            jnp.stack([A31, A32, A33], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def _robust_weight(chi2, robust, huber2=HUBER2):
    w = jnp.where(chi2 <= huber2, 1.0, jnp.sqrt(huber2 / jnp.maximum(chi2, 1e-12)))
    return jnp.where(robust, w, 1.0)


def _robust_cost(chi2, robust, huber2=HUBER2):
    rho = jnp.where(
        chi2 <= huber2, chi2,
        2.0 * jnp.sqrt(huber2 * jnp.maximum(chi2, 1e-12)) - huber2,
    )
    return jnp.where(robust, rho, chi2)


def _per_obs_chi2_th(prob, chi2_mono=CHI2_MONO, chi2_stereo=CHI2_STEREO):
    """(P,O) chi2 gate: 5.991 for mono, 7.815 for stereo observations."""
    if prob.obs_has_ur is None:
        return chi2_mono
    return jnp.where(prob.obs_has_ur, chi2_stereo, chi2_mono)


def build_normal_equations(cam_pose, points, K, obs_cam, obs_uv, w, C,
                           obs_ur=None, obs_has_ur=None, bf=None):
    """Accumulate the BA normal equations in matmul layouts.

    w: (P, O) final per-observation weights (information x robust x masks).
    Returns Hcc (C,6,6), bc (C,6), Hpp (P,3,3), bp (P,3), U (6C, 3P) — the
    camera-point cross term laid out so the Schur product is one matmul.
    The optional stereo right-u row (obs_ur/obs_has_ur/bf) adds its products
    to every block with the same information weight (Optimizer.cc:295-305).
    This function is the sharding point for distributed BA: observations can
    be partitioned along P and the reduced system psum-reduced.
    """
    P, O = w.shape
    N = P * O
    pl = _project_planes(cam_pose, points, K, obs_cam, obs_uv, C, obs_ur, bf)
    wf = (w * (pl["z"].reshape(P, O) > 0)).reshape(N)
    Ju, Jv, Jpu, Jpv = pl["Ju"], pl["Jv"], pl["Jpu"], pl["Jpv"]
    ru, rv = pl["ru"], pl["rv"]
    stereo = obs_ur is not None
    if stereo:
        wur = wf * obs_has_ur.reshape(N)
        Jur, Jpur, rur = pl["Jur"], pl["Jpur"], pl["rur"]

    def pp(a, b):
        t = (Jpu[a] * Jpu[b] + Jpv[a] * Jpv[b]) * wf
        return t + Jpur[a] * Jpur[b] * wur if stereo else t

    def prhs(a):
        t = (Jpu[a] * ru + Jpv[a] * rv) * wf
        return t + Jpur[a] * rur * wur if stereo else t

    def cc(a, b):
        t = (Ju[a] * Ju[b] + Jv[a] * Jv[b]) * wf
        return t + Jur[a] * Jur[b] * wur if stereo else t

    def crhs(a):
        t = (Ju[a] * ru + Jv[a] * rv) * wf
        return t + Jur[a] * rur * wur if stereo else t

    def cp(a, b):
        t = (Ju[a] * Jpu[b] + Jv[a] * Jpv[b]) * wf
        return t + Jur[a] * Jpur[b] * wur if stereo else t

    # ---- point blocks: 6 unique entries of the 3x3 symmetric Hpp ----------
    # Sanitize per-observation products before any reduction: with the
    # one-hot matmul layout a single non-finite observation would poison
    # EVERY camera block (0 * NaN = NaN spreads through the contraction),
    # whereas the old scatter-add corrupted only its own block. Zeroing the
    # bad product is exactly "drop the observation", which the chi2 gates
    # would do next round anyway.
    def finite(plane):
        return jnp.where(jnp.isfinite(plane), plane, 0.0)

    def psum(plane):
        return jnp.sum(finite(plane).reshape(P, O), axis=1)

    Hpp = jnp.stack(
        [
            jnp.stack([psum(pp(a, b)) for b in range(3)], axis=-1)
            for a in range(3)
        ],
        axis=-2,
    )  # (P, 3, 3)
    bp = jnp.stack([-psum(prhs(a)) for a in range(3)], axis=-1)

    # ---- camera blocks: one-hot matmul reduction per camera ---------------
    # (a (C, N) @ (N, 36) contraction instead of a scatter-add over N
    # duplicate camera indices)
    onehot = (
        jnp.maximum(obs_cam, 0).reshape(N)[:, None]
        == jnp.arange(C, dtype=jnp.int32)[None, :]
    ).astype(jnp.float32)
    Hcc_blk = jnp.stack(
        [
            jnp.stack([cc(a, b) for b in range(6)], axis=-1)
            for a in range(6)
        ],
        axis=-2,
    )  # (N, 6, 6)
    bc_blk = jnp.stack([-crhs(a) for a in range(6)], axis=-1)  # (N, 6)
    Hcc = (onehot.T @ finite(Hcc_blk).reshape(N, 36)).reshape(C, 6, 6)
    bc = onehot.T @ finite(bc_blk)

    # ---- cross term in matmul layout: U (C, 6, P, 3) -> (6C, 3P) ----------
    G = jnp.stack(
        [
            jnp.stack([cp(a, b) for b in range(3)], axis=-1)
            for a in range(6)
        ],
        axis=-2,
    )  # (N, 6, 3)
    # U[c, p] = sum over point p's observations with camera c — a per-point
    # contraction over the O axis instead of a (cam, p) scatter-add
    U5 = jnp.einsum(
        "poc,pox->pcx", onehot.reshape(P, O, C), finite(G).reshape(P, O, 18)
    )
    U = U5.reshape(P, C, 6, 3).transpose(1, 2, 0, 3).reshape(C * 6, P * 3)
    return Hcc, bc, Hpp, bp, U


def schur_solve(Hcc, bc, Hpp, bp, U, cam_free, point_free, lam, psum_axis=None):
    """Solve the damped normal equations by marginalizing points.

    U: (6C, 3P) cross term from build_normal_equations. cam_free: (C,) bool —
    optimizable cameras; fixed/invalid get dx = 0. point_free: (P,).
    lam: LM damping. psum_axis: shard_map axis name for the distributed
    variant (the reduced system is summed over it). Returns (dc (C,6),
    dp (P,3)).
    """
    C = Hcc.shape[0]
    P = Hpp.shape[0]

    # Marquardt damping: scale each diagonal entry by (1 + lam)
    Hcc_d = Hcc + (lam * jnp.maximum(jnp.einsum("cii->ci", Hcc), 1e-6))[..., None] * jnp.eye(6)
    Hpp_d = Hpp + (lam * jnp.maximum(jnp.einsum("pii->pi", Hpp), 1e-6))[..., None] * jnp.eye(3)

    # mask out frozen points: make their block identity, rhs zero
    Hpp_d = jnp.where(point_free[:, None, None], Hpp_d, jnp.eye(3))
    bp = jnp.where(point_free[:, None], bp, 0.0)
    pmask = jnp.broadcast_to(point_free[:, None], (P, 3)).reshape(P * 3)
    U = jnp.where(pmask[None, :], U, 0.0)

    Hpp_inv = _inv3x3(Hpp_d)  # (P, 3, 3)
    # Q = U · blockdiag(Hpp_inv): 9 elementwise multiply-adds of (6C, P)
    U3 = U.reshape(C * 6, P, 3)
    Q = jnp.stack(
        [
            sum(U3[:, :, k] * Hpp_inv[None, :, k, b] for k in range(3))
            for b in range(3)
        ],
        axis=-1,
    ).reshape(C * 6, P * 3)
    # the reduced camera system: ONE (6C, 3P) @ (3P, 6C) contraction
    S = -(Q @ U.T)
    b_red = bc.reshape(C * 6) - Q @ bp.reshape(P * 3)
    S = S.reshape(C, 6, C, 6).transpose(0, 2, 1, 3)
    S = S.at[jnp.arange(C), jnp.arange(C)].add(Hcc_d)
    b_red = b_red.reshape(C, 6)

    if psum_axis is not None:
        S = jax.lax.psum(S, psum_axis)
        b_red = jax.lax.psum(b_red, psum_axis)

    # freeze fixed cameras: identity rows/cols
    free = cam_free
    mask2 = free[:, None] & free[None, :]
    S = jnp.where(mask2[:, :, None, None], S, 0.0)
    S = S.at[jnp.arange(C), jnp.arange(C)].add(
        jnp.where(free, 0.0, 1.0)[:, None, None] * jnp.eye(6)
    )
    b_red = jnp.where(free[:, None], b_red, 0.0)

    S_dense = S.transpose(0, 2, 1, 3).reshape(C * 6, C * 6)
    S_dense = S_dense + 1e-8 * jnp.eye(C * 6)
    dc = jax.scipy.linalg.solve(S_dense, b_red.reshape(-1), assume_a="pos")
    dc = dc.reshape(C, 6)
    dc = jnp.where(free[:, None], dc, 0.0)

    # back-substitute points: dp = Hpp^-1 (bp - U^T dc)
    tmp = (U.T @ dc.reshape(C * 6)).reshape(P, 3)
    rhs = bp - tmp
    dp = jnp.stack(
        [
            sum(Hpp_inv[:, b, k] * rhs[:, k] for k in range(3))
            for b in range(3)
        ],
        axis=-1,
    )
    dp = jnp.where(point_free[:, None], dp, 0.0)
    return dc, dp


def _total_cost(cam_pose, points, K, prob: BAProblem, active_obs, robust):
    C = prob.cam_pose.shape[0]
    r2, z = _chi2_planes(
        cam_pose, points, K, prob.obs_cam, prob.obs_uv, C,
        prob.obs_ur, prob.obs_has_ur, prob.bf,
    )
    chi2 = r2 * prob.obs_inv_sigma2
    cost = _robust_cost(chi2, robust, _per_obs_chi2_th(prob))
    ok = active_obs & (z > 0)
    return jnp.sum(jnp.where(ok, cost, 0.0)), chi2, z


def _base_obs(prob: BAProblem):
    return (
        prob.obs_valid
        & (prob.obs_cam >= 0)
        & prob.point_valid[:, None]
        & prob.cam_valid[jnp.maximum(prob.obs_cam, 0)]
    )


def _lm_phase(prob, cam_pose, points, active_obs, robust, n_iters, lam0):
    """n_iters damped LM steps over the active observation set. Returns
    (cam_pose, points, lam) — lam carries across chunk boundaries so a
    resumed phase continues with the adapted damping."""
    C = prob.cam_pose.shape[0]
    cam_free = prob.cam_valid & ~prob.cam_fixed
    base = _base_obs(prob)
    point_free = prob.point_valid & (base.sum(axis=1) > 0)

    def step(_, state):
        cam_pose, points, lam = state
        c0, chi2, _ = _total_cost(
            cam_pose, points, prob.K, prob, active_obs, robust
        )
        w = prob.obs_inv_sigma2 * _robust_weight(
            chi2, robust, _per_obs_chi2_th(prob)
        )
        w = jnp.where(active_obs, w, 0.0)
        Hcc, bc, Hpp, bp, U = build_normal_equations(
            cam_pose, points, prob.K, prob.obs_cam, prob.obs_uv, w, C,
            prob.obs_ur, prob.obs_has_ur, prob.bf,
        )
        dc, dp = schur_solve(Hcc, bc, Hpp, bp, U, cam_free, point_free, lam)

        new_pose = jax.vmap(se3.retract)(cam_pose, dc)
        new_pts = points + dp

        c1, _, _ = _total_cost(new_pose, new_pts, prob.K, prob, active_obs, robust)
        # a NaN/Inf state must never be accepted (a NaN cost masks to 0
        # through the validity gates, which would look like a decrease)
        finite = (
            jnp.isfinite(c1)
            & jnp.all(jnp.isfinite(dc))
            & jnp.all(jnp.isfinite(dp))
        )
        accept = (c1 < c0) & finite
        cam_pose = jnp.where(accept, new_pose, cam_pose)
        points = jnp.where(accept, new_pts, points)
        # floor the damping: monocular BA has gauge/low-parallax null
        # directions; letting lam -> 0 sends points sliding to infinity
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 8.0), 1e-5, 1e3)
        return cam_pose, points, lam

    return jax.lax.fori_loop(0, n_iters, step, (cam_pose, points, lam0))


# ---------------------------------------------------------------------------
# Resumable chunks: the abortable-BA building blocks. The reference's
# LocalBundleAdjustment takes mbAbortBA and quits between LM iterations
# (g2o setForceStopFlag + the bDoMore check — src/Optimizer.cc:617-640,
# src/LocalMapping.cc:127,681-684); here the schedule is sliced into separate
# device programs so the host can stop issuing chunks at any boundary and
# finalize from the best-so-far state.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("n_iters",))
def ba_phase1(
    prob: BAProblem, n_iters: int = 5,
    chi2_th: float = CHI2_MONO, lambda_init: float = 1e-4,
):
    """Robust phase + outlier classification (Optimizer.cc:617-655).
    Returns (cam_pose, points, lam, inlier (P,O))."""
    base = _base_obs(prob)
    cam_pose, points, lam = _lm_phase(
        prob, prob.cam_pose, prob.points, base, jnp.asarray(True),
        n_iters, lambda_init,
    )
    _, chi2, z = _total_cost(
        cam_pose, points, prob.K, prob, base, jnp.asarray(True)
    )
    th = _per_obs_chi2_th(prob, chi2_th)
    inlier = base & (chi2 <= th) & (z > 0)
    return cam_pose, points, lam, inlier


@partial(jax.jit, static_argnames=("n_iters",))
def ba_phase2_chunk(
    prob: BAProblem, cam_pose, points, lam, inlier, n_iters: int = 5,
):
    """One non-robust refinement chunk over the classified inlier set
    (resumable: feed the outputs back in for the next chunk)."""
    cam_pose, points, lam = _lm_phase(
        prob, cam_pose, points, inlier, jnp.asarray(False), n_iters, lam
    )
    return cam_pose, points, lam


@jax.jit
def ba_finalize(
    prob: BAProblem, cam_pose, points, chi2_th: float = CHI2_MONO
) -> BAResult:
    """Orthonormalize + final inlier classification from ANY intermediate
    state (the abort path adopts best-so-far, like the reference's writeback
    after an interrupted optimize — Optimizer.cc:700-778)."""
    base = _base_obs(prob)
    cam_pose = jax.vmap(se3.orthonormalize)(cam_pose)
    final_cost, chi2, z = _total_cost(
        cam_pose, points, prob.K, prob, base, jnp.asarray(False)
    )
    th = _per_obs_chi2_th(prob, chi2_th)
    obs_inlier = base & (chi2 <= th) & (z > 0)
    return BAResult(
        cam_pose=cam_pose, points=points, obs_inlier=obs_inlier,
        final_cost=final_cost,
    )


@partial(jax.jit, static_argnames=("iters1", "iters2"))
def solve_ba(
    prob: BAProblem,
    iters1: int = 5,
    iters2: int = 10,
    chi2_th: float = CHI2_MONO,
    lambda_init: float = 1e-4,
) -> BAResult:
    """Two-phase LM bundle adjustment (the LocalBundleAdjustment schedule:
    5 robust iters, chi2 outlier rejection, 10 non-robust iters —
    Optimizer.cc:617-680) as ONE fused program (the uninterruptible fast
    path; the chunked ba_phase1/ba_phase2_chunk/ba_finalize trio is the
    abortable pipeline variant and computes the same schedule)."""
    cam_pose, points, lam, inlier = ba_phase1(
        prob, iters1, chi2_th, lambda_init
    )
    cam_pose, points, lam = ba_phase2_chunk(
        prob, cam_pose, points, lambda_init, inlier, iters2
    )
    return ba_finalize(prob, cam_pose, points, chi2_th)
