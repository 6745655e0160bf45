"""Essential-graph optimization: Gauss-Newton over Sim3 keyframe poses.

JAX replacement for ``Optimizer::OptimizeEssentialGraph``
(jni/ORB_SLAM2/src/Optimizer.cc:781-1044): the reference builds a g2o graph
with Sim3 vertices (BlockSolver_7_3, lambda 1e-16, 20 iterations) over
spanning-tree + covisibility(>=100) + loop edges. Here:

* all edge residuals r_e = log(S_meas^-1 S_j S_i^-1) are evaluated in one
  vmapped batch, with Jacobians from jax.jacfwd in the tangent space
  (replacing g2o's numeric/analytic edge jacobians);
* the normal equations are solved either dense over 7K variables (K = keyframe
  capacity, <= a few hundred -> a small dense Cholesky) or — for
  large maps — by block-Jacobi-preconditioned conjugate gradient on the
  *block-sparse* system: H·x products are evaluated straight from the per-edge
  (7,7) blocks with two gathers and two scatter-adds, so memory stays
  O(E·49 + K·49) instead of O((7K)^2) and K=1024+ keyframes are tractable
  (the reference's g2o uses sparse Cholesky; CG over gathers and
  scatter-adds is the array equivalent). solver="auto" picks dense
  below 320 keyframes, PCG above;
* fixed gauge: the loop keyframe (Optimizer.cc:840).

After convergence the Sim3 poses are mapped back to SE3 (t / s — the same
recovery as Optimizer.cc:1003-1012) and map points are corrected with the
relative transform of their reference keyframe (Optimizer.cc:1015-1041).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry import sim3


def _solve_dense(
    D: jnp.ndarray,        # (K, 7, 7) damped+masked diagonal blocks
    Hij: jnp.ndarray,      # (E, 7, 7) off-diagonal blocks (rows=i dofs)
    ei: jnp.ndarray,
    ej: jnp.ndarray,
    off_ok: jnp.ndarray,   # (E,) include the off-diagonal block
    b: jnp.ndarray,        # (K, 7)
) -> jnp.ndarray:
    """Materialize the full (7K, 7K) system and solve with dense Cholesky."""
    K = D.shape[0]
    Ho = Hij * off_ok[:, None, None]
    H = jnp.zeros((K, K, 7, 7))
    H = H.at[jnp.arange(K), jnp.arange(K)].set(D)
    H = H.at[ei, ej].add(Ho)
    H = H.at[ej, ei].add(jnp.swapaxes(Ho, -1, -2))
    Hd = H.transpose(0, 2, 1, 3).reshape(K * 7, K * 7) + 1e-8 * jnp.eye(K * 7)
    return jax.scipy.linalg.solve(Hd, b.reshape(-1), assume_a="pos").reshape(K, 7)


def _solve_pcg(
    D: jnp.ndarray,
    Hij: jnp.ndarray,
    ei: jnp.ndarray,
    ej: jnp.ndarray,
    off_ok: jnp.ndarray,
    b: jnp.ndarray,
    cg_iters: int,
) -> jnp.ndarray:
    """Block-Jacobi preconditioned CG on the block-sparse normal equations.

    Never materializes H: the matvec gathers x at each edge's endpoints,
    applies the cached (7,7) blocks, and scatter-adds — the same access
    pattern a sharded solver would psum across devices
    (parallel/sharded_ba.py).
    """
    K = D.shape[0]
    Ho = Hij * off_ok[:, None, None]
    HoT = jnp.swapaxes(Ho, -1, -2)

    def matvec(x):
        y = jnp.einsum("kab,kb->ka", D, x)
        y = y.at[ei].add(jnp.einsum("eab,eb->ea", Ho, x[ej]))
        y = y.at[ej].add(jnp.einsum("eab,eb->ea", HoT, x[ei]))
        return y

    # block-Jacobi preconditioner: inverse of each (damped) diagonal block
    Minv = jnp.linalg.inv(D + 1e-8 * jnp.eye(7))

    def precond(r):
        return jnp.einsum("kab,kb->ka", Minv, r)

    x = jnp.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = jnp.sum(r * z)
    b2 = jnp.maximum(jnp.sum(b * b), 1e-30)

    def body(_, carry):
        x, r, p, rz = carry
        done = jnp.sum(r * r) <= 1e-12 * b2
        Ap = matvec(p)
        alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = precond(r_n)
        rz_n = jnp.sum(r_n * z_n)
        beta = rz_n / jnp.maximum(rz, 1e-30)
        p_n = z_n + beta * p
        keep = lambda new, old: jnp.where(done, old, new)
        return keep(x_n, x), keep(r_n, r), keep(p_n, p), keep(rz_n, rz)

    x, _, _, _ = jax.lax.fori_loop(0, cg_iters, body, (x, r, p, rz))
    return x


@partial(jax.jit, static_argnames=("n_iters", "fix_scale", "solver", "cg_iters"))
def optimize_pose_graph(
    S_init: jnp.ndarray,      # (K, 4, 4) initial Sim3 poses (world->kf)
    kf_valid: jnp.ndarray,    # (K,) bool
    fixed: jnp.ndarray,       # (K,) bool — gauge-fixed vertices
    edge_i: jnp.ndarray,      # (E,) int32 source vertex (or -1 for padding)
    edge_j: jnp.ndarray,      # (E,) int32 target vertex
    edge_S_ji: jnp.ndarray,   # (E, 4, 4) measured relative Sim3 S_j S_i^-1
    edge_valid: jnp.ndarray,  # (E,)
    n_iters: int = 20,
    lambda_init: float = 1e-6,
    fix_scale: bool = False,
    solver: str = "auto",
    cg_iters: int = 64,
) -> jnp.ndarray:
    """Returns optimized (K, 4, 4) Sim3 poses.

    fix_scale freezes the log-scale dof of every vertex (VertexSim3Expmap
    _fix_scale for stereo/RGB-D — src/Optimizer.cc:818, set from bFixScale
    at src/LoopClosing.cc:73): a metric map must never be rescaled by a
    loop closure.

    solver: "dense" (exact, O((7K)^2) memory), "pcg" (block-sparse
    matrix-free CG, O(E+K) memory — required past a few hundred keyframes),
    or "auto" (dense for K <= 320)."""
    if solver == "auto":
        solver = "dense" if S_init.shape[0] <= 320 else "pcg"
    K = S_init.shape[0]
    E = edge_i.shape[0]
    ei = jnp.maximum(edge_i, 0)
    ej = jnp.maximum(edge_j, 0)
    ev = edge_valid & (edge_i >= 0) & (edge_j >= 0)
    ev = ev & kf_valid[ei] & kf_valid[ej]
    S_meas_inv = jax.vmap(sim3.inv)(edge_S_ji)

    free = kf_valid & ~fixed

    def edge_residual(xi_i, xi_j, Si, Sj, Sm_inv):
        """r = log(S_meas^-1 · exp(xi_j) Sj · (exp(xi_i) Si)^-1) — 7-vector."""
        Sj_new = sim3.exp(xi_j) @ Sj
        Si_new = sim3.exp(xi_i) @ Si
        return sim3.log(Sm_inv @ Sj_new @ sim3.inv(Si_new))

    def all_residuals(S):
        zero = jnp.zeros(7)
        return jax.vmap(
            lambda i, j, sm: edge_residual(zero, zero, S[i], S[j], sm)
        )(ei, ej, S_meas_inv)

    def cost_of(S):
        r = all_residuals(S)
        return jnp.sum(jnp.where(ev[:, None], r * r, 0.0))

    def step(_, carry):
        S, lam = carry
        zero = jnp.zeros(7)
        # residuals + jacobians per edge (autodiff in tangent space)
        def per_edge(i, j, sm):
            Si, Sj = S[i], S[j]
            r = edge_residual(zero, zero, Si, Sj, sm)
            Ji = jax.jacfwd(lambda x: edge_residual(x, zero, Si, Sj, sm))(zero)
            Jj = jax.jacfwd(lambda x: edge_residual(zero, x, Si, Sj, sm))(zero)
            return r, Ji, Jj

        r, Ji, Jj = jax.vmap(per_edge)(ei, ej, S_meas_inv)  # (E,7),(E,7,7),(E,7,7)
        w = ev.astype(jnp.float32)
        Ji = Ji * w[:, None, None]
        Jj = Jj * w[:, None, None]

        # per-edge (7,7) normal-equation blocks — all either solver needs
        Hii = jnp.einsum("eij,eik->ejk", Ji, Ji)
        Hjj = jnp.einsum("eij,eik->ejk", Jj, Jj)
        Hij = jnp.einsum("eij,eik->ejk", Ji, Jj)
        bi = -jnp.einsum("eij,ei->ej", Ji, r * w[:, None])
        bj = -jnp.einsum("eij,ei->ej", Jj, r * w[:, None])

        D = jnp.zeros((K, 7, 7)).at[ei].add(Hii).at[ej].add(Hjj)
        b = jnp.zeros((K, 7)).at[ei].add(bi).at[ej].add(bj)

        # LM damping on the diagonal blocks
        damp = lam * jnp.maximum(jnp.einsum("kii->ki", D), 1e-6)
        D = D + damp[:, :, None] * jnp.eye(7)

        # freeze fixed/invalid vertices: identity diagonal block, zero rhs,
        # drop every off-diagonal block touching them -> dx == 0 there
        D = jnp.where(free[:, None, None], D, jnp.eye(7))
        b = jnp.where(free[:, None], b, 0.0)
        off_ok = (free[ei] & free[ej]).astype(jnp.float32)

        if fix_scale:
            # freeze the sigma (log-scale) dof: zero its rows/cols, unit
            # diagonal -> dx[:, 6] == 0 exactly
            sel = jnp.arange(7) == 6
            kill = sel[None, :, None] | sel[None, None, :]
            D = jnp.where(kill, 0.0, D).at[:, 6, 6].set(1.0)
            Hoff = jnp.where(kill, 0.0, Hij)
            b = jnp.where(sel[None, :], 0.0, b)
        else:
            Hoff = Hij

        if solver == "dense":
            dx = _solve_dense(D, Hoff, ei, ej, off_ok, b)
        else:
            dx = _solve_pcg(D, Hoff, ei, ej, off_ok, b, cg_iters)
        dx = jnp.where(free[:, None], dx, 0.0)

        S_new = jax.vmap(lambda s, x: sim3.exp(x) @ s)(S, dx)
        c0 = cost_of(S)
        c1 = cost_of(S_new)
        ok = (c1 < c0) & jnp.all(jnp.isfinite(S_new))
        S = jnp.where(ok, S_new, S)
        lam = jnp.clip(jnp.where(ok, lam * 0.5, lam * 8.0), 1e-8, 1e3)
        return S, lam

    S, _ = jax.lax.fori_loop(0, n_iters, step, (S_init, lambda_init))
    return S


def correct_map_after_pose_graph(
    mp_pos: jnp.ndarray,       # (M, 3)
    mp_valid: jnp.ndarray,
    mp_ref_kf: jnp.ndarray,    # (M,) reference keyframe per point
    S_old: jnp.ndarray,        # (K, 4, 4) pre-optimization Sim3 (world->kf)
    S_new: jnp.ndarray,        # (K, 4, 4) optimized
) -> jnp.ndarray:
    """Transform map points with their reference keyframe's correction:
    X' = S_new_ref^-1 · S_old_ref · X (Optimizer.cc:1015-1041)."""
    ref = jnp.maximum(mp_ref_kf, 0)
    corr = jax.vmap(lambda a, b: sim3.inv(a) @ b)(S_new, S_old)  # (K,4,4)
    Xc = jax.vmap(lambda T, x: sim3.apply(T, x))(corr[ref], mp_pos)
    ok = mp_valid & (mp_ref_kf >= 0)
    return jnp.where(ok[:, None], Xc, mp_pos)
