"""Micro-profile solve_ba internals on a synthetic problem with the bench's
local-BA shapes (C=32, P=2048, O=32). Timed to finished results (block_until_ready)."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timed(fn, *args, n=5, **kw):
    out = fn(*args, **kw)

    def sync(o):
        leaf = jax.tree.leaves(o)[0]
        np.asarray(leaf.ravel()[0] if hasattr(leaf, "ravel") else leaf)

    sync(out)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync(out)
        ts.append(time.perf_counter() - t0)
    return min(ts) * 1e3, out


def make_problem(C=32, P=2048, O=32, seed=0):
    from weiner_slamit_v2_tpu.optim.local_ba import BAProblem

    rng = np.random.RandomState(seed)
    # cameras on a ring looking at origin-ish cloud
    poses = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    poses[:, 0, 3] = rng.uniform(-0.5, 0.5, C)
    poses[:, 1, 3] = rng.uniform(-0.5, 0.5, C)
    poses[:, 2, 3] = rng.uniform(3.5, 4.5, C)
    pts = rng.uniform(-2, 2, (P, 3)).astype(np.float32)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    obs_cam = rng.randint(0, C, (P, O)).astype(np.int32)
    obs_valid = rng.rand(P, O) < 0.3
    # project ground truth + noise
    uvs = np.zeros((P, O, 2), np.float32)
    for o in range(O):
        T = poses[obs_cam[:, o]]
        Pc = (T[:, :3, :3] @ pts[:, :, None])[:, :, 0] + T[:, :3, 3]
        uvs[:, o, 0] = 500 * Pc[:, 0] / Pc[:, 2] + 320
        uvs[:, o, 1] = 500 * Pc[:, 1] / Pc[:, 2] + 240
    uvs += rng.randn(P, O, 2).astype(np.float32)
    prob = BAProblem(
        cam_pose=jnp.asarray(poses),
        cam_fixed=jnp.arange(C) >= C // 2,
        cam_valid=jnp.ones(C, bool),
        points=jnp.asarray(pts + rng.randn(P, 3).astype(np.float32) * 0.01),
        point_valid=jnp.ones(P, bool),
        obs_cam=jnp.where(jnp.asarray(obs_valid), jnp.asarray(obs_cam), -1),
        obs_uv=jnp.asarray(uvs),
        obs_inv_sigma2=jnp.ones((P, O)),
        obs_valid=jnp.asarray(obs_valid),
        K=jnp.asarray(K),
    )
    return prob


def main():
    from weiner_slamit_v2_tpu.optim import local_ba as lb

    prob = make_problem()
    C = prob.cam_pose.shape[0]
    np.asarray(jnp.zeros(1))[0]

    ms, _ = timed(lb.solve_ba, prob, 5, 10)
    print(f"solve_ba(5+10):        {ms:8.1f} ms")
    ms1, _ = timed(lb.solve_ba, prob, 1, 1)
    print(f"solve_ba(1+1):         {ms1:8.1f} ms  -> per-iter ~{(ms-ms1)/13:.1f} ms")

    base_obs = prob.obs_valid & (prob.obs_cam >= 0)
    w = jnp.where(base_obs, prob.obs_inv_sigma2, 0.0)

    bne = jax.jit(
        lambda cp, p, w: lb.build_normal_equations(
            cp, p, prob.K, prob.obs_cam, prob.obs_uv, w, C
        )
    )
    ms_b, (Hcc, bc, Hpp, bp, U) = timed(bne, prob.cam_pose, prob.points, w)
    print(f"build_normal_eqs:      {ms_b:8.1f} ms")

    cam_free = prob.cam_valid & ~prob.cam_fixed
    point_free = prob.point_valid

    ss = jax.jit(
        lambda Hcc, bc, Hpp, bp, U: lb.schur_solve(
            Hcc, bc, Hpp, bp, U, cam_free, point_free, 1e-4
        )
    )
    ms_s, _ = timed(ss, Hcc, bc, Hpp, bp, U)
    print(f"schur_solve:           {ms_s:8.1f} ms")

    tc = jax.jit(
        lambda cp, p: lb._total_cost(
            cp, p, prob.K, prob, base_obs, jnp.asarray(True)
        )
    )
    ms_c, _ = timed(tc, prob.cam_pose, prob.points)
    print(f"_total_cost:           {ms_c:8.1f} ms")

    # schur internals: the dense solve alone
    S = np.eye(C * 6, dtype=np.float32) * 100 + np.ones((C * 6, C * 6), np.float32)
    Sj = jnp.asarray(S)
    bj = jnp.ones(C * 6)
    ms_solve, _ = timed(
        jax.jit(lambda S, b: jax.scipy.linalg.solve(S, b, assume_a="pos")), Sj, bj
    )
    print(f"dense 192 solve alone: {ms_solve:8.1f} ms")

    # scatter-adds alone (Hcc/bc/U4 pattern)
    N = prob.obs_cam.size
    P = prob.points.shape[0]
    cam = jnp.maximum(prob.obs_cam, 0).reshape(N)
    G = jnp.ones((N, 6, 3))
    p_idx = jnp.broadcast_to(
        jnp.arange(P, dtype=jnp.int32)[:, None], (P, prob.obs_cam.shape[1])
    ).reshape(N)

    def scat(cam, G):
        return jnp.zeros((C, P, 6, 3)).at[cam, p_idx].add(G)

    ms_u4, _ = timed(jax.jit(scat), cam, G)
    print(f"U4 scatter alone:      {ms_u4:8.1f} ms")

    blk = jnp.ones((N, 6, 6))

    def scat2(cam, blk):
        return jnp.zeros((C, 6, 6)).at[cam].add(blk)

    ms_hcc, _ = timed(jax.jit(scat2), cam, blk)
    print(f"Hcc scatter alone:     {ms_hcc:8.1f} ms")


if __name__ == "__main__":
    main()
