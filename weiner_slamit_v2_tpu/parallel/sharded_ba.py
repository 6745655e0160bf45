"""Distributed bundle adjustment: Schur reduction over device collectives.

The reference has no distributed analogue — its "communication backend" is
mutexes + shared memory in one process (SURVEY.md §5). This module is the
north-star component (BASELINE.json): the map's points (and their
observations) are partitioned across chips; each chip accumulates the normal
equations of its point shard, the *reduced camera system* is summed over the
mesh with ``jax.lax.psum``, every chip solves the small dense
camera system redundantly (cheaper than scattering a 6Cx6C solve), and point
back-substitution stays local to the shard.

Communication per LM iteration: one psum of (6C)^2 + 6C floats — for a
C=64-camera window that is ~590 KB, well under a millisecond over NVLink
at its 450 GB/s each way; everything else
is local. This is the distributed-Schur recipe of scaling BA, expressed as
``shard_map`` + XLA collectives instead of MPI.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import se3
from ..optim.local_ba import (
    BAProblem,
    BAResult,
    _chi2_planes,
    _robust_cost,
    _robust_weight,
    build_normal_equations,
    schur_solve,
)

CHI2_MONO = 5.991


def make_ba_mesh(devices=None, axis: str = "ba") -> Mesh:
    import numpy as np

    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def shard_problem(prob: BAProblem, mesh: Mesh, axis: str = "ba") -> BAProblem:
    """Place the problem: point-major arrays sharded over the mesh axis,
    camera arrays + K replicated. Stereo planes (obs_ur/obs_has_ur) shard
    with the observations; bf replicates."""
    pt = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    def put(x, sh):
        return jax.device_put(x, sh)

    return BAProblem(
        cam_pose=put(prob.cam_pose, rep),
        cam_fixed=put(prob.cam_fixed, rep),
        cam_valid=put(prob.cam_valid, rep),
        points=put(prob.points, pt),
        point_valid=put(prob.point_valid, pt),
        obs_cam=put(prob.obs_cam, pt),
        obs_uv=put(prob.obs_uv, pt),
        obs_inv_sigma2=put(prob.obs_inv_sigma2, pt),
        obs_valid=put(prob.obs_valid, pt),
        K=put(prob.K, rep),
        obs_ur=put(prob.obs_ur, pt) if prob.obs_ur is not None else None,
        obs_has_ur=(
            put(prob.obs_has_ur, pt) if prob.obs_has_ur is not None else None
        ),
        bf=put(prob.bf, rep) if prob.bf is not None else None,
    )


def _local_cost(cam_pose, points, K, obs_cam, obs_uv, inv_sigma2, active,
                robust, obs_ur=None, obs_has_ur=None, bf=None, huber2=None):
    C = cam_pose.shape[0]
    r2, z = _chi2_planes(
        cam_pose, points, K, obs_cam, obs_uv, C, obs_ur, obs_has_ur, bf
    )
    chi2 = r2 * inv_sigma2
    cost = (
        _robust_cost(chi2, robust)
        if huber2 is None
        else _robust_cost(chi2, robust, huber2)
    )
    ok = active & (z > 0)
    return jnp.sum(jnp.where(ok, cost, 0.0)), chi2, z


def solve_ba_sharded(
    prob: BAProblem,
    mesh: Mesh,
    iters1: int = 5,
    iters2: int = 10,
    chi2_th: float = CHI2_MONO,
    lambda_init: float = 1e-4,
    axis: str = "ba",
) -> BAResult:
    """Distributed two-phase LM BA. Semantically identical to
    optim.local_ba.solve_ba; the P (points) axis is sharded over `mesh`.
    Stereo problems (obs_ur/obs_has_ur/bf set) keep their 3-dof rows —
    the planes shard with the observations."""
    C = prob.cam_pose.shape[0]
    stereo = prob.obs_ur is not None
    st_specs = (P(axis), P(axis), P()) if stereo else ()

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(), P(),                 # cam_pose, cam_fixed, cam_valid
            P(axis), P(axis),              # points, point_valid
            P(axis), P(axis), P(axis), P(axis),  # obs_*
            P(),                           # K
        ) + st_specs,
        out_specs=(P(), P(axis), P(axis), P()),
        check_vma=False,
    )
    def run(cam_pose, cam_fixed, cam_valid, points, point_valid,
            obs_cam, obs_uv, obs_inv_sigma2, obs_valid, K, *st):
        obs_ur, obs_has_ur, bf = st if stereo else (None, None, None)
        # per-observation Huber delta^2 / chi2 gate: 7.815 stereo, 5.991 mono
        th_obs = (
            jnp.where(obs_has_ur, 7.815, CHI2_MONO) if stereo else None
        )
        base_obs = (
            obs_valid
            & (obs_cam >= 0)
            & point_valid[:, None]
            & cam_valid[jnp.maximum(obs_cam, 0)]
        )
        cam_free = cam_valid & ~cam_fixed
        point_free = point_valid & (base_obs.sum(axis=1) > 0)

        def lm_phase(cam_pose, points, active_obs, robust, n_iters, lam0):
            def step(_, state):
                cam_pose, points, lam = state
                c0, chi2, _ = _local_cost(
                    cam_pose, points, K, obs_cam, obs_uv, obs_inv_sigma2,
                    active_obs, robust, obs_ur, obs_has_ur, bf, th_obs,
                )
                w = obs_inv_sigma2 * (
                    _robust_weight(chi2, robust, th_obs)
                    if stereo else _robust_weight(chi2, robust)
                )
                w = jnp.where(active_obs, w, 0.0)
                Hcc, bc, Hpp, bp, U = build_normal_equations(
                    cam_pose, points, K, obs_cam, obs_uv, w, C,
                    obs_ur, obs_has_ur, bf,
                )
                # ---- distributed Schur: local point marginalization; the
                # reduced camera system is psum'd over the mesh inside
                # schur_solve, points stay shard-local -----------------------
                dc, dp = schur_solve(
                    Hcc, bc, Hpp, bp, U, cam_free, point_free, lam,
                    psum_axis=axis,
                )

                new_pose = jax.vmap(se3.retract)(cam_pose, dc)
                new_pts = points + dp
                c1_l, _, _ = _local_cost(
                    new_pose, new_pts, K, obs_cam, obs_uv, obs_inv_sigma2,
                    active_obs, robust, obs_ur, obs_has_ur, bf, th_obs,
                )
                c0 = jax.lax.psum(c0, axis)
                c1 = jax.lax.psum(c1_l, axis)
                n_bad_dp = jax.lax.psum(
                    (~jnp.isfinite(dp)).sum().astype(jnp.int32), axis
                )
                finite = (
                    jnp.isfinite(c1) & jnp.all(jnp.isfinite(dc)) & (n_bad_dp == 0)
                )
                accept = (c1 < c0) & finite
                cam_pose = jnp.where(accept, new_pose, cam_pose)
                points = jnp.where(accept, new_pts, points)
                lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 8.0), 1e-5, 1e3)
                return cam_pose, points, lam

            cam_pose, points, _ = jax.lax.fori_loop(
                0, n_iters, step, (cam_pose, points, lam0)
            )
            return cam_pose, points

        cam_pose, points = lm_phase(
            cam_pose, points, base_obs, jnp.asarray(True), iters1, lambda_init
        )
        _, chi2, z = _local_cost(
            cam_pose, points, K, obs_cam, obs_uv, obs_inv_sigma2, base_obs,
            jnp.asarray(True), obs_ur, obs_has_ur, bf, th_obs,
        )
        th = th_obs if stereo else chi2_th
        inlier = base_obs & (chi2 <= th) & (z > 0)
        cam_pose, points = lm_phase(
            cam_pose, points, inlier, jnp.asarray(False), iters2, lambda_init
        )
        cam_pose = jax.vmap(se3.orthonormalize)(cam_pose)
        # final cost over every base observation, as local_ba.ba_finalize
        # reports it (chi2 and depth do not depend on the active set)
        fc_l, chi2, z = _local_cost(
            cam_pose, points, K, obs_cam, obs_uv, obs_inv_sigma2, base_obs,
            jnp.asarray(False), obs_ur, obs_has_ur, bf, th_obs,
        )
        obs_inlier = base_obs & (chi2 <= th) & (z > 0)
        final_cost = jax.lax.psum(fc_l, axis)
        return cam_pose, points, obs_inlier, final_cost

    st_vals = (prob.obs_ur, prob.obs_has_ur, prob.bf) if stereo else ()
    cam_pose, points, obs_inlier, final_cost = run(
        prob.cam_pose, prob.cam_fixed, prob.cam_valid, prob.points,
        prob.point_valid, prob.obs_cam, prob.obs_uv, prob.obs_inv_sigma2,
        prob.obs_valid, prob.K, *st_vals,
    )
    return BAResult(
        cam_pose=cam_pose, points=points, obs_inlier=obs_inlier,
        final_cost=final_cost,
    )
