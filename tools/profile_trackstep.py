"""Time each stage of the fused _track_step on the real device.

Builds steady-state session state (55 frames through the real System), then
times the stage functions as standalone jit programs on the live inputs:
N dispatches + one sync, minus the cost of a bare sync.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timeit(label, fn, *args, n=10, **kw):
    out = fn(*args, **kw)  # compile
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n * 1e3
    print(f"{label:28s} {dt:8.2f} ms", flush=True)
    return out


def main():
    from weiner_slamit_v2_tpu.config import (
        CameraConfig, OrbConfig, SlamConfig, TrackingConfig,
    )
    from weiner_slamit_v2_tpu.geometry.camera import Camera
    from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
    from weiner_slamit_v2_tpu.tracking import tracker as trk
    from weiner_slamit_v2_tpu.tracking.system import System

    H, W = 480, 640
    fx = fy = 500.0
    K = np.array([[fx, 0, 320.0], [0, fy, 240.0], [0, 0, 1]], np.float32)
    cfg = SlamConfig(
        orb=OrbConfig(n_features=1024),
        camera=CameraConfig(fx=fx, fy=fy, cx=320.0, cy=240.0, k1=0, k2=0,
                            p1=0, p2=0, k3=0, width=W, height=H),
        # frames_per_sync=1: keep the per-frame path so state is materialized
        tracking=TrackingConfig(mapping_latency_frames=8, frames_per_sync=1),
    )
    cam = Camera.create(fx, fy, 320.0, 240.0, width=W, height=H)
    seq = make_synthetic_sequence(n_frames=56, h=H, w=W, seed=0,
                                  motion="orbit", K=K)
    sys_ = System(cfg, cam)
    for i, f in enumerate(seq.frames):
        sys_.track_monocular(np.asarray(f.image, np.float32), i / 30.0)
    t = sys_.tracker
    assert t.state == "OK"
    # poison sync
    np.asarray(t.last_Tcw)

    img = jnp.asarray(seq.frames[-1].image, jnp.float32)
    feats = t._extract_track(img)
    jax.block_until_ready(feats.desc)

    m = t.m
    p = t.params.replace(local_th=jnp.asarray(1.0, jnp.float32))
    statics = dict(
        n_levels=cfg.orb.n_levels,
        max_local_points=cfg.capacity.local_ba_points,
        local_kf_cap=cfg.tracking.local_map_kf_cap,
        pose_rounds=cfg.optim.pose_opt_rounds,
        pose_iters=cfg.optim.pose_opt_iters,
        histo_bins=cfg.matcher.histo_length,
    )
    print(f"map: n_kf={t.n_kf_host} max_kf={m.max_kf} max_mp={m.max_mp} "
          f"local_pts={statics['max_local_points']} "
          f"kf_cap={statics['local_kf_cap']}")

    timeit("extract+undistort", t._extract_track, img)

    vel = t.velocity if t.velocity is not None else jnp.eye(4)
    Tcw_pred = vel @ t.last_Tcw

    f_motion = jax.jit(lambda m, feats, lobs, loct, lang, T, window: trk._track_last_frame(
        m, feats, lobs, loct, lang, T, t.K, window, t.scale_factors,
        cfg.orb.n_levels, p.nn_ratio_motion, p.th_high,
        cfg.matcher.histo_length, forward=False, backward=False))
    obs_a, n_a = timeit(
        "motion match", f_motion, m, feats, t.last_obs,
        t.last_feats.octave, t.last_feats.angle, Tcw_pred, p.motion_window,
    )

    f_ref = jax.jit(lambda m, feats: trk._match_reference_kf(
        m, feats, jnp.asarray(t.ref_kf), p.nn_ratio_refkf, p.th_low,
        cfg.matcher.histo_length))
    timeit("ref-kf match (cond arm)", f_ref, m, feats)

    f_pose = jax.jit(lambda m, feats, obs, T: trk._pose_opt_on_obs(
        m, feats, obs, T, t.K, t.inv_sigma2,
        cfg.optim.pose_opt_rounds, cfg.optim.pose_opt_iters, p.lm_lambda))
    Tcw1, obs_d, n_i1 = timeit("pose LM #1", f_pose, m, feats, obs_a, Tcw_pred)

    f_local = jax.jit(lambda m, feats, obs, T: trk._track_local_map(
        m, feats, obs, T, t.K, t.scale_factors, p.local_th,
        cfg.orb.n_levels, p.nn_ratio_localmap, p.th_high,
        max_local_points=cfg.capacity.local_ba_points,
        local_kf_cap=cfg.tracking.local_map_kf_cap))
    obs_e, visible = timeit("local-map search", f_local, m, feats, obs_d, Tcw1)

    timeit("pose LM #2", f_pose, m, feats, obs_e, Tcw1)

    f_full = jax.jit(lambda m, feats: trk._track_step_impl(
        m, feats, t.last_obs, t.last_feats.octave, t.last_feats.angle,
        jnp.asarray(True), vel, t.last_Tcw, jnp.asarray(t.ref_kf),
        t.K, t.scale_factors, t.inv_sigma2, p, **statics))
    timeit("FULL _track_step", f_full, m, feats)

    # the fused scan body = extract + track: compare 4-frame batch
    imgs = jnp.stack([jnp.asarray(seq.frames[-1 - i].image, jnp.float32)
                      for i in range(4)])

    def scan4(m, imgs):
        def body(carry, img):
            lobs, lT = carry
            fe = t.extractor._extract_impl(img)
            fe = fe.replace(xy_und=cam.undistort_points(fe.xy))
            m2, Tcw, cur_obs, vel_new, T_cr, scalars, inc = trk._track_step_impl(
                m, fe, lobs, t.last_feats.octave, t.last_feats.angle,
                jnp.asarray(True), vel, lT, jnp.asarray(t.ref_kf),
                t.K, t.scale_factors, t.inv_sigma2, p, **statics)
            return (cur_obs, Tcw), scalars

        return jax.lax.scan(body, (t.last_obs, t.last_Tcw), imgs)

    scan4_j = jax.jit(scan4)
    timeit("scan4 (extract+track x4)", scan4_j, m, imgs, n=5)


if __name__ == "__main__":
    main()
