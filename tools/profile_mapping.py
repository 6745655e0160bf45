"""Profile the local-mapping pass stage-by-stage on the real device.

Builds a representative map by running the bench sequence through the real
System for ~40 frames, snapshots the map right before a keyframe's mapping
pass, then times each mapping_step stage as its own jit program with honest
sync timing (each stage timed to a finished readback).

Usage: python tools/profile_mapping.py [--frames 40]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timed(fn, *args, n=5, **kw):
    # warmup/compile
    out = fn(*args, **kw)
    jax.tree.map(
        lambda a: a.block_until_ready() if hasattr(a, "block_until_ready") else a,
        out,
    )
    # honest: one tiny readback to drain (device-side slice first so the
    # transfer itself stays negligible)
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args()

    from weiner_slamit_v2_tpu.config import (
        CameraConfig, OrbConfig, SlamConfig, TrackingConfig,
    )
    from weiner_slamit_v2_tpu.geometry.camera import Camera
    from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
    from weiner_slamit_v2_tpu.tracking.system import System

    H, W = 480, 640
    fx = fy = 500.0
    cx, cy = 320.0, 240.0
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    cfg = SlamConfig(
        orb=OrbConfig(n_features=1024),
        camera=CameraConfig(
            fx=fx, fy=fy, cx=cx, cy=cy, k1=0, k2=0, p1=0, p2=0, k3=0,
            width=W, height=H,
        ),
        tracking=TrackingConfig(mapping_latency_frames=8),
    )
    cam = Camera.create(fx, fy, cx, cy, width=W, height=H)
    seq = make_synthetic_sequence(
        n_frames=args.frames, h=H, w=W, seed=0, motion="orbit", K=K
    )
    sys_ = System(cfg, cam, enable_mapping=True)
    np.asarray(jnp.zeros(1))[0]

    snap = {}
    orig_hook = sys_._on_new_keyframe

    def capture_hook(kf_id):
        snap["m"] = sys_.tracker.m
        snap["kf"] = kf_id
        orig_hook(kf_id)

    sys_.tracker.mapping_hook = capture_hook
    for i, f in enumerate(seq.frames):
        sys_.track_monocular(np.asarray(f.image, np.float32), f.timestamp)
    sys_.finish()
    assert "m" in snap, "no keyframe was created"
    m, kf = snap["m"], jnp.asarray(snap["kf"])
    print(f"snapshot: kf={snap['kf']}, n_kf={int(m.n_kf)}, n_mp={int(m.n_mp)}, "
          f"valid_mp={int(m.mp_valid.sum())}")

    t = sys_.tracker
    K_, sf, s2, is2 = t.K, t.scale_factors, t.sigma2, t.inv_sigma2

    from weiner_slamit_v2_tpu.slam_map import types as mt
    from weiner_slamit_v2_tpu.slam_map.covisibility import covisibility_matrix
    from weiner_slamit_v2_tpu.slam_map.point_stats import refresh_point_stats
    from weiner_slamit_v2_tpu.tracking import local_mapping as lm

    nn = cfg.mapping.triangulation_neighbors

    # --- whole pass -------------------------------------------------------
    whole = jax.jit(
        lm.mapping_step, static_argnames=("cfg", "n_neighbors", "run_ba", "run_culling")
    )
    ms, _ = timed(whole, m, kf, K_, sf, s2, is2, cfg, n_neighbors=nn)
    print(f"mapping_step (whole): {ms:8.1f} ms")

    # --- stages -----------------------------------------------------------
    ms_cull, m1 = timed(
        jax.jit(lm.cull_map_points, static_argnames=("cfg",)), m, kf, cfg
    )
    print(f"  cull_map_points:    {ms_cull:8.1f} ms")

    ms_cov, W_ = timed(jax.jit(covisibility_matrix), m1)
    print(f"  covisibility_mat:   {ms_cov:8.1f} ms")

    vals, idx = jax.lax.top_k(W_[kf], min(nn, m.max_kf))

    ms_tri, m2 = timed(
        jax.jit(lm.triangulate_with_neighbors, static_argnames=("cfg",)),
        m1, kf, idx, vals > 0, K_, sf, s2, cfg,
    )
    print(f"  triangulate:        {ms_tri:8.1f} ms")

    ms_fuse, m3 = timed(
        jax.jit(lm.fuse_in_neighbors, static_argnames=("cfg",)),
        m2, kf, idx, vals > 0, K_, sf, s2, cfg,
    )
    print(f"  fuse_in_neighbors:  {ms_fuse:8.1f} ms")

    ms_stats, m4 = timed(jax.jit(refresh_point_stats), m3, sf)
    print(f"  refresh_stats:      {ms_stats:8.1f} ms")

    from weiner_slamit_v2_tpu.optim.ba_extract import extract_local_ba, write_back_ba
    from weiner_slamit_v2_tpu.optim.local_ba import solve_ba

    def ba_all(mm):
        prob, cam_ids, point_ids = extract_local_ba(
            mm, kf, K_, is2,
            window=cfg.capacity.local_ba_window,
            n_fixed=cfg.capacity.local_ba_window,
            max_points=cfg.capacity.local_ba_points,
            bf=cfg.camera.baseline_times_fx,
        )
        res = solve_ba(prob, cfg.optim.local_ba_iters1, cfg.optim.local_ba_iters2)
        return write_back_ba(mm, res, prob, cam_ids, point_ids, rebuild=False)

    ms_ba, m5 = timed(jax.jit(ba_all), m4)
    print(f"  local_ba (e+s+w):   {ms_ba:8.1f} ms")

    # BA decomposition
    def ba_extract_only(mm):
        return extract_local_ba(
            mm, kf, K_, is2,
            window=cfg.capacity.local_ba_window,
            n_fixed=cfg.capacity.local_ba_window,
            max_points=cfg.capacity.local_ba_points,
            bf=cfg.camera.baseline_times_fx,
        )

    ms_ext, (prob, cam_ids, point_ids) = timed(jax.jit(ba_extract_only), m4)
    print(f"    extract_local_ba: {ms_ext:8.1f} ms")
    ms_solve, res = timed(
        solve_ba,  # already jitted with static iters
        prob, cfg.optim.local_ba_iters1, cfg.optim.local_ba_iters2,
    )
    print(f"    solve_ba:         {ms_solve:8.1f} ms")
    ms_wb, _ = timed(
        jax.jit(write_back_ba, static_argnames=("rebuild",)),
        m4, res, prob, cam_ids, point_ids, rebuild=False,
    )
    print(f"    write_back_ba:    {ms_wb:8.1f} ms")

    ms_kfc, m6 = timed(
        jax.jit(lm.cull_keyframes, static_argnames=("cfg",)), m5, kf, cfg
    )
    print(f"  cull_keyframes:     {ms_kfc:8.1f} ms")

    ms_rb, _ = timed(jax.jit(mt.rebuild_observation_lists), m6)
    print(f"  rebuild_obs_lists:  {ms_rb:8.1f} ms")

    tot = ms_cull + ms_cov + ms_tri + ms_fuse + ms_stats + ms_ba + ms_kfc + ms_rb
    print(f"  --- sum of stages: {tot:8.1f} ms (whole {ms:.1f})")

    # fuse decomposition: scan part only
    def fuse_scan_only(mm):
        inv_s2 = 1.0 / s2
        W2 = covisibility_matrix(mm)
        sec_vals, sec_idx = jax.lax.top_k(
            W2[jnp.maximum(idx, 0)], min(5, mm.max_kf)
        )
        targets = jnp.concatenate([idx, sec_idx.reshape(-1)])
        return targets

    # observation_indicator cost alone
    ms_oi, _ = timed(jax.jit(mt.observation_indicator), m1)
    print(f"  [observation_indicator alone: {ms_oi:8.1f} ms]")


if __name__ == "__main__":
    main()
