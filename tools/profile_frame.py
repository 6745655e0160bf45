"""Profile the steady-state tracked frame on the real device.

Runs the bench sequence through System, then times (a) the whole
track_monocular call per frame (median/p90), (b) the extract dispatch alone,
(c) the fused _track_step alone, each timed to finished results.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from weiner_slamit_v2_tpu.config import (
        CameraConfig, OrbConfig, SlamConfig, TrackingConfig,
    )
    from weiner_slamit_v2_tpu.geometry.camera import Camera
    from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
    from weiner_slamit_v2_tpu.tracking.system import System
    from weiner_slamit_v2_tpu.tracking import tracker as trk

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
    n_frames = 80
    seq = make_synthetic_sequence(
        n_frames=n_frames, h=H, w=W, seed=0, motion="orbit", K=K
    )
    images = [np.asarray(f.image, np.float32) for f in seq.frames]
    sys_ = System(cfg, cam, enable_mapping=True)
    np.asarray(jnp.zeros(1))[0]

    # warmup 16 frames
    for i in range(16):
        sys_.track_monocular(images[i], seq.frames[i].timestamp)

    # per-frame timing
    times = []
    kf_frames = []
    for i in range(16, n_frames):
        t0 = time.perf_counter()
        out = sys_.track_monocular(images[i], seq.frames[i].timestamp)
        dt = (time.perf_counter() - t0) * 1e3
        times.append(dt)
        if out.created_kf:
            kf_frames.append(i - 16)
    times = np.asarray(times)
    print(f"frames: {len(times)}, keyframes at {kf_frames}")
    print(f"per-frame ms: median {np.median(times):.1f}  p90 "
          f"{np.percentile(times, 90):.1f}  max {times.max():.1f}")
    print(f"fps (all): {1000.0 / times.mean():.1f}")
    nk = np.ones(len(times), bool)
    for k in kf_frames:
        nk[k:k + 3] = False
    print(f"steady (no-KF) median: {np.median(times[nk]):.1f} ms")

    # --- components --------------------------------------------------------
    t = sys_.tracker
    img = jnp.asarray(images[-1])

    def timed(fn, *args, n=8, **kw):
        out = fn(*args, **kw)
        leaf = jax.tree.leaves(out)[0]
        np.asarray(leaf.ravel()[0] if hasattr(leaf, "ravel") else leaf)
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            leaf = jax.tree.leaves(out)[0]
            np.asarray(leaf.ravel()[0] if hasattr(leaf, "ravel") else leaf)
            ts.append(time.perf_counter() - t0)
        return min(ts) * 1e3, out

    ms_ex, feats = timed(t._extract_track, img)
    print(f"extract+undistort: {ms_ex:.1f} ms")

    p = t.params
    has_vel = t.velocity is not None
    vel = t.velocity if has_vel else t._eye4
    ms_ts, _ = timed(
        trk._track_step,
        t.m, feats, t.last_obs, t.last_feats.octave, t.last_feats.angle,
        jnp.asarray(has_vel), vel, t.last_Tcw,
        jnp.asarray(t.ref_kf, jnp.int32), t.K, t.scale_factors,
        t.inv_sigma2, p,
        n_levels=cfg.orb.n_levels,
        max_local_points=cfg.capacity.local_ba_points,
        local_kf_cap=cfg.tracking.local_map_kf_cap,
        pose_rounds=cfg.optim.pose_opt_rounds,
        pose_iters=cfg.optim.pose_opt_iters,
        histo_bins=cfg.matcher.histo_length,
    )
    print(f"_track_step:       {ms_ts:.1f} ms")

    # empty sync round-trip for reference
    zero = jnp.zeros(())
    f0 = jax.jit(lambda x: x + 1)
    ms0, _ = timed(f0, zero)
    print(f"sync floor:        {ms0:.1f} ms")


if __name__ == "__main__":
    main()
