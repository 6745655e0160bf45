"""Cumulative wall-time breakdown of the LIVE bench loop (bench.py config):
wraps the hot methods with timers and reports seconds spent per phase over
the timed window. The per-frame budget at 30 fps is 33.3 ms."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TIMED_FRAMES = 100


def main():
    import jax.numpy as jnp
    import numpy as np

    from weiner_slamit_v2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from weiner_slamit_v2_tpu.config import (
        CameraConfig, OrbConfig, SlamConfig, TrackingConfig,
    )
    from weiner_slamit_v2_tpu.geometry.camera import Camera
    from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
    from weiner_slamit_v2_tpu.tracking import tracker as trk
    from weiner_slamit_v2_tpu.tracking import system as sysmod
    from weiner_slamit_v2_tpu.tracking.system import System

    H, W = 480, 640
    fx = fy = 500.0
    K = np.array([[fx, 0, 320.0], [0, fy, 240.0], [0, 0, 1]], np.float32)
    cfg = SlamConfig(
        orb=OrbConfig(n_features=1024),
        camera=CameraConfig(fx=fx, fy=fy, cx=320.0, cy=240.0, k1=0, k2=0,
                            p1=0, p2=0, k3=0, width=W, height=H),
        tracking=TrackingConfig(mapping_latency_frames=8, frames_per_sync=4),
    )
    cam = Camera.create(fx, fy, 320.0, 240.0, width=W, height=H)
    n_frames = 240 + TIMED_FRAMES
    seq = make_synthetic_sequence(
        n_frames=n_frames, h=H, w=W, seed=0, motion="orbit", K=K,
        motion_frames=164,
    )
    images = [np.asarray(np.clip(f.image, 0, 255), np.uint8) for f in seq.frames]
    stamps = [f.timestamp for f in seq.frames]

    acc = {}
    counts = {}

    def timed(obj, name, label=None):
        label = label or name
        orig = getattr(obj, name)
        acc[label] = 0.0
        counts[label] = 0

        def wrap(*a, **k):
            t0 = time.perf_counter()
            r = orig(*a, **k)
            acc[label] += time.perf_counter() - t0
            counts[label] += 1
            return r

        setattr(obj, name, wrap)

    sys_ = System(cfg, cam, enable_mapping=True)
    np.asarray(jnp.zeros(1))[0]

    warm = 0
    while warm < 240 and not (warm >= 64 and sys_.tracker.n_kf_host >= 17):
        sys_.track_monocular(images[warm], stamps[warm])
        warm += 1
    print(f"warmed {warm} frames, {sys_.tracker.n_kf_host} kfs", flush=True)

    t = sys_.tracker
    timed(t, "_run_scan_batch")
    timed(t, "_resolve_pending")
    timed(t, "_create_keyframe")
    timed(t, "_register_kf_bow")
    timed(sys_, "mapper_idle")
    timed(sys_, "_pre_frame")
    timed(sys_, "_on_new_keyframe")

    # also time the pure upload (jnp.asarray of the image)
    orig_pf = t.process_frame
    acc["upload"] = 0.0
    counts["upload"] = 0

    def pf(image, ts, **k):
        t0 = time.perf_counter()
        img = jnp.asarray(image)
        acc["upload"] += time.perf_counter() - t0
        counts["upload"] += 1
        return orig_pf(img, ts, **k)

    t.process_frame = pf

    t0 = time.perf_counter()
    for i in range(warm, warm + TIMED_FRAMES):
        sys_.track_monocular(images[i], stamps[i])
    dt = time.perf_counter() - t0
    print(f"\ntimed {TIMED_FRAMES} frames in {dt:.3f}s = {TIMED_FRAMES/dt:.2f} fps")
    for k in sorted(acc, key=lambda k: -acc[k]):
        print(f"  {k:24s} {1e3*acc[k]:8.1f} ms total  {counts[k]:4d} calls"
              f"  {1e3*acc[k]/max(counts[k],1):7.2f} ms/call")
    # note: _run_scan_batch includes _resolve_pending (nested); upload is
    # inside process_frame which is inside neither.


if __name__ == "__main__":
    main()
