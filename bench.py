"""Benchmark: END-TO-END System tracking throughput on one chip.

Unlike bench_hotpath.py (which times the device-resident extract+match+pose
scan with no map), this runs the REAL public API — ``System.track_monocular``
with local mapping enabled — over a synthetic 640x480 sequence at the
reference's feature budget (1024 vs 1000 — jni/ORB_SLAM2/src/Tracking.cc:148),
including keyframe insertion, triangulation, local BA, and the per-frame
state machine. The fused tracking step (tracking/tracker.py::_track_step)
performs exactly ONE device->host sync per frame.

Baseline: the reference is an Android phone app with no published numbers
(BASELINE.md); the only in-repo performance anchor is the assumed 30 fps
camera rate (src/Tracking.cc:123-131), so vs_baseline = fps / 30.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

import json
import time

import numpy as np

# Warmup must cover the FULL steady-state program mix before timing starts:
# the per-frame-path compiles, the fused N-frame scan (engages at
# pipeline_warmup_kfs keyframes, ~frame 52), the first keyframe created in
# scan mode, and the nKF=16 vocabulary retrain (~frame 130). Warmup
# therefore runs until the map holds 17 keyframes (capped); compiles are
# one-time session costs and the persistent compile cache also carries them
# across runs.
MIN_WARMUP_FRAMES = 64
MAX_WARMUP_FRAMES = 240
TIMED_FRAMES = 100


def main():
    from weiner_slamit_v2_tpu.config import (
        SlamConfig, CameraConfig, OrbConfig, TrackingConfig,
    )
    from weiner_slamit_v2_tpu.geometry.camera import Camera
    from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
    from weiner_slamit_v2_tpu.tracking.system import System
    from weiner_slamit_v2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

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
        # real-time cadence: the mapper turns a keyframe around in ~8 frames
        # (the reference's thread does the same under load; c1a still forces
        # insertion after max_frames_between_kf). frames_per_sync=4 pipelines
        # four fused tracking steps per device->host sync once the map is
        # mature (config.py TrackingConfig.frames_per_sync).
        tracking=TrackingConfig(mapping_latency_frames=8, frames_per_sync=4),
    )
    cam = Camera.create(fx, fy, cx, cy, width=W, height=H)

    n_frames = MAX_WARMUP_FRAMES + TIMED_FRAMES
    # motion_frames pins the per-frame motion (and keyframe cadence) to the
    # historical 164-frame pace regardless of how much warmup runway the
    # sequence carries
    seq = make_synthetic_sequence(
        n_frames=n_frames, h=H, w=W, seed=0, motion="orbit", K=K,
        motion_frames=164,
    )
    # 8-bit frames, as a camera delivers them: 0.3 MB/frame to upload
    # instead of 1.2 MB
    images = [np.asarray(np.clip(f.image, 0, 255), np.uint8) for f in seq.frames]
    stamps = [f.timestamp for f in seq.frames]

    sys_ = System(cfg, cam, enable_mapping=True)

    # warmup: runs until every one-time session event has happened — the
    # fused-scan compile (engages at 8 keyframes), the first in-scan
    # keyframe's programs, and the nKF=16 vocabulary retrain — so the timed
    # window measures pure steady state. The tracker reads scalars back
    # every frame, so the host clock times finished work.
    warm = 0
    while warm < MAX_WARMUP_FRAMES and not (
        warm >= MIN_WARMUP_FRAMES and sys_.tracker.n_kf_host >= 17
    ):
        sys_.track_monocular(images[warm], stamps[warm])
        warm += 1

    t0 = time.perf_counter()
    n_ok = 0
    for i in range(warm, warm + TIMED_FRAMES):
        out = sys_.track_monocular(images[i], stamps[i])
        n_ok += out.state == "OK"
    dt = time.perf_counter() - t0
    fps = TIMED_FRAMES / dt

    assert n_ok >= 0.9 * TIMED_FRAMES, f"tracking unhealthy: {n_ok} OK frames"

    print(
        json.dumps(
            {
                "metric": "system_tracking_fps_per_chip",
                "value": round(fps, 2),
                "unit": (
                    "frames/s end-to-end (System.track_monocular, 640x480, "
                    "1024 feats, mapping on; hot path alone: bench_hotpath.py)"
                ),
                "vs_baseline": round(fps / 30.0, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
