"""Benchmark: per-frame tracking throughput on one chip.

Times the per-frame hot path of the SLAM engine (the workload ranked #1-2 in
SURVEY.md §3: ORB pyramid/FAST/BRIEF extraction + descriptor matching +
motion-only LM pose optimization) as one jitted program on 640x480 frames —
the reference's frame size and feature budget (1000 features, 8 levels —
jni/ORB_SLAM2/src/Tracking.cc:148-153).

Baseline: the reference is an Android phone app with no published numbers
(BASELINE.md); the only in-repo performance anchor is the assumed 30 fps
camera rate (src/Tracking.cc:123-131), so vs_baseline = fps / 30 — how many
times faster than the real-time rate the reference was built around.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

import json
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from weiner_slamit_v2_tpu.config import OrbConfig
    from weiner_slamit_v2_tpu.frontend.extractor import OrbExtractor
    from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
    from weiner_slamit_v2_tpu.ops import hamming
    from weiner_slamit_v2_tpu.optim.pose_opt import optimize_pose

    H, W = 480, 640
    N = 1024
    cfg = OrbConfig(n_features=N)
    ex = OrbExtractor(cfg, (H, W))
    K = jnp.asarray([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])

    def frame_step(image, prev_desc, prev_valid, points, Tcw0):
        feats = ex._extract_impl(image)
        dist = hamming.masked_distance_matrix(
            prev_desc, feats.desc, prev_valid, feats.valid
        )
        idx, best, second = hamming.best_and_second(dist)
        ok = (best <= 50) & (
            best.astype(jnp.float32) < 0.9 * second.astype(jnp.float32)
        )
        uv = feats.xy_und[jnp.maximum(idx, 0)]
        Tcw, inl, n_inl = optimize_pose(
            Tcw0, points, uv, jnp.ones(N), ok, K
        )
        return Tcw, n_inl, feats.desc, feats.valid

    N_STEPS = 200

    @jax.jit
    def run_frames(images, prev_desc, prev_valid, points, Tcw0):
        """Device-resident loop over frames: measures sustained per-chip
        throughput without a host round trip per frame."""

        def body(carry, i):
            Tcw, prev_desc, prev_valid = carry
            img = images[i % images.shape[0]]
            Tcw, n_inl, desc, valid = frame_step(
                img, prev_desc, prev_valid, points, Tcw
            )
            return (Tcw, desc, valid), n_inl

        (Tcw, d, v), n_inls = jax.lax.scan(
            body, (Tcw0, prev_desc, prev_valid), jnp.arange(N_STEPS)
        )
        return Tcw, n_inls

    # realistic textured frames (corners for FAST), deterministic
    seq = make_synthetic_sequence(n_frames=4, h=H, w=W, seed=0, motion="strafe")
    images = jnp.stack([jnp.asarray(f.image) for f in seq.frames])
    rng = np.random.default_rng(0)
    prev_desc = jnp.asarray(rng.integers(0, 2**32, (N, 8), dtype=np.uint32))
    prev_valid = jnp.ones(N, bool)
    points = jnp.asarray(
        np.stack(
            [rng.uniform(-2, 2, N), rng.uniform(-2, 2, N), rng.uniform(3, 8, N)],
            axis=1,
        ).astype(np.float32)
    )
    Tcw0 = jnp.eye(4)

    # warmup / compile
    out = run_frames(images, prev_desc, prev_valid, points, Tcw0)
    jax.block_until_ready(out)

    t0 = time.perf_counter()
    out = run_frames(images, prev_desc, prev_valid, points, Tcw0)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    fps = N_STEPS / dt

    print(
        json.dumps(
            {
                "metric": "tracking_fps_per_chip",
                "value": round(fps, 2),
                "unit": "frames/s (640x480, 1024 ORB feats + match + pose LM)",
                "vs_baseline": round(fps / 30.0, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
