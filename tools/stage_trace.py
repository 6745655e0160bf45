"""Device time of single stages against a tracked frame's, from traces.

    python tools/stage_trace.py

Needs a GPU. Runs chip_smoke.py's monocular session (640x480, 1024
features, mapping and loop closing on), traces a steady window of frames
with jax.profiler and reduces it to device busy time per frame. Then traces
two stages alone, each as one compiled program called repeatedly at the
benchmark's shapes: FAST score+NMS over the 8 pyramid levels of a frame,
and the fuse matcher over 20 targets x 1024 points x 1024 features. Prints
one JSON line with each stage's device time per call and its share of a
frame's device time.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WARM_FRAMES = 150
TRACED_FRAMES = 48
REPS = 50


def trace_busy(fn) -> tuple[dict, float]:
    """Run fn under the profiler; (GPU 0's busy/span/kernels, wall s)."""
    from weiner_slamit_v2_tpu.utils.profiling import device_busy, device_trace

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        with device_trace(d):
            fn()
        wall = time.perf_counter() - t0
        return device_busy(d)["/device:GPU:0"], wall


def traced(fn, reps: int) -> dict:
    """Trace `reps` calls of fn (each blocked on); device busy per call."""
    import jax

    jax.block_until_ready(fn())  # compile outside the window

    def calls():
        for _ in range(reps):
            jax.block_until_ready(fn())

    busy, wall = trace_busy(calls)
    return dict(
        device_us_per_call=busy["busy_ns"] / reps / 1e3,
        idle_share=1.0 - busy["busy_ns"] / max(busy["span_ns"], 1.0),
        kernels_per_call=busy["n_kernels"] / reps,
        wall_ms_per_call_traced=1e3 * wall / reps,
    )


def main() -> None:
    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        sys.exit("stage_trace: no GPU")
    import chip_smoke as smoke
    from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
    from weiner_slamit_v2_tpu.frontend.extractor import detect_level
    from weiner_slamit_v2_tpu.ops import pyramid
    from weiner_slamit_v2_tpu.tracking.system import System
    from weiner_slamit_v2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    # ---- a steady window of the monocular session ----------------------
    cfg, cam, K = smoke.make_cfg()
    n = WARM_FRAMES + TRACED_FRAMES
    seq = make_synthetic_sequence(n_frames=n, h=smoke.H, w=smoke.W,
                                  seed=smoke.SEED, K=K, motion="orbit",
                                  motion_frames=164)
    imgs = [smoke._u8(f.image) for f in seq.frames]
    sys_ = System(cfg, cam, enable_mapping=True, enable_loop_closing=True)
    for i in range(WARM_FRAMES):
        sys_.track_monocular(imgs[i], seq.frames[i].timestamp)
    sys_.tracker.flush_pending()
    kf0 = sys_.tracker.n_kf_host

    def window():
        for i in range(WARM_FRAMES, n):
            sys_.track_monocular(imgs[i], seq.frames[i].timestamp)
        sys_.tracker.flush_pending()
        sys_.mapper_idle(force=True)

    busy, wall = trace_busy(window)
    frame = dict(
        device_us_per_frame=busy["busy_ns"] / TRACED_FRAMES / 1e3,
        wall_ms_per_frame_traced=1e3 * wall / TRACED_FRAMES,
        idle_share=1.0 - busy["busy_ns"] / max(busy["span_ns"], 1.0),
        keyframes_in_window=sys_.tracker.n_kf_host - kf0,
    )

    # ---- FAST score+NMS over the 8 levels of one frame -----------------
    orb = cfg.orb
    levels = jax.jit(
        lambda x: pyramid.build_pyramid(x, orb.n_levels, orb.scale_factor)
    )(jnp.asarray(imgs[0], jnp.float32))
    fast_all = jax.jit(lambda lv: [
        detect_level(x, orb.fast_min_threshold) for x in lv
    ])
    fast_stats = traced(lambda: fast_all(levels), REPS)

    # ---- fuse matcher, 20 targets x 1024 x 1024 ------------------------
    f, fargs = smoke.fuse_matcher(smoke.fuse_inputs(), cfg.mapping.chi2_mono)
    fargs = jax.device_put(fargs)
    fuse_stats = traced(lambda: f(*fargs), REPS)

    per_frame = frame["device_us_per_frame"]
    for s in (fast_stats, fuse_stats):
        s["share_of_frame_device_time"] = s["device_us_per_call"] / per_frame
    kf_rate = frame["keyframes_in_window"] / TRACED_FRAMES
    fuse_stats["share_amortized_per_keyframe"] = (
        fuse_stats["share_of_frame_device_time"] * kf_rate
    )
    print(json.dumps(dict(
        card=card, frame=frame, fast_8_levels=fast_stats,
        fuse_20x1024x1024=fuse_stats,
    )), flush=True)


if __name__ == "__main__":
    main()
