"""FAST score+NMS on the GPU: the Triton kernels against the XLA form.

    python tools/fast_ab.py

Needs a GPU. Both forms are timed in turns (ORDER: four pairs, each form
first in two of them):
  * the stage alone: device time of FAST+NMS over the 8 pyramid levels of a
    640x480 frame, from a profiler trace of repeated calls;
  * end to end: chip_smoke.py's monocular session (camera, features and
    mapping as there, over a longer sequence), steady ms/frame on the host
    clock over the last TIMED frames, with the session's scale-aligned ATE.
    One untimed session per form runs first, so that every program of
    both is compiled (and cached) before the timed turns.
Prints one JSON line per turn, then one with everything.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FRAMES = 400
TIMED = 256
ORDER = ("xla", "triton", "triton", "xla", "triton", "xla", "xla", "triton")


def main() -> None:
    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        sys.exit("fast_ab: no GPU")
    import chip_smoke as smoke
    from stage_trace import traced

    from weiner_slamit_v2_tpu.frontend import extractor
    from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
    from weiner_slamit_v2_tpu.ops import fast, pyramid
    from weiner_slamit_v2_tpu.ops.fast_triton import fast_score_nms_triton
    from weiner_slamit_v2_tpu.tracking.system import System
    from weiner_slamit_v2_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    impls = {"xla": fast.fast_score_nms, "triton": fast_score_nms_triton}
    cfg, cam, K = smoke.make_cfg()
    orb = cfg.orb
    seq = make_synthetic_sequence(n_frames=FRAMES, h=smoke.H, w=smoke.W,
                                  seed=smoke.SEED, K=K, motion="orbit",
                                  motion_frames=164)
    imgs = [smoke._u8(f.image) for f in seq.frames]
    levels = jax.jit(
        lambda x: pyramid.build_pyramid(x, orb.n_levels, orb.scale_factor)
    )(jnp.asarray(imgs[0], jnp.float32))

    def session(impl) -> dict:
        extractor.detect_level = impl  # traced by the System built below
        sys_ = System(cfg, cam, enable_mapping=True, enable_loop_closing=True)
        for i, f in enumerate(seq.frames):
            if i == FRAMES - TIMED:
                sys_.tracker.flush_pending()
                t0 = time.perf_counter()
            sys_.track_monocular(imgs[i], f.timestamp)
        sys_.tracker.flush_pending()
        dt = time.perf_counter() - t0
        sys_.finish()
        return dict(
            steady_ms_per_frame=1e3 * dt / TIMED,
            ate=smoke.ate(sys_, seq, align_scale=True),
            keyframes_created=sys_.tracker.n_kf_host,
        )

    for name in ("xla", "triton"):
        print(json.dumps(dict(warm=name, **session(impls[name]))), flush=True)
    stage, e2e = [], []
    for name in ORDER:
        impl = impls[name]
        prog = jax.jit(lambda lv, impl=impl: [
            impl(x, orb.fast_min_threshold) for x in lv
        ])
        stage.append(dict(impl=name, **traced(lambda: prog(levels), 50)))
        e2e.append(dict(impl=name, **session(impl)))
        print(json.dumps(dict(stage=stage[-1], e2e=e2e[-1])), flush=True)
    print(json.dumps(dict(card=card, stage=stage, e2e=e2e)), flush=True)


if __name__ == "__main__":
    main()
