"""BASELINE measurement campaign: the five north-star configs, measured.

The reference publishes no numbers (BASELINE.md §1); its capability claim is
real-time tracking at the 30 fps camera rate (jni/ORB_SLAM2/src/
Tracking.cc:123-131). No real TUM/KITTI/EuRoC data exists in this
environment (zero egress), so each config runs on the HARD synthetic battery
(io/datasets.py MultiPlaneWorld: multi-plane occluding scene + per-frame
gain/bias drift + sensor noise) as the closest available proxy, at the
reference's 640x480 / 1024-feature budget.

Per config this measures:
  * GPU end-to-end fps (System.track_*, steady state, honest sync timing)
  * CPU fps of the SAME pipeline (the >=5x target denominator)
  * ATE RMSE vs exact ground truth
Config 5 measures the sharded-BA scaling curve (C=64, P=32768) over 1/2/4
GPUs, or over virtual CPU devices with --platform cpu (those timeshare the
host's cores, so that curve checks the collective structure, not speedup).

Usage:
  python tools/run_baseline.py --all            # full campaign (subprocesses)
  python tools/run_baseline.py --config 1 --platform gpu   # one cell
  python tools/run_baseline.py --scaling --devices 4       # one scaling cell
--all keeps the parent process off JAX and runs its cells one after another,
each in its own child process (one JAX process per GPU at a time), and prints
every row plus one JSON summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

H, W = 480, 640
FX = 500.0
N_FEATURES = 1024
STEREO_BASELINE = 0.12  # m -> bf = 60.0


def _setup_platform(platform: str):
    if platform == "cpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        # cap the CPU JIT ISA: some hosts fault on (advertised) AVX-512
        # instructions — see tests/conftest.py
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX2"
        ).strip()
    import jax

    if jax.devices()[0].platform != platform:
        raise SystemExit(
            f"asked for {platform}, JAX has {jax.devices()[0].platform}"
        )
    if platform != "cpu":
        # persistent cache for the GPU cells only: XLA:CPU executable
        # serialization is unsafe on some hosts (tests/conftest.py note)
        from weiner_slamit_v2_tpu.utils.compile_cache import (
            enable_compile_cache,
        )

        enable_compile_cache()
    return jax


def _mk(cfg_kwargs=None, cam_kwargs=None):
    import numpy as np

    from weiner_slamit_v2_tpu.config import (
        CameraConfig, OrbConfig, SlamConfig, TrackingConfig,
    )
    from weiner_slamit_v2_tpu.geometry.camera import Camera

    cam_kwargs = dict(cam_kwargs or {})
    cfg = SlamConfig(
        orb=OrbConfig(n_features=N_FEATURES),
        camera=CameraConfig(
            fx=FX, fy=FX, cx=W / 2 - 0.5, cy=H / 2 - 0.5,
            k1=0, k2=0, p1=0, p2=0, k3=0, width=W, height=H, **cam_kwargs,
        ),
        tracking=TrackingConfig(mapping_latency_frames=8, frames_per_sync=4),
        **(cfg_kwargs or {}),
    )
    K = np.array(
        [[FX, 0, W / 2 - 0.5], [0, FX, H / 2 - 0.5], [0, 0, 1]], np.float32
    )
    cam = Camera.create(FX, FX, W / 2 - 0.5, H / 2 - 0.5, width=W, height=H)
    return cfg, cam, K


def _ate(sys_, seq, align_scale):
    import numpy as np

    from weiner_slamit_v2_tpu.io.evaluation import ate_rmse

    ts, Twc = sys_.tracker.trajectory_Twc()
    n = min(len(Twc), len(seq.gt_Twc))
    if n < 5:
        return float("nan")
    return ate_rmse(
        np.asarray(Twc)[:n], np.asarray(seq.gt_Twc)[:n],
        align_scale=align_scale,
    )


def _prep_frames(seq, with_right=False, with_depth=False):
    """uint8 frames as a camera ships them (host arrays: each frame's
    upload is part of the timed work)."""
    import numpy as np

    def u8(a):
        return np.asarray(np.clip(a, 0, 255), np.uint8)

    imgs = [u8(f.image) for f in seq.frames]
    rights = [u8(f.image_right) for f in seq.frames] if with_right else None
    depths = (
        [np.asarray(f.depth, np.float32) for f in seq.frames]
        if with_depth else None
    )
    return imgs, rights, depths


def _run_session(sys_, feed, n_warm, n_timed, warm_until=None,
                 max_warm=None):
    """Feed frames; return steady-state fps timed over the last n_timed.

    warm_until: optional predicate — warmup continues past n_warm until it
    returns True (bounded at max_warm frames, default 3x n_warm), so
    one-time events (fused-scan compile at 8 keyframes, nKF=16 vocabulary
    retrain) stay out of the timed window; too small a bound for the
    keyframe cadence leaves a cell compile-dominated — bench.py warms up to
    240 frames for the same reason."""
    import numpy as np  # noqa: F401

    cap = max_warm if max_warm is not None else 3 * n_warm
    i = 0
    while i < n_warm or (
        warm_until is not None and not warm_until() and i < cap
    ):
        feed(i)
        i += 1
    sys_.tracker.flush_pending()
    t0 = time.perf_counter()
    for j in range(i, i + n_timed):
        feed(j)
    sys_.tracker.flush_pending()
    dt = time.perf_counter() - t0
    return n_timed / dt


def run_config(n: int, platform: str, quick: bool = False) -> dict:
    _setup_platform(platform)
    import numpy as np

    from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
    from weiner_slamit_v2_tpu.tracking.system import System

    n_warm = 8 if platform == "cpu" else 16
    n_timed = (4 if quick else 10) if platform == "cpu" else (8 if quick else 80)
    # sequences carry runway for predicate-extended warmup (_run_session)
    n_total = 3 * n_warm + n_timed + 12

    if n == 1:
        # config 1: monocular tracking, single chip (fr1/xyz proxy).
        # Mapping bootstraps the map, then localization-only mode isolates
        # the tracking loop (System::ActivateLocalizationMode).
        cfg, cam, K = _mk()
        seq = make_synthetic_sequence(
            n_frames=n_total + 10, h=H, w=W, seed=4, K=K, motion="orbit",
            world="multi", photometric_noise=2.0,
        )
        sys_ = System(cfg, cam)
        imgs, _, _ = _prep_frames(seq)
        for i in range(10):
            sys_.track_monocular(imgs[i], i / 30.0)
        sys_.tracker.flush_pending()
        sys_.activate_localization_mode()

        def feed(i):
            sys_.track_monocular(imgs[10 + i], (10 + i) / 30.0)

        fps = _run_session(sys_, feed, n_warm, n_timed)
        ate = _ate(sys_, seq, align_scale=True)
        return dict(config=1, name="mono tracking (fr1/xyz proxy)",
                    platform=platform, fps=fps, ate_rmse=ate,
                    frames=n_timed, sensor="monocular")

    if n == 2:
        # config 2: mono + local mapping + local BA (fr2/desk proxy)
        cfg, cam, K = _mk()
        max_warm = 280 if platform == "gpu" else 3 * n_warm
        seq = make_synthetic_sequence(
            n_frames=max_warm + n_timed + 20, h=H, w=W, seed=5, K=K,
            motion="orbit", world="multi", photometric_noise=2.0,
            motion_frames=n_total,
        )
        sys_ = System(cfg, cam)
        imgs, _, _ = _prep_frames(seq)

        def feed(i):
            sys_.track_monocular(imgs[i], i / 30.0)

        # warm past the fused-scan compile (engages at 8 keyframes) AND the
        # first in-scan keyframe programs so the timed window is steady
        # state (a 48-frame bound leaves the cell compile-dominated)
        fps = _run_session(
            sys_, feed, n_warm, n_timed,
            warm_until=lambda: sys_.tracker.n_kf_host >= 17,
            max_warm=max_warm,
        )
        sys_.finish()
        ate = _ate(sys_, seq, align_scale=True)
        return dict(config=2, name="mono + mapping + local BA (fr2/desk proxy)",
                    platform=platform, fps=fps, ate_rmse=ate,
                    frames=n_timed, sensor="monocular",
                    n_kf=int(sys_.n_keyframes()),
                    n_mp=int(sys_.n_map_points()))

    if n == 3:
        # config 3: RGB-D full pipeline + BoW relocalization (fr1/room proxy)
        cfg, cam, K = _mk(cam_kwargs=dict(
            baseline_times_fx=STEREO_BASELINE * FX, depth_threshold=40.0,
        ))
        cfg = cfg.replace(sensor="rgbd")
        # this orbit's rgbd keyframe cadence (~1 per 45 frames) cannot reach
        # fused-scan steady state (8 KFs to engage + compile) inside any
        # reasonable warmup runway, so the cell pins the PER-FRAME path for
        # a consistent measurement (the scan otherwise engages mid-window
        # and its compile poisons the timing)
        cfg = cfg.replace(
            tracking=cfg.tracking.__class__(
                **{**cfg.tracking.__dict__, "pipeline_warmup_kfs": 10**6}
            )
        )
        max_warm = 280 if platform == "gpu" else 3 * n_warm
        seq = make_synthetic_sequence(
            n_frames=max_warm + n_timed + 20, h=H, w=W, seed=6, K=K,
            motion="orbit", world="multi", photometric_noise=2.0,
            with_depth=True, motion_frames=n_total,
        )
        sys_ = System(cfg, cam)
        imgs, _, depths = _prep_frames(seq, with_depth=True)

        def feed(i):
            sys_.track_rgbd(imgs[i], depths[i], i / 30.0)

        # depth sessions use the fused scan too now; same predicate warmup
        fps = _run_session(
            sys_, feed, n_warm, n_timed,
            warm_until=lambda: sys_.tracker.n_kf_host >= 17,
            max_warm=max_warm,
        )
        sys_.finish()
        ate = _ate(sys_, seq, align_scale=False)  # metric (depth) scale
        # relocalization against the session map (BoW candidates -> PnP):
        # a fresh localization-only session adopts the map and must relocalize
        import tempfile

        from weiner_slamit_v2_tpu.tracking.system import System as Sys2

        with tempfile.TemporaryDirectory() as td:
            mp = os.path.join(td, "map.npz")
            sys_.save_map(mp)
            s2 = Sys2(cfg, cam)
            s2.load_map(mp)
            s2.activate_localization_mode()
            reloc_ok = False
            for i in range(0, min(8, n_total)):
                f = seq.frames[i]
                out = s2.track_rgbd(f.image, f.depth, 100.0 + i / 30.0)
                if out.state == "OK":
                    reloc_ok = True
                    break
        return dict(config=3, name="RGB-D + reloc + BoW (fr1/room proxy)",
                    platform=platform, fps=fps, ate_rmse=ate,
                    frames=n_timed, sensor="rgbd", reloc_ok=bool(reloc_ok),
                    n_kf=int(sys_.n_keyframes()))

    if n == 4:
        # config 4: stereo + loop closing (KITTI 00 proxy): closed circuit,
        # Sim3 (fixed scale) + essential graph at the revisit
        cfg, cam, K = _mk(cam_kwargs=dict(
            baseline_times_fx=STEREO_BASELINE * FX, depth_threshold=40.0,
        ))
        cfg = cfg.replace(sensor="stereo")
        max_warm = 520 if platform == "gpu" else 3 * n_warm
        seq = make_synthetic_sequence(
            n_frames=max_warm + n_timed + 60, h=H, w=W, seed=7,
            K=K, motion="loop", world="multi", photometric_noise=2.0,
            stereo_baseline=STEREO_BASELINE, motion_frames=n_total,
        )
        sys_ = System(cfg, cam, enable_loop_closing=True)
        imgs, rights, _ = _prep_frames(seq, with_right=True)

        fed = [0]

        def feed(i):
            sys_.track_stereo(imgs[i], rights[i], i / 30.0)
            fed[0] = max(fed[0], i + 1)

        fps = _run_session(
            sys_, feed, n_warm, n_timed,
            warm_until=lambda: sys_.tracker.n_kf_host >= 17,
            max_warm=max_warm,
        )
        # run the remainder of the circuit so the revisit happens inside the
        # measured session (fps stays the steady-state window above)
        i = fed[0]
        while (
            sys_.loop_closer.n_loops_closed == 0 and i < len(seq.frames)
        ):
            feed(i)
            i += 1
        sys_.finish()
        ate = _ate(sys_, seq, align_scale=False)
        lc = sys_.loop_closer
        n_loops = int(getattr(lc, "n_loops_closed", 0))
        return dict(config=4, name="stereo + loop closing (KITTI 00 proxy)",
                    platform=platform, fps=fps, ate_rmse=ate,
                    frames=n_timed, sensor="stereo",
                    n_loops=n_loops,
                    loop_closed=bool(n_loops >= 1),  # the cell's pass gate
                    n_kf=int(sys_.n_keyframes()))

    raise SystemExit(f"unknown config {n}")


def run_scaling(n_devices: int, platform: str, n_cams=64, n_pts=32768,
                max_obs=8) -> dict:
    """Config 5: sharded global BA over n_devices GPUs, or over as many
    virtual CPU devices."""
    if platform == "cpu":
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={n_devices}"
        )
    jax = _setup_platform(platform)
    import jax.numpy as jnp
    import numpy as np

    from weiner_slamit_v2_tpu.geometry import se3
    from weiner_slamit_v2_tpu.optim.local_ba import BAProblem
    from weiner_slamit_v2_tpu.parallel.sharded_ba import (
        make_ba_mesh, shard_problem, solve_ba_sharded,
    )

    assert len(jax.devices()) >= n_devices, jax.devices()
    devices = jax.devices()[:n_devices]
    rng = np.random.default_rng(0)
    K = jnp.asarray(
        [[FX, 0, W / 2 - 0.5], [0, FX, H / 2 - 0.5], [0, 0, 1]], jnp.float32
    )
    poses = []
    for i in range(n_cams):
        xi = np.array([0.08 * i, 0.02 * np.sin(i), 0, 0, -0.01 * i, 0], np.float32)
        poses.append(se3.exp(jnp.asarray(xi)))
    poses = jnp.stack(poses)
    X = np.stack([
        rng.uniform(-4, 8, n_pts), rng.uniform(-3, 3, n_pts),
        rng.uniform(4, 12, n_pts),
    ], axis=1).astype(np.float32)
    obs_cam = rng.integers(0, n_cams, (n_pts, max_obs)).astype(np.int32)
    Pw = jnp.asarray(X)
    Tcs = poses[obs_cam.reshape(-1)]
    Pc = jnp.einsum("oij,oj->oi", Tcs[:, :3, :3], jnp.repeat(Pw, max_obs, 0)) + Tcs[:, :3, 3]
    z = jnp.maximum(Pc[:, 2], 0.1)
    uv = jnp.stack([
        FX * Pc[:, 0] / z + W / 2 - 0.5, FX * Pc[:, 1] / z + H / 2 - 0.5,
    ], axis=1).reshape(n_pts, max_obs, 2)
    uv = uv + jnp.asarray(rng.normal(0, 0.5, uv.shape), jnp.float32)
    in_img = (
        (uv[..., 0] > 0) & (uv[..., 0] < W) & (uv[..., 1] > 0) & (uv[..., 1] < H)
        & (Pc[:, 2].reshape(n_pts, max_obs) > 0.2)
    )
    # perturb
    X_n = jnp.asarray(X + rng.normal(0, 0.05, X.shape).astype(np.float32))
    pose_noise = jnp.stack([
        se3.exp(jnp.asarray(np.r_[rng.normal(0, 0.01, 6)], jnp.float32)) @ poses[i]
        for i in range(n_cams)
    ])
    prob = BAProblem(
        cam_pose=pose_noise,
        cam_fixed=jnp.zeros(n_cams, bool).at[0].set(True),
        cam_valid=jnp.ones(n_cams, bool),
        points=X_n,
        point_valid=jnp.ones(n_pts, bool),
        obs_cam=jnp.asarray(obs_cam),
        obs_uv=uv,
        obs_inv_sigma2=jnp.ones((n_pts, max_obs)),
        obs_valid=jnp.asarray(in_img),
        K=K,
    )
    mesh = make_ba_mesh(devices)
    prob_s = shard_problem(prob, mesh)
    res = solve_ba_sharded(prob_s, mesh)  # compile + run
    jax.block_until_ready(res.cam_pose)
    t0 = time.perf_counter()
    res = solve_ba_sharded(prob_s, mesh)
    jax.block_until_ready(res.cam_pose)
    dt = time.perf_counter() - t0
    return dict(
        config=5, platform=platform, n_devices=n_devices, n_cams=n_cams,
        n_pts=n_pts,
        wall_s=dt, final_cost=float(res.final_cost),
        pts_per_device=n_pts // n_devices,
    )


def orchestrate(quick: bool = False):
    results = {"configs": [], "scaling": []}
    # two rows per config: GPU, and CPU (the >=5x target's denominator)
    for n in (1, 2, 3, 4):
        for platform in ("gpu", "cpu"):
            cmd = [sys.executable, __file__, "--config", str(n),
                   "--platform", platform]
            if quick:
                cmd.append("--quick")
            env = dict(os.environ)
            print(f"[baseline] config {n} on {platform}...", flush=True)
            t0 = time.time()
            p = subprocess.run(
                cmd, capture_output=True, text=True, env=env,
                timeout=4800, cwd=REPO,
            )
            if p.returncode != 0:
                print(p.stdout[-2000:], p.stderr[-2000:], flush=True)
                results["configs"].append(dict(
                    config=n, platform=platform, error=p.returncode))
                continue
            rec = json.loads(p.stdout.strip().splitlines()[-1])
            rec["wall_s"] = round(time.time() - t0, 1)
            print(f"  -> {rec}", flush=True)
            results["configs"].append(rec)
    for nd in (1, 2, 4):
        cmd = [sys.executable, __file__, "--scaling", "--devices", str(nd),
               "--platform", "gpu"]
        print(f"[baseline] scaling over {nd} GPUs...", flush=True)
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=3600, cwd=REPO)
        if p.returncode != 0:
            print(p.stdout[-2000:], p.stderr[-2000:], flush=True)
            results["scaling"].append(dict(n_devices=nd, error=p.returncode))
            continue
        rec = json.loads(p.stdout.strip().splitlines()[-1])
        print(f"  -> {rec}", flush=True)
        results["scaling"].append(rec)
    print(json.dumps(results))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int)
    ap.add_argument("--platform", default="gpu", choices=("gpu", "cpu"))
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    if args.all:
        orchestrate(quick=args.quick)
        return
    if args.scaling:
        print(json.dumps(run_scaling(args.devices, args.platform)))
        return
    if args.config:
        print(json.dumps(run_config(args.config, args.platform, args.quick)))
        return
    ap.print_help()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
