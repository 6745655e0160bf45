"""Smoke run of the SLAM main path on NVIDIA GPUs, through the public API.

    python chip_smoke.py             # one GPU
    python chip_smoke.py --chips 4   # the multi-device paths, on four GPUs
    python chip_smoke.py --cpu-ate   # monocular session on the CPU backend

One GPU, in one process:
  1. device check: a GPU, its name and power limit, matmul precision;
  2. compiled stages against plain references: FAST score+NMS on all 8
     pyramid levels of a 640x480 frame and the fuse matcher at 20 targets x
     1024 points x 1024 features against ops/numpy_reference.py; one
     motion-only pose optimisation and one local-BA solve on the GPU against
     the same on the CPU backend;
  3. System.track_monocular, 240 frames at 640x480 with 1024 features, the
     default map capacity, local mapping and loop closing on;
  4. System.track_rgbd and System.track_stereo, 60 frames each.
Four GPUs: a map built on card 0, System.distributed_gba over a 1-D mesh
of the four cards against the same problem solved on card 0, then a session
whose mapping runs on card 1.

A failed check raises, so the process exits nonzero. Without a GPU it exits
nonzero before printing a result. The last line of a passing run is
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

H, W = 480, 640
FX = 500.0
N_FEATURES = 1024
STEREO_BASELINE = 0.12  # m
SEED = 0

# Scale-aligned ATE (m) of phase 3's session on the CPU backend, same seed
# and config (`JAX_PLATFORMS=cpu python chip_smoke.py --cpu-ate` on the
# 16-core host of an H100 machine).
CPU_MONO_ATE = 0.006638932184391253

MONO_FRAMES = 240
MONO_MAX_ATE = 0.05        # m, scale-aligned
DEPTH_MAX_ATE = 0.05       # m, metric (RGB-D, stereo)
MIN_OK_SHARE = 0.9         # frames OK after initialisation

COMPILE = {"s": 0.0, "n": 0}


def log(msg: str) -> None:
    print(msg, flush=True)


def _on_event_duration(event: str, duration: float, **_) -> None:
    if event == "/jax/core/compile/backend_compile_duration":
        COMPILE["s"] += duration
        COMPILE["n"] += 1


# ---------------------------------------------------------------- phase 1
def device_check(n_chips: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX platform is {devs[0].platform!r})")
    if len(devs) < n_chips:
        sys.exit(f"chip_smoke: need {n_chips} GPUs, JAX sees {len(devs)}")
    log(f"device_kind: {devs[0].device_kind} x{len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    for line in smi.stdout.strip().splitlines():
        log(line.strip())  # as nvidia-smi prints it: name, power limit
    card = smi.stdout.strip().splitlines()[0].strip()

    import weiner_slamit_v2_tpu  # noqa: F401  (sets the matmul precision)
    from weiner_slamit_v2_tpu.utils.compile_cache import enable_compile_cache

    prec = jax.config.jax_default_matmul_precision
    log(f"jax_default_matmul_precision: {prec}")
    assert prec == "highest", prec
    log(f"compile cache: {enable_compile_cache()}")
    jax.monitoring.register_event_duration_secs_listener(_on_event_duration)
    return devs, card


def make_cfg(sensor: str = "monocular", **tracking):
    from weiner_slamit_v2_tpu.config import (
        CameraConfig, OrbConfig, SlamConfig, TrackingConfig,
    )
    from weiner_slamit_v2_tpu.geometry.camera import Camera

    cx, cy = W / 2 - 0.5, H / 2 - 0.5
    depth = (
        {} if sensor == "monocular"
        else dict(baseline_times_fx=STEREO_BASELINE * FX, depth_threshold=40.0)
    )
    cfg = SlamConfig(
        orb=OrbConfig(n_features=N_FEATURES),
        camera=CameraConfig(fx=FX, fy=FX, cx=cx, cy=cy, k1=0, k2=0, p1=0,
                            p2=0, k3=0, width=W, height=H, **depth),
        # the benchmark's deployment: mapper turnaround of 8 frames, four
        # fused tracking steps per host sync once the map is mature
        tracking=TrackingConfig(
            mapping_latency_frames=8, frames_per_sync=4, **tracking
        ),
        sensor=sensor,
    )
    K = np.array([[FX, 0, cx], [0, FX, cy], [0, 0, 1]], np.float32)
    return cfg, Camera.create(FX, FX, cx, cy, width=W, height=H), K


# ---------------------------------------------------------------- phase 2
def check_fast(cfg) -> None:
    import jax
    import jax.numpy as jnp

    from weiner_slamit_v2_tpu.frontend.extractor import detect_level
    from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
    from weiner_slamit_v2_tpu.ops import numpy_reference, pyramid

    orb = cfg.orb
    img = make_synthetic_sequence(n_frames=1, h=H, w=W, seed=SEED).frames[0].image
    levels = jax.jit(
        lambda x: pyramid.build_pyramid(x, orb.n_levels, orb.scale_factor)
    )(jnp.asarray(img, jnp.float32))
    fast_nms = jax.jit(detect_level, static_argnums=1)
    for lvl, li in enumerate(levels):
        got = np.asarray(fast_nms(li, orb.fast_min_threshold))
        ref = numpy_reference.fast9_nms(np.asarray(li), orb.fast_min_threshold)
        err = float(np.abs(got - ref).max())
        log(f"  fast level {lvl} {li.shape}: {int((ref > 0).sum())} corners, "
            f"max |gpu - numpy| = {err}")
        assert err <= 1e-4, (lvl, err)
        assert (ref > 0).sum() > 0, lvl


def fuse_inputs(seed: int = SEED, S: int = 20, N1: int = 1024,
                N2: int = 1024, n_levels: int = 8, scale: float = 1.2):
    """Fuse-stage inputs at the mapping pass's shapes: S target keyframes,
    N1 projected points, N2 features each; half the points have a true
    feature near their projection (a few flipped bits, ~1.5 px off)."""
    rng = np.random.default_rng(seed)
    desc1 = rng.integers(0, 2**32, (N1, 8), dtype=np.uint32)
    desc2 = rng.integers(0, 2**32, (S, N2, 8), dtype=np.uint32)
    xy2 = np.stack([rng.uniform(0, W, (S, N2)), rng.uniform(0, H, (S, N2))],
                   -1).astype(np.float32)
    oct2 = rng.integers(0, n_levels, (S, N2)).astype(np.int32)
    pred = np.stack([rng.uniform(0, W, (S, N1)), rng.uniform(0, H, (S, N1))],
                    -1).astype(np.float32)
    lo = rng.integers(-1, n_levels - 1, (S, N1)).astype(np.int32)
    for s in range(S):
        rows = rng.permutation(N1)[: N1 // 2]
        cols = rng.permutation(N2)[: N1 // 2]
        flips = rng.integers(0, 2**32, (len(rows), 8), dtype=np.uint32)
        flips &= rng.integers(0, 2**32, (len(rows), 8), dtype=np.uint32)
        flips &= rng.integers(0, 2**32, (len(rows), 8), dtype=np.uint32)
        desc2[s, cols] = desc1[rows] ^ (flips & (flips >> 3))
        xy2[s, cols] = pred[s, rows] + rng.normal(0, 1.5, (len(rows), 2))
        oct2[s, cols] = np.clip(lo[s, rows] + 1, 0, n_levels - 1)
    inv_s2 = (1.0 / scale ** (2 * np.arange(n_levels))).astype(np.float32)
    return dict(
        desc1=desc1, desc2=desc2,
        valid1=rng.random((S, N1)) > 0.05, valid2=rng.random((S, N2)) > 0.05,
        pred_xy=pred, xy2=xy2,
        window=(3.0 * scale ** np.clip(lo + 1, 0, None)).astype(np.float32),
        oct_lo=lo, oct_hi=lo + 1, octave2=oct2, chi2_w=inv_s2[oct2],
    )


def fuse_matcher(d, chi2_th):
    """The fuse stage's batched form: one program over all targets."""
    import jax

    from weiner_slamit_v2_tpu.frontend import matcher

    keys = ("desc2", "valid1", "valid2", "pred_xy", "xy2", "window",
            "oct_lo", "oct_hi", "octave2", "chi2_w")
    f = jax.jit(jax.vmap(
        lambda desc1, d2, v1, v2, p, x2, win, lo, hi, o2, w2:
        matcher.windowed_best2(desc1, d2, v1, v2, p, x2, win, lo, hi, o2,
                               chi2_w=w2, chi2_th=chi2_th),
        in_axes=(None,) + (0,) * len(keys),
    ))
    return f, (d["desc1"],) + tuple(d[k] for k in keys)


def check_fuse_matcher(cfg) -> None:
    from weiner_slamit_v2_tpu.ops import numpy_reference

    d = fuse_inputs()
    f, args = fuse_matcher(d, cfg.mapping.chi2_mono)
    bi, bd, sd = (np.asarray(a) for a in f(*args))
    n_found = n_unique = 0
    for s in range(d["desc2"].shape[0]):
        ri, rb, rs = numpy_reference.windowed_best2(
            d["desc1"], d["desc2"][s], d["valid1"][s], d["valid2"][s],
            d["pred_xy"][s], d["xy2"][s], d["window"][s], d["oct_lo"][s],
            d["oct_hi"][s], d["octave2"][s], d["chi2_w"][s],
            cfg.mapping.chi2_mono,
        )
        np.testing.assert_array_equal(bd[s], rb)
        np.testing.assert_array_equal(sd[s], rs)
        unique = (rb < numpy_reference.INVALID_DIST) & (rb < rs)
        np.testing.assert_array_equal(bi[s][unique], ri[unique])
        n_found += int((rb < numpy_reference.INVALID_DIST).sum())
        n_unique += int(unique.sum())
    log(f"  fuse matcher {d['desc2'].shape[0]}x{d['desc1'].shape[0]}x"
        f"{d['desc2'].shape[1]}: best/second distances equal to numpy on "
        f"every row; {n_found} rows with a candidate, indices equal on the "
        f"{n_unique} with a unique best")
    assert n_unique > 1000, n_unique


def _pose_problem(seed: int = SEED, n: int = 1024):
    from weiner_slamit_v2_tpu.geometry import se3

    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(3, 9, n)], 1).astype(np.float32)
    T = np.asarray(se3.exp(np.asarray([0.05, -0.02, 0.1, 0.01, 0.02, -0.01],
                                      np.float32)))
    Pc = X @ T[:3, :3].T + T[:3, 3]
    uv = FX * Pc[:, :2] / Pc[:, 2:] + np.array([W / 2 - 0.5, H / 2 - 0.5])
    uv += rng.normal(0, 0.5, uv.shape)
    outlier = rng.random(n) < 0.1
    uv[outlier] += rng.uniform(30, 60, (outlier.sum(), 2))
    K = np.array([[FX, 0, W / 2 - 0.5], [0, FX, H / 2 - 0.5], [0, 0, 1]],
                 np.float32)
    return (np.eye(4, dtype=np.float32), X, uv.astype(np.float32),
            np.ones(n, np.float32), np.ones(n, bool), K)


def _ba_problem(seed: int = SEED, C: int = 16, P: int = 2048, O: int = 8):
    """A local-BA problem at the solver's default window (16 cameras, 2048
    points, 8 observations per point), 0.5 px noise, perturbed start."""
    import jax.numpy as jnp

    from weiner_slamit_v2_tpu.geometry import se3
    from weiner_slamit_v2_tpu.optim.local_ba import BAProblem

    rng = np.random.default_rng(seed)
    poses = np.stack([
        np.asarray(se3.exp(np.asarray(
            [0.08 * i, 0.02 * np.sin(i), 0, 0, -0.01 * i, 0], np.float32)))
        for i in range(C)
    ])
    X = np.stack([rng.uniform(-2, 3, P), rng.uniform(-2, 2, P),
                  rng.uniform(4, 10, P)], 1).astype(np.float32)
    obs_cam = np.stack([rng.permutation(C)[:O] for _ in range(P)])
    T = poses[obs_cam]
    Pc = np.einsum("poij,pj->poi", T[..., :3, :3], X) + T[..., :3, 3]
    uv = FX * Pc[..., :2] / Pc[..., 2:] + np.array([W / 2 - 0.5, H / 2 - 0.5])
    uv += rng.normal(0, 0.5, uv.shape)
    noisy = np.stack([
        np.asarray(se3.exp(rng.normal(0, 0.005, 6).astype(np.float32)))
        @ poses[i] for i in range(C)
    ])
    noisy[0] = poses[0]
    K = np.array([[FX, 0, W / 2 - 0.5], [0, FX, H / 2 - 0.5], [0, 0, 1]],
                 np.float32)
    return BAProblem(
        cam_pose=jnp.asarray(noisy, jnp.float32),
        cam_fixed=jnp.arange(C) < 2,
        cam_valid=jnp.ones(C, bool),
        points=jnp.asarray(X + rng.normal(0, 0.03, X.shape), jnp.float32),
        point_valid=jnp.ones(P, bool),
        obs_cam=jnp.asarray(obs_cam, jnp.int32),
        obs_uv=jnp.asarray(uv, jnp.float32),
        obs_inv_sigma2=jnp.ones((P, O), jnp.float32),
        obs_valid=jnp.ones((P, O), bool),
        K=jnp.asarray(K),
    )


def check_solvers(gpu) -> None:
    """Same programs on the GPU and the CPU backend. Tolerances: the
    float32 sums over observations run in another order on each backend,
    so poses agree to ~1e-5 and costs to ~1e-6 relative; the bounds below
    leave an order of magnitude (LM accept/reject decisions taken on nearly
    equal costs may also differ near convergence)."""
    import jax

    from weiner_slamit_v2_tpu.optim.local_ba import solve_ba
    from weiner_slamit_v2_tpu.optim.pose_opt import optimize_pose

    cpu = jax.devices("cpu")[0]
    pose_fn = jax.jit(optimize_pose)
    args = _pose_problem()
    res = []
    for dev in (gpu, cpu):
        out = pose_fn(*jax.device_put(args, dev))
        assert next(iter(out[0].devices())) == dev
        res.append([np.asarray(o) for o in out])
    (Tg, inl_g, n_g), (Tc, inl_c, _) = res
    dT = float(np.abs(Tg - Tc).max())
    d_inl = int((inl_g != inl_c).sum())
    log(f"  optimize_pose 1024 pts: max |T_gpu - T_cpu| = {dT:.3g}, "
        f"inlier flags differing: {d_inl}, inliers {int(n_g)}")
    assert dT <= 1e-4 and d_inl == 0, (dT, d_inl)

    ba_fn = jax.jit(solve_ba)
    prob = _ba_problem()
    g, c = (
        jax.tree.map(np.asarray, ba_fn(jax.device_put(prob, dev)))
        for dev in (gpu, cpu)
    )
    dpose = float(np.abs(g.cam_pose - c.cam_pose).max())
    dcost = abs(float(g.final_cost) - float(c.final_cost)) / float(c.final_cost)
    d_inl = int((g.obs_inlier != c.obs_inlier).sum())
    log(f"  solve_ba 16 cams x 2048 pts x 8 obs: max |pose_gpu - pose_cpu| "
        f"= {dpose:.3g}, final cost {float(g.final_cost):.6g} (rel diff "
        f"{dcost:.3g}), inlier flags differing: {d_inl}")
    assert dpose <= 1e-3 and dcost <= 1e-4 and d_inl <= 8, (dpose, dcost, d_inl)


# ------------------------------------------------------------- phases 3-4
def _u8(a):
    return np.asarray(np.clip(a, 0, 255), np.uint8)


def ate(sys_, seq, align_scale: bool) -> float:
    from weiner_slamit_v2_tpu.io.evaluation import ate_rmse

    ts, Twc = sys_.tracker.trajectory_Twc()
    index = {f.timestamp: i for i, f in enumerate(seq.frames)}
    gt = seq.gt_Twc[[index[t] for t in ts]]
    return ate_rmse(np.asarray(Twc), gt, align_scale=align_scale)


def run_session(sensor: str, n_frames: int, timed: int = 0,
                seed: int = SEED, mapping_device=None, label: str = ""):
    """Drive one System session; return (system, sequence, stats)."""
    from weiner_slamit_v2_tpu.io.datasets import make_synthetic_sequence
    from weiner_slamit_v2_tpu.tracking.system import System

    cfg, cam, K = make_cfg(sensor)
    kw = dict(n_frames=n_frames, h=H, w=W, seed=seed, K=K, motion="orbit",
              motion_frames=164)
    if sensor == "rgbd":
        kw.update(world="multi", with_depth=True)
    elif sensor == "stereo":
        kw.update(world="multi", stereo_baseline=STEREO_BASELINE)
    seq = make_synthetic_sequence(**kw)
    sys_ = System(cfg, cam, enable_mapping=True, enable_loop_closing=True,
                  mapping_device=mapping_device)
    states, marks = [], []
    c0 = dict(COMPILE)
    t_start = time.perf_counter()
    for i, f in enumerate(seq.frames):
        if i == n_frames - timed:
            sys_.tracker.flush_pending()
            marks = [time.perf_counter(), dict(COMPILE)]
        img = _u8(f.image)
        if sensor == "rgbd":
            out = sys_.track_rgbd(img, f.depth, f.timestamp)
        elif sensor == "stereo":
            out = sys_.track_stereo(img, _u8(f.image_right), f.timestamp)
        else:
            out = sys_.track_monocular(img, f.timestamp)
        states.append(out.state)
    sys_.tracker.flush_pending()
    t_end = time.perf_counter()
    sys_.finish()
    first_ok = states.index("OK")
    after = states[first_ok:]
    stats = dict(
        frames=n_frames, first_ok=first_ok,
        ok_share=after.count("OK") / len(after),
        keyframes_created=sys_.tracker.n_kf_host,
        keyframes=sys_.n_keyframes(), map_points=sys_.n_map_points(),
        ba_chunks=sys_.ba_chunks_issued,
        loops=sys_.loop_closer.n_loops_closed,
        ate=ate(sys_, seq, align_scale=sensor == "monocular"),
        session_s=t_end - t_start,
        compile_s=COMPILE["s"] - c0["s"], compiles=COMPILE["n"] - c0["n"],
    )
    if timed:
        stats["steady_ms_per_frame"] = 1e3 * (t_end - marks[0]) / timed
        stats["compiles_in_window"] = COMPILE["n"] - marks[1]["n"]
    log(f"  {label or sensor}: " + json.dumps(stats))
    return sys_, seq, stats


def check_health(stats, max_ate, min_kf, cpu_ate=None) -> None:
    assert stats["ok_share"] >= MIN_OK_SHARE, stats
    assert stats["keyframes_created"] >= min_kf, stats
    assert stats["ba_chunks"] >= 1, stats
    assert np.isfinite(stats["ate"]) and stats["ate"] <= max_ate, stats
    if cpu_ate is not None:
        assert stats["ate"] <= 2 * cpu_ate, (stats["ate"], cpu_ate)


def print_memory(gpu, label: str) -> None:
    ms = gpu.memory_stats() or {}
    log(f"  {label} peak_bytes_in_use: {ms.get('peak_bytes_in_use')}")


def tracking_step_memory(capture) -> None:
    """memory_analysis() of the fused tracking step, compiled for the
    arguments it was last called with."""
    from weiner_slamit_v2_tpu.tracking import tracker as trk

    args, kwargs = capture["args"]
    ma = trk._track_step.lower(*args, **kwargs).compile().memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    log("  fused tracking step memory_analysis: " + json.dumps(
        {f: getattr(ma, f, None) for f in fields}))


def capture_track_step():
    from weiner_slamit_v2_tpu.tracking import tracker as trk

    capture = {}
    inner = trk._track_step

    def wrapped(*args, **kwargs):
        capture["args"] = (args, kwargs)
        return inner(*args, **kwargs)

    wrapped.lower = inner.lower
    trk._track_step = wrapped
    return capture


def one_chip(gpu, card: str) -> None:
    cfg, _, _ = make_cfg()
    log("phase 2: compiled stages against plain references")
    check_fast(cfg)
    check_fuse_matcher(cfg)
    check_solvers(gpu)

    capture = capture_track_step()
    log("phase 3: System.track_monocular")
    _, _, st = run_session("monocular", MONO_FRAMES, timed=96)
    log(f"  monocular steady ms/frame on {card}: "
        f"{st['steady_ms_per_frame']:.3f} (compile {st['compile_s']:.1f} s)")
    print_memory(gpu, "after monocular")
    tracking_step_memory(capture)
    check_health(st, MONO_MAX_ATE, min_kf=10, cpu_ate=CPU_MONO_ATE)

    log("phase 4: System.track_rgbd and System.track_stereo")
    for sensor, seed in (("rgbd", SEED + 1), ("stereo", SEED + 2)):
        _, _, st = run_session(sensor, 60, timed=24, seed=seed)
        log(f"  {sensor} steady ms/frame on {card}: "
            f"{st['steady_ms_per_frame']:.3f} (compile {st['compile_s']:.1f} s)")
        print_memory(gpu, f"after {sensor}")
        check_health(st, DEPTH_MAX_ATE, min_kf=2)


def four_chips(devs, card: str) -> None:
    import jax
    import jax.numpy as jnp

    from weiner_slamit_v2_tpu.optim.ba_extract import extract_global_ba
    from weiner_slamit_v2_tpu.optim.local_ba import solve_ba
    from weiner_slamit_v2_tpu.parallel.sharded_ba import make_ba_mesh

    devs = devs[:4]
    log("setup: map built on card 0 (untimed)")
    sys_, seq, st = run_session("monocular", 120, label="map on card 0")
    t = sys_.tracker
    # perturb every non-gauge keyframe and every point: a stand-in for
    # accumulated drift that global BA should remove
    rng = np.random.default_rng(SEED + 3)
    m = t.m
    nkf = m.kf_pose.shape[0]
    gauge = int(np.flatnonzero(np.asarray(m.kf_valid))[0])
    move = (jnp.arange(nkf) != gauge)[:, None] & m.kf_valid[:, None]
    pose = m.kf_pose.at[:, :3, 3].add(jnp.where(
        move, jnp.asarray(rng.normal(0, 0.01, (nkf, 3)), jnp.float32), 0.0))
    pts = m.mp_pos + m.mp_valid[:, None] * jnp.asarray(
        rng.normal(0, 0.01, m.mp_pos.shape), jnp.float32)
    t.m = m.replace(kf_pose=pose, mp_pos=pts)
    ate_before = ate(sys_, seq, align_scale=True)

    log("distributed_gba over a 1-D mesh of 4 cards vs one card")
    prob, _, _ = extract_global_ba(t.m, t.K, t.inv_sigma2, gauge_kf=gauge)
    c0 = dict(COMPILE)
    t0 = time.perf_counter()
    ref = jax.jit(solve_ba, static_argnums=(1, 2))(prob, 5, 10)
    ref_cost = float(ref.final_cost)
    t_ref = time.perf_counter() - t0
    mesh = make_ba_mesh(devs)
    t0 = time.perf_counter()
    res = sys_.distributed_gba(mesh, iters=15)
    cost = float(res.final_cost)
    t_dist = time.perf_counter() - t0
    ate_after = ate(sys_, seq, align_scale=True)
    dpose = float(np.abs(np.asarray(ref.cam_pose)
                         - np.asarray(res.cam_pose)).max())
    rel = abs(cost - ref_cost) / ref_cost
    log("  " + json.dumps(dict(
        keyframes=st["keyframes"], map_points=st["map_points"],
        cost_1card=ref_cost, cost_4cards=cost, rel_cost_diff=rel,
        max_pose_diff=dpose, ate_before=ate_before, ate_after=ate_after,
        wall_s_1card=t_ref, wall_s_4cards=t_dist,
        compile_s=COMPILE["s"] - c0["s"], card=card,
    )))
    # float32 sums over 16384 points run in another order across 4 shards
    assert rel <= 1e-3 and dpose <= 1e-3, (rel, dpose)
    assert ate_after <= ate_before + 1e-3, (ate_before, ate_after)

    log("mapping on card 1: System(mapping_device=devices[1])")
    sys2, _, st2 = run_session("monocular", 40, mapping_device=devs[1],
                               seed=SEED + 4, label="mapping on card 1")
    assert next(iter(sys2.tracker.m.kf_pose.devices())) == devs[0]
    assert st2["ok_share"] >= MIN_OK_SHARE, st2
    assert st2["keyframes_created"] >= 2, st2
    assert np.isfinite(st2["ate"]) and st2["ate"] <= MONO_MAX_ATE, st2


def cpu_ate() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    assert jax.devices()[0].platform == "cpu"
    _, _, st = run_session("monocular", MONO_FRAMES, label="monocular on CPU")
    log(f"cpu_mono_ate: {st['ate']!r}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    ap.add_argument("--cpu-ate", action="store_true",
                    help="run phase 3's session on the CPU backend and print "
                         "its ATE (the reference for CPU_MONO_ATE)")
    args = ap.parse_args()
    if args.cpu_ate:
        cpu_ate()
        return
    devs, card = device_check(args.chips)
    log("phase 1: device check passed")
    if args.chips == 4:
        four_chips(devs, card)
    else:
        one_chip(devs[0], card)
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
