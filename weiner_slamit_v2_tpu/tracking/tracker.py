"""Per-frame tracking: the state machine of the SLAM front end.

JAX replacement for ``Tracking`` (jni/ORB_SLAM2/src/Tracking.cc).
States NOT_INITIALIZED / OK / LOST mirror include/Tracking.h:88-94.

The whole per-frame cascade — constant-velocity projection matching, the 2x
window widening retry, the reference-keyframe fallback (Tracking.cc:431-453),
both motion-only pose optimizations, local-map tracking, the point counters,
and the NeedNewKeyFrame statistics — is ONE jitted program
(:func:`_track_step`) that returns a single packed scalar vector. The host
performs exactly one device->host synchronization per tracked frame; all
state-machine decisions are made from that one fetch. Rare paths
(initialization, relocalization) stay in Python.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..frontend import matcher
from ..frontend.extractor import FrameFeatures, OrbExtractor
from ..frontend.initializer import initialize_two_view
from ..geometry import se3
from ..geometry.camera import Camera
from ..optim.pnp import ransac_pnp
from ..optim.pose_opt import optimize_pose
from ..slam_map import types as mt
from ..slam_map.point_stats import predict_octave, refresh_point_stats
from ..slam_map.types import SlamMap
from ..utils import struct

NO_IMAGES_YET = "NO_IMAGES_YET"
NOT_INITIALIZED = "NOT_INITIALIZED"
OK = "OK"
LOST = "LOST"


@struct.dataclass
class TrackParams:
    """Per-frame tracking thresholds as device scalars (traced, so changing
    them — e.g. the post-relocalization search window — never recompiles).
    Values come from config.py, which carries the reference citations."""

    motion_window: jnp.ndarray      # px (Tracking.cc:1108)
    min_matches_motion: jnp.ndarray
    min_matches_refkf: jnp.ndarray
    min_inliers_motion: jnp.ndarray
    nn_ratio_motion: jnp.ndarray
    nn_ratio_refkf: jnp.ndarray
    nn_ratio_localmap: jnp.ndarray
    th_low: jnp.ndarray
    th_high: jnp.ndarray
    local_th: jnp.ndarray           # local-map window multiplier (1 / 5 after reloc)
    lm_lambda: jnp.ndarray          # pose-LM initial damping
    bounds: jnp.ndarray             # (4,) undistorted image bounds (Frame.cc:561)

    @staticmethod
    def from_config(cfg: SlamConfig) -> "TrackParams":
        from ..geometry.camera import bounds_from_config

        t, mc, o = cfg.tracking, cfg.matcher, cfg.optim
        f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
        i32 = lambda v: jnp.asarray(v, jnp.int32)  # noqa: E731
        # stereo/RGB-D motion search window th=7 vs mono 15 (Tracking.cc:1108)
        motion_win = (
            7.0 if cfg.sensor != "monocular" else t.motion_search_window
        )
        return TrackParams(
            motion_window=f32(motion_win),
            min_matches_motion=i32(t.min_matches_motion),
            min_matches_refkf=i32(t.min_matches_refkf),
            min_inliers_motion=i32(t.min_inliers_motion),
            nn_ratio_motion=f32(mc.nn_ratio_motion),
            nn_ratio_refkf=f32(mc.nn_ratio_refkf),
            nn_ratio_localmap=f32(mc.nn_ratio_localmap),
            th_low=i32(mc.th_low),
            th_high=i32(mc.th_high),
            local_th=f32(1.0),
            lm_lambda=f32(o.lm_lambda_init),
            bounds=jnp.asarray(bounds_from_config(cfg.camera)),
        )


def _track_last_frame(
    m: SlamMap,
    feats: FrameFeatures,
    last_obs: jnp.ndarray,      # (N,) mp ids of last frame's features
    last_octave: jnp.ndarray,   # (N,)
    last_angle: jnp.ndarray,    # (N,) keypoint angles of the last frame
    Tcw_pred: jnp.ndarray,
    K: jnp.ndarray,
    window: jnp.ndarray,
    scale_factors: jnp.ndarray,
    n_levels: int,
    nn_ratio: jnp.ndarray,
    th_high: jnp.ndarray,
    histo_bins: int = matcher.HISTO_LENGTH,
    forward: jnp.ndarray | bool = False,
    backward: jnp.ndarray | bool = False,
):
    """SearchByProjection last->current (ORBmatcher.cc:1332-1474): project
    the last frame's tracked map points with the predicted pose and match
    against current features in a scale-gated window, with the reference's
    rotation-histogram consistency filter (mbCheckOrientation).

    Returns cur_obs (N,) int32: map-point id per current feature (-1 none).
    """
    has = last_obs >= 0
    mp = jnp.maximum(last_obs, 0)
    has = has & m.mp_valid[mp]
    X = m.mp_pos[mp]
    Pc = se3.apply(Tcw_pred, X)
    z = Pc[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    pred = jnp.stack(
        [K[0, 0] * Pc[:, 0] / zs + K[0, 2], K[1, 1] * Pc[:, 1] / zs + K[1, 2]],
        axis=1,
    )
    has = has & (z > 0)

    # window scaled by the last octave's scale factor (ORBmatcher.cc:1352)
    sf = scale_factors[jnp.clip(last_octave, 0, n_levels - 1)]
    win = window * sf
    # stereo forward/backward single-sided octave gating by tz vs baseline
    # (ORBmatcher.cc:1352-1394): moving forward the feature appears at a
    # finer-or-equal level, backward coarser-or-equal; mono keeps [l-1, l+1]
    lo = jnp.where(
        forward, last_octave,
        jnp.where(backward, 0, jnp.clip(last_octave - 1, 0, n_levels - 1)),
    )
    hi = jnp.where(
        forward, n_levels - 1,
        jnp.where(
            backward, last_octave, jnp.clip(last_octave + 1, 0, n_levels - 1)
        ),
    )
    idx, dist = matcher.match_with_window(
        jnp.where(has[:, None], m.mp_desc[mp], 0),
        feats.desc,
        has,
        feats.valid,
        pred_xy=pred,
        xy2=feats.xy_und,
        window=win,
        max_dist=th_high,
        nn_ratio=nn_ratio,
        octave2=feats.octave,
        octave_lo=lo,
        octave_hi=hi,
        angle1=last_angle,
        angle2=feats.angle,
        histo_bins=histo_bins,
    )
    n = feats.xy.shape[0]
    cur_obs = jnp.full((n,), -1, jnp.int32)
    ok = idx >= 0
    cur_obs = cur_obs.at[jnp.where(ok, idx, n)].set(
        jnp.where(ok, mp, -1), mode="drop"
    )
    return cur_obs, ok.sum()


def _match_reference_kf(
    m: SlamMap,
    feats: FrameFeatures,
    ref_kf: jnp.ndarray,
    nn_ratio: jnp.ndarray,
    th_low: jnp.ndarray,
    histo_bins: int = matcher.HISTO_LENGTH,
):
    """TrackReferenceKeyFrame's matching stage (src/Tracking.cc:977-1024):
    descriptor matching (the reference brute-forces within shared BoW nodes;
    the full masked matrix is one dense program) against the reference
    keyframe's map-point features, rotation-checked."""
    ref_has = (m.kf_obs[ref_kf] >= 0) & m.kf_feat_valid[ref_kf]
    idx, dist = matcher.match_by_descriptor(
        m.kf_desc[ref_kf], feats.desc, ref_has, feats.valid,
        max_dist=th_low, nn_ratio=nn_ratio,
        angle1=m.kf_angle[ref_kf], angle2=feats.angle,
        histo_bins=histo_bins,
    )
    n = feats.n
    ok = idx >= 0
    cur_obs = jnp.full((n,), -1, jnp.int32).at[
        jnp.where(ok, idx, n)
    ].set(jnp.where(ok, m.kf_obs[ref_kf], -1), mode="drop")
    return cur_obs, ok.sum()


def _track_local_map(
    m: SlamMap,
    feats: FrameFeatures,
    cur_obs: jnp.ndarray,
    Tcw: jnp.ndarray,
    K: jnp.ndarray,
    scale_factors: jnp.ndarray,
    th: jnp.ndarray,
    n_levels: int,
    nn_ratio: jnp.ndarray,
    th_high: jnp.ndarray,
    max_local_points: int = 4096,
    local_kf_cap: int = 80,
    bounds: jnp.ndarray | None = None,
):
    """TrackLocalMap's point harvest + projection matching
    (Tracking::UpdateLocalKeyFrames/SearchLocalPoints,
    src/Tracking.cc:1409-1626): vote for keyframes observing the currently
    tracked points, union their map points, frustum-filter, and match.

    Returns (new cur_obs, visible-point mask over M).
    """
    # --- vote for local keyframes ----------------------------------------
    has = (cur_obs >= 0) & m.mp_valid[jnp.maximum(cur_obs, 0)]
    mp = jnp.maximum(cur_obs, 0)
    obs_kf = m.mp_obs_kf[mp]                 # (N, O)
    obs_ok = has[:, None] & (obs_kf >= 0)
    votes = jnp.zeros(m.max_kf, jnp.int32).at[
        jnp.where(obs_ok, obs_kf, m.max_kf)
    ].add(1, mode="drop")
    votes = jnp.where(m.kf_valid, votes, 0)
    kvals, kidx = jax.lax.top_k(votes, min(local_kf_cap, m.max_kf))
    local_kf = jnp.zeros(m.max_kf, bool).at[
        jnp.where(kvals > 0, kidx, m.max_kf)
    ].set(True, mode="drop")

    # --- local point set --------------------------------------------------
    flat = jnp.where((local_kf & m.kf_valid)[:, None], m.kf_obs, -1).reshape(-1)
    in_local = jnp.zeros(m.max_mp, bool).at[
        jnp.where(flat >= 0, flat, m.max_mp)
    ].set(True, mode="drop")
    in_local = in_local & m.mp_valid
    already = jnp.zeros(m.max_mp, bool).at[jnp.where(has, mp, m.max_mp)].set(
        True, mode="drop"
    )
    cand = in_local & ~already

    # --- frustum filter (Frame::isInFrustum, src/Frame.cc:389-445) --------
    X = m.mp_pos
    Pc = se3.apply(Tcw, X)
    z = Pc[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = K[0, 0] * Pc[:, 0] / zs + K[0, 2]
    v = K[1, 1] * Pc[:, 1] / zs + K[1, 2]
    C = -jnp.einsum("ji,j->i", Tcw[:3, :3], Tcw[:3, 3])
    ray = X - C
    dist = jnp.linalg.norm(ray, axis=1)
    viewcos = jnp.sum(ray * m.mp_normal, axis=1) / jnp.maximum(dist, 1e-9)
    # undistorted image bounds (Frame::ComputeImageBounds, Frame.cc:561-589);
    # fall back to the symmetric-principal-point box when not supplied
    if bounds is None:
        bounds = jnp.stack(
            [0.0 * K[0, 2], 2.0 * K[0, 2], 0.0 * K[1, 2], 2.0 * K[1, 2]]
        )
    in_frustum = (
        cand
        & (z > 0)
        & (u >= bounds[0]) & (u < bounds[1])
        & (v >= bounds[2]) & (v < bounds[3])
        & (dist >= 0.8 * m.mp_min_dist) & (dist <= 1.2 * m.mp_max_dist)
        & (viewcos > 0.5)
    )

    # take up to max_local_points candidates
    sel_score = jnp.where(in_frustum, m.mp_n_obs, -1)
    pvals, pid = jax.lax.top_k(sel_score, min(max_local_points, m.max_mp))
    p_ok = pvals >= 0
    pid_s = jnp.maximum(pid, 0)

    pred_oct = predict_octave(
        dist[pid_s], m.mp_max_dist[pid_s], scale_factors[1], n_levels
    )
    # radius by viewing cos (ORBmatcher.cc:65-71): 2.5 if cos>0.998 else 4.0
    r = jnp.where(viewcos[pid_s] > 0.998, 2.5, 4.0)
    win = r * th * scale_factors[jnp.clip(pred_oct, 0, n_levels - 1)]

    free_feat = feats.valid & (cur_obs < 0)
    idx, dsts = matcher.match_with_window(
        m.mp_desc[pid_s],
        feats.desc,
        p_ok,
        free_feat,
        pred_xy=jnp.stack([u[pid_s], v[pid_s]], axis=1),
        xy2=feats.xy_und,
        window=win,
        max_dist=th_high,
        nn_ratio=nn_ratio,
        octave2=feats.octave,
        octave_lo=jnp.clip(pred_oct - 1, 0, n_levels - 1),
        octave_hi=jnp.clip(pred_oct, 0, n_levels - 1),
    )
    n = feats.xy.shape[0]
    ok = idx >= 0
    cur_obs = cur_obs.at[jnp.where(ok, idx, n)].set(
        jnp.where(ok, pid_s, -1), mode="drop"
    )
    visible = jnp.zeros(m.max_mp, bool).at[
        jnp.where(p_ok, pid_s, m.max_mp)
    ].set(True, mode="drop")
    return cur_obs, visible


def _pose_opt_on_obs(
    m: SlamMap,
    feats: FrameFeatures,
    cur_obs: jnp.ndarray,
    Tcw0: jnp.ndarray,
    K: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    n_rounds: int = 4,
    n_iters: int = 10,
    lm_lambda: jnp.ndarray | float = 1e-3,
    ur: jnp.ndarray | None = None,
    bf: jnp.ndarray | float = 0.0,
):
    """Motion-only optimization over the frame's current map-point matches
    (Optimizer::PoseOptimization, src/Optimizer.cc:239-451). ur/bf add the
    frame's stereo right-u rows (EdgeStereoSE3ProjectXYZOnlyPose)."""
    has = (cur_obs >= 0) & m.mp_valid[jnp.maximum(cur_obs, 0)] & feats.valid
    mp = jnp.maximum(cur_obs, 0)
    X = m.mp_pos[mp]
    w = inv_sigma2[jnp.clip(feats.octave, 0, inv_sigma2.shape[0] - 1)]
    Tcw, inl, n_inl = optimize_pose(
        Tcw0, X, feats.xy_und, w, has, K,
        n_rounds=n_rounds, n_iters=n_iters, lambda_init=lm_lambda,
        ur=ur, bf=bf,
    )
    cur_obs = jnp.where(inl | ~has, cur_obs, -1)
    return Tcw, cur_obs, n_inl


def _reloc_widen(
    m: SlamMap,
    feats: FrameFeatures,
    cand: jnp.ndarray,
    cur_obs: jnp.ndarray,
    Tcw: jnp.ndarray,
    K: jnp.ndarray,
    scale_factors: jnp.ndarray,
    n_levels: int,
    window_th: float,
    orb_dist: int,
    histo_bins: int,
) -> jnp.ndarray:
    """The relocalization SearchByProjection overload
    (ORBmatcher.cc:1476-1604): project the candidate keyframe's map points
    that are NOT already found into the current frame; window
    th*scale(predicted level), level gate [pred-1, pred+1], plain descriptor
    gate ORBdist (no ratio test in this overload), rotation histogram.
    Returns cur_obs with the additional matches scattered in."""
    from ..slam_map.point_stats import predict_octave

    obs_kf = m.kf_obs[cand]
    has = (obs_kf >= 0) & m.kf_feat_valid[cand]
    mp = jnp.maximum(obs_kf, 0)
    has = has & m.mp_valid[mp]
    # sAlreadyFound: skip points the frame already holds
    already = jnp.zeros(m.max_mp, bool).at[
        jnp.where(cur_obs >= 0, jnp.maximum(cur_obs, 0), m.max_mp)
    ].set(True, mode="drop")
    has = has & ~already[mp]

    X = m.mp_pos[mp]
    Pc = se3.apply(Tcw, X)
    z = Pc[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    pred = jnp.stack(
        [K[0, 0] * Pc[:, 0] / zs + K[0, 2], K[1, 1] * Pc[:, 1] / zs + K[1, 2]],
        axis=1,
    )
    has = has & (z > 0)
    C = -jnp.einsum("ji,j->i", Tcw[:3, :3], Tcw[:3, 3])
    dist3 = jnp.linalg.norm(X - C, axis=1)
    pred_oct = predict_octave(dist3, m.mp_max_dist[mp], scale_factors[1], n_levels)
    win = window_th * scale_factors[jnp.clip(pred_oct, 0, n_levels - 1)]
    free = feats.valid & (cur_obs < 0)
    idx, _ = matcher.match_with_window(
        jnp.where(has[:, None], m.mp_desc[mp], 0),
        feats.desc,
        has,
        free,
        pred_xy=pred,
        xy2=feats.xy_und,
        window=win,
        max_dist=orb_dist,
        nn_ratio=1e6,  # best-only acceptance (ORBmatcher.cc:1560-1575)
        octave2=feats.octave,
        octave_lo=jnp.clip(pred_oct - 1, 0, n_levels - 1),
        octave_hi=jnp.clip(pred_oct + 1, 0, n_levels - 1),
        angle1=m.kf_angle[cand],
        angle2=feats.angle,
        histo_bins=histo_bins,
    )
    n = feats.n
    ok = idx >= 0
    return cur_obs.at[jnp.where(ok, idx, n)].set(
        jnp.where(ok, mp, -1), mode="drop"
    )


@partial(
    jax.jit,
    static_argnames=("n_levels", "histo_bins", "accept_n", "min_bow_matches"),
)
def _reloc_program(
    m: SlamMap,
    feats: FrameFeatures,
    cands: jnp.ndarray,     # (C,) candidate keyframe ids (padded)
    cand_ok: jnp.ndarray,   # (C,) bool
    keys: jnp.ndarray,      # (C, 2) PRNG keys
    K: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    scale_factors: jnp.ndarray,
    nn_ratio_bow: jnp.ndarray,
    th_low: jnp.ndarray,
    ur: jnp.ndarray | None,
    bf: jnp.ndarray,
    n_levels: int,
    histo_bins: int,
    accept_n: int,
    min_bow_matches: int = 15,
):
    """The full per-candidate relocalization cascade as ONE vmapped device
    program (Tracking::Relocalization, src/Tracking.cc:1687-1816):
    BoW-style matching -> RANSAC PnP -> PoseOptimization -> if nGood<50 a
    wide SearchByProjection(th=10, ORBdist=100) retry -> if 30<nGood<50 a
    narrow (th=3, ORBdist=64) retry. The host performs ONE scalar fetch for
    the whole lost frame (the (C,) inlier counts) instead of 2-3 blocking
    fetches per candidate.
    Returns (n_good (C,), Tcw (C,4,4), cur_obs (C,N))."""

    def one_candidate(cand, okc, key):
        kf_obs = m.kf_obs[cand]
        ref_has = (kf_obs >= 0) & m.kf_feat_valid[cand] & okc
        idx, _ = matcher.match_by_descriptor(
            m.kf_desc[cand], feats.desc, ref_has, feats.valid,
            max_dist=th_low, nn_ratio=nn_ratio_bow,
            angle1=m.kf_angle[cand], angle2=feats.angle,
            histo_bins=histo_bins,
        )
        n = feats.n
        okm = idx >= 0
        cur_obs = jnp.full((n,), -1, jnp.int32).at[
            jnp.where(okm, idx, n)
        ].set(jnp.where(okm, kf_obs, -1), mode="drop")
        n_matches = okm.sum()

        has = (cur_obs >= 0) & m.mp_valid[jnp.maximum(cur_obs, 0)]
        X = m.mp_pos[jnp.maximum(cur_obs, 0)]
        w = inv_sigma2[jnp.clip(feats.octave, 0, n_levels - 1)]
        Tcw0, inl, n_inl = ransac_pnp(X, feats.xy_und, has, w, K, key)

        # round 1: motion-only optimization on the PnP inliers
        Tcw1, obs1, n1 = _pose_opt_on_obs(
            m, feats, jnp.where(inl, cur_obs, -1), Tcw0, K, inv_sigma2,
            ur=ur, bf=bf,
        )

        def widen(obs, Tcw, th, od):
            obs_w = _reloc_widen(
                m, feats, cand, obs, Tcw, K, scale_factors, n_levels,
                th, od, histo_bins,
            )
            return _pose_opt_on_obs(
                m, feats, obs_w, Tcw, K, inv_sigma2, ur=ur, bf=bf
            )

        # round 2: wide retry when 10 <= nGood < 50 (Tracking.cc:1765-1785)
        do2 = (n1 < accept_n) & (n1 >= 10)
        Tcw2, obs2, n2 = jax.lax.cond(
            do2,
            lambda: widen(obs1, Tcw1, 10.0, 100),
            lambda: (Tcw1, obs1, n1),
        )
        # round 3: narrow retry when 30 < nGood < 50 (Tracking.cc:1787-1808)
        do3 = do2 & (n2 > 30) & (n2 < accept_n)
        Tcw3, obs3, n3 = jax.lax.cond(
            do3,
            lambda: widen(obs2, Tcw2, 3.0, 64),
            lambda: (Tcw2, obs2, n2),
        )
        good = okc & (n_matches >= min_bow_matches) & (n_inl >= 10)
        return jnp.where(good, n3, 0), Tcw3, obs3

    return jax.vmap(one_candidate)(cands, cand_ok, keys)


def _update_point_counters(m: SlamMap, visible, cur_obs):
    """IncreaseVisible / IncreaseFound counters (Tracking.cc:1409-1447)."""
    found = jnp.zeros(m.max_mp, bool).at[
        jnp.where(cur_obs >= 0, jnp.maximum(cur_obs, 0), m.max_mp)
    ].set(True, mode="drop")
    return m.replace(
        mp_visible=m.mp_visible + (visible | found).astype(jnp.int32),
        mp_found=m.mp_found + found.astype(jnp.int32),
    )


# Packed scalar layout returned by _track_step: the ONE per-frame fetch.
S_N_MATCHES = 0
S_USED_REF = 1
S_N_INL1 = 2
S_N_INL2 = 3
S_OK1 = 4
S_N_REF = 5
S_N_KF = 6
S_N_CLOSE_T = 7
S_N_CLOSE_U = 8
N_SCALARS = 9


def _pack_bits(mask: jnp.ndarray) -> jnp.ndarray:
    """Pack a (M,) bool mask into (M/32,) uint32 (M must be a multiple of
    32 — map capacities are). Tiny per-frame artifact letting the host roll
    back counter increments of frames later shown to be garbage."""
    b = mask.reshape(-1, 32).astype(jnp.uint32)
    w = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, :]
    return jnp.sum(b * w, axis=1, dtype=jnp.uint32)


def _unpack_bits(packed: jnp.ndarray, m_size: int) -> jnp.ndarray:
    w = (packed[:, None] >> jnp.arange(32, dtype=jnp.uint32)[None, :]) & 1
    return w.reshape(m_size).astype(bool)


def _mat(x):
    """Materialize a lazy batched reference.

    The fused N-frame scan returns STACKED per-frame outputs; slicing them
    into per-frame arrays eagerly costs one tiny device program per field
    per frame (~30+ programs per batch). Pending records and trajectory
    entries therefore hold ("sliced", stacked_pytree, i) references and
    materialize only when actually consumed (keyframe creation, loss
    rollback, trajectory export)."""
    if isinstance(x, tuple) and len(x) == 3 and x[0] == "sliced":
        return jax.tree.map(lambda a: a[x[2]], x[1])
    return x


def _track_step_impl(
    m: SlamMap,
    feats: FrameFeatures,
    last_obs: jnp.ndarray,
    last_octave: jnp.ndarray,
    last_angle: jnp.ndarray,
    has_velocity: jnp.ndarray,
    velocity: jnp.ndarray,
    last_Tcw: jnp.ndarray,
    ref_kf: jnp.ndarray,
    K: jnp.ndarray,
    scale_factors: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    p: TrackParams,
    n_levels: int,
    max_local_points: int,
    local_kf_cap: int,
    pose_rounds: int,
    pose_iters: int,
    histo_bins: int,
    ur: jnp.ndarray | None = None,
    bf: jnp.ndarray | float = 0.0,
    depth: jnp.ndarray | None = None,
    depth_threshold: jnp.ndarray | float = 0.0,
):
    """One fused tracking step (Tracking::Track, src/Tracking.cc:385-694,
    OK-state branch). Returns (map-with-updated-counters, Tcw, cur_obs,
    new velocity, packed scalars) — the scalars are the only thing the host
    needs to read back. ur (N,): the frame's stereo right-u per feature
    (-1 = mono), adding the 3-dof stereo rows to both pose optimizations.
    depth (N,): per-feature stereo/RGB-D depth, feeding the close-point
    counts of the reference's stereo keyframe gate c1c
    (Tracking.cc:1264-1283)."""
    Tcw_pred = jnp.where(has_velocity, velocity @ last_Tcw, last_Tcw)

    # stereo forward/backward motion classification (ORBmatcher.cc:1352-1360):
    # tz of the last->current relative motion vs the stereo baseline
    if ur is not None:
        T_cl = Tcw_pred @ se3.inv(last_Tcw)
        tz = T_cl[2, 3]
        base = bf / K[0, 0]
        fwd = has_velocity & (tz > base)
        bwd = has_velocity & (-tz > base)
    else:
        fwd = bwd = False

    def motion(window):
        return _track_last_frame(
            m, feats, last_obs, last_octave, last_angle, Tcw_pred, K,
            window, scale_factors, n_levels, p.nn_ratio_motion, p.th_high,
            histo_bins, forward=fwd, backward=bwd,
        )

    obs_a, n_a = motion(p.motion_window)
    # widen the window 2x on failure (Tracking.cc:1108-1121)
    obs_b, n_b = jax.lax.cond(
        n_a < p.min_matches_motion,
        lambda: motion(2.0 * p.motion_window),
        lambda: (obs_a, n_a),
    )
    # TrackReferenceKeyFrame fallback (Tracking.cc:449)
    need_ref = n_b < p.min_matches_motion
    obs_c, n_c = jax.lax.cond(
        need_ref,
        lambda: _match_reference_kf(
            m, feats, ref_kf, p.nn_ratio_refkf, p.th_low, histo_bins
        ),
        lambda: (obs_b, n_b),
    )
    Tcw0 = jnp.where(need_ref, last_Tcw, Tcw_pred)
    min_required = jnp.where(
        need_ref, p.min_matches_refkf, p.min_matches_motion
    )
    enough = n_c >= min_required

    Tcw1, obs_d, n_i1 = _pose_opt_on_obs(
        m, feats, obs_c, Tcw0, K, inv_sigma2, pose_rounds, pose_iters,
        p.lm_lambda, ur=ur, bf=bf,
    )
    ok1 = enough & (n_i1 >= p.min_inliers_motion)

    # TrackLocalMap (Tracking.cc:1163-1207)
    obs_e, visible = _track_local_map(
        m, feats, obs_d, Tcw1, K, scale_factors, p.local_th, n_levels,
        p.nn_ratio_localmap, p.th_high,
        max_local_points=max_local_points, local_kf_cap=local_kf_cap,
        bounds=p.bounds,
    )
    Tcw2, obs_f, n_i2 = _pose_opt_on_obs(
        m, feats, obs_e, Tcw1, K, inv_sigma2, pose_rounds, pose_iters,
        p.lm_lambda, ur=ur, bf=bf,
    )

    m_cnt = _update_point_counters(m, visible, obs_f)
    # counters only advance when the pre-local-map stages succeeded (the
    # reference never reaches TrackLocalMap otherwise)
    m2 = m.replace(
        mp_visible=jnp.where(ok1, m_cnt.mp_visible, m.mp_visible),
        mp_found=jnp.where(ok1, m_cnt.mp_found, m.mp_found),
    )
    # packed per-frame counter increments: lets the pipelined resolver
    # reconstruct the counter planes as of any frame in a batch (rolling
    # back increments chained by garbage frames after a mid-batch loss)
    found_mask = jnp.zeros(m.max_mp, bool).at[
        jnp.where(obs_f >= 0, jnp.maximum(obs_f, 0), m.max_mp)
    ].set(True, mode="drop")
    inc_vis = _pack_bits((visible | found_mask) & ok1)
    inc_found = _pack_bits(found_mask & ok1)

    # NeedNewKeyFrame statistics (Tracking.cc:1210-1310): tracked points of
    # the reference KF with >= minObs observations
    n_kf_valid = m.kf_valid.sum().astype(jnp.int32)
    min_obs = jnp.where(n_kf_valid > 2, 3, 2)
    robs = m.kf_obs[ref_kf]
    rmp = jnp.maximum(robs, 0)
    rhas = (robs >= 0) & m.kf_feat_valid[ref_kf] & m.mp_valid[rmp]
    n_ref = jnp.sum(rhas & (m.mp_n_obs[rmp] >= min_obs)).astype(jnp.int32)

    # stereo close-point statistics for NeedNewKeyFrame's ratioMap
    # (Tracking.cc:1238-1263): nMap = close-depth features matched to an
    # OBSERVED map point, nTotal = all close-depth features; the packed
    # scalars carry (nMap, nTotal - nMap). Zeros on the mono path.
    if depth is not None:
        close = feats.valid & (depth > 0) & (depth < depth_threshold)
        mp_of = jnp.maximum(obs_f, 0)
        has_map = (
            (obs_f >= 0) & m.mp_valid[mp_of] & (m.mp_n_obs[mp_of] > 0)
        )
        n_close_t = jnp.sum(close & has_map).astype(jnp.int32)
        n_close_u = jnp.sum(close & ~has_map).astype(jnp.int32)
    else:
        n_close_t = jnp.asarray(0, jnp.int32)
        n_close_u = jnp.asarray(0, jnp.int32)

    vel_new = Tcw2 @ se3.inv(last_Tcw)
    # keyframe-relative trajectory entry (src/Tracking.cc:666-694) computed
    # in-program: the eager per-frame composition was 3 extra dispatches
    # riding every frame's sync
    T_cr = Tcw2 @ se3.inv(m.kf_pose[ref_kf])
    scalars = jnp.stack(
        [
            n_c.astype(jnp.int32),
            need_ref.astype(jnp.int32),
            n_i1.astype(jnp.int32),
            n_i2.astype(jnp.int32),
            ok1.astype(jnp.int32),
            n_ref,
            n_kf_valid,
            n_close_t,
            n_close_u,
        ]
    )
    return m2, Tcw2, obs_f, vel_new, T_cr, scalars, (inc_vis, inc_found)


_track_step = partial(
    jax.jit,
    static_argnames=(
        "n_levels", "max_local_points", "local_kf_cap",
        "pose_rounds", "pose_iters", "histo_bins",
    ),
)(_track_step_impl)


@jax.jit
def _counters_at(
    snap_visible: jnp.ndarray,
    snap_found: jnp.ndarray,
    inc_vis: jnp.ndarray,      # (B, M/32) u32 packed per-frame increments
    inc_found: jnp.ndarray,    # (B, M/32)
    upto: jnp.ndarray,         # () i32: apply frames [0, upto)
):
    """Counter planes as of frame `upto` of a pipelined batch: the batch
    snapshot plus the increments of the frames before the loss. The
    reference never updates statistics from lost frames
    (Tracking.cc:1409-1447); this rolls back the ones garbage frames
    chained in before the loss was detected."""
    M = snap_visible.shape[0]
    keep = (jnp.arange(inc_vis.shape[0]) < upto)[:, None]
    vis = jax.vmap(lambda p: _unpack_bits(p, M))(inc_vis)
    fnd = jax.vmap(lambda p: _unpack_bits(p, M))(inc_found)
    dv = jnp.sum(jnp.where(keep, vis, False), axis=0)
    df = jnp.sum(jnp.where(keep, fnd, False), axis=0)
    return snap_visible + dv.astype(jnp.int32), snap_found + df.astype(jnp.int32)


@jax.jit
def _freeze_kf(m, Tcw, feats, cur_obs, frame_id, ts, parent):
    """Freeze a tracked frame into a keyframe (Tracking::CreateNewKeyFrame,
    src/Tracking.cc:1312) — one jit dispatch instead of eager map surgery."""
    return mt.add_keyframe(
        m, Tcw, feats.xy_und, feats.octave, feats.angle, feats.desc,
        feats.valid, cur_obs, frame_id, ts, parent,
    )


@jax.jit
def _freeze_kf_depth(
    m, Tcw, feats, cur_obs, frame_id, ts, parent, depth, camera,
    depth_threshold, scale_factors, bf,
):
    """Keyframe freeze + close-point creation from depth
    (src/Tracking.cc:1340-1395). bf > 0 stores the stereo right-u
    coordinate per feature (mvuRight = u - bf/z) for 3-dof BA edges."""
    ur = jnp.where(
        (depth > 0) & (bf > 0),
        feats.xy_und[:, 0] - bf / jnp.maximum(depth, 1e-6), -1.0,
    )
    m, kf_id = mt.add_keyframe(
        m, Tcw, feats.xy_und, feats.octave, feats.angle, feats.desc,
        feats.valid, cur_obs, frame_id, ts, parent, ur=ur,
    )
    kf = jnp.maximum(kf_id, 0)
    N = feats.n
    free = feats.valid & (m.kf_obs[kf] < 0) & (depth > 0) & (kf_id >= 0)
    close = depth < depth_threshold
    # far-point creation (src/Tracking.cc:1355-1394): the reference walks
    # ALL depth-bearing features closest-first (tracked ones count toward
    # the total) and keeps creating past ThDepth until 100 points exist —
    # a far-field scene (few close points) still seeds the map.
    has_depth = feats.valid & (depth > 0) & (kf_id >= 0)
    depth_key = jnp.where(has_depth, depth, jnp.inf)
    order = jnp.argsort(depth_key)                      # closest first
    rank = jnp.zeros(N, jnp.int32).at[order].set(
        jnp.arange(N, dtype=jnp.int32)
    )
    create = free & (close | (rank < 100))
    Xc = camera.unproject(feats.xy_und, depth)
    Xw = se3.apply(se3.inv(Tcw), Xc)
    m, _ = mt.add_map_points(
        m,
        pos=Xw,
        desc=feats.desc,
        normal=jnp.tile(jnp.asarray([0.0, 0.0, 1.0]), (N, 1)),
        min_dist=jnp.full(N, 0.1),
        max_dist=jnp.full(N, 100.0),
        kf1=jnp.full(N, 0, jnp.int32) + kf,
        feat1=jnp.arange(N, dtype=jnp.int32),
        kf2=jnp.full(N, -1, jnp.int32),
        feat2=jnp.zeros(N, jnp.int32),
        valid=create,
    )
    m = refresh_point_stats(m, scale_factors)
    return m, kf_id


@partial(jax.jit, static_argnames=("n_out",))
def _build_initial_map(
    m, feats1, feats2, idx, good, pts, Tcw2, fid1, ts1, fid2, ts2,
    K, inv_sigma2, scale_factors, n_out,
):
    """CreateInitialMapMonocular (src/Tracking.cc:852-957) as one program:
    truncate the 2x init feature budget back to the map capacity (keeping
    every triangulated match first), median-depth rescale, run the
    two-camera init BA, then freeze both keyframes and insert the optimized
    points. The BA problem is built directly at (2, n_out) shapes — the
    generic global extractor would compile at full map capacity
    (max_kf x max_mp), gigabytes of Schur blocks for a 2-camera solve."""
    from ..optim.local_ba import BAProblem, solve_ba

    n_big = feats1.n

    def top_rows(f, keep):
        key = (
            keep.astype(jnp.float32) * 1e9
            + f.valid.astype(jnp.float32) * 1e6
            + f.response
        )
        _, sel = jax.lax.top_k(key, n_out)
        return sel

    sel1 = top_rows(feats1, good)
    matched_cols = jnp.zeros(n_big, bool).at[
        jnp.where(good, jnp.maximum(idx, 0), n_big)
    ].set(True, mode="drop")
    sel2 = top_rows(feats2, matched_cols)
    f1 = jax.tree.map(lambda a: a[sel1], feats1)
    f2 = jax.tree.map(lambda a: a[sel2], feats2)
    inv2 = jnp.full(n_big, -1, jnp.int32).at[sel2].set(
        jnp.arange(n_out, dtype=jnp.int32)
    )
    idx_n = jnp.where(good[sel1], inv2[jnp.maximum(idx[sel1], 0)], -1)
    good_n = good[sel1] & (idx_n >= 0)
    pts_n = pts[sel1]

    # median-depth normalization (Tracking.cc:901-930)
    med = jnp.nanmedian(jnp.where(good_n, pts_n[:, 2], jnp.nan))
    med = jnp.where(jnp.isnan(med) | (med <= 1e-6), 1.0, med)
    pts_n = pts_n / med
    Tcw2 = Tcw2.at[:3, 3].set(Tcw2[:3, 3] / med)

    # init BA (GlobalBundleAdjustemnt(map, 20) — Tracking.cc:894) on the
    # two-camera problem; gauge fixed at camera 0
    eye = jnp.eye(4)
    L = inv_sigma2.shape[0]
    w1 = inv_sigma2[jnp.clip(f1.octave, 0, L - 1)]
    w2 = inv_sigma2[jnp.clip(f2.octave[jnp.maximum(idx_n, 0)], 0, L - 1)]
    prob = BAProblem(
        cam_pose=jnp.stack([eye, Tcw2]),
        cam_fixed=jnp.asarray([True, False]),
        cam_valid=jnp.asarray([True, True]),
        points=pts_n,
        point_valid=good_n,
        obs_cam=jnp.where(
            good_n[:, None], jnp.asarray([0, 1], jnp.int32)[None, :], -1
        ),
        obs_uv=jnp.stack(
            [f1.xy_und, f2.xy_und[jnp.maximum(idx_n, 0)]], axis=1
        ),
        obs_inv_sigma2=jnp.stack([w1, w2], axis=1),
        obs_valid=good_n[:, None] & jnp.asarray([True, True])[None, :],
        K=K,
    )
    ba = solve_ba(prob, 5, 15)
    Tcw2 = ba.cam_pose[1]
    pts_n = ba.points
    # a point losing either observation dies (nObs <= 2 rule applied at birth)
    good_n = good_n & jnp.all(ba.obs_inlier | ~prob.obs_valid, axis=1)

    m, kf0 = mt.add_keyframe(
        m, eye, f1.xy_und, f1.octave, f1.angle, f1.desc, f1.valid,
        jnp.full(n_out, -1, jnp.int32), fid1, ts1, jnp.asarray(-1),
    )
    m, kf1 = mt.add_keyframe(
        m, Tcw2, f2.xy_und, f2.octave, f2.angle, f2.desc, f2.valid,
        jnp.full(n_out, -1, jnp.int32), fid2, ts2, kf0,
    )
    m, _ = mt.add_map_points(
        m,
        pos=pts_n,
        desc=f1.desc,
        normal=jnp.tile(jnp.asarray([0.0, 0.0, 1.0]), (n_out, 1)),
        min_dist=jnp.full(n_out, 0.1),
        max_dist=jnp.full(n_out, 100.0),
        kf1=jnp.zeros(n_out, jnp.int32) + kf0,
        feat1=jnp.arange(n_out, dtype=jnp.int32),
        kf2=jnp.zeros(n_out, jnp.int32) + kf1,
        feat2=jnp.maximum(idx_n, 0),
        valid=good_n,
    )
    m = refresh_point_stats(m, scale_factors)
    return m, f2


@jax.jit
def _build_depth_init(m, feats, feat_depth, camera, frame_id, ts, scale_factors, bf):
    """Stereo/RGB-D initialization (Tracking::StereoInitialization,
    src/Tracking.cc:700-748) as one program."""
    N = feats.n
    ur = jnp.where(
        (feat_depth > 0) & (bf > 0),
        feats.xy_und[:, 0] - bf / jnp.maximum(feat_depth, 1e-6), -1.0,
    )
    m, kf0 = mt.add_keyframe(
        m, jnp.eye(4), feats.xy_und, feats.octave, feats.angle,
        feats.desc, feats.valid, jnp.full(N, -1, jnp.int32),
        frame_id, ts, jnp.asarray(-1), ur=ur,
    )
    has_d = feats.valid & (feat_depth > 0)
    X = camera.unproject(feats.xy_und, feat_depth)
    m, ids = mt.add_map_points(
        m,
        pos=X,
        desc=feats.desc,
        normal=jnp.tile(jnp.asarray([0.0, 0.0, 1.0]), (N, 1)),
        min_dist=jnp.full(N, 0.1),
        max_dist=jnp.full(N, 100.0),
        kf1=jnp.zeros(N, jnp.int32) + kf0,
        feat1=jnp.arange(N, dtype=jnp.int32),
        kf2=jnp.full(N, -1, jnp.int32),
        feat2=jnp.zeros(N, jnp.int32),
        valid=has_d,
    )
    m = refresh_point_stats(m, scale_factors)
    return m, has_d.sum()


@dataclass
class TrackerOutput:
    state: str
    Tcw: np.ndarray | jax.Array | None
    n_inliers: int
    created_kf: bool
    # keyframe-relative pose for the trajectory log, already composed on
    # device (None = compose eagerly; the ref_kf is read at append time)
    T_cr: jax.Array | None = None
    # True when the frame was pipelined (frames_per_sync > 1): state/Tcw are
    # speculative until the next resolution; n_inliers is -1
    deferred: bool = False


class Tracker:
    """Monocular tracking session. Owns the map and per-frame state."""

    # last_feats is lazily materialized from the fused scan's stacked output
    # (the [-1] slice of every FrameFeatures field is ~8 device programs —
    # only paid when a consumer actually leaves the batched fast path)
    @property
    def last_feats(self):
        if self._last_feats_val is None and self._last_feats_batched is not None:
            self._last_feats_val = jax.tree.map(
                lambda a: a[-1], self._last_feats_batched
            )
            self._last_feats_batched = None
        return self._last_feats_val

    @last_feats.setter
    def last_feats(self, v):
        self._last_feats_val = v
        self._last_feats_batched = None
        self._carry_oct = None
        self._carry_ang = None

    def __init__(self, cfg: SlamConfig, camera: Camera):
        self.cfg = cfg
        self.camera = camera
        hw = (camera.height, camera.width)
        self.extractor = OrbExtractor(cfg.orb, hw)
        # 2x feature budget during monocular initialization (Tracking.cc:162)
        init_cfg = cfg.orb.__class__(
            **{
                **cfg.orb.__dict__,
                "n_features": cfg.orb.n_features * cfg.orb.init_features_mult,
            }
        )
        self.init_extractor = (
            OrbExtractor(init_cfg, hw)
            if cfg.orb.init_features_mult > 1
            else self.extractor
        )
        self.K = jnp.asarray(np.asarray(camera.K), jnp.float32)
        self.scale_factors = jnp.asarray(self.extractor.scales)
        self.sigma2 = jnp.asarray(self.extractor.sigma2)
        self.inv_sigma2 = jnp.asarray(self.extractor.inv_sigma2)
        self.params = TrackParams.from_config(cfg)
        self._eye4 = jnp.eye(4)

        # extract + undistort fused into one jit dispatch per frame
        def make_extract(ex):
            def f(img):
                feats = ex._extract_impl(img)
                return feats.replace(xy_und=camera.undistort_points(feats.xy))

            return jax.jit(f)

        self._extract_track = make_extract(self.extractor)
        self._extract_init = (
            make_extract(self.init_extractor)
            if self.init_extractor is not self.extractor
            else self._extract_track
        )

        # fused per-frame programs for depth-bearing modes: extraction (+
        # the second extraction + row-band matcher for stereo) in ONE launch,
        # consuming the already-uploaded (uint8) frames
        from ..ops.stereo import depth_from_depthmap, match_stereo

        bf_c = np.float32(cfg.camera.baseline_times_fx)
        minz_c = np.float32(bf_c / cfg.camera.fx if bf_c > 0 else 0.0)
        n_levels_c = cfg.orb.n_levels

        def rgbd_frame(img, dmap):
            feats = self.extractor._extract_impl(img)
            feats = feats.replace(xy_und=camera.undistort_points(feats.xy))
            return feats, depth_from_depthmap(feats, dmap)

        def stereo_frame(img_l, img_r):
            fl = self.extractor._extract_impl(img_l)
            fl = fl.replace(xy_und=camera.undistort_points(fl.xy))
            fr = self.extractor._extract_impl(img_r)
            fd, _ = match_stereo(
                fl, fr, img_l.astype(jnp.float32), img_r.astype(jnp.float32),
                jnp.asarray(bf_c), jnp.asarray(minz_c),
                jnp.asarray(self.extractor.scales), n_levels=n_levels_c,
            )
            return fl, fd

        self._rgbd_frame_fn = jax.jit(rgbd_frame)
        self._stereo_frame_fn = jax.jit(stereo_frame)

        self.m = mt.empty_map(cfg.capacity, cfg.orb.n_features)
        # host mirror of the allocated-keyframe counter (slot ids are never
        # reused, so this avoids a device fetch per keyframe decision)
        self.n_kf_host = 0
        self.state = NO_IMAGES_YET
        self.frame_id = -1
        self.last_feats: Optional[FrameFeatures] = None
        self.last_obs: Optional[jnp.ndarray] = None
        self.last_Tcw: Optional[jnp.ndarray] = None
        self.velocity: Optional[jnp.ndarray] = None
        self.ref_kf = 0
        self.last_kf_frame = 0
        self.last_reloc_frame = -(10**9)
        self.init_feats: Optional[FrameFeatures] = None
        self._cur_depth: Optional[jnp.ndarray] = None
        self._cur_ur: Optional[jnp.ndarray] = None
        # frames tracked but not yet resolved (frames_per_sync > 1): each
        # entry keeps the device arrays needed to make the LOST/keyframe
        # decisions once the batched scalar fetch lands
        self._pending_frames: list[dict] = []
        # raw frames buffered for the fused extract+track device scan
        # (mono steady state): ONE device program + ONE sync per batch
        self._img_buffer: list[dict] = []
        # (mp_visible, mp_found) snapshot at the head of the pending batch,
        # for counter rollback when a mid-batch loss is detected
        self._batch_counters = None
        self._scan_fns = {}  # mode -> jitted fused scan (built lazily)
        self._scan_mode = "mono"  # sensor mode of the buffered frames
        # per-frame trajectory log: (timestamp, T_cr = Tcw · Tref^-1, ref_kf)
        # — relative to the reference keyframe, like the reference's
        # (mlRelativeFramePoses, mlpReferences) lists (src/Tracking.cc:666-694)
        # so that loop/BA corrections propagate into the export
        # (System::SaveTrajectoryTUM, src/System.cc:401-454).
        self.trajectory: list[tuple[float, jnp.ndarray, int]] = []
        # culled-keyframe re-anchoring for records still in flight: slot ->
        # (T_culled_parent, surviving ancestor). Pipelined records whose
        # recorded ref_kf is culled mid-resolution (a c1a/c1c forced
        # adoption inside _resolve_pending) would otherwise append
        # trajectory entries anchored to a dead slot that stops receiving
        # loop/GBA corrections (the mTcp mechanism, src/KeyFrame.cc:460-552).
        self.culled_remap: dict[int, tuple[jnp.ndarray, int]] = {}
        self.mapping_hook = None  # set by System: called with (new_kf_id)
        # mapper_idle_hook(force=False) -> bool: adopt finished async mapping
        # output / report idleness (System.mapper_idle); None = always idle
        self.mapper_idle_hook = None
        # reset_hook(): called by reset() so the pipeline can drop any
        # in-flight async mapping pass (a stale pass adopted after reset
        # would resurrect the old map into a fresh session)
        self.reset_hook = None
        # optional PoseNet person-keypoint head, run per frame like the
        # reference's Frame ctor (src/Frame.cc:222-334); enable with
        # enable_posenet(). Results (device arrays) in last_person.
        self._posenet_params = None
        self._posenet_fn = None
        self.last_person = None  # (positions (17,2), scores (17,), mask)
        self.allow_keyframes = True  # cleared in localization-only mode
        self.bow = self._make_bow()

    def _make_bow(self):
        """Fresh recognition index. cfg.vocabulary_path loads a pre-trained
        DBoW2-format vocabulary (the ORBvoc.txt flow — src/System.cc:124-129);
        otherwise the vocabulary trains online from the session's keyframes."""
        from ..bow.database import BowIndex

        path = getattr(self.cfg, "vocabulary_path", None)
        if path:
            return BowIndex.from_pretrained(
                path, self.cfg.capacity.max_keyframes,
                sparse_slots=self.cfg.orb.n_features,
            )
        return BowIndex(self.cfg.capacity.max_keyframes)

    def enable_posenet(self, params=None) -> None:
        """Run the PoseNet human-keypoint head on every frame (the reference
        instantiates it in Tracking and runs it in the Frame ctor —
        src/Tracking.cc:184-187, src/Frame.cc:222-232). params: trained
        params in the models/posenet.py layout; random init when None (no
        pretrained weights ship with the reference repo either)."""
        from ..models import posenet

        self._posenet_params = (
            params
            if params is not None
            else posenet.init_params(jax.random.PRNGKey(self.cfg.seed + 99))
        )
        self._posenet_fn = jax.jit(posenet.person_keypoints_for_frame)

    # ------------------------------------------------------------------
    def process_frame(
        self,
        image: np.ndarray,
        timestamp: float,
        depth: np.ndarray | None = None,
        image_right: np.ndarray | None = None,
    ) -> TrackerOutput:
        """Track one frame. `depth` (H, W) meters enables the RGB-D path;
        `image_right` enables the stereo path (rectified pair)."""
        self.frame_id += 1
        mono = depth is None and image_right is None
        mode = "mono" if mono else ("rgbd" if depth is not None else "stereo")
        # uint8 frames transfer 4x fewer bytes over the host->device link
        # (the largest per-frame transfer); device compute casts to f32 at
        # the head of the extract program. The same applies to the stereo
        # right image; the depth map stays f32.
        def upload(a, force_f32=False):
            if not force_f32 and getattr(a, "dtype", None) == np.uint8:
                return jnp.asarray(a)
            return jnp.asarray(a, jnp.float32)

        img_dev = upload(image)
        img_r_dev = upload(image_right) if image_right is not None else None
        dmap_dev = upload(depth, force_f32=True) if depth is not None else None

        # steady-state fast path (all sensor modes): buffer the raw frame(s)
        # and track a whole batch inside ONE device program (extraction —
        # and stereo matching / depth lookup — fused into the tracking scan;
        # removes the per-frame launch + sync overhead)
        cfgt = self.cfg.tracking
        just_reloc = self.frame_id < self.last_reloc_frame + 2
        # the keyframe-count warmup protects KEYFRAME timing while the map
        # is young; localization-only sessions (ActivateLocalizationMode /
        # loaded maps) never insert keyframes, so any map size rides the
        # fused scan
        warmed = (
            self.n_kf_host >= cfgt.pipeline_warmup_kfs
            or not self.allow_keyframes
        )
        if (
            self.state == OK and cfgt.frames_per_sync > 1
            and warmed
            and not just_reloc
            and all(
                isinstance(r["scalars"], tuple) for r in self._pending_frames
            )  # scan-batch records may stay deferred; per-frame ones may not
            and (not self._img_buffer or self._scan_mode == mode)
        ):
            if self._posenet_fn is not None:
                self.last_person = self._posenet_fn(self._posenet_params, img_dev)
            self._cur_depth = None
            self._cur_ur = None
            recent_reloc = (
                self.frame_id
                < self.last_reloc_frame + cfgt.max_frames_between_kf
            )
            self._scan_mode = mode
            self._img_buffer.append(dict(
                img=img_dev, img_r=img_r_dev, dmap=dmap_dev,
                ts=timestamp, frame_id=self.frame_id,
                recent_reloc=recent_reloc,
            ))
            if len(self._img_buffer) >= cfgt.frames_per_sync:
                self._run_scan_batch()
            if self.state != OK:
                return TrackerOutput(self.state, None, -1, False, deferred=True)
            return TrackerOutput(OK, self.last_Tcw, -1, False, deferred=True)

        # a frame leaving the fast path (loss, mode switch, reloc) drains any
        # buffered-but-untracked frames first so ordering is preserved
        if self._img_buffer:
            self._drain_img_buffer()
        initializing = self.state in (NO_IMAGES_YET, NOT_INITIALIZED)
        if self._posenet_fn is not None:
            # async dispatch; results are device futures (no per-frame sync)
            self.last_person = self._posenet_fn(self._posenet_params, img_dev)

        # extraction (+ per-feature depth for stereo / RGB-D) as one fused
        # program per mode — the stereo pair is uploaded ONCE and both
        # extractions + the row-band matcher share the launch
        feat_depth = None
        if mode == "rgbd":
            feats, feat_depth = self._rgbd_frame_fn(img_dev, dmap_dev)
        elif mode == "stereo":
            feats, feat_depth = self._stereo_frame_fn(img_dev, img_r_dev)
        else:
            extract = (
                self._extract_init if initializing else self._extract_track
            )
            feats = extract(img_dev)
        self._cur_depth = feat_depth
        # current frame's stereo right-u (mvuRight) for the 3-dof pose rows
        if feat_depth is not None:
            bf_v = self.cfg.camera.baseline_times_fx
            self._cur_ur = jnp.where(
                (feat_depth > 0) & (bf_v > 0),
                feats.xy_und[:, 0] - bf_v / jnp.maximum(feat_depth, 1e-6),
                -1.0,
            )
        else:
            self._cur_ur = None

        if initializing:
            if feat_depth is not None:
                out = self._initialize_with_depth(feats, feat_depth, timestamp)
            else:
                out = self._try_initialize(feats, timestamp)
        elif self.state == OK:
            out = self._track(feats, timestamp)
        else:
            out = self._relocalize(feats, timestamp)

        if out.deferred:
            # pipelined frames log their trajectory entry at resolution time
            return out
        if out.Tcw is not None:
            # the fused step supplies T_cr on device; a frame that just froze
            # a keyframe anchors to it with the identity (the new keyframe's
            # pose IS this frame's pose — src/Tracking.cc:670-676); rare
            # paths (init/reloc) compose eagerly
            if out.created_kf:
                T_cr = self._eye4
            elif out.T_cr is not None:
                T_cr = out.T_cr
            else:
                T_cr = jnp.asarray(out.Tcw) @ se3.inv(self.m.kf_pose[self.ref_kf])
            self.trajectory.append((timestamp, T_cr, self.ref_kf))
        elif self.trajectory:
            last = self.trajectory[-1]
            self.trajectory.append((timestamp, last[1], last[2]))
        return out

    def _initialize_with_depth(
        self, feats: FrameFeatures, feat_depth: jnp.ndarray, ts: float
    ) -> TrackerOutput:
        """Stereo/RGB-D initialization (Tracking::StereoInitialization,
        src/Tracking.cc:700-748): one keyframe, map points unprojected from
        depth — no two-view geometry needed."""
        n_valid = int(feats.valid.sum())
        if n_valid <= 100:  # ref demands N>500 at 2000 feats; scale to budget
            return TrackerOutput(NOT_INITIALIZED, None, 0, False)

        m, n_pts = _build_depth_init(
            self.m, feats, feat_depth, self.camera,
            jnp.asarray(self.frame_id), jnp.asarray(ts, jnp.float32),
            self.scale_factors,
            jnp.asarray(self.cfg.camera.baseline_times_fx, jnp.float32),
        )
        self.m = m
        kf0 = 0  # initialization always starts from an empty map
        self.n_kf_host = 1
        self.last_feats = feats
        self.last_obs = self.m.kf_obs[kf0]
        self.last_Tcw = self._eye4
        self.velocity = None
        self.ref_kf = kf0
        self.last_kf_frame = self.frame_id
        self.state = OK
        self._register_kf_bow(kf0)
        return TrackerOutput(OK, np.eye(4), int(n_pts), True)

    # ------------------------------------------------------------------
    def _try_initialize(self, feats: FrameFeatures, ts: float) -> TrackerOutput:
        cfg = self.cfg
        n_valid = int(feats.valid.sum())
        if self.init_feats is None:
            if n_valid > cfg.tracking.init_min_keypoints:
                self.init_feats = feats
                self.init_ts = ts
                self.state = NOT_INITIALIZED
            return TrackerOutput(self.state, None, 0, False)

        if n_valid <= cfg.tracking.init_min_keypoints:
            self.init_feats = None
            return TrackerOutput(self.state, None, 0, False)

        idx, dist = matcher.search_for_initialization(
            self.init_feats, feats, window=cfg.tracking.init_window,
            nn_ratio=cfg.matcher.nn_ratio_motion,
        )
        n_matches = int((idx >= 0).sum())
        if n_matches < cfg.tracking.init_min_matches:
            self.init_feats = feats  # restart with the newer frame
            self.init_ts = ts
            return TrackerOutput(self.state, None, n_matches, False)

        # two-view reconstruction on the matched subset (padded)
        ok = idx >= 0
        uv1 = self.init_feats.xy_und
        uv2 = feats.xy_und[jnp.maximum(idx, 0)]
        # per-match noise scale: the coarser octave of the pair
        oct_pair = jnp.maximum(
            self.init_feats.octave, feats.octave[jnp.maximum(idx, 0)]
        )
        sig2 = self.sigma2[jnp.clip(oct_pair, 0, self.cfg.orb.n_levels - 1)]
        res = initialize_two_view(
            uv1, uv2, ok, self.K, jax.random.PRNGKey(cfg.seed + self.frame_id),
            sigma2=sig2,
        )
        if not bool(res.success):
            return TrackerOutput(self.state, None, n_matches, False)

        self._create_initial_map(feats, idx, res, ts)
        self._register_kf_bow(0)
        self._register_kf_bow(1)
        self.state = OK
        return TrackerOutput(
            OK, np.asarray(self.last_Tcw), int(res.n_good), True
        )

    def _create_initial_map(self, feats, idx, res, ts):
        """CreateInitialMapMonocular (src/Tracking.cc:852-957) — one jit
        dispatch (_build_initial_map)."""
        good = res.is_point & (idx >= 0)
        m, f2 = _build_initial_map(
            self.m, self.init_feats, feats, idx, good, res.points,
            res.Tcw2, jnp.asarray(self.frame_id - 1),
            jnp.asarray(self.init_ts, jnp.float32),
            jnp.asarray(self.frame_id), jnp.asarray(ts, jnp.float32),
            self.K, self.inv_sigma2, self.scale_factors,
            n_out=self.cfg.orb.n_features,
        )
        self.m = m
        kf1 = 1  # initialization always starts from an empty map: kf0=0
        self.n_kf_host = 2
        self.last_feats = f2
        self.last_obs = self.m.kf_obs[kf1]
        self.last_Tcw = self.m.kf_pose[kf1]
        self.velocity = None
        self.ref_kf = kf1
        self.last_kf_frame = self.frame_id

    # ------------------------------------------------------------------
    def _track(
        self, feats: FrameFeatures, ts: float, frame_id: int | None = None
    ) -> TrackerOutput:
        cfg = self.cfg
        fid = self.frame_id if frame_id is None else frame_id
        has_vel = self.velocity is not None
        vel = self.velocity if has_vel else self._eye4
        # post-relocalization widening (Tracking.cc:1452: th=5 if just
        # relocalized) and the stricter 50-inlier acceptance within
        # mMaxFrames of the reloc (Tracking.cc:1200-1206)
        just_reloc = fid < self.last_reloc_frame + 2
        recent_reloc = (
            fid < self.last_reloc_frame + cfg.tracking.max_frames_between_kf
        )
        p = self.params.replace(
            local_th=jnp.asarray(5.0 if just_reloc else 1.0, jnp.float32)
        )

        m2, Tcw, cur_obs, vel_new, T_cr, scalars, inc_bits = _track_step(
            self.m, feats, self.last_obs, self.last_feats.octave,
            self.last_feats.angle, jnp.asarray(has_vel), vel, self.last_Tcw,
            jnp.asarray(self.ref_kf, jnp.int32), self.K, self.scale_factors,
            self.inv_sigma2, p,
            n_levels=cfg.orb.n_levels,
            max_local_points=cfg.capacity.local_ba_points,
            local_kf_cap=cfg.tracking.local_map_kf_cap,
            pose_rounds=cfg.optim.pose_opt_rounds,
            pose_iters=cfg.optim.pose_opt_iters,
            histo_bins=cfg.matcher.histo_length,
            ur=self._cur_ur,
            bf=jnp.asarray(cfg.camera.baseline_times_fx, jnp.float32),
            depth=self._cur_depth,
            depth_threshold=jnp.asarray(
                cfg.camera.depth_threshold, jnp.float32
            ),
        )

        if (
            cfg.tracking.frames_per_sync > 1
            and self.n_kf_host >= cfg.tracking.pipeline_warmup_kfs
        ):
            # pipelined mode: chain the per-frame device state WITHOUT a
            # sync; LOST/keyframe decisions are resolved in one batched
            # fetch every frames_per_sync frames (_resolve_pending).
            # (The mono path normally batches the launches too via
            # _run_scan_batch; this per-frame variant serves depth/stereo.)
            if not self._pending_frames:
                self._batch_counters = (self.m.mp_visible, self.m.mp_found)
            self.m = m2
            self.velocity = vel_new
            self.last_Tcw = Tcw
            self.last_feats = feats
            self.last_obs = cur_obs
            self._pending_frames.append(dict(
                scalars=scalars, feats=feats, Tcw=Tcw, cur_obs=cur_obs,
                T_cr=T_cr, ts=ts, frame_id=fid,
                ref_kf=self.ref_kf, recent_reloc=recent_reloc,
                depth=self._cur_depth, inc_bits=inc_bits,
            ))
            if len(self._pending_frames) >= cfg.tracking.frames_per_sync:
                self._resolve_pending()
            if self.state != OK:  # the resolution just detected a loss
                return TrackerOutput(self.state, None, -1, False, deferred=True)
            return TrackerOutput(OK, Tcw, -1, False, deferred=True)

        # leftover pipelined frames (e.g. the warmup gate re-engaged after a
        # compaction) resolve first so trajectory entries stay ordered
        if self._pending_frames:
            self._resolve_pending()
        s = np.asarray(scalars)  # the ONE device->host sync of the frame
        n_matches = int(s[S_N_MATCHES])
        n_i2 = int(s[S_N_INL2])
        n_kf_valid = int(s[S_N_KF])
        self.m = m2

        if not bool(s[S_OK1]):
            self.state = LOST
            self._maybe_auto_reset(n_kf_valid)
            return TrackerOutput(LOST, None, int(s[S_N_INL1]), False)

        min_local = (
            cfg.tracking.min_inliers_localmap_reloc
            if recent_reloc
            else cfg.tracking.min_inliers_localmap
        )
        if n_i2 < min_local:
            self.state = LOST
            self._maybe_auto_reset(n_kf_valid)
            return TrackerOutput(LOST, None, n_i2, False)

        # motion model update (device-resident; no fetch)
        self.velocity = vel_new
        self.last_Tcw = Tcw
        self.last_feats = feats
        self.last_obs = cur_obs

        created = False
        if self._need_new_keyframe(
            n_i2, int(s[S_N_REF]), n_kf_valid, frame_id=fid,
            n_close_tracked=int(s[S_N_CLOSE_T]),
            n_close_untracked=int(s[S_N_CLOSE_U]),
        ):
            self._create_keyframe(feats, Tcw, cur_obs, ts, frame_id=fid)
            created = True

        return TrackerOutput(OK, Tcw, n_i2, created, T_cr=T_cr)

    def flush_pending(self):
        """Resolve any pipelined frames (blocking fetch). Called before any
        host-side consumer of tracker state (trajectory export, reset,
        compaction, map views)."""
        self._drain_img_buffer()
        self._resolve_pending()

    def _build_scan_fn(self, mode: str = "mono"):
        """Jit the fused N-frame tracking program: lax.scan of
        (extract -> undistort [-> stereo match / depth lookup] ->
        _track_step) over a stacked frame batch, carrying only the state a
        frame actually mutates (the two counter planes + per-frame chain
        state). One program launch and one scalar fetch replace 2-3 launches
        and a host sync PER FRAME — the reference gets
        the same effect from its camera thread running free of the mapping
        thread. mode selects the per-frame depth source: "mono" none,
        "rgbd" depth-map lookup, "stereo" fused right-image extraction +
        row-band matching (Frame::ComputeStereoMatches)."""
        from ..ops.stereo import depth_from_depthmap, match_stereo

        cfg = self.cfg
        camera = self.camera
        extract_impl = self.extractor._extract_impl
        statics = dict(
            n_levels=cfg.orb.n_levels,
            max_local_points=cfg.capacity.local_ba_points,
            local_kf_cap=cfg.tracking.local_map_kf_cap,
            pose_rounds=cfg.optim.pose_opt_rounds,
            pose_iters=cfg.optim.pose_opt_iters,
            histo_bins=cfg.matcher.histo_length,
        )
        bf_c = np.float32(cfg.camera.baseline_times_fx)
        minz_c = np.float32(bf_c / cfg.camera.fx if bf_c > 0 else 0.0)
        thr_c = np.float32(cfg.camera.depth_threshold)

        def scan_fn(
            m, xs, last_obs, last_octave, last_angle, has_vel, vel,
            last_Tcw, ref_kf, K, scale_factors, inv_sigma2, p,
        ):
            def body(carry, x):
                (mp_visible, mp_found, lobs, loct, lang, hv, v, lT) = carry
                feats = extract_impl(x["img"])
                feats = feats.replace(
                    xy_und=camera.undistort_points(feats.xy)
                )
                if mode == "rgbd":
                    fd = depth_from_depthmap(feats, x["dmap"])
                elif mode == "stereo":
                    fr = extract_impl(x["img_r"])
                    fd, _ = match_stereo(
                        feats, fr,
                        x["img"].astype(jnp.float32),
                        x["img_r"].astype(jnp.float32),
                        jnp.asarray(bf_c), jnp.asarray(minz_c),
                        scale_factors, n_levels=cfg.orb.n_levels,
                    )
                else:
                    fd = None
                if fd is not None:
                    ur = jnp.where(
                        (fd > 0) & (bf_c > 0),
                        feats.xy_und[:, 0] - bf_c / jnp.maximum(fd, 1e-6),
                        -1.0,
                    )
                else:
                    ur = None
                m_c = m.replace(mp_visible=mp_visible, mp_found=mp_found)
                m2, Tcw, cur_obs, vel_new, T_cr, scalars, inc = (
                    _track_step_impl(
                        m_c, feats, lobs, loct, lang, hv, v, lT, ref_kf,
                        K, scale_factors, inv_sigma2, p, **statics,
                        ur=ur, bf=jnp.asarray(bf_c), depth=fd,
                        depth_threshold=jnp.asarray(thr_c),
                    )
                )
                carry2 = (
                    m2.mp_visible, m2.mp_found, cur_obs, feats.octave,
                    feats.angle, jnp.asarray(True), vel_new, Tcw,
                )
                outs = (feats, Tcw, cur_obs, T_cr, scalars, inc)
                if fd is not None:
                    outs = outs + (fd,)
                return carry2, outs

            carry0 = (
                m.mp_visible, m.mp_found, last_obs, last_octave,
                last_angle, has_vel, vel, last_Tcw,
            )
            return jax.lax.scan(body, carry0, xs)

        return jax.jit(scan_fn)

    def _run_scan_batch(self):
        """Launch the fused scan over the buffered frames and queue the
        per-frame records for resolution (one batched scalar fetch)."""
        recs = self._img_buffer
        self._img_buffer = []
        if not recs:
            return
        cfg = self.cfg
        mode = self._scan_mode
        if len(recs) != cfg.tracking.frames_per_sync:
            # partial batch (flush mid-batch): per-frame path, same records
            for r in recs:
                if self.state != OK:
                    if self.trajectory:
                        last = self.trajectory[-1]
                        self.trajectory.append((r["ts"], last[1], last[2]))
                    continue
                if mode == "rgbd":
                    feats, fd = self._rgbd_frame_fn(r["img"], r["dmap"])
                elif mode == "stereo":
                    feats, fd = self._stereo_frame_fn(r["img"], r["img_r"])
                else:
                    feats, fd = self._extract_track(r["img"]), None
                self._cur_depth = fd
                if fd is not None:
                    bf_v = cfg.camera.baseline_times_fx
                    self._cur_ur = jnp.where(
                        (fd > 0) & (bf_v > 0),
                        feats.xy_und[:, 0] - bf_v / jnp.maximum(fd, 1e-6),
                        -1.0,
                    )
                else:
                    self._cur_ur = None
                self._track(feats, r["ts"], frame_id=r["frame_id"])
            self._resolve_pending()
            return
        if mode not in self._scan_fns:
            self._scan_fns[mode] = self._build_scan_fn(mode)
        xs = {"img": jnp.stack([r["img"] for r in recs])}
        if mode == "rgbd":
            xs["dmap"] = jnp.stack([r["dmap"] for r in recs])
        elif mode == "stereo":
            xs["img_r"] = jnp.stack([r["img_r"] for r in recs])
        has_vel = self.velocity is not None
        vel = self.velocity if has_vel else self._eye4
        p = self.params.replace(local_th=jnp.asarray(1.0, jnp.float32))
        snapshot = (self.m.mp_visible, self.m.mp_found)
        # the chained octave/angle come from the previous batch's carry when
        # available — reading them off last_feats would materialize slices
        loct = self._carry_oct if self._carry_oct is not None else self.last_feats.octave
        lang = self._carry_ang if self._carry_ang is not None else self.last_feats.angle
        carry, outs = self._scan_fns[mode](
            self.m, xs, self.last_obs, loct, lang,
            jnp.asarray(has_vel), vel, self.last_Tcw,
            jnp.asarray(self.ref_kf, jnp.int32), self.K, self.scale_factors,
            self.inv_sigma2, p,
        )
        mp_visible, mp_found, last_obs, loct_n, lang_n, _, vel_new, last_Tcw = carry
        depth_s = None
        if mode == "mono":
            feats_s, Tcw_s, obs_s, T_cr_s, scalars_s, inc_s = outs
        else:
            feats_s, Tcw_s, obs_s, T_cr_s, scalars_s, inc_s, depth_s = outs
        self.m = self.m.replace(mp_visible=mp_visible, mp_found=mp_found)
        self.velocity = vel_new
        self.last_Tcw = last_Tcw
        self.last_obs = last_obs
        # lazy: stacked outputs are NOT sliced here (each slice is a device
        # program — the storm of ~30 of them per batch used to cost more
        # than the whole scan computation); consumers go through _mat()
        self._last_feats_val = None
        self._last_feats_batched = feats_s
        self._carry_oct = loct_n
        self._carry_ang = lang_n
        if self._batch_counters is None:
            # snapshot at the head of the UNRESOLVED window (advanced as
            # prefixes resolve — see _resolve_pending)
            self._batch_counters = snapshot
        for i, rec in enumerate(recs):
            self._pending_frames.append(dict(
                scalars=("sliced", scalars_s, i),
                feats=("sliced", feats_s, i),
                Tcw=("sliced", Tcw_s, i),
                cur_obs=("sliced", obs_s, i),
                T_cr=("sliced", T_cr_s, i),
                ts=rec["ts"], frame_id=rec["frame_id"], ref_kf=self.ref_kf,
                recent_reloc=rec["recent_reloc"],
                depth=None if depth_s is None else ("sliced", depth_s, i),
                inc_bits=("sliced", inc_s, i),
            ))
        # DELAYED RESOLUTION: the just-launched batch stays deferred; only
        # older batches resolve now. The host's blocking scalar fetch then
        # waits on a batch the device finished while this one was being
        # assembled — and the device proceeds straight into the new scan
        # instead of idling through the ~22 ms host round trip + decision
        # code (the fetch used to cost ~87 ms/batch of pure serialization,
        # tools/profile_live.py).
        self._resolve_pending(keep_last=len(recs))

    def _drain_img_buffer(self):
        """Track any buffered-but-unscanned frames (full batch via the scan,
        partial via the per-frame path) and resolve them."""
        if not self._img_buffer:
            return
        self._run_scan_batch()

    def _resolve_pending(self, keep_last: int = 0):
        """Resolve the deferred state machine for pipelined frames with ONE
        device->host fetch (frames_per_sync > 1 mode). Walks the records in
        order: appends trajectory entries, replays the LOST test and the
        NeedNewKeyFrame decision per frame (a keyframe is created from the
        stored device arrays of the frame that earned it — up to N-1 frames
        late, the same lateness the reference's mapping thread already
        imposes on keyframe processing).

        keep_last > 0 defers the newest `keep_last` records (the scan batch
        launched this turn): their scalars resolve on the NEXT batch
        boundary, overlapping the host's blocking fetch with the device's
        next scan. A loss detected in the resolved prefix marks the deferred
        suffix lost as well (it chained on garbage)."""
        if not self._pending_frames:
            return
        recs = self._pending_frames
        n_res = len(recs) - keep_last if keep_last else len(recs)
        if n_res <= 0:
            return
        self._pending_frames = []
        batch_counters = self._batch_counters
        self._batch_counters = None
        # one fetch per distinct stacked parent (= per scan batch) — a scan
        # batch's scalars arrive already stacked; per-frame records (depth/
        # stereo pipelined mode) are stacked here into one extra fetch
        svecs: list = [None] * n_res
        plain_j, plain_v = [], []
        parents: dict = {}
        for j, r in enumerate(recs[:n_res]):
            s = r["scalars"]
            if isinstance(s, tuple) and s[0] == "sliced":
                parents.setdefault(id(s[1]), (s[1], []))[1].append((j, s[2]))
            else:
                plain_j.append(j)
                plain_v.append(s)
        if plain_v:
            arr = np.asarray(jnp.stack(plain_v))
            for j, v in zip(plain_j, arr):
                svecs[j] = v
        for arr, items in parents.values():
            a = np.asarray(arr)
            for j, i in items:
                svecs[j] = a[i]
        cfg = self.cfg
        last_created_fid = None
        for i, (rec, s) in enumerate(zip(recs[:n_res], svecs)):
            n_i2 = int(s[S_N_INL2])
            n_kf_valid = int(s[S_N_KF])
            min_local = (
                cfg.tracking.min_inliers_localmap_reloc
                if rec["recent_reloc"]
                else cfg.tracking.min_inliers_localmap
            )
            if not bool(s[S_OK1]) or n_i2 < min_local:
                # this frame was actually lost: frames after it in the batch
                # chained on garbage — log them as lost (the reference
                # repeats the last relative pose for lost frames,
                # src/System.cc:420-433) and enter relocalization
                self.state = LOST
                # roll the visible/found counters back to the loss frame:
                # the garbage frames' increments never happened as far as
                # the found-ratio culling statistic is concerned (the
                # reference never updates stats from lost frames)
                if batch_counters is not None:
                    snap_v, snap_f = batch_counters
                    incs = [_mat(r["inc_bits"]) for r in recs]
                    inc_v = jnp.stack([b[0] for b in incs])
                    inc_f = jnp.stack([b[1] for b in incs])
                    new_v, new_f = _counters_at(
                        snap_v, snap_f, inc_v, inc_f, jnp.asarray(i + 1)
                    )
                    self.m = self.m.replace(
                        mp_visible=new_v, mp_found=new_f
                    )
                for rec2 in recs[i:]:
                    if self.trajectory:
                        last = self.trajectory[-1]
                        self.trajectory.append((rec2["ts"], last[1], last[2]))
                self._maybe_auto_reset(n_kf_valid)
                return
            created = False
            # multiple keyframes per batch are allowed as long as the later
            # frame independently clears the min-frames gate relative to the
            # keyframe just created (otherwise fast motion pays up to N-1
            # frames of extra keyframe latency per batch)
            gate_ok = (
                last_created_fid is None
                or rec["frame_id"] >= last_created_fid
                + max(cfg.tracking.min_frames_between_kf, 1)
            )
            if gate_ok and self._need_new_keyframe(
                n_i2, int(s[S_N_REF]), n_kf_valid, frame_id=rec["frame_id"],
                n_close_tracked=int(s[S_N_CLOSE_T]),
                n_close_untracked=int(s[S_N_CLOSE_U]),
            ):
                self._create_keyframe(
                    _mat(rec["feats"]), _mat(rec["Tcw"]),
                    _mat(rec["cur_obs"]), rec["ts"],
                    frame_id=rec["frame_id"], depth=_mat(rec["depth"]),
                )
                created = True
                last_created_fid = rec["frame_id"]
            if created:
                self.trajectory.append((rec["ts"], self._eye4, self.ref_kf))
            elif rec["ref_kf"] in self.culled_remap:
                T_cp, nr = self.culled_remap[rec["ref_kf"]]
                self.trajectory.append((rec["ts"], _mat(rec["T_cr"]) @ T_cp, nr))
            else:
                self.trajectory.append((rec["ts"], rec["T_cr"], rec["ref_kf"]))

        # prefix resolved OK: the deferred suffix (the just-launched scan
        # batch) stays pending; advance the rollback snapshot past the
        # resolved batches' counter increments (grouped per stacked parent —
        # one tiny program per batch, no per-frame slicing)
        if keep_last:
            self._pending_frames = recs[n_res:]
        if self._pending_frames and batch_counters is not None:
            snap_v, snap_f = batch_counters
            seen: set[int] = set()
            for r in recs[:n_res]:
                ib = r["inc_bits"]
                if isinstance(ib, tuple) and ib[0] == "sliced":
                    if id(ib[1]) in seen:
                        continue
                    seen.add(id(ib[1]))
                    pv, pf = ib[1]
                    snap_v, snap_f = _counters_at(
                        snap_v, snap_f, pv, pf, jnp.asarray(pv.shape[0])
                    )
                else:
                    snap_v, snap_f = _counters_at(
                        snap_v, snap_f, ib[0][None], ib[1][None],
                        jnp.asarray(1),
                    )
            self._batch_counters = (snap_v, snap_f)

    def _traj_stack(self) -> jnp.ndarray:
        """(F, 4, 4) stacked trajectory relatives. Lazy entries from scan
        batches are resolved with ONE gather per source batch instead of a
        slice program per entry."""
        F = len(self.trajectory)
        out = jnp.zeros((F, 4, 4))
        eager_j, eager_m = [], []
        groups: dict = {}
        for j, (_, p, _) in enumerate(self.trajectory):
            if isinstance(p, tuple) and p[0] == "sliced":
                g = groups.setdefault(id(p[1]), (p[1], [], []))
                g[1].append(j)
                g[2].append(p[2])
            else:
                eager_j.append(j)
                eager_m.append(jnp.asarray(p))
        if eager_m:
            out = out.at[jnp.asarray(eager_j)].set(jnp.stack(eager_m))
        for arr, js, srcs in groups.values():
            out = out.at[jnp.asarray(js)].set(arr[jnp.asarray(srcs)])
        return out

    def _maybe_auto_reset(self, n_kf_valid: int):
        """Reset the whole session when tracking is lost soon after
        initialization (Tracking.cc:646-656: LOST with <= 5 keyframes)."""
        if n_kf_valid <= self.cfg.tracking.auto_reset_max_kfs:
            self.reset()

    def reset(self):
        """Tracking::Reset (src/Tracking.cc:1835-1870): clear the map,
        database, and per-frame state; keep the trajectory log."""
        # pipelined frames are gone with the map; drop them (resolving them
        # against the cleared map would be meaningless)
        self._pending_frames.clear()
        self._img_buffer.clear()
        self._batch_counters = None
        self.culled_remap.clear()
        # the trajectory prefix references the OLD map's keyframe poses; bake
        # every entry to an absolute pose (ref=-1) before the poses vanish,
        # exactly like compaction does for culled anchors
        if self.trajectory:
            T_cr = self._traj_stack()
            refs = jnp.asarray(
                [r for _, _, r in self.trajectory], jnp.int32
            )
            anchor = jnp.where(
                (refs >= 0)[:, None, None],
                self.m.kf_pose[jnp.maximum(refs, 0)],
                jnp.eye(4)[None],
            )
            baked = T_cr @ anchor
            self.trajectory = [
                (ts, baked[i], -1)
                for i, (ts, _, _) in enumerate(self.trajectory)
            ]
        # notify the pipeline (System) so an in-flight async mapping pass is
        # discarded instead of being adopted into the fresh session
        if self.reset_hook is not None:
            self.reset_hook()
        self.m = mt.empty_map(self.cfg.capacity, self.cfg.orb.n_features)
        self.n_kf_host = 0
        self.state = NO_IMAGES_YET
        self.last_feats = None
        self.last_obs = None
        self.last_Tcw = None
        self.velocity = None
        self.ref_kf = 0
        self.last_kf_frame = 0
        self.last_reloc_frame = -(10**9)
        self.init_feats = None
        self._cur_depth = None
        self.bow = self._make_bow()

    def load_map(self, m: SlamMap) -> None:
        """Adopt an externally loaded map (slam_map/checkpoint.py) and
        restore every host mirror a live session needs: the allocated-slot
        counter, the reference keyframe, and the BoW recognition database
        (rebuilt by re-indexing every valid keyframe; the vocabulary is
        retrained on the loaded corpus). The session enters LOST so the next
        frame relocalizes against the loaded map — the reference's
        acknowledged SaveMap/LoadMap TODO (include/System.h:119-121) plus
        ActivateLocalizationMode (src/System.cc:364) is exactly this flow.
        """
        self._pending_frames.clear()
        self._img_buffer.clear()
        self._batch_counters = None
        self.culled_remap.clear()
        if self.reset_hook is not None:
            self.reset_hook()
        self.m = m
        valid_np = np.asarray(m.kf_valid)
        self.n_kf_host = int(np.asarray(m.n_kf))
        valid_slots = np.flatnonzero(valid_np)
        self.ref_kf = int(valid_slots[-1]) if valid_slots.size else 0
        self.state = LOST if valid_slots.size else NO_IMAGES_YET
        self.last_feats = None
        self.last_obs = None
        self.last_Tcw = self._eye4
        self.velocity = None
        self.init_feats = None
        self.last_kf_frame = self.frame_id
        self.last_reloc_frame = -(10**9)
        # rebuild the recognition database from the loaded keyframes
        self.bow = self._make_bow()
        if self.bow.pretrained:
            self.bow.reindex(m.kf_desc, m.kf_feat_valid, m.kf_valid)
        elif valid_slots.size >= 4:
            self.bow.retrain(
                m.kf_desc, m.kf_feat_valid, m.kf_valid,
                jax.random.PRNGKey(self.cfg.seed + 7),
            )
        else:
            for k in valid_slots:
                self.bow.add(int(k), m.kf_desc[int(k)], m.kf_feat_valid[int(k)])

    def _need_new_keyframe(
        self, n_inliers: int, n_ref: int, n_kf_valid: int,
        frame_id: int | None = None,
        n_close_tracked: int = 0, n_close_untracked: int = 0,
    ) -> bool:
        """NeedNewKeyFrame (src/Tracking.cc:1210-1310), evaluated from the
        fused step's device-computed statistics.
        Localization-only mode never inserts (Tracking.cc:1213).
        frame_id: the frame being decided (defaults to the current frame;
        pipelined resolution passes the recorded one).
        n_close_tracked/untracked: stereo/RGB-D close-point counts feeding
        c1c (Tracking.cc:1264-1283) — a frame seeing few tracked close
        points but many untracked ones must insert even when the inlier
        ratio looks healthy (the reference's stereo map-density gate)."""
        cfg = self.cfg
        fid = self.frame_id if frame_id is None else frame_id
        if not self.allow_keyframes:
            return False
        if self.n_kf_host >= self.m.max_kf - 1:
            return False
        # reloc gate: no keyframes right after relocalization while the map
        # is already mature (Tracking.cc:1222)
        if (
            fid < self.last_reloc_frame + cfg.tracking.max_frames_between_kf
            and n_kf_valid > cfg.tracking.max_frames_between_kf
        ):
            return False
        mono = cfg.sensor == "monocular"
        # ratioMap (this fork's Tracking.cc:1238-1276): close map-matches /
        # all close-depth features — "how many MapPoints we could create if
        # we insert a keyframe"; 1.0 on the mono path
        n_close_total = n_close_tracked + n_close_untracked
        ratio_map = (
            n_close_tracked / max(1, n_close_total) if not mono else 1.0
        )
        # thRefRatio: 0.9 mono; 0.75 stereo/RGB-D, relaxed to 0.4 while the
        # map has <2 keyframes (Tracking.cc:1265-1271)
        if mono:
            th_ref = cfg.tracking.keyframe_min_ratio
        else:
            th_ref = 0.4 if n_kf_valid < 2 else 0.75
        # thMapRatio: 0.35, or 0.20 when tracking is rich (Tracking.cc:1273)
        th_map = 0.20 if n_inliers > 300 else 0.35
        c2 = (
            (n_inliers < n_ref * th_ref) or (ratio_map < th_map)
        ) and n_inliers > 15
        # bootstrap escape: right after depth initialization the single
        # keyframe's points all have ONE observation, so n_ref
        # (TrackedMapPoints(minObs>=2)) is 0 and `inliers < 0`
        # can never hold — accept on raw inliers until the reference
        # keyframe has multi-observed points (deviation from the reference,
        # which leaves this state via its always-running mapper)
        if n_ref == 0:
            c2 = n_inliers > 15
        if not c2:
            return False
        c1a = fid >= self.last_kf_frame + cfg.tracking.max_frames_between_kf
        idle = self.mapper_idle_hook() if self.mapper_idle_hook else True
        # c1b requires the local mapper to be idle (Tracking.cc:1267); c1a
        # and c1c force insertion, draining the pipeline first (the
        # InterruptBA + queue-drain analogue, Tracking.cc:1287-1303)
        c1b = (
            fid >= self.last_kf_frame + cfg.tracking.min_frames_between_kf
        ) and idle
        # c1c "tracking is weak" (Tracking.cc:1280-1281)
        c1c = (not mono) and (
            n_inliers < n_ref * 0.25 or ratio_map < 0.3
        )
        if (c1a or c1c) and not idle:
            # InterruptBA (src/LocalMapping.cc:127): abort queued BA chunks
            # and adopt best-so-far instead of blocking on the full schedule
            self.mapper_idle_hook(force=True, abort=True)
            idle = True
        return bool(c1a or c1b or c1c)

    def _create_keyframe(
        self, feats, Tcw, cur_obs, ts, frame_id: int | None = None,
        depth=None,
    ):
        """CreateNewKeyFrame (src/Tracking.cc:1312-1407) + asynchronous
        local-mapping pass (the reference queues to the mapping thread)."""
        if self.n_kf_host >= self.m.max_kf:
            return
        fid = self.frame_id if frame_id is None else frame_id
        if depth is None:
            depth = self._cur_depth
        args = (
            self.m, Tcw, feats, cur_obs, jnp.asarray(fid),
            jnp.asarray(ts, jnp.float32), jnp.asarray(self.ref_kf),
        )
        if depth is not None:
            # stereo/RGB-D: create close points directly from depth for
            # features without a map point (src/Tracking.cc:1340-1395)
            m, kf_id = _freeze_kf_depth(
                *args, depth, self.camera,
                jnp.asarray(self.cfg.camera.depth_threshold, jnp.float32),
                self.scale_factors,
                jnp.asarray(self.cfg.camera.baseline_times_fx, jnp.float32),
            )
        else:
            m, kf_id = _freeze_kf(*args)
        kf = self.n_kf_host  # slot allocation is deterministic
        self.n_kf_host += 1
        self.m = m
        self.ref_kf = kf
        self.last_kf_frame = fid
        self._register_kf_bow(kf)
        if self.mapping_hook is not None:
            # asynchronous: enqueues the mapping pass; the result is adopted
            # by mapper_idle_hook once the device finishes (tracking/system.py)
            self.mapping_hook(kf)

    # ------------------------------------------------------------------
    def _register_kf_bow(self, kf: int) -> None:
        """Add the new keyframe to the recognition database; train the
        vocabulary once enough descriptor corpus has accumulated (no
        ORBvoc.txt exists — see bow/vocabulary.py)."""
        m = self.m
        self.bow.add(kf, m.kf_desc[kf], m.kf_feat_valid[kf])
        if not self.bow.ready and self.n_kf_host >= 4:
            n_train = self.n_kf_host
            desc = m.kf_desc[:n_train].reshape(-1, 8)
            valid = m.kf_feat_valid[:n_train].reshape(-1)
            self.bow.maybe_train(
                desc, valid, jax.random.PRNGKey(self.cfg.seed + 7)
            )
        elif self.n_kf_host in (16, 64) and not self.bow.pretrained:
            # vocabulary lifecycle: retrain on the accumulated corpus and
            # re-index all keyframes (the initial tiny-corpus vocabulary has
            # mostly-empty words and a frozen idf); a pre-trained ORBvoc-style
            # vocabulary is fixed for the session (src/System.cc:124-129)
            self.bow.retrain(
                m.kf_desc, m.kf_feat_valid, m.kf_valid,
                jax.random.PRNGKey(self.cfg.seed + 7 + self.n_kf_host),
            )

    def _reloc_candidates(self, feats: FrameFeatures) -> list[int]:
        """BoW candidate keyframes for relocalization
        (KeyFrameDatabase::DetectRelocalizationCandidates,
        src/KeyFrameDatabase.cc:208-328). Before the vocabulary is trained,
        candidates fall back to raw-descriptor scoring against every valid
        keyframe (instead of only the reference KF)."""
        if not self.bow.ready:
            return self._reloc_candidates_untrained(feats)
        from ..slam_map.covisibility import covisibility_matrix

        # lazily propagate device-side keyframe culls into the database
        # (KeyFrameDatabase::erase, src/KeyFrameDatabase.cc:60-75 — the culls
        # happen inside the jitted mapping pass, so the rows are zeroed here,
        # at the first query that could otherwise return a dead keyframe)
        self.bow.mask_valid(self.m.kf_valid)
        v = self.bow.query_vector(feats.desc, feats.valid)
        W = covisibility_matrix(self.m)
        acc, keep = self.bow.candidates(
            v, ~self.m.kf_valid, W.astype(jnp.float32)
        )
        acc = np.asarray(jnp.where(keep, acc, -1.0))
        order = np.argsort(-acc)
        cands = [int(k) for k in order[:3] if acc[k] > 0]
        return cands or self._reloc_candidates_untrained(feats)

    def _reloc_candidates_untrained(self, feats: FrameFeatures) -> list[int]:
        """Pre-vocabulary fallback: rank ALL valid keyframes by brute-force
        descriptor match count against the frame. Candidates are enumerated
        from the map's kf_valid (device truth) — NOT the n_kf_host mirror,
        which is 0 for an externally loaded map."""
        m = self.m
        valid_slots = np.flatnonzero(np.asarray(m.kf_valid))
        if valid_slots.size == 0:
            return [self.ref_kf]
        count_futs = []
        for k in valid_slots:
            k = int(k)
            has = (m.kf_obs[k] >= 0) & m.kf_feat_valid[k]
            idx, _ = matcher.match_by_descriptor(
                m.kf_desc[k], feats.desc, has, feats.valid,
                nn_ratio=self.cfg.matcher.nn_ratio_bow,
            )
            count_futs.append((idx >= 0).sum())
        # one stacked fetch for all candidates
        counts = np.asarray(jnp.stack(count_futs))
        order = np.argsort(-counts)
        return [int(valid_slots[i]) for i in order[:3]]

    def _relocalize(self, feats: FrameFeatures, ts: float) -> TrackerOutput:
        """Relocalization (Tracking::Relocalization,
        src/Tracking.cc:1628-1833): BoW candidates -> per-candidate staged
        cascade (PnP -> PoseOptimization -> wide th=10/ORBdist=100 retry ->
        narrow th=3/ORBdist=64 retry) as ONE vmapped device program with ONE
        scalar fetch per lost frame; accept at >= reloc_min_inliers, then
        widen with the local map for the session restart."""
        cfg = self.cfg
        m = self.m
        cands = self._reloc_candidates(feats)
        if not cands:
            return TrackerOutput(LOST, None, 0, False)
        C = 3
        cand_list = (cands + [0] * C)[:C]
        ok_list = [True] * min(len(cands), C) + [False] * max(C - len(cands), 0)
        keys = jnp.stack([
            jax.random.PRNGKey(cfg.seed + 31 * self.frame_id + k)
            for k in cand_list
        ])
        bf = jnp.asarray(cfg.camera.baseline_times_fx, jnp.float32)
        n_good, Tcw_all, obs_all = _reloc_program(
            m, feats, jnp.asarray(cand_list, jnp.int32),
            jnp.asarray(ok_list), keys, self.K, self.inv_sigma2,
            self.scale_factors,
            jnp.asarray(cfg.matcher.nn_ratio_bow, jnp.float32),
            jnp.asarray(cfg.matcher.th_low, jnp.int32),
            self._cur_ur, bf,
            n_levels=cfg.orb.n_levels,
            histo_bins=cfg.matcher.histo_length,
            accept_n=cfg.tracking.reloc_min_inliers,
        )
        ng = np.asarray(n_good)  # the ONE fetch of the lost frame
        b = int(np.argmax(ng))
        if int(ng[b]) < cfg.tracking.reloc_min_inliers:
            return TrackerOutput(LOST, None, int(ng[b]), False)
        n_inl = int(ng[b])
        Tcw, cur_obs = Tcw_all[b], obs_all[b]
        self.state = OK
        self.last_Tcw = Tcw
        self.last_feats = feats
        self.last_obs = cur_obs
        self.velocity = None
        self.last_reloc_frame = self.frame_id
        return TrackerOutput(OK, np.asarray(Tcw), n_inl, False)

    # ------------------------------------------------------------------
    def trajectory_Twc(self) -> tuple[np.ndarray, np.ndarray]:
        """(timestamps (F,), Twc (F,4,4)) for export/eval.

        Each frame's pose is recomposed from its logged keyframe-relative
        transform and the reference keyframe's CURRENT pose, so loop-closure
        and BA corrections propagate into the export exactly like
        System::SaveTrajectoryTUM (src/System.cc:401-454). Per-frame
        relatives stay on device during tracking; this is one stacked
        device->host transfer."""
        self.flush_pending()
        if not self.trajectory:
            return np.zeros(0), np.zeros((0, 4, 4))
        ts = np.asarray([t for t, _, _ in self.trajectory])
        T_cr = self._traj_stack()
        refs = jnp.asarray([r for _, _, r in self.trajectory], jnp.int32)
        # ref == -1: the entry was baked to an absolute pose (its anchor
        # keyframe was dropped by map compaction)
        anchor = jnp.where(
            (refs >= 0)[:, None, None],
            self.m.kf_pose[jnp.maximum(refs, 0)],
            jnp.eye(4)[None],
        )
        Tcw = np.asarray(T_cr @ anchor)
        Twc = np.linalg.inv(Tcw)
        return ts, Twc
