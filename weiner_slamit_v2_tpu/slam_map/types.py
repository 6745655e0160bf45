"""The map as structure-of-arrays: keyframes, map points, observations.

JAX replacement for the reference's pointer-graph data model —
``KeyFrame`` (jni/ORB_SLAM2/src/KeyFrame.cc), ``MapPoint``
(src/MapPoint.cc), ``Map`` (src/Map.cc) — which is a web of heap objects,
std::maps and per-object mutexes. Here the whole map is one immutable pytree
of fixed-capacity arrays (SURVEY.md §7 hard part (b): pre-allocated pools);
updates are pure functions returning a new map, which is what makes the
pipeline stages race-free without any locks (the reference needs
``Map::mMutexMapUpdate`` + per-object mutexes; we need nothing).

Conventions:
* keyframe id == slot index in the kf_* arrays; ids are never reused.
* map-point id == slot index in mp_* arrays.
* ``kf_obs[k, f]`` = map-point id observed by feature f of keyframe k, or -1
  (the array analogue of Frame::mvpMapPoints).
* the per-point observation list ``mp_obs_kf/mp_obs_feat`` is the analogue of
  MapPoint::mObservations (capped at MAX_OBS per point).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import MapCapacityConfig
from ..utils import struct


@struct.dataclass
class SlamMap:
    # --- keyframes -------------------------------------------------------
    kf_pose: jnp.ndarray       # (K, 4, 4) f32 world->camera
    kf_valid: jnp.ndarray      # (K,) bool (False = never allocated or culled)
    kf_frame_id: jnp.ndarray   # (K,) i32 source frame index
    kf_timestamp: jnp.ndarray  # (K,) f32
    kf_parent: jnp.ndarray     # (K,) i32 spanning-tree parent (-1 = root)
    # frozen per-KF features (KeyFrame is a frozen copy of Frame —
    # src/KeyFrame.cc:33-61)
    kf_xy: jnp.ndarray         # (K, N, 2) f32 undistorted keypoint coords
    kf_octave: jnp.ndarray     # (K, N) i32
    kf_angle: jnp.ndarray      # (K, N) f32
    kf_desc: jnp.ndarray       # (K, N, 8) u32
    kf_feat_valid: jnp.ndarray  # (K, N) bool
    kf_obs: jnp.ndarray        # (K, N) i32 map-point id or -1
    # stereo right-image u coordinate per feature (mvuRight,
    # jni/ORB_SLAM2/include/Frame.h); -1 = monocular feature
    kf_ur: jnp.ndarray         # (K, N) f32

    # --- map points ------------------------------------------------------
    mp_pos: jnp.ndarray        # (M, 3) f32 world position
    mp_valid: jnp.ndarray      # (M,) bool
    mp_desc: jnp.ndarray       # (M, 8) u32 distinctive descriptor
    mp_normal: jnp.ndarray     # (M, 3) f32 mean viewing direction
    mp_min_dist: jnp.ndarray   # (M,) f32 scale-invariance band
    mp_max_dist: jnp.ndarray   # (M,) f32
    mp_first_kf: jnp.ndarray   # (M,) i32 creating keyframe
    mp_visible: jnp.ndarray    # (M,) i32 frustum-visible counter
    mp_found: jnp.ndarray      # (M,) i32 tracking-found counter
    # observation lists (MapPoint::mObservations)
    mp_obs_kf: jnp.ndarray     # (M, O) i32 keyframe id or -1
    mp_obs_feat: jnp.ndarray   # (M, O) i32 feature index in that keyframe
    mp_n_obs: jnp.ndarray      # (M,) i32

    # --- counters --------------------------------------------------------
    n_kf: jnp.ndarray          # () i32 number of allocated keyframe slots
    n_mp: jnp.ndarray          # () i32 number of allocated map-point slots

    @property
    def max_kf(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def max_mp(self) -> int:
        return self.mp_pos.shape[0]

    @property
    def n_feat(self) -> int:
        return self.kf_obs.shape[1]

    @property
    def max_obs(self) -> int:
        return self.mp_obs_kf.shape[1]


def empty_map(cap: MapCapacityConfig, n_features: int) -> SlamMap:
    K, M, O = cap.max_keyframes, cap.max_map_points, cap.max_obs_per_point
    N = n_features
    f32 = jnp.float32
    i32 = jnp.int32
    return SlamMap(
        kf_pose=jnp.tile(jnp.eye(4, dtype=f32), (K, 1, 1)),
        kf_valid=jnp.zeros(K, bool),
        kf_frame_id=jnp.full(K, -1, i32),
        kf_timestamp=jnp.zeros(K, f32),
        kf_parent=jnp.full(K, -1, i32),
        kf_xy=jnp.zeros((K, N, 2), f32),
        kf_octave=jnp.zeros((K, N), i32),
        kf_angle=jnp.zeros((K, N), f32),
        kf_desc=jnp.zeros((K, N, 8), jnp.uint32),
        kf_feat_valid=jnp.zeros((K, N), bool),
        kf_obs=jnp.full((K, N), -1, i32),
        kf_ur=jnp.full((K, N), -1.0, f32),
        mp_pos=jnp.zeros((M, 3), f32),
        mp_valid=jnp.zeros(M, bool),
        mp_desc=jnp.zeros((M, 8), jnp.uint32),
        mp_normal=jnp.zeros((M, 3), f32),
        mp_min_dist=jnp.zeros(M, f32),
        mp_max_dist=jnp.full(M, jnp.inf, f32),
        mp_first_kf=jnp.full(M, -1, i32),
        mp_visible=jnp.ones(M, i32),
        mp_found=jnp.ones(M, i32),
        mp_obs_kf=jnp.full((M, O), -1, i32),
        mp_obs_feat=jnp.full((M, O), -1, i32),
        mp_n_obs=jnp.zeros(M, i32),
        n_kf=jnp.asarray(0, i32),
        n_mp=jnp.asarray(0, i32),
    )


# ---------------------------------------------------------------------------
# Keyframe insertion
# ---------------------------------------------------------------------------


def add_keyframe(
    m: SlamMap,
    pose: jnp.ndarray,
    xy_und: jnp.ndarray,
    octave: jnp.ndarray,
    angle: jnp.ndarray,
    desc: jnp.ndarray,
    feat_valid: jnp.ndarray,
    obs: jnp.ndarray,
    frame_id: jnp.ndarray,
    timestamp: jnp.ndarray,
    parent: jnp.ndarray,
    ur: jnp.ndarray | None = None,
) -> tuple[SlamMap, jnp.ndarray]:
    """Freeze a frame into keyframe slot n_kf. obs: (N,) map-point id or -1
    for features already associated with map points (the tracking matches —
    Tracking::CreateNewKeyFrame, src/Tracking.cc:1312).

    Returns (new map, kf_id). If the pool is full the map is unchanged and
    kf_id is -1.
    """
    k = m.n_kf
    ok = k < m.max_kf
    kc = jnp.minimum(k, m.max_kf - 1)
    if ur is None:
        ur = jnp.full(obs.shape, -1.0, jnp.float32)

    obs = jnp.where(feat_valid, obs, -1)
    m2 = m.replace(
        kf_pose=m.kf_pose.at[kc].set(pose),
        kf_valid=m.kf_valid.at[kc].set(True),
        kf_frame_id=m.kf_frame_id.at[kc].set(frame_id),
        kf_timestamp=m.kf_timestamp.at[kc].set(timestamp),
        kf_parent=m.kf_parent.at[kc].set(parent),
        kf_xy=m.kf_xy.at[kc].set(xy_und),
        kf_octave=m.kf_octave.at[kc].set(octave),
        kf_angle=m.kf_angle.at[kc].set(angle),
        kf_desc=m.kf_desc.at[kc].set(desc),
        kf_feat_valid=m.kf_feat_valid.at[kc].set(feat_valid),
        kf_obs=m.kf_obs.at[kc].set(obs),
        kf_ur=m.kf_ur.at[kc].set(ur),
        n_kf=k + 1,
    )
    # register observations on the observed points
    m2 = _add_observations_for_kf(m2, kc, obs)
    m_out = jax.tree.map(lambda a, b: jnp.where(ok, a, b), m2, m)
    return m_out, jnp.where(ok, kc, -1)


def _add_observations_for_kf(m: SlamMap, kf_id, obs: jnp.ndarray) -> SlamMap:
    """Append (kf_id, feat) to each observed map point's observation list."""
    feat_idx = jnp.arange(obs.shape[0], dtype=jnp.int32)
    has = obs >= 0
    mp = jnp.where(has, obs, 0)
    slot = jnp.where(has, m.mp_n_obs[mp], m.max_obs)  # full lists drop extras
    w = has & (slot < m.max_obs)
    # dropped writes go out of bounds with mode="drop"
    mp_w = jnp.where(w, mp, m.max_mp)
    slot_w = jnp.where(w, slot, m.max_obs)
    obs_kf = m.mp_obs_kf.at[mp_w, slot_w].set(kf_id, mode="drop")
    obs_feat = m.mp_obs_feat.at[mp_w, slot_w].set(feat_idx, mode="drop")
    n_obs = m.mp_n_obs.at[mp_w].add(1, mode="drop")
    return m.replace(mp_obs_kf=obs_kf, mp_obs_feat=obs_feat, mp_n_obs=n_obs)


# ---------------------------------------------------------------------------
# Map-point insertion (batched)
# ---------------------------------------------------------------------------


def add_map_points(
    m: SlamMap,
    pos: jnp.ndarray,        # (B, 3) candidate positions
    desc: jnp.ndarray,       # (B, 8) descriptors
    normal: jnp.ndarray,     # (B, 3)
    min_dist: jnp.ndarray,   # (B,)
    max_dist: jnp.ndarray,   # (B,)
    kf1: jnp.ndarray,        # (B,) first observing keyframe (creator)
    feat1: jnp.ndarray,      # (B,) feature index in kf1
    kf2: jnp.ndarray,        # (B,) second observing keyframe (-1 = none)
    feat2: jnp.ndarray,      # (B,)
    valid: jnp.ndarray,      # (B,) which candidates to actually insert
) -> tuple[SlamMap, jnp.ndarray]:
    """Batch-insert triangulated points and register their two observations
    (LocalMapping::CreateNewMapPoints creates each point with observations in
    the current and neighbor keyframes — src/LocalMapping.cc:441-455).

    Returns (new map, ids (B,) with -1 where not inserted).
    """
    B = pos.shape[0]
    offset = jnp.cumsum(valid.astype(jnp.int32)) - 1
    ids = m.n_mp + offset
    fits = valid & (ids < m.max_mp)
    idw = jnp.where(fits, ids, m.max_mp)  # OOB + mode="drop" for skipped rows

    def scatter(arr, vals):
        return arr.at[idw].set(vals, mode="drop")

    m2 = m.replace(
        mp_pos=scatter(m.mp_pos, pos),
        mp_desc=scatter(m.mp_desc, desc),
        mp_normal=scatter(m.mp_normal, normal),
        mp_min_dist=scatter(m.mp_min_dist, min_dist),
        mp_max_dist=scatter(m.mp_max_dist, max_dist),
        mp_first_kf=scatter(m.mp_first_kf, kf1),
        mp_valid=m.mp_valid.at[idw].set(True, mode="drop"),
        mp_visible=scatter(m.mp_visible, jnp.ones(B, jnp.int32)),
        mp_found=scatter(m.mp_found, jnp.ones(B, jnp.int32)),
        mp_n_obs=m.mp_n_obs.at[idw].set(0, mode="drop"),
        n_mp=m.n_mp + fits.sum(dtype=jnp.int32),
    )

    # observations: (kf1, feat1) and (kf2, feat2)
    def put_obs(mm, kfs, feats, slot_idx):
        has = fits & (kfs >= 0)
        idx = jnp.where(has, idw, m.max_mp)
        obs_kf = mm.mp_obs_kf.at[idx, slot_idx].set(kfs, mode="drop")
        obs_feat = mm.mp_obs_feat.at[idx, slot_idx].set(feats, mode="drop")
        n_obs = mm.mp_n_obs.at[idx].add(1, mode="drop")
        kf_w = jnp.where(has, kfs, mm.max_kf)
        kf_obs = mm.kf_obs.at[kf_w, feats].set(idw, mode="drop")
        return mm.replace(
            mp_obs_kf=obs_kf, mp_obs_feat=obs_feat, mp_n_obs=n_obs, kf_obs=kf_obs
        )

    m2 = put_obs(m2, kf1, feat1, 0)
    m2 = put_obs(m2, kf2, feat2, 1)
    return m2, jnp.where(fits, ids, -1)


# ---------------------------------------------------------------------------
# Derived quantities
# ---------------------------------------------------------------------------


def observation_indicator(m: SlamMap) -> jnp.ndarray:
    """(K, M) bool: keyframe k observes map point p. Built from kf_obs; the
    base relation for covisibility and BA."""
    K, N = m.kf_obs.shape
    M = m.max_mp
    flat_kf = jnp.repeat(jnp.arange(K), N)
    flat_mp = m.kf_obs.reshape(-1)
    has = (flat_mp >= 0) & m.kf_feat_valid.reshape(-1)
    ind = jnp.zeros((K, M), bool)
    return ind.at[flat_kf, jnp.where(has, flat_mp, 0)].max(has)


def rebuild_observation_lists(m: SlamMap) -> SlamMap:
    """Reconstruct mp_obs_kf/mp_obs_feat/mp_n_obs from kf_obs (the ground
    truth relation). Used after observation deletions (BA outlier removal,
    point culling) — the array analogue of MapPoint::EraseObservation
    bookkeeping (src/MapPoint.cc:104-143), done as one sort instead of
    per-object list surgery.
    """
    K, N = m.kf_obs.shape
    Mx = m.max_mp
    O = m.max_obs
    flat_mp = m.kf_obs.reshape(-1)
    has = (flat_mp >= 0) & m.kf_feat_valid.reshape(-1) & jnp.repeat(m.kf_valid, N)
    sort_key = jnp.where(has, flat_mp, Mx)  # invalid entries last
    order = jnp.argsort(sort_key, stable=True)
    sorted_mp = sort_key[order]
    flat_kf = jnp.repeat(jnp.arange(K, dtype=jnp.int32), N)[order]
    flat_ft = jnp.tile(jnp.arange(N, dtype=jnp.int32), K)[order]
    # rank of each entry within its mp group
    first_pos = jnp.searchsorted(sorted_mp, jnp.arange(Mx), side="left")
    pos = jnp.arange(K * N)
    rank = pos - first_pos[jnp.clip(sorted_mp, 0, Mx - 1)]
    ok = (sorted_mp < Mx) & (rank < O)
    # dropped writes use an out-of-bounds index + mode="drop" (no sink cell)
    mp_w = jnp.where(ok, sorted_mp, Mx)
    rk_w = jnp.where(ok, rank, O)
    obs_kf = jnp.full((Mx, O), -1, jnp.int32).at[mp_w, rk_w].set(
        flat_kf, mode="drop"
    )
    obs_feat = jnp.full((Mx, O), -1, jnp.int32).at[mp_w, rk_w].set(
        flat_ft, mode="drop"
    )
    counts = jnp.zeros(Mx, jnp.int32).at[mp_w].add(1, mode="drop")
    return m.replace(
        mp_obs_kf=obs_kf, mp_obs_feat=obs_feat, mp_n_obs=counts
    )


def recount_observations(m: SlamMap) -> jnp.ndarray:
    """(M,) number of observing keyframes per point, derived from kf_obs
    (ground truth for mp_n_obs; useful after culling)."""
    flat_mp = m.kf_obs.reshape(-1)
    has = (flat_mp >= 0) & m.kf_feat_valid.reshape(-1) & m.kf_valid.repeat(m.n_feat)
    counts = jnp.zeros(m.max_mp, jnp.int32)
    return counts.at[jnp.where(has, flat_mp, 0)].add(has.astype(jnp.int32))
