"""Batched map-point statistics: distinctive descriptor, normal, scale band.

JAX replacement for ``MapPoint::ComputeDistinctiveDescriptors``
(jni/ORB_SLAM2/src/MapPoint.cc:248-313 — min-median-Hamming descriptor
election among observations) and ``MapPoint::UpdateNormalAndDepth``
(src/MapPoint.cc:336-377 — mean viewing ray + scale-invariance distance
band). The reference updates one point at a time whenever its observation set
changes; here all points refresh in one batched pass over the observation
lists (gathers + masked reductions), typically after a mapping step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import hamming
from .types import SlamMap


def refresh_point_stats(
    m: SlamMap, scale_factors: jnp.ndarray, point_mask: jnp.ndarray | None = None
) -> SlamMap:
    """Recompute mp_desc / mp_normal / mp_min_dist / mp_max_dist for all
    (or masked) valid points from their observation lists.

    scale_factors: (L,) per-octave scale factors (1.2^l).
    """
    if point_mask is None:
        point_mask = m.mp_valid
    M, O = m.mp_obs_kf.shape

    obs_ok = (m.mp_obs_kf >= 0) & (
        jnp.arange(O)[None, :] < m.mp_n_obs[:, None]
    )
    kf = jnp.maximum(m.mp_obs_kf, 0)
    ft = jnp.maximum(m.mp_obs_feat, 0)
    # observation stale check: the keyframe slot must still point back at us
    obs_ok = obs_ok & (m.kf_obs[kf, ft] == jnp.arange(M)[:, None]) & m.kf_valid[kf]

    # --- distinctive descriptor: min median distance to the others ---------
    descs = m.kf_desc[kf, ft]  # (M, O, 8)
    d = jax.vmap(hamming.distance_matrix)(descs, descs)  # (M, O, O)
    pair_ok = obs_ok[:, :, None] & obs_ok[:, None, :]
    d = jnp.where(pair_ok, d, hamming.INVALID_DIST)
    # median along axis 2 over valid entries: sort and index at count/2
    d_sorted = jnp.sort(d, axis=2)
    cnt = obs_ok.sum(axis=1)  # (M,) valid observation count
    med_idx = jnp.maximum(cnt[:, None] // 2, 0)
    median = jnp.take_along_axis(d_sorted, med_idx[..., None], axis=2)[..., 0]  # (M, O)
    median = jnp.where(obs_ok, median, hamming.INVALID_DIST)
    best_obs = jnp.argmin(median, axis=1)  # (M,)
    new_desc = descs[jnp.arange(M), best_obs]

    # --- normal + scale band ----------------------------------------------
    R = m.kf_pose[kf][..., :3, :3]
    t = m.kf_pose[kf][..., :3, 3]
    centers = -jnp.einsum("moji,moj->moi", R, t)  # (M, O, 3) camera centers
    rays = m.mp_pos[:, None, :] - centers
    norms = jnp.linalg.norm(rays, axis=-1)
    rays_n = rays / jnp.maximum(norms, 1e-9)[..., None]
    w = obs_ok.astype(jnp.float32)
    normal = (rays_n * w[..., None]).sum(axis=1) / jnp.maximum(
        w.sum(axis=1), 1.0
    )[:, None]

    # reference: band from the *reference* (first-listed) observation's depth
    # and octave (MapPoint.cc:358-374): maxDist = dist * scale^octave;
    # minDist = maxDist / scale^(L-1)
    ref_slot = jnp.argmax(obs_ok, axis=1)
    ref_kf = kf[jnp.arange(M), ref_slot]
    ref_ft = ft[jnp.arange(M), ref_slot]
    ref_dist = norms[jnp.arange(M), ref_slot]
    ref_octave = m.kf_octave[ref_kf, ref_ft]
    L = scale_factors.shape[0]
    max_dist = ref_dist * scale_factors[jnp.clip(ref_octave, 0, L - 1)]
    min_dist = max_dist / scale_factors[L - 1]

    upd = point_mask & (cnt > 0)
    return m.replace(
        mp_desc=jnp.where(upd[:, None], new_desc, m.mp_desc),
        mp_normal=jnp.where(upd[:, None], normal, m.mp_normal),
        mp_max_dist=jnp.where(upd, max_dist, m.mp_max_dist),
        mp_min_dist=jnp.where(upd, min_dist, m.mp_min_dist),
        mp_n_obs=jnp.where(point_mask, cnt, m.mp_n_obs),
    )


def refresh_point_stats_touched(
    m: SlamMap,
    scale_factors: jnp.ndarray,
    touched: jnp.ndarray,
    cap: int = 4096,
) -> SlamMap:
    """refresh_point_stats restricted to a compacted subset of points.

    The full refresh gathers every point's observation descriptors
    ((M, O, 8) random 2-D gathers) and sorts an (M, O, O) Hamming cube; a mapping pass
    only perturbs the points observed by the new keyframe and its fuse
    targets (<= a few thousand), so the work here is gathered down to the
    top-`cap` touched points and scattered back — ~4x less traffic at the
    default capacities. Points beyond the cap keep their previous stats
    until a later pass touches them (the reference likewise only updates
    affected MapPoints — MapPoint.cc:248-377)."""
    sel_v, pids = jax.lax.top_k(
        (touched & m.mp_valid).astype(jnp.int32), min(cap, m.max_mp)
    )
    sel = sel_v > 0
    T = pids.shape[0]
    O = m.mp_obs_kf.shape[1]

    obs_kf = m.mp_obs_kf[pids]
    obs_ft = m.mp_obs_feat[pids]
    n_obs = m.mp_n_obs[pids]
    obs_ok = (obs_kf >= 0) & (jnp.arange(O)[None, :] < n_obs[:, None])
    kf = jnp.maximum(obs_kf, 0)
    ft = jnp.maximum(obs_ft, 0)
    obs_ok = obs_ok & (m.kf_obs[kf, ft] == pids[:, None]) & m.kf_valid[kf]

    descs = m.kf_desc[kf, ft]  # (T, O, 8)
    d = jax.vmap(hamming.distance_matrix)(descs, descs)  # (T, O, O)
    pair_ok = obs_ok[:, :, None] & obs_ok[:, None, :]
    d = jnp.where(pair_ok, d, hamming.INVALID_DIST)
    d_sorted = jnp.sort(d, axis=2)
    cnt = obs_ok.sum(axis=1)
    med_idx = jnp.maximum(cnt[:, None] // 2, 0)
    median = jnp.take_along_axis(d_sorted, med_idx[..., None], axis=2)[..., 0]
    median = jnp.where(obs_ok, median, hamming.INVALID_DIST)
    best_obs = jnp.argmin(median, axis=1)
    new_desc = descs[jnp.arange(T), best_obs]

    R = m.kf_pose[kf][..., :3, :3]
    t = m.kf_pose[kf][..., :3, 3]
    centers = -jnp.einsum("moji,moj->moi", R, t)
    rays = m.mp_pos[pids][:, None, :] - centers
    norms = jnp.linalg.norm(rays, axis=-1)
    rays_n = rays / jnp.maximum(norms, 1e-9)[..., None]
    w = obs_ok.astype(jnp.float32)
    normal = (rays_n * w[..., None]).sum(axis=1) / jnp.maximum(
        w.sum(axis=1), 1.0
    )[:, None]

    ref_slot = jnp.argmax(obs_ok, axis=1)
    aT = jnp.arange(T)
    ref_kf = kf[aT, ref_slot]
    ref_ft = ft[aT, ref_slot]
    ref_dist = norms[aT, ref_slot]
    ref_octave = m.kf_octave[ref_kf, ref_ft]
    L = scale_factors.shape[0]
    max_dist = ref_dist * scale_factors[jnp.clip(ref_octave, 0, L - 1)]
    min_dist = max_dist / scale_factors[L - 1]

    upd = sel & (cnt > 0)
    w_idx = jnp.where(upd, pids, m.max_mp)
    w_cnt = jnp.where(sel, pids, m.max_mp)
    return m.replace(
        mp_desc=m.mp_desc.at[w_idx].set(new_desc, mode="drop"),
        mp_normal=m.mp_normal.at[w_idx].set(normal, mode="drop"),
        mp_max_dist=m.mp_max_dist.at[w_idx].set(max_dist, mode="drop"),
        mp_min_dist=m.mp_min_dist.at[w_idx].set(min_dist, mode="drop"),
        mp_n_obs=m.mp_n_obs.at[w_cnt].set(cnt, mode="drop"),
    )


def predict_octave(
    dist: jnp.ndarray, max_dist: jnp.ndarray, scale_factor, n_levels: int
) -> jnp.ndarray:
    """Predicted pyramid level from viewing distance
    (MapPoint::PredictScale, src/MapPoint.cc:391-400)."""
    ratio = jnp.maximum(max_dist, 1e-9) / jnp.maximum(dist, 1e-9)
    lvl = jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-9)) / jnp.log(scale_factor))
    return jnp.clip(lvl.astype(jnp.int32), 0, n_levels - 1)
