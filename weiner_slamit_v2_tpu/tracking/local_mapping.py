"""Local mapping: triangulate new points, cull, fuse, local BA.

JAX replacement for the ``LocalMapping`` thread
(jni/ORB_SLAM2/src/LocalMapping.cc). The reference runs an infinite polling
loop with per-keyframe scalar work; here each responsibility is a batched
array pass over the map, invoked synchronously per new keyframe by the
pipeline (tracking/system.py) — deterministic by construction, no stop/finish
flag protocol needed (SURVEY.md §5 "race detection").
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import SlamConfig
from ..frontend import matcher
from ..geometry import camera, epipolar, se3, triangulate
from ..ops import hamming
from ..slam_map import types as mt
from ..slam_map.covisibility import covisibility_matrix
from ..slam_map.point_stats import refresh_point_stats  # noqa: F401  (re-exported for depth-init)
from ..slam_map.types import SlamMap


def _median_depth_of_kf(m: SlamMap, kf_id) -> jnp.ndarray:
    """Median depth of the map points a keyframe observes
    (KeyFrame::ComputeSceneMedianDepth, src/KeyFrame.cc:641-671)."""
    obs = m.kf_obs[kf_id]
    has = (obs >= 0) & m.kf_feat_valid[kf_id]
    pts = m.mp_pos[jnp.maximum(obs, 0)]
    z = triangulate.depth_in_view(m.kf_pose[kf_id], pts)
    z_masked = jnp.where(has & (z > 0), z, jnp.nan)
    med = jnp.nanmedian(z_masked)
    return jnp.where(jnp.isnan(med), 1.0, med)


def _triangulation_candidates(
    m: SlamMap,
    kf1,
    kf2,
    K: jnp.ndarray,
    scale_factors: jnp.ndarray,
    sigma2: jnp.ndarray,
    cfg: SlamConfig,
):
    """Candidate new map points between keyframes kf1 (current) and kf2
    (covisible neighbor): epipolar-gated matching of yet-unmatched features,
    DLT triangulation, and the reference's acceptance gates
    (LocalMapping::CreateNewMapPoints, src/LocalMapping.cc:221-505).

    Returns (good (N,), X (N,3), idx (N,), best_dist (N,)) — vmapped over
    neighbors by :func:`triangulate_with_neighbors`.
    """
    T1 = m.kf_pose[kf1]
    T2 = m.kf_pose[kf2]
    C1 = triangulate.camera_center(T1)
    C2 = triangulate.camera_center(T2)
    baseline = jnp.linalg.norm(C2 - C1)
    med_depth = _median_depth_of_kf(m, kf2)
    pair_ok = (baseline / jnp.maximum(med_depth, 1e-9)) > cfg.mapping.min_baseline_depth_ratio

    # --- epipolar-constrained matching of unmatched features --------------
    un1 = m.kf_feat_valid[kf1] & (m.kf_obs[kf1] < 0)
    un2 = m.kf_feat_valid[kf2] & (m.kf_obs[kf2] < 0)
    xy1 = m.kf_xy[kf1]
    xy2 = m.kf_xy[kf2]
    F12 = epipolar.fundamental_from_poses(T1, T2, K, K)
    # all-pairs epipolar distance: line in image 1 from each kp2, distance of
    # each kp1 from it (CheckDistEpipolarLine, ORBmatcher.cc:142-159)
    n = xy1.shape[0]
    x2h = jnp.concatenate([xy2, jnp.ones((n, 1))], axis=1)
    lines = x2h @ F12.T                                  # (N2, 3)
    num = xy1 @ lines[:, :2].T + lines[None, :, 2]       # (N1, N2)
    den = jnp.maximum(lines[:, 0] ** 2 + lines[:, 1] ** 2, 1e-12)
    d2 = num * num / den[None, :]
    oct2 = m.kf_octave[kf2]
    epi_ok = d2 < 3.84 * sigma2[jnp.clip(oct2, 0, sigma2.shape[0] - 1)][None, :]
    # epipole proximity rejection: dist^2 > 100 * scale^2 (ORBmatcher.cc:749)
    e12 = _project_point(K, T2, C1)  # epipole of cam1 in image 2
    dist_e = jnp.sum((xy2 - e12) ** 2, axis=1)
    far_from_epipole = dist_e > 100.0 * sigma2[jnp.clip(oct2, 0, sigma2.shape[0] - 1)]
    pair_mask = epi_ok & far_from_epipole[None, :]

    dist = hamming.masked_distance_matrix(
        m.kf_desc[kf1], m.kf_desc[kf2], un1, un2, pair_mask
    )
    idx, best, second = hamming.best_and_second(dist)
    ok = (best <= matcher.TH_LOW) & (
        best.astype(jnp.float32)
        < cfg.matcher.nn_ratio_triangulation
        * jnp.where(second < hamming.INVALID_DIST, second, hamming.INVALID_DIST).astype(jnp.float32)
    )
    ok = ok & matcher._column_unique_best(idx, best, ok, n)

    # --- triangulate + gates ---------------------------------------------
    uv1 = xy1
    uv2m = xy2[jnp.maximum(idx, 0)]
    P1 = triangulate._projection_matrix(K, T1)
    P2 = triangulate._projection_matrix(K, T2)
    X = triangulate.triangulate_dlt(uv1, uv2m, P1, P2)
    finite = jnp.all(jnp.isfinite(X), axis=1)

    cosp = triangulate.parallax_cos(C1, C2, X)
    z1 = triangulate.depth_in_view(T1, X)
    z2 = triangulate.depth_in_view(T2, X)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def reproj2(T, uv):
        Pc = se3.apply(T, X)
        zs = jnp.where(jnp.abs(Pc[:, 2]) < 1e-9, 1e-9, Pc[:, 2])
        u = fx * Pc[:, 0] / zs + cx
        v = fy * Pc[:, 1] / zs + cy
        return (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2

    oct1 = m.kf_octave[kf1]
    s2_1 = sigma2[jnp.clip(oct1, 0, sigma2.shape[0] - 1)]
    s2_2 = sigma2[jnp.clip(m.kf_octave[kf2][jnp.maximum(idx, 0)], 0, sigma2.shape[0] - 1)]
    err1_ok = reproj2(T1, uv1) < cfg.mapping.chi2_mono * s2_1
    err2_ok = reproj2(T2, uv2m) < cfg.mapping.chi2_mono * s2_2

    # scale consistency (LocalMapping.cc:465-483)
    d1 = jnp.linalg.norm(X - C1, axis=1)
    d2n = jnp.linalg.norm(X - C2, axis=1)
    ratio_dist = d2n / jnp.maximum(d1, 1e-9)
    sf1 = scale_factors[jnp.clip(oct1, 0, sigma2.shape[0] - 1)]
    sf2 = scale_factors[jnp.clip(m.kf_octave[kf2][jnp.maximum(idx, 0)], 0, sigma2.shape[0] - 1)]
    ratio_octave = sf1 / sf2
    ratio_factor = 1.5 * float(cfg.orb.scale_factor)
    scale_ok = (ratio_dist * ratio_factor > ratio_octave) & (
        ratio_dist < ratio_octave * ratio_factor
    )

    good = (
        ok & pair_ok & finite & (cosp < 0.9998) & (cosp > 0)
        & (z1 > 0) & (z2 > 0) & err1_ok & err2_ok & scale_ok
    )
    return good, X, idx, best


def triangulate_with_neighbors(
    m: SlamMap,
    kf1,
    neighbors: jnp.ndarray,   # (nn,) keyframe ids
    neigh_ok: jnp.ndarray,    # (nn,) bool
    K: jnp.ndarray,
    scale_factors: jnp.ndarray,
    sigma2: jnp.ndarray,
    cfg: SlamConfig,
) -> SlamMap:
    """Triangulate new points against every covisible neighbor at once.

    The reference walks the nn=20 neighbors sequentially and a feature gets
    its point from the first neighbor that matches it
    (src/LocalMapping.cc:221-505); the batched equivalent computes all
    neighbor candidates with one vmapped program and keeps, per feature, the
    candidate with the smallest descriptor distance — then inserts the whole
    batch with a single scatter.
    """
    good_nn, X_nn, idx_nn, dist_nn = jax.vmap(
        lambda k2: _triangulation_candidates(
            m, kf1, k2, K, scale_factors, sigma2, cfg
        )
    )(jnp.maximum(neighbors, 0))
    good_nn = good_nn & neigh_ok[:, None] & (neighbors[:, None] != kf1)

    # per-feature winner across neighbors: smallest Hamming distance
    n = good_nn.shape[1]
    big = 10_000
    d = jnp.where(good_nn, dist_nn, big)
    win = jnp.argmin(d, axis=0)                         # (N,)
    cols = jnp.arange(n)
    good = good_nn[win, cols]
    X = X_nn[win, cols]
    idx = idx_nn[win, cols]
    kf2 = neighbors[win]

    C1 = triangulate.camera_center(m.kf_pose[kf1])
    oct1 = m.kf_octave[kf1]
    sf1 = scale_factors[jnp.clip(oct1, 0, scale_factors.shape[0] - 1)]
    d1 = jnp.linalg.norm(X - C1, axis=1)
    normal = (X - C1) / jnp.maximum(
        jnp.linalg.norm(X - C1, axis=1, keepdims=True), 1e-9
    )
    L = scale_factors.shape[0]
    max_dist = d1 * sf1
    min_dist = max_dist / scale_factors[L - 1]
    m2, _ = mt.add_map_points(
        m,
        pos=X,
        desc=m.kf_desc[kf1],
        normal=normal,
        min_dist=min_dist,
        max_dist=max_dist,
        kf1=jnp.full(n, kf1, jnp.int32),
        feat1=jnp.arange(n, dtype=jnp.int32),
        kf2=jnp.where(good, kf2, -1),
        feat2=jnp.maximum(idx, 0),
        valid=good,
    )
    return m2


def _project_point(K, Tcw, Xw):
    Pc = se3.apply(Tcw, Xw)
    z = jnp.where(jnp.abs(Pc[..., 2]) < 1e-9, 1e-9, Pc[..., 2])
    u = K[0, 0] * Pc[..., 0] / z + K[0, 2]
    v = K[1, 1] * Pc[..., 1] / z + K[1, 2]
    return jnp.stack([u, v], axis=-1)


def _fuse_points_into_kf(
    m: SlamMap,
    pts_mask: jnp.ndarray,    # (M,) candidate points to project
    dst,
    K: jnp.ndarray,
    scale_factors: jnp.ndarray,
    inv_sigma2_by_oct: jnp.ndarray,
    cfg: SlamConfig,
    max_points: int,
    window_mult: float = 3.0,
    prefer_src: bool = False,
) -> SlamMap:
    """ORBmatcher::Fuse (jni/ORB_SLAM2/src/ORBmatcher.cc:829-979): project
    candidate map points into keyframe `dst`; a match against a feature that
    already owns a different map point merges the two keeping the
    more-observed one (MapPoint::Replace, src/MapPoint.cc:183-221); a match
    against a free feature adds an observation.

    window_mult: search radius in units of the predicted level's scale
    (3.0 in SearchInNeighbors, 4.0 in loop SearchAndFuse —
    LoopClosing.cc:612). prefer_src=True makes the projected candidate win
    every merge regardless of observation count (loop fusion semantics,
    LoopClosing.cc:540-556)."""
    from ..slam_map.point_stats import predict_octave

    L = scale_factors.shape[0]
    # candidate selection (cap for fixed shapes; prefer well-observed points)
    already_here = jnp.any(m.mp_obs_kf == dst, axis=1)
    cand = pts_mask & m.mp_valid & ~already_here
    sel_score = jnp.where(cand, m.mp_n_obs, -1)
    vals, pid = jax.lax.top_k(sel_score, min(max_points, m.max_mp))
    p_ok = vals >= 0
    pid = jnp.maximum(pid, 0)

    Tcw = m.kf_pose[dst]
    X = m.mp_pos[pid]
    Pc = se3.apply(Tcw, X)
    z = Pc[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = K[0, 0] * Pc[:, 0] / zs + K[0, 2]
    v = K[1, 1] * Pc[:, 1] / zs + K[1, 2]
    C = triangulate.camera_center(Tcw)
    ray = X - C
    dist3 = jnp.linalg.norm(ray, axis=1)
    viewcos = jnp.sum(ray * m.mp_normal[pid], axis=1) / jnp.maximum(dist3, 1e-9)
    # undistorted image bounds (Frame::ComputeImageBounds, Frame.cc:561-589)
    bx = camera.bounds_from_config(cfg.camera)
    p_ok = (
        p_ok & (z > 0) & (viewcos > 0.5)
        & (dist3 >= 0.8 * m.mp_min_dist[pid])
        & (dist3 <= 1.2 * m.mp_max_dist[pid])
        & (u >= bx[0]) & (u < bx[1]) & (v >= bx[2]) & (v < bx[3])
    )
    pred_oct = predict_octave(dist3, m.mp_max_dist[pid], scale_factors[1], L)

    # pairwise gates: window 3*scale(predicted level) (ORBmatcher.cc:868),
    # level in [pred-1, pred], chi2 5.99 * sigma2(feature octave)
    octf = m.kf_octave[dst]
    fidx, best, _ = matcher.windowed_best2(
        m.mp_desc[pid], m.kf_desc[dst], p_ok, m.kf_feat_valid[dst],
        pred_xy=jnp.stack([u, v], axis=1), xy2=m.kf_xy[dst],
        window=window_mult * scale_factors[jnp.clip(pred_oct, 0, L - 1)],
        oct_lo=pred_oct - 1, oct_hi=pred_oct, octave2=octf,
        chi2_w=inv_sigma2_by_oct[jnp.clip(octf, 0, L - 1)],
        chi2_th=cfg.mapping.chi2_mono,
    )
    ok = (best <= cfg.matcher.th_low) & p_ok
    ok = ok & matcher._column_unique_best(fidx, best, ok, m.n_feat)

    f = jnp.maximum(fidx, 0)
    q = m.kf_obs[dst, f]                   # existing point at that feature
    p = pid

    # --- add observations on free features --------------------------------
    add = ok & (q < 0)
    kf_obs_dst = m.kf_obs[dst].at[jnp.where(add, f, m.n_feat)].set(
        jnp.where(add, p, -1), mode="drop"
    )
    m = m.replace(kf_obs=m.kf_obs.at[dst].set(kf_obs_dst))
    n_obs = m.mp_n_obs.at[jnp.where(add, p, m.max_mp)].add(1, mode="drop")

    # --- merge duplicates (MapPoint::Replace) ------------------------------
    merge = ok & (q >= 0) & (q != p) & m.mp_valid[jnp.maximum(q, 0)]
    qs = jnp.maximum(q, 0)
    p_wins = (
        jnp.ones_like(q, dtype=bool) if prefer_src else n_obs[p] >= n_obs[qs]
    )
    winner = jnp.where(p_wins, p, qs)
    loser = jnp.where(p_wins, qs, p)
    Mx = m.max_mp
    r = jnp.arange(Mx, dtype=jnp.int32).at[
        jnp.where(merge, loser, Mx)
    ].set(jnp.where(merge, winner, -1), mode="drop")
    r = r[r]  # resolve 2-chains within the batch
    kf_obs = jnp.where(m.kf_obs >= 0, r[jnp.maximum(m.kf_obs, 0)], m.kf_obs)
    mp_valid = m.mp_valid.at[jnp.where(merge, loser, Mx)].set(
        False, mode="drop"
    )
    # Replace merges the found/visible counters (MapPoint.cc:183-221)
    lw = jnp.where(merge, winner, Mx)
    lf = jnp.where(merge, m.mp_found[loser], 0)
    lv = jnp.where(merge, m.mp_visible[loser], 0)
    ln = jnp.where(merge, n_obs[loser], 0)
    return m.replace(
        kf_obs=kf_obs,
        mp_valid=mp_valid,
        mp_found=m.mp_found.at[lw].add(lf, mode="drop"),
        mp_visible=m.mp_visible.at[lw].add(lv, mode="drop"),
        mp_n_obs=n_obs.at[lw].add(ln, mode="drop"),
    )


def _fuse_match_in_kf(
    m: SlamMap,
    pid: jnp.ndarray,        # (S,) candidate point ids
    p_ok_in: jnp.ndarray,    # (S,) candidate validity
    dst,
    K: jnp.ndarray,
    scale_factors: jnp.ndarray,
    inv_sigma2_by_oct: jnp.ndarray,
    cfg: SlamConfig,
    window_mult: float,
):
    """Match-only half of ORBmatcher::Fuse (src/ORBmatcher.cc:829-979):
    project candidate points into keyframe `dst` and find, per point, the
    best in-window feature. Returns (ok (S,), fidx (S,)) — the map update
    (add/merge) is applied by the caller so it can be batched over targets.
    """
    from ..slam_map.point_stats import predict_octave

    L = scale_factors.shape[0]
    already_here = jnp.any(m.mp_obs_kf[pid] == dst, axis=1)
    p_ok = p_ok_in & m.mp_valid[pid] & ~already_here

    Tcw = m.kf_pose[dst]
    X = m.mp_pos[pid]
    Pc = se3.apply(Tcw, X)
    z = Pc[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = K[0, 0] * Pc[:, 0] / zs + K[0, 2]
    v = K[1, 1] * Pc[:, 1] / zs + K[1, 2]
    C = triangulate.camera_center(Tcw)
    ray = X - C
    dist3 = jnp.linalg.norm(ray, axis=1)
    viewcos = jnp.sum(ray * m.mp_normal[pid], axis=1) / jnp.maximum(dist3, 1e-9)
    # undistorted image bounds (Frame::ComputeImageBounds, Frame.cc:561-589)
    bx = camera.bounds_from_config(cfg.camera)
    p_ok = (
        p_ok & (z > 0) & (viewcos > 0.5)
        & (dist3 >= 0.8 * m.mp_min_dist[pid])
        & (dist3 <= 1.2 * m.mp_max_dist[pid])
        & (u >= bx[0]) & (u < bx[1]) & (v >= bx[2]) & (v < bx[3])
    )
    pred_oct = predict_octave(dist3, m.mp_max_dist[pid], scale_factors[1], L)

    xy = m.kf_xy[dst]
    octf = m.kf_octave[dst]
    win = window_mult * scale_factors[jnp.clip(pred_oct, 0, L - 1)]
    fidx, best, _ = matcher.windowed_best2(
        m.mp_desc[pid], m.kf_desc[dst], p_ok, m.kf_feat_valid[dst],
        pred_xy=jnp.stack([u, v], axis=1), xy2=xy, window=win,
        oct_lo=pred_oct - 1, oct_hi=pred_oct, octave2=octf,
        chi2_w=inv_sigma2_by_oct[jnp.clip(octf, 0, L - 1)],
        chi2_th=cfg.mapping.chi2_mono,
    )
    ok = (best <= cfg.matcher.th_low) & p_ok
    ok = ok & matcher._column_unique_best(fidx, best, ok, m.n_feat)
    return ok, jnp.maximum(fidx, 0)


def fuse_in_neighbors(
    m: SlamMap,
    kf1,
    neighbors: jnp.ndarray,
    neigh_ok: jnp.ndarray,
    K: jnp.ndarray,
    scale_factors: jnp.ndarray,
    sigma2: jnp.ndarray,
    cfg: SlamConfig,
    max_targets: int = 20,
) -> SlamMap:
    """LocalMapping::SearchInNeighbors (src/LocalMapping.cc:507-588): fuse
    the new keyframe's points into its 1st+2nd covisibility neighbors, then
    fuse the union of the neighbors' points back into the new keyframe, and
    rebuild the observation lists.

    The reference walks the targets sequentially with in-order duplicate
    resolution. Here the EXPENSIVE half — projecting kf1's points into every
    target and window-matching descriptors (_fuse_match_in_kf) — depends
    only on pre-pass state (poses, positions, descriptors and feature
    planes are immutable during the pass), so it runs as ONE vmapped batch
    over all targets; the scan then only applies the cheap mutations
    (add/merge scatters) in covisibility order, carrying a cumulative
    Replace map so later targets see earlier merges. This removed ~32
    serial match programs (~3 ms each) from the mapping pass's critical
    path. Validity of a fused point is re-checked against the carried
    mp_valid at apply time, so a point merged away by an earlier target
    never fuses under its dead id.
    """
    inv_s2 = 1.0 / sigma2
    W = covisibility_matrix(m)
    # second neighbors: top-5 covisible of each first neighbor
    # (LocalMapping.cc:522-534)
    sec_vals, sec_idx = jax.lax.top_k(
        W[jnp.maximum(neighbors, 0)], min(5, m.max_kf)
    )
    targets = jnp.concatenate([neighbors, sec_idx.reshape(-1)])
    t_ok = jnp.concatenate(
        [neigh_ok, (sec_vals > 0).reshape(-1) & jnp.repeat(neigh_ok, sec_vals.shape[1])]
    )
    t_ok = t_ok & (targets != kf1) & m.kf_valid[jnp.maximum(targets, 0)]
    # deduplicate targets (keep first occurrence)
    tt = jnp.where(t_ok, targets, -1)
    first_hit = jnp.full(m.max_kf + 1, tt.shape[0], jnp.int32).at[
        jnp.where(t_ok, targets, m.max_kf)
    ].min(jnp.arange(tt.shape[0], dtype=jnp.int32), mode="drop")
    t_ok = t_ok & (first_hit[jnp.maximum(tt, 0)] == jnp.arange(tt.shape[0]))
    # cap at the most covisible targets — the reference's own first-neighbor
    # budget is nn=20 (src/LocalMapping.cc:512), and each target costs ~3 ms
    # of window-matching on the device (tools/profile_mapping.py)
    rank = jnp.where(t_ok, W[kf1][jnp.maximum(targets, 0)] + 1, -1)
    tvals, tsel = jax.lax.top_k(rank, min(max_targets, rank.shape[0]))
    targets = jnp.maximum(targets[tsel], 0)
    t_ok = (tvals > 0) & t_ok[tsel]
    T = targets.shape[0]

    # ---- forward: kf1's points into each target, in covisibility order ----
    Mx = m.max_mp
    Nf = m.n_feat

    # candidate set from the PRE-pass kf1 row, fused once per point
    # (the reference passes a unique MapPoint set — src/LocalMapping.cc:561)
    pid0 = jnp.maximum(m.kf_obs[kf1], 0)
    p_has0 = (m.kf_obs[kf1] >= 0) & m.kf_feat_valid[kf1]
    first0 = jnp.full(Mx + 1, Nf, jnp.int32).at[
        jnp.where(p_has0, pid0, Mx)
    ].min(jnp.arange(Nf, dtype=jnp.int32), mode="drop")
    p_has0 = p_has0 & (first0[pid0] == jnp.arange(Nf))

    # one batched match over ALL targets (the hot half of the pass)
    ok_s, f_s = jax.vmap(
        lambda dst: _fuse_match_in_kf(
            m, pid0, p_has0, dst, K, scale_factors, inv_s2, cfg,
            window_mult=3.0,
        )
    )(targets)

    def step(carry, tv):
        kf_obs_c, mp_valid_c, n_obs_c, found_c, visible_c, r_cum = carry
        dst, ok_t, ok_m, f = tv
        # remap the precomputed candidate ids through earlier merges and
        # re-check liveness under the carried validity plane
        pid = r_cum[pid0]
        # dedup after remapping (two kf1 features may now share a winner)
        first = jnp.full(Mx + 1, Nf, jnp.int32).at[
            jnp.where(p_has0, pid, Mx)
        ].min(jnp.arange(Nf, dtype=jnp.int32), mode="drop")
        ok = (
            ok_m & ok_t & p_has0
            & mp_valid_c[pid]
            & (first[pid] == jnp.arange(Nf))
        )
        q = kf_obs_c[dst, f]

        # add observations on free features
        add = ok & (q < 0)
        row = kf_obs_c[dst].at[jnp.where(add, f, Nf)].set(
            jnp.where(add, pid, -1), mode="drop"
        )
        kf_obs_c = kf_obs_c.at[dst].set(row)
        n_obs_c = n_obs_c.at[jnp.where(add, pid, Mx)].add(1, mode="drop")

        # merge duplicates (MapPoint::Replace, src/MapPoint.cc:183-221)
        merge = ok & (q >= 0) & (q != pid) & mp_valid_c[jnp.maximum(q, 0)]
        qs = jnp.maximum(q, 0)
        p_wins = n_obs_c[pid] >= n_obs_c[qs]
        winner = jnp.where(p_wins, pid, qs)
        loser = jnp.where(p_wins, qs, pid)
        r = jnp.arange(Mx, dtype=jnp.int32).at[
            jnp.where(merge, loser, Mx)
        ].set(jnp.where(merge, winner, -1), mode="drop")
        r = r[r]  # resolve 2-chains within this target's batch
        kf_obs_c = jnp.where(
            kf_obs_c >= 0, r[jnp.maximum(kf_obs_c, 0)], kf_obs_c
        )
        mp_valid_c = mp_valid_c.at[jnp.where(merge, loser, Mx)].set(
            False, mode="drop"
        )
        lw = jnp.where(merge, winner, Mx)
        found_c = found_c.at[lw].add(jnp.where(merge, found_c[loser], 0), mode="drop")
        visible_c = visible_c.at[lw].add(jnp.where(merge, visible_c[loser], 0), mode="drop")
        n_obs_c = n_obs_c.at[lw].add(jnp.where(merge, n_obs_c[loser], 0), mode="drop")
        # fold this step's Replace map into the cumulative one
        r_cum = r[r_cum]
        return (kf_obs_c, mp_valid_c, n_obs_c, found_c, visible_c, r_cum), None

    carry0 = (
        m.kf_obs, m.mp_valid, m.mp_n_obs, m.mp_found, m.mp_visible,
        jnp.arange(Mx, dtype=jnp.int32),
    )
    carry, _ = jax.lax.scan(step, carry0, (targets, t_ok, ok_s, f_s))
    m = m.replace(
        kf_obs=carry[0], mp_valid=carry[1], mp_n_obs=carry[2],
        mp_found=carry[3], mp_visible=carry[4],
    )

    # ---- reverse direction: union of target keyframes' points into kf1 ----
    tmask = jnp.zeros(m.max_kf, bool).at[
        jnp.where(t_ok, targets, m.max_kf)
    ].set(True, mode="drop")
    flat = jnp.where(tmask[:, None], m.kf_obs, -1).reshape(-1)
    cand = jnp.zeros(m.max_mp, bool).at[
        jnp.where(flat >= 0, flat, m.max_mp)
    ].set(True, mode="drop")
    m = _fuse_points_into_kf(
        m, cand, kf1, K, scale_factors, inv_s2, cfg,
        max_points=cfg.capacity.local_ba_points,
    )
    return mt.rebuild_observation_lists(m)


def cull_map_points(m: SlamMap, current_kf, cfg: SlamConfig) -> SlamMap:
    """Invalidate weak recent points (LocalMapping::MapPointCulling,
    src/LocalMapping.cc:184-219): found-ratio < 0.25, or <= 2 observations
    within 2 keyframes of creation; points older than 3 keyframes graduate.
    """
    age = current_kf - m.mp_first_kf
    found_ratio = m.mp_found.astype(jnp.float32) / jnp.maximum(
        m.mp_visible.astype(jnp.float32), 1.0
    )
    # Both tests only apply to RECENT points: the reference iterates
    # mlpRecentAddedMapPoints, and a point leaves that list (graduates) at
    # age >= 3 (src/LocalMapping.cc:198-216) — so the found-ratio test is
    # implicitly capped at age <= 3 too. age here is keyframe-id distance,
    # exactly the reference's nCurrentKFid - mnFirstKFid.
    bad = (found_ratio < cfg.mapping.culling_found_ratio) & (age <= 3)
    bad = bad | (
        (age >= 2) & (age <= 3)
        & (m.mp_n_obs <= cfg.mapping.culling_min_obs - 1)
    )
    bad = bad & m.mp_valid
    return invalidate_points(m, bad, rebuild=False)


def invalidate_points(m: SlamMap, bad: jnp.ndarray, rebuild: bool = True) -> SlamMap:
    """Remove points: clear their kf_obs references and observation lists
    (MapPoint::SetBadFlag, src/MapPoint.cc:157-181).

    rebuild=False defers the observation-list rebuild (a full sort — the
    single most expensive map maintenance op) to the caller; every consumer
    of the lists back-checks kf_obs, so stale supersets are safe."""
    mp_valid = m.mp_valid & ~bad
    refd = m.kf_obs >= 0
    still = mp_valid[jnp.maximum(m.kf_obs, 0)]
    kf_obs = jnp.where(refd & ~still, -1, m.kf_obs)
    m = m.replace(mp_valid=mp_valid, kf_obs=kf_obs)
    return mt.rebuild_observation_lists(m) if rebuild else m


def cull_keyframes(m: SlamMap, center_kf, cfg: SlamConfig) -> SlamMap:
    """Cull redundant covisible keyframes of `center_kf`: >= 90% of their
    points are seen by >= 3 other keyframes at the same or finer scale
    (LocalMapping::KeyFrameCulling, src/LocalMapping.cc:686-752).
    The first keyframe (id 0) is never culled.
    """
    K_, N = m.kf_obs.shape
    # per-observation octaves of every point, from the obs lists
    kf = jnp.maximum(m.mp_obs_kf, 0)
    ft = jnp.maximum(m.mp_obs_feat, 0)
    obs_ok = (m.mp_obs_kf >= 0) & (
        jnp.arange(m.max_obs)[None, :] < m.mp_n_obs[:, None]
    ) & (m.kf_obs[kf, ft] == jnp.arange(m.max_mp)[:, None])
    obs_oct = jnp.where(obs_ok, m.kf_octave[kf, ft], 127)  # (M, O)

    W = covisibility_matrix(m)
    covis = W[center_kf] > 0

    def redundancy_of_kf(k):
        obs = m.kf_obs[k]
        has = (obs >= 0) & m.kf_feat_valid[k] & m.mp_valid[jnp.maximum(obs, 0)]
        mp = jnp.maximum(obs, 0)
        my_oct = m.kf_octave[k]
        # for each of this KF's points: count other KFs observing at
        # scale <= my_oct + 1
        oct_p = obs_oct[mp]                     # (N, O)
        other = m.mp_obs_kf[mp] != k            # (N, O)
        fine = oct_p <= (my_oct[:, None] + 1)
        n_better = jnp.sum(other & fine & (oct_p < 127), axis=1)
        redundant = has & (n_better >= cfg.mapping.kf_culling_min_obs)
        n_pts = jnp.maximum(has.sum(), 1)
        return redundant.sum() / n_pts, has.sum()

    # only the center's covisible keyframes are cull candidates
    # (LocalMapping.cc:689 iterates GetVectorCovisibleKeyFrames) — evaluate
    # redundancy for the top-C of them instead of vmapping all kf slots
    # (8x less gather work on a 256-slot pool)
    C_CAND = min(32, K_)
    cand_w = jnp.where(
        covis & m.kf_valid
        & (jnp.arange(K_) != 0) & (jnp.arange(K_) != center_kf),
        W[center_kf], 0,
    )
    cw, cand_idx = jax.lax.top_k(cand_w, C_CAND)
    ratios, counts = jax.vmap(redundancy_of_kf)(cand_idx)
    cullable = (
        (cw > 0)
        & (ratios > cfg.mapping.kf_culling_redundancy)
        & (counts > 0)
    )
    # cull at most one keyframe per pass (the reference culls greedily while
    # iterating; one-at-a-time keeps covisibility consistent)
    first = jnp.argmax(cullable)
    do_cull = cullable[first]
    victim = jnp.where(do_cull, cand_idx[first], -1)
    return invalidate_keyframe(m, victim, rebuild=False)


def invalidate_keyframe(m: SlamMap, kf_id, rebuild: bool = True) -> SlamMap:
    """Remove a keyframe (KeyFrame::SetBadFlag, src/KeyFrame.cc:460-552).
    kf_id = -1 is a no-op.

    Children re-parent by MAX COVISIBILITY among the candidate set — the
    culled keyframe's parent plus its other children (the reference grows
    the candidate set greedily as children are adopted,
    KeyFrame.cc:478-540); here a child may adopt a lower-id sibling (or the
    grandparent), which keeps the forest acyclic in one vectorized pass and
    picks the same winner in the common case of one dominant sibling."""
    do = kf_id >= 0
    k = jnp.maximum(kf_id, 0)
    kf_valid = m.kf_valid.at[k].set(jnp.where(do, False, m.kf_valid[k]))
    parent = m.kf_parent[k]
    children = (m.kf_parent == k) & m.kf_valid & do
    ids = jnp.arange(m.max_kf)
    W = covisibility_matrix(m)
    # candidate siblings: other children of k with SMALLER id (acyclic)
    cand = children[None, :] & (ids[None, :] < ids[:, None])
    w_sib = jnp.where(cand, W, -1)
    best_sib = jnp.argmax(w_sib, axis=1).astype(jnp.int32)
    best_w = jnp.max(w_sib, axis=1)
    w_par = jnp.where(
        (parent >= 0) & m.kf_valid[jnp.maximum(parent, 0)],
        W[:, jnp.maximum(parent, 0)], 0,
    )
    adopt = jnp.where(best_w > w_par, best_sib, parent)
    new_parent = jnp.where(children, adopt, m.kf_parent)
    kf_obs = m.kf_obs.at[k].set(
        jnp.where(do, jnp.full((m.n_feat,), -1, jnp.int32), m.kf_obs[k])
    )
    m = m.replace(
        kf_valid=kf_valid,
        kf_parent=jnp.where(do, new_parent, m.kf_parent),
        kf_obs=kf_obs,
    )
    return mt.rebuild_observation_lists(m) if rebuild else m


def mapping_pre(
    m: SlamMap,
    new_kf,
    K: jnp.ndarray,
    scale_factors: jnp.ndarray,
    sigma2: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    cfg: SlamConfig,
    n_neighbors: int | None = None,
    run_ba: bool = True,
    run_culling: bool = True,
):
    """Structure half of the local-mapping pass (LocalMapping::Run up to the
    BA — src/LocalMapping.cc:50-84): point culling -> triangulation with top
    covisible neighbors -> cross-neighbor fuse -> statistics refresh -> BA
    problem extraction. Returns (m, prob, cam_ids, point_ids); the BA triple
    is None when run_ba=False. Splitting here is what makes the pass
    abortable: the host can stop issuing BA chunks between this program and
    mapping_finish (the mbAbortBA analogue, src/LocalMapping.cc:127)."""
    from ..optim.ba_extract import extract_local_ba

    if n_neighbors is None:
        n_neighbors = cfg.mapping.triangulation_neighbors

    if run_culling:
        m = cull_map_points(m, new_kf, cfg)

    W = covisibility_matrix(m)
    vals, idx = jax.lax.top_k(W[new_kf], min(n_neighbors, m.max_kf))
    m = triangulate_with_neighbors(
        m, new_kf, idx, vals > 0, K, scale_factors, sigma2, cfg
    )

    m = fuse_in_neighbors(m, new_kf, idx, vals > 0, K, scale_factors, sigma2, cfg)

    # stats refresh restricted to the points this pass could have touched:
    # everything observed by the new keyframe or any covisible keyframe.
    # The covisibility row is recomputed AFTER the fuse: a Replace winner
    # owned by a second-neighbor fuse target inherits the loser's new_kf
    # observation and becomes covisible only now — the pre-pass row would
    # miss it and leave its descriptor/normal stale.
    from ..slam_map.point_stats import refresh_point_stats_touched

    W2 = covisibility_matrix(m)
    sel_kf = (W2[new_kf] > 0) | (jnp.arange(m.max_kf) == new_kf)
    flat = jnp.where((sel_kf & m.kf_valid)[:, None], m.kf_obs, -1).reshape(-1)
    touched = jnp.zeros(m.max_mp, bool).at[
        jnp.where(flat >= 0, flat, m.max_mp)
    ].set(True, mode="drop")
    m = refresh_point_stats_touched(m, scale_factors, touched)

    if not run_ba:
        return m, None, None, None
    prob, cam_ids, point_ids = extract_local_ba(
        m, new_kf, K, inv_sigma2,
        window=cfg.capacity.local_ba_window,
        n_fixed=cfg.capacity.local_ba_window,
        max_points=cfg.capacity.local_ba_points,
        bf=cfg.camera.baseline_times_fx,
    )
    return m, prob, cam_ids, point_ids


def mapping_finish(
    m: SlamMap,
    new_kf,
    res,
    prob,
    cam_ids,
    point_ids,
    cfg: SlamConfig,
    run_culling: bool = True,
) -> SlamMap:
    """Write-back half of the mapping pass (src/LocalMapping.cc:84-118):
    BA write-back (skipped when res is None — the fully-aborted path) ->
    keyframe culling -> one deferred observation-list rebuild."""
    from ..optim.ba_extract import write_back_ba

    if res is not None:
        m = write_back_ba(m, res, prob, cam_ids, point_ids, rebuild=False)
    if run_culling:
        m = cull_keyframes(m, new_kf, cfg)
    # single deferred rebuild for all the list mutations above (BA outlier
    # erase, keyframe cull) — consumers in between back-check kf_obs
    return mt.rebuild_observation_lists(m)


def mapping_step(
    m: SlamMap,
    new_kf,
    K: jnp.ndarray,
    scale_factors: jnp.ndarray,
    sigma2: jnp.ndarray,
    inv_sigma2: jnp.ndarray,
    cfg: SlamConfig,
    n_neighbors: int | None = None,
    run_ba: bool = True,
    run_culling: bool = True,
) -> SlamMap:
    """One full local-mapping pass for a freshly inserted keyframe
    (the body of LocalMapping::Run, src/LocalMapping.cc:50-118):
    point culling -> triangulation with top covisible neighbors ->
    cross-neighbor fuse -> statistics refresh -> local BA -> keyframe
    culling. Pure function of the map; jit-compiled by the pipeline
    (tracking/system.py) with cfg static. The fused single-program variant;
    the staged pipeline (mapping_pre + BA chunks + mapping_finish) computes
    the same pass abortably."""
    from ..optim.local_ba import solve_ba

    m, prob, cam_ids, point_ids = mapping_pre(
        m, new_kf, K, scale_factors, sigma2, inv_sigma2, cfg,
        n_neighbors=n_neighbors, run_ba=run_ba, run_culling=run_culling,
    )
    res = None
    if run_ba:
        res = solve_ba(
            prob, cfg.optim.local_ba_iters1, cfg.optim.local_ba_iters2
        )
    return mapping_finish(
        m, new_kf, res, prob, cam_ids, point_ids, cfg, run_culling=run_culling
    )
