"""Loop closing: detection, Sim3 estimation, fusion, pose-graph correction.

JAX replacement for the ``LoopClosing`` thread
(jni/ORB_SLAM2/src/LoopClosing.cc). Runs synchronously per keyframe (the
pipeline analogue of the reference's 5ms polling loop):

1. detect (DetectLoop, LoopClosing.cc:111-245): BoW candidates excluding the
   covisibility group, gated at the minimum covis score, accepted after
   `covisibility_consistency_th` consecutive hits;
2. compute Sim3 (ComputeSim3, LoopClosing.cc:247-416): BoW matching ->
   RANSAC Horn Sim3 -> guided SearchBySim3 re-matching -> Sim3 GN refinement
   (>= 20 inliers) -> project the loop region's map points with the
   corrected Scw and demand >= `min_total_matches` (40) total matches;
3. correct (CorrectLoop, LoopClosing.cc:418-598): propagate the corrected
   Sim3 through the current covisibility group, correct their map points,
   fuse the matched loop points (MapPoint::Replace — loop point wins),
   SearchAndFuse the loop region into the corrected group (th=4), optimize
   the essential graph (spanning tree + covis >= 100 + loop edges, past
   loops included), recover SE3, correct all points.

The reference spawns a global-BA thread afterwards (RunGlobalBundleAdjustment,
LoopClosing.cc:658-758); here an optional synchronous global BA follows.

Each numbered stage is a single jitted program; the host only orchestrates
the rare accept/reject gates (loop closures happen every few hundred frames).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..frontend import matcher
from ..geometry import se3, sim3
from ..ops import hamming
from ..optim.pose_graph import correct_map_after_pose_graph, optimize_pose_graph
from ..optim.sim3_solver import ransac_sim3, refine_sim3
from ..slam_map import types as mt
from ..slam_map.covisibility import covisibility_matrix
from ..slam_map.point_stats import predict_octave
from .local_mapping import _fuse_points_into_kf


class LoopCloser:
    def __init__(self, cfg: SlamConfig, tracker):
        self.cfg = cfg
        self.tracker = tracker
        self.last_loop_kf = -1_000
        self.consistency_counts: dict[int, int] = {}
        self.n_loops_closed = 0
        self.gba_chunks_issued = 0
        self.run_global_ba = True
        # stereo/RGB-D maps are metric: Sim3 scale is frozen everywhere
        # (bFixScale — src/LoopClosing.cc:73, src/Sim3Solver.cc:37-112)
        self.fix_scale = cfg.sensor != "monocular"
        # in-flight asynchronous global BA (the mbRunningGBA/mbStopGBA
        # protocol of src/LoopClosing.cc:60-63 as a device future + token)
        self._pending_gba: dict | None = None
        # accumulated loop edges (i, j, S_ji) for future essential graphs
        # (the reference keeps them in KeyFrame::mspLoopEdges)
        self.loop_edges: list[tuple[int, int, jnp.ndarray]] = []

    # ------------------------------------------------------------------
    def _enqueue_global_ba(self, gauge_kf: int):
        """Launch the full-map BA as an async device computation, sliced
        into LM chunks so a supersede (new loop / reset) stops issuing work
        mid-run — the mbStopGBA protocol (src/LoopClosing.cc:429-442,
        :658-688). The robust phase launches now; refinement chunks are
        issued from poll_global_ba."""
        from ..optim.ba_extract import extract_global_ba
        from ..optim.local_ba import ba_phase1

        t = self.tracker
        cfg = self.cfg
        prob, cam_ids, point_ids = extract_global_ba(
            t.m, t.K, t.inv_sigma2, gauge_kf=gauge_kf,
            bf=cfg.camera.baseline_times_fx,
        )
        per = max(cfg.tracking.ba_chunk_iters, 1)
        n_refine = max(cfg.optim.global_ba_iters - 5, 0)
        state = ba_phase1(prob, n_iters=5)
        self.gba_chunks_issued += 1
        self._pending_gba = dict(
            res=None, prob=prob, state=state,
            chunks_left=-(-n_refine // per) if n_refine else 0,
            cam_ids=cam_ids, point_ids=point_ids,
            pose_snap=t.m.kf_pose, n_kf_snap=t.n_kf_host,
        )

    def discard_pending_gba(self):
        """Supersede the running GBA (mbStopGBA): the state is dropped and
        NO further chunks are issued."""
        self._pending_gba = None

    def _advance_gba(self, g: dict, eager: bool = False) -> bool:
        """Issue the next refinement chunk / finalize once the previous
        program resolved (eager=True chains without waiting). True when the
        final result future exists."""
        from ..optim.local_ba import ba_finalize, ba_phase2_chunk

        if g["res"] is not None:
            return True
        cam_pose, points, lam, inlier = g["state"]
        if not (eager or self._gba_state_ready(g)):
            return False
        if g["chunks_left"] > 0:
            g["state"] = (
                *ba_phase2_chunk(
                    g["prob"], cam_pose, points, lam, inlier,
                    n_iters=self.cfg.tracking.ba_chunk_iters,
                ),
                inlier,
            )
            g["chunks_left"] -= 1
            self.gba_chunks_issued += 1
            return False
        g["res"] = ba_finalize(g["prob"], cam_pose, points)
        return True

    @staticmethod
    def _gba_state_ready(g: dict) -> bool:
        leaf = g["state"][0]
        return not hasattr(leaf, "is_ready") or leaf.is_ready()

    def poll_global_ba(self, force: bool = False) -> bool:
        """Advance/adopt the concurrent global BA; True if one was adopted.
        Keyframes created while the BA ran are corrected through the
        spanning tree, points created meanwhile through their first
        observer — exactly the reference's post-GBA propagation
        (src/LoopClosing.cc:689-748). A reset or a new loop since enqueue
        supersedes the run (discard_pending_gba): remaining chunks are
        simply never issued."""
        g = self._pending_gba
        if g is None:
            return False
        if force:
            while not self._advance_gba(g, eager=True):
                pass
        else:
            progressed = True
            while progressed and g["res"] is None:
                left = g["chunks_left"]
                done = self._advance_gba(g)
                progressed = done or g["chunks_left"] != left
            if g["res"] is None:
                return False
        if not (force or g["res"].cam_pose.is_ready()):
            return False
        self._pending_gba = None
        t = self.tracker
        if t.n_kf_host < g["n_kf_snap"] or t.n_kf_host == 0:
            return False  # superseded by a session reset
        t.flush_pending()
        from ..slam_map.point_stats import refresh_point_stats

        old_ref_pose = t.m.kf_pose[t.ref_kf]
        t.m = _adopt_gba(
            t.m, g["res"].cam_pose, g["cam_ids"], g["res"].points,
            g["point_ids"], jnp.asarray(g["n_kf_snap"], jnp.int32),
        )
        t.m = refresh_point_stats(t.m, t.scale_factors)
        # re-anchor the tracking chain: the last pose moves with its
        # reference keyframe's correction
        if t.last_Tcw is not None:
            t.last_Tcw = (
                t.last_Tcw @ se3.inv(old_ref_pose) @ t.m.kf_pose[t.ref_kf]
            )
        t.velocity = None
        return True

    # ------------------------------------------------------------------
    def on_keyframe(self, kf_id: int) -> bool:
        """Process a new keyframe; returns True if a loop was closed."""
        cfg = self.cfg
        t = self.tracker
        if not t.bow.ready:
            return False
        if kf_id < self.last_loop_kf + cfg.loop.min_kfs_between_loops:
            return False
        cand = self._detect(kf_id)
        if cand is None:
            return False
        ok = self._close(kf_id, cand)
        if ok:
            self.last_loop_kf = kf_id
            self.n_loops_closed += 1
            self.consistency_counts.clear()
        return ok

    # ------------------------------------------------------------------
    def _detect(self, kf_id: int):
        """BoW loop candidates with covisibility-consistency accumulation."""
        cfg = self.cfg
        t = self.tracker
        m = t.m
        W = covisibility_matrix(m)
        Wnp = np.asarray(W)
        covis_group = set(np.nonzero(Wnp[kf_id] > 0)[0].tolist()) | {kf_id}

        # min score among covisible neighbors (LoopClosing.cc:137-153)
        v = t.bow.row_query(kf_id)
        neigh = [k for k in covis_group if k != kf_id]
        if neigh:
            scores = np.asarray(t.bow.score_rows(neigh, v))
            min_score = float(scores.min())
        else:
            min_score = 0.0

        exclude = np.zeros(m.max_kf, bool)
        for k in covis_group:
            exclude[k] = True
        # also exclude very recent keyframes (id gap, LoopClosing.cc:124)
        recent = np.arange(m.max_kf) > kf_id - cfg.loop.min_kfs_between_loops
        exclude |= recent
        # culled keyframes stay in the BoW database (their rows are not
        # erased); the validity mask is the KeyFrameDatabase::erase analogue
        exclude |= ~np.asarray(m.kf_valid)

        acc, keep = t.bow.candidates(
            v, jnp.asarray(exclude), W.astype(jnp.float32), min_score
        )
        keep_np = np.asarray(keep)
        cands = np.nonzero(keep_np)[0]
        if len(cands) == 0:
            self.consistency_counts.clear()
            return None

        # covisibility-consistency over consecutive keyframes
        # (LoopClosing.cc:170-243): a candidate's covis group must have been
        # seen in the previous keyframe's candidate set too.
        new_counts: dict[int, int] = {}
        chosen = None
        for c in cands:
            group = set(np.nonzero(Wnp[c] > 0)[0].tolist()) | {int(c)}
            prev = max(
                (self.consistency_counts.get(g, 0) for g in group), default=0
            )
            cnt = prev + 1
            for g in group:
                new_counts[g] = max(new_counts.get(g, 0), cnt)
            if cnt >= self.cfg.loop.covisibility_consistency_th:
                chosen = int(c)
        self.consistency_counts = new_counts
        return chosen

    # ------------------------------------------------------------------
    def _close(self, kf_id: int, cand: int) -> bool:
        """ComputeSim3 (LoopClosing.cc:247-416) + CorrectLoop."""
        cfg = self.cfg
        t = self.tracker
        m = t.m

        # --- 1. BoW-style matching of the two keyframes' map points -------
        has1 = (m.kf_obs[kf_id] >= 0) & m.kf_feat_valid[kf_id]
        has2 = (m.kf_obs[cand] >= 0) & m.kf_feat_valid[cand]
        idx, dist = matcher.match_by_descriptor(
            m.kf_desc[kf_id], m.kf_desc[cand], has1, has2,
            max_dist=cfg.matcher.th_low,
            nn_ratio=cfg.matcher.nn_ratio_bow,
            angle1=m.kf_angle[kf_id], angle2=m.kf_angle[cand],
        )
        ok = idx >= 0
        if int(ok.sum()) < cfg.loop.min_bow_matches:
            return False

        # --- 2. RANSAC Horn Sim3 (Sim3Solver, 3-point minimal sets) --------
        S12, inl, n_inl = _sim3_from_matches(
            m, kf_id, cand, idx, t.K, t.inv_sigma2,
            jax.random.PRNGKey(cfg.seed + 97 * kf_id), cfg.orb.n_levels,
            self.fix_scale,
        )
        if int(n_inl) < cfg.loop.min_sim3_inliers:
            return False

        # --- 3. guided SearchBySim3 widening (LoopClosing.cc:333-343) ------
        idx2 = search_by_sim3(
            m, jnp.asarray(kf_id), jnp.asarray(cand), S12,
            jnp.asarray(7.5), t.K, t.scale_factors, t.params.bounds,
        )
        idx = jnp.where(idx >= 0, idx, idx2)

        # --- 4. Sim3 GN refinement (OptimizeSim3, >= 20 inliers) -----------
        S12, inl, n_inl = _refine_sim3_on_matches(
            m, kf_id, cand, idx, t.K, t.inv_sigma2, S12,
            cfg.loop.sim3_chi2, cfg.orb.n_levels, self.fix_scale,
        )
        if int(n_inl) < cfg.loop.min_sim3_inliers:
            return False

        # --- 5. total-match acceptance gate (LoopClosing.cc:352-401) -------
        # project the loop region's points (candidate + its covis group)
        # with the corrected Scw and count all matches
        W = covisibility_matrix(m)
        loop_group = (W[cand] > 0) | (
            jnp.arange(m.max_kf) == cand
        )
        loop_mask = _points_of_group(m, loop_group)
        S_cw = S12 @ sim3.from_se3(m.kf_pose[cand])
        matched_loop = _project_loop_points(
            m, jnp.asarray(kf_id), S_cw, loop_mask, jnp.asarray(10.0),
            t.K, t.scale_factors, t.params.bounds,
        )
        n_total = int((matched_loop >= 0).sum())
        if n_total < cfg.loop.min_total_matches:
            return False

        self._correct(kf_id, cand, S12, S_cw, loop_mask, matched_loop)
        return True

    # ------------------------------------------------------------------
    def _correct(self, kf_id, cand, S12, S_cw, loop_mask, matched_loop):
        """CorrectLoop (LoopClosing.cc:418-598): Sim3 propagation through the
        covis group, point correction, loop fusion, SearchAndFuse, essential
        graph, SE3 recovery (+ optional global BA)."""
        cfg = self.cfg
        t = self.tracker
        m = t.m
        K_ = m.max_kf

        W = covisibility_matrix(m)
        group = (W[kf_id] > 0) | (jnp.arange(K_) == kf_id)

        # --- propagate + correct points + fuse (one jit program) ----------
        m, S_old, S_corr = _propagate_and_fuse(
            m, jnp.asarray(kf_id), S_cw, group, loop_mask, matched_loop,
            t.K, t.scale_factors, t.sigma2, cfg,
        )

        # SearchAndFuse over the corrected group (LoopClosing.cc:600-626):
        # scan the group keyframes, loop points win every merge
        m = _search_and_fuse(
            m, group, loop_mask, t.K, t.scale_factors, t.sigma2, cfg
        )
        t.m = m

        # --- essential graph ----------------------------------------------
        Wnp = np.asarray(covisibility_matrix(m))
        kf_valid_np = np.asarray(m.kf_valid)
        parent_np = np.asarray(m.kf_parent)
        edges_i, edges_j = [], []
        for k in range(K_):
            if not kf_valid_np[k]:
                continue
            p = int(parent_np[k])
            if p >= 0 and kf_valid_np[p]:
                edges_i.append(k)
                edges_j.append(p)
        strong = np.argwhere(
            np.triu(Wnp, 1) >= cfg.loop.essential_min_covis_weight
        )
        for i, j in strong:
            edges_i.append(int(i))
            edges_j.append(int(j))
        # past loop edges (KeyFrame::mspLoopEdges, Optimizer.cc:905-922)
        past = [
            (i, j, S) for (i, j, S) in self.loop_edges
            if kf_valid_np[i] and kf_valid_np[j]
        ]
        E_base = len(edges_i)
        edge_i = jnp.asarray(
            edges_i + [i for i, _, _ in past] + [cand], jnp.int32
        )
        edge_j = jnp.asarray(
            edges_j + [j for _, j, _ in past] + [kf_id], jnp.int32
        )
        # measurements from PRE-correction poses (NonCorrectedSim3); loop
        # edges use their computed Sim3
        base_S = _relative_sim3(S_old, edge_i[:E_base], edge_j[:E_base])
        edge_S = jnp.concatenate(
            [base_S] + [S[None] for _, _, S in past] + [S12[None]]
        )
        edge_valid = jnp.ones(edge_i.shape[0], bool)

        fixed = jnp.zeros(K_, bool).at[cand].set(True)  # Optimizer.cc:840
        S_opt = optimize_pose_graph(
            S_corr, m.kf_valid, fixed, edge_i, edge_j, edge_S, edge_valid,
            n_iters=cfg.optim.essential_graph_iters,
            lambda_init=cfg.optim.essential_lambda_init,
            fix_scale=self.fix_scale,
        )

        # --- write back: SE3 poses + corrected points ----------------------
        T_new = jax.vmap(sim3.to_se3)(S_opt)
        T_new = jax.vmap(se3.orthonormalize)(T_new)
        mp_pos = correct_map_after_pose_graph(
            t.m.mp_pos, t.m.mp_valid, t.m.mp_first_kf, S_corr, S_opt
        )
        t.m = t.m.replace(
            kf_pose=jnp.where(m.kf_valid[:, None, None], T_new, m.kf_pose),
            mp_pos=mp_pos,
        )
        self.loop_edges.append((cand, kf_id, S12))
        # tracking continuity: refresh the cached last pose to the corrected
        # current keyframe
        t.last_Tcw = t.m.kf_pose[kf_id]
        t.velocity = None

        # --- concurrent global BA (RunGlobalBundleAdjustment thread,
        # src/LoopClosing.cc:658-758): enqueued as an async device program;
        # tracking keeps running and the result is adopted — with spanning-
        # tree propagation to keyframes/points created meanwhile — once the
        # device finishes (poll_global_ba, driven by System._pre_frame)
        if self.run_global_ba:
            # a GBA still running from a previous loop is superseded: its
            # remaining chunks are never issued (mbStopGBA,
            # src/LoopClosing.cc:429-442)
            self.discard_pending_gba()
            self._enqueue_global_ba(gauge_kf=cand)


# ---------------------------------------------------------------------------
# Jitted stage programs
# ---------------------------------------------------------------------------


@jax.jit
def _adopt_gba(m, ba_pose, cam_ids, ba_pts, point_ids, n_kf_snap):
    """Write a finished global BA into the CURRENT map with propagation to
    entities created while it ran (src/LoopClosing.cc:689-748):

    * keyframes in the BA take their optimized poses;
    * keyframes allocated after the snapshot chain through the spanning
      tree: T_child_new = (T_child_old · T_parent_old^-1) · T_parent_new
      (parents always have smaller slot ids, so one forward pass settles
      arbitrary chains);
    * points in the BA take their optimized positions; points created
      meanwhile move with their first observer's correction.
    """
    old_pose = m.kf_pose
    cam_w = jnp.where(cam_ids >= 0, cam_ids, m.max_kf)
    kf_pose = old_pose.at[cam_w].set(ba_pose, mode="drop")

    def chain(k, pose):
        parent = m.kf_parent[k]
        p = jnp.maximum(parent, 0)
        T_new = old_pose[k] @ se3.inv(old_pose[p]) @ pose[p]
        use = (k >= n_kf_snap) & (parent >= 0) & m.kf_valid[k]
        return pose.at[k].set(jnp.where(use, T_new, pose[k]))

    kf_pose = jax.lax.fori_loop(0, m.max_kf, chain, kf_pose)

    in_ba = jnp.zeros(m.max_mp, bool).at[
        jnp.where(point_ids >= 0, point_ids, m.max_mp)
    ].set(True, mode="drop")
    pt_w = jnp.where(point_ids >= 0, point_ids, m.max_mp)
    mp_pos = m.mp_pos.at[pt_w].set(ba_pts, mode="drop")
    # correction of the remaining points via their first observer
    ref = jnp.where(
        m.mp_obs_kf[:, 0] >= 0, m.mp_obs_kf[:, 0],
        jnp.maximum(m.mp_first_kf, 0),
    )
    ref = jnp.clip(ref, 0, m.max_kf - 1)
    corr_R = jax.vmap(lambda r: se3.inv(kf_pose[r]) @ old_pose[r])(ref)
    Xc = jax.vmap(se3.apply)(corr_R, m.mp_pos[:, None, :])[:, 0]
    need = m.mp_valid & ~in_ba
    mp_pos = jnp.where(need[:, None], Xc, mp_pos)
    return m.replace(kf_pose=kf_pose, mp_pos=mp_pos)


@partial(jax.jit, static_argnames=("n_levels", "fix_scale"))
def _sim3_from_matches(
    m, kf_id, cand, idx, K, inv_sigma2, key, n_levels, fix_scale=False
):
    """Gather matched 3D pairs in each camera frame and run the RANSAC Horn
    Sim3 solver (Sim3Solver, src/Sim3Solver.cc)."""
    ok = idx >= 0
    mp1 = jnp.maximum(m.kf_obs[kf_id], 0)
    mp2 = jnp.maximum(m.kf_obs[cand][jnp.maximum(idx, 0)], 0)
    X1 = se3.apply(m.kf_pose[kf_id], m.mp_pos[mp1])
    X2 = se3.apply(m.kf_pose[cand], m.mp_pos[mp2])
    uv1 = m.kf_xy[kf_id]
    uv2 = m.kf_xy[cand][jnp.maximum(idx, 0)]
    s2_1 = inv_sigma2[jnp.clip(m.kf_octave[kf_id], 0, n_levels - 1)]
    oct2 = m.kf_octave[cand][jnp.maximum(idx, 0)]
    s2_2 = inv_sigma2[jnp.clip(oct2, 0, n_levels - 1)]
    valid = (
        ok
        & (m.kf_obs[kf_id] >= 0)
        & m.mp_valid[mp1]
        & m.mp_valid[mp2]
    )
    return ransac_sim3(
        X1, X2, valid, uv1, uv2, s2_1, s2_2, K, key, fix_scale=fix_scale
    )


@partial(jax.jit, static_argnames=("n_levels", "fix_scale"))
def _refine_sim3_on_matches(
    m, kf_id, cand, idx, K, inv_sigma2, S12, chi2, n_levels, fix_scale=False
):
    ok = idx >= 0
    mp1 = jnp.maximum(m.kf_obs[kf_id], 0)
    mp2 = jnp.maximum(m.kf_obs[cand][jnp.maximum(idx, 0)], 0)
    X1 = se3.apply(m.kf_pose[kf_id], m.mp_pos[mp1])
    X2 = se3.apply(m.kf_pose[cand], m.mp_pos[mp2])
    uv1 = m.kf_xy[kf_id]
    uv2 = m.kf_xy[cand][jnp.maximum(idx, 0)]
    s2_1 = inv_sigma2[jnp.clip(m.kf_octave[kf_id], 0, n_levels - 1)]
    oct2 = m.kf_octave[cand][jnp.maximum(idx, 0)]
    s2_2 = inv_sigma2[jnp.clip(oct2, 0, n_levels - 1)]
    valid = (
        ok
        & (m.kf_obs[kf_id] >= 0)
        & m.mp_valid[mp1]
        & m.mp_valid[mp2]
    )
    return refine_sim3(
        S12, X1, X2, valid, uv1, uv2, s2_1, s2_2, K, chi2_th=chi2,
        fix_scale=fix_scale,
    )


@jax.jit
def search_by_sim3(m, kf1, kf2, S12, th, K, scale_factors, bounds):
    """ORBmatcher::SearchBySim3 (src/ORBmatcher.cc:1106-1328): project each
    keyframe's map points into the other through the Sim3 and keep mutual
    agreements. Returns idx (N,) feature-of-kf1 -> feature-of-kf2 (-1)."""
    L = scale_factors.shape[0]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def direction(src, dst, S_dc):
        """Project src's points into dst; per-src-feature best dst feature."""
        obs = m.kf_obs[src]
        has = (obs >= 0) & m.kf_feat_valid[src] & m.mp_valid[jnp.maximum(obs, 0)]
        mp = jnp.maximum(obs, 0)
        S_dw = S_dc @ sim3.from_se3(m.kf_pose[src])
        Pc = sim3.apply(S_dw, m.mp_pos[mp])
        z = Pc[:, 2]
        zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = fx * Pc[:, 0] / zs + cx
        v = fy * Pc[:, 1] / zs + cy
        dist3 = jnp.linalg.norm(Pc, axis=1)
        okp = (
            has & (z > 0)
            & (dist3 >= 0.8 * m.mp_min_dist[mp])
            & (dist3 <= 1.2 * m.mp_max_dist[mp])
            & (u >= bounds[0]) & (u < bounds[1])
            & (v >= bounds[2]) & (v < bounds[3])
        )
        pred = predict_octave(dist3, m.mp_max_dist[mp], scale_factors[1], L)
        win = th * scale_factors[jnp.clip(pred, 0, L - 1)]
        xy = m.kf_xy[dst]
        pair = (
            (jnp.abs(xy[None, :, 0] - u[:, None]) < win[:, None])
            & (jnp.abs(xy[None, :, 1] - v[:, None]) < win[:, None])
            & (m.kf_octave[dst][None, :] >= (pred - 1)[:, None])
            & (m.kf_octave[dst][None, :] <= pred[:, None])
        )
        dist = hamming.masked_distance_matrix(
            m.mp_desc[mp], m.kf_desc[dst], okp, m.kf_feat_valid[dst], pair
        )
        fidx, best, _ = hamming.best_and_second(dist)
        good = okp & (best <= matcher.TH_HIGH)
        return jnp.where(good, fidx, -1)

    # S12 maps cam2 coords -> cam1 coords: project kf2's points into kf1
    # through S12 and kf1's into kf2 through S21.
    fwd = direction(kf2, kf1, S12)
    bwd = direction(kf1, kf2, sim3.inv(S12))

    # mutual agreement: feature f1 of kf1 matched by kf2's point-row r2
    # (fwd[r2] = f1) and kf1's point-row f1 matched bwd to kf2 feature f2
    # with kf2's row r2 owning f2.
    n = m.n_feat
    # map kf2 feature -> its row index (rows of fwd are kf2 features too)
    f1_of_r2 = fwd                       # (N,) kf2 feature r2 -> kf1 feature
    f2_of_f1 = bwd                       # (N,) kf1 feature -> kf2 feature
    agree = jnp.zeros(n, jnp.int32) - 1
    r2 = jnp.arange(n)
    tgt = jnp.where(f1_of_r2 >= 0, f1_of_r2, n)
    agree = agree.at[tgt].set(r2.astype(jnp.int32), mode="drop")
    # kf1 feature f1 agrees if bwd maps it back to the same kf2 feature
    mutual = (agree >= 0) & (f2_of_f1 == agree) & (f2_of_f1 >= 0)
    return jnp.where(mutual, agree, -1)


@jax.jit
def _points_of_group(m, group_mask):
    """(M,) mask of map points observed by any keyframe in the group."""
    flat = jnp.where((group_mask & m.kf_valid)[:, None], m.kf_obs, -1).reshape(-1)
    return (
        jnp.zeros(m.max_mp, bool)
        .at[jnp.where(flat >= 0, flat, m.max_mp)]
        .set(True, mode="drop")
        & m.mp_valid
    )


@jax.jit
def _project_loop_points(m, kf, S_cw, loop_mask, th, K, scale_factors, bounds):
    """SearchByProjection with a Sim3 world->camera (ORBmatcher.cc:294-407):
    match loop-region points against the current keyframe's features.
    Returns (N,) loop map-point id per feature (-1 = none); features that
    already hold a loop match keep it (the reference skips matched ones)."""
    L = scale_factors.shape[0]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    M = m.max_mp
    # candidates capped to the feature budget for fixed shapes
    sel = jnp.where(loop_mask, m.mp_n_obs, -1)
    vals, pid = jax.lax.top_k(sel, min(4096, M))
    okp = vals >= 0
    pid = jnp.maximum(pid, 0)
    Pc = sim3.apply(S_cw, m.mp_pos[pid])
    z = Pc[:, 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = fx * Pc[:, 0] / zs + cx
    v = fy * Pc[:, 1] / zs + cy
    dist3 = jnp.linalg.norm(Pc, axis=1)
    okp = (
        okp & (z > 0)
        & (dist3 >= 0.8 * m.mp_min_dist[pid])
        & (dist3 <= 1.2 * m.mp_max_dist[pid])
        & (u >= bounds[0]) & (u < bounds[1])
        & (v >= bounds[2]) & (v < bounds[3])
    )
    pred = predict_octave(dist3, m.mp_max_dist[pid], scale_factors[1], L)
    win = th * scale_factors[jnp.clip(pred, 0, L - 1)]
    xy = m.kf_xy[kf]
    pair = (
        (jnp.abs(xy[None, :, 0] - u[:, None]) < win[:, None])
        & (jnp.abs(xy[None, :, 1] - v[:, None]) < win[:, None])
        & (m.kf_octave[kf][None, :] >= (pred - 1)[:, None])
        & (m.kf_octave[kf][None, :] <= (pred + 1)[:, None])
    )
    dist = hamming.masked_distance_matrix(
        m.mp_desc[pid], m.kf_desc[kf], okp, m.kf_feat_valid[kf], pair
    )
    fidx, best, _ = hamming.best_and_second(dist)
    ok = okp & (best <= matcher.TH_LOW)
    ok = ok & matcher._column_unique_best(fidx, best, ok, m.n_feat)
    out = jnp.full(m.n_feat, -1, jnp.int32)
    out = out.at[jnp.where(ok, jnp.maximum(fidx, 0), m.n_feat)].set(
        jnp.where(ok, pid, -1), mode="drop"
    )
    # keep features whose existing point is already a loop point
    cur = m.kf_obs[kf]
    already = (cur >= 0) & loop_mask[jnp.maximum(cur, 0)]
    return jnp.where(already, cur, out)


@jax.jit
def _relative_sim3(S_poses, edge_i, edge_j):
    """S_ji = S_j · S_i^-1 for every edge, from (K,4,4) Sim3 poses."""
    return jax.vmap(
        lambda i, j: sim3.compose(S_poses[j], sim3.inv(S_poses[i]))
    )(edge_i, edge_j)


@partial(jax.jit, static_argnames=("cfg",))
def _propagate_and_fuse(
    m, kf, S_cw, group_mask, loop_mask, matched_loop, K, scale_factors,
    sigma2, cfg,
):
    """CorrectLoop's pose propagation + point correction + loop-point
    replacement (LoopClosing.cc:456-556) as one program.

    Returns (map, S_old (K,4,4) Sim3 pre-correction, S_corr corrected)."""
    K_ = m.max_kf
    S_old = jax.vmap(sim3.from_se3)(m.kf_pose)
    T_c_inv = se3.inv(m.kf_pose[kf])

    def per(i):
        T_ic = m.kf_pose[i] @ T_c_inv
        return sim3.compose(sim3.from_se3(T_ic), S_cw)

    S_prop = jax.vmap(per)(jnp.arange(K_))
    grp = group_mask & m.kf_valid
    S_corr = jnp.where(grp[:, None, None], S_prop, S_old)

    # correct points observed by group keyframes with their first group
    # observer's transform: X' = S_corr^-1 · S_old · X (LoopClosing.cc:480-505)
    obs_in_grp = (m.mp_obs_kf >= 0) & grp[jnp.maximum(m.mp_obs_kf, 0)]
    first = jnp.where(
        obs_in_grp, m.mp_obs_kf, K_
    ).min(axis=1)
    has_ref = (first < K_) & m.mp_valid
    ref = jnp.clip(first, 0, K_ - 1)
    corr = jax.vmap(lambda a, b: sim3.compose(sim3.inv(a), b))(S_corr, S_old)
    Xc = jax.vmap(lambda T, x: sim3.apply(T, x))(corr[ref], m.mp_pos)
    mp_pos = jnp.where(has_ref[:, None], Xc, m.mp_pos)

    # write corrected SE3 poses for group keyframes
    T_corr = jax.vmap(sim3.to_se3)(S_corr)
    T_corr = jax.vmap(se3.orthonormalize)(T_corr)
    kf_pose = jnp.where(grp[:, None, None], T_corr, m.kf_pose)
    m = m.replace(mp_pos=mp_pos, kf_pose=kf_pose)

    # loop fusion: replace the current KF's matched points with the loop
    # points (loop point wins — LoopClosing.cc:540-556)
    p = matched_loop                       # (N,) loop point per feature
    q = m.kf_obs[kf]
    okm = (p >= 0) & m.mp_valid[jnp.maximum(p, 0)]
    add = okm & (q < 0)
    kf_row = m.kf_obs[kf].at[jnp.where(add, jnp.arange(m.n_feat), m.n_feat)].set(
        jnp.where(add, p, -1), mode="drop"
    )
    m = m.replace(kf_obs=m.kf_obs.at[kf].set(kf_row))
    merge = okm & (q >= 0) & (q != p) & m.mp_valid[jnp.maximum(q, 0)]
    Mx = m.max_mp
    loser = jnp.maximum(q, 0)
    winner = jnp.maximum(p, 0)
    r = jnp.arange(Mx, dtype=jnp.int32).at[
        jnp.where(merge, loser, Mx)
    ].set(jnp.where(merge, winner, -1), mode="drop")
    r = r[r]
    kf_obs = jnp.where(m.kf_obs >= 0, r[jnp.maximum(m.kf_obs, 0)], m.kf_obs)
    mp_valid = m.mp_valid.at[jnp.where(merge, loser, Mx)].set(False, mode="drop")
    lw = jnp.where(merge, winner, Mx)
    m = m.replace(
        kf_obs=kf_obs,
        mp_valid=mp_valid,
        mp_found=m.mp_found.at[lw].add(
            jnp.where(merge, m.mp_found[loser], 0), mode="drop"
        ),
        mp_visible=m.mp_visible.at[lw].add(
            jnp.where(merge, m.mp_visible[loser], 0), mode="drop"
        ),
    )
    m = mt.rebuild_observation_lists(m)
    return m, S_old, S_corr


@partial(jax.jit, static_argnames=("cfg", "max_targets"))
def _search_and_fuse(
    m, group_mask, loop_mask, K, scale_factors, sigma2, cfg, max_targets=24
):
    """LoopClosing::SearchAndFuse (LoopClosing.cc:600-626): project the loop
    points into the corrected group keyframes with th=4; the loop point
    wins every merge. The scan covers only the group (the reference passes
    mvpCurrentConnectedKFs, typically <20 keyframes), most-recent first —
    not all keyframe slots."""
    inv_s2 = 1.0 / sigma2

    # top-k group members by recency (kf_frame_id >= 0 for allocated slots)
    sel = jnp.where(group_mask & m.kf_valid, m.kf_frame_id + 1, -1)
    vals, targets = jax.lax.top_k(sel, min(max_targets, m.max_kf))
    t_ok = vals > 0
    targets = jnp.maximum(targets, 0)

    def step(m, tv):
        k, ok = tv
        m2 = _fuse_points_into_kf(
            m, loop_mask & m.mp_valid, k, K, scale_factors, inv_s2, cfg,
            max_points=cfg.capacity.local_ba_points,
            window_mult=4.0, prefer_src=True,
        )
        m = jax.tree.map(lambda a, b: jnp.where(ok, a, b), m2, m)
        return m, None

    m, _ = jax.lax.scan(step, m, (targets, t_ok))
    return mt.rebuild_observation_lists(m)
