"""System facade: the public entry point of the SLAM engine.

JAX replacement for ``ORB_SLAM2::System``
(jni/ORB_SLAM2/src/System.cc, include/System.h:63-117): construction wires
tracking + local mapping (+ loop closing when enabled), ``track_monocular``
is the per-frame entry, and the save_trajectory_* methods write the same
TUM/KITTI formats as SaveTrajectoryTUM/KITTI (src/System.cc:401-541).

The reference spawns three std::threads and coordinates them with
stop/finish/reset flags; here the pipeline runs the mapping pass
synchronously after each keyframe insertion (deterministic, testable) —
asynchronous multi-stage execution is the distribution story
(parallel/, SURVEY.md §2.4 "pipelined keyframe dataflow").
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..geometry.camera import Camera
from ..geometry.se3 import inv as se3_inv
from ..io import trajectory as traj_io
from .local_mapping import mapping_finish, mapping_pre, mapping_step
from .tracker import Tracker, TrackerOutput

# The whole local-mapping pass is ONE jit program per (cfg, n_neighbors):
# one launch per keyframe instead of hundreds of eager op dispatches.
_mapping_step_jit = jax.jit(
    mapping_step,
    static_argnames=("cfg", "n_neighbors", "run_ba", "run_culling"),
)

# Staged (abortable) pipeline: structure pass, then BA in separate chunk
# programs, then write-back — the host stops issuing chunks to abort
# (mbAbortBA, src/LocalMapping.cc:127,681-684).
_mapping_pre_jit = jax.jit(
    mapping_pre,
    static_argnames=("cfg", "n_neighbors", "run_ba", "run_culling"),
)
_mapping_finish_jit = jax.jit(
    mapping_finish, static_argnames=("cfg", "run_culling")
)


def _ready(x) -> bool:
    """True when an async device pytree has resolved. All outputs of one
    program complete together, so the first leaf's readiness suffices."""
    for leaf in jax.tree.leaves(x):
        if hasattr(leaf, "is_ready"):
            return leaf.is_ready()
    return True


@jax.jit
def _apply_counter_deltas(m, cur_visible, cur_found, snap_visible, snap_found):
    """Carry tracking's visible/found increments across a mapping adoption.
    Slot semantics are stable across a pass (point ids are never reused), so
    an elementwise delta is exact for surviving points; counters merged into
    a Replace winner during the pass keep the winner's merged totals."""
    return m.replace(
        mp_visible=m.mp_visible + (cur_visible - snap_visible),
        mp_found=m.mp_found + (cur_found - snap_found),
    )


class System:
    def __init__(
        self,
        cfg: Optional[SlamConfig] = None,
        camera: Optional[Camera] = None,
        enable_mapping: bool = True,
        enable_loop_closing: bool = False,
        mapping_neighbors: int | None = None,
        mapping_device: Optional[jax.Device] = None,
    ):
        """mapping_device: run the local-mapping stage on a different chip
        (pipeline parallelism — the tracking chip keeps the per-frame hot
        path while the mapper chip does triangulation/fuse/BA; the map
        snapshot is transferred per keyframe and the result adopted back).
        None = same device (the mapping pass still overlaps via the async
        adoption protocol)."""
        self.cfg = cfg or SlamConfig()
        cc = self.cfg.camera
        self.camera = camera or Camera.create(
            cc.fx, cc.fy, cc.cx, cc.cy, cc.k1, cc.k2, cc.p1, cc.p2, cc.k3,
            width=cc.width, height=cc.height,
        )
        self.tracker = Tracker(self.cfg, self.camera)
        self.enable_mapping = enable_mapping
        self.enable_loop_closing = enable_loop_closing
        # nn=20 covisible neighbors for triangulation (LocalMapping.cc:224)
        self.mapping_neighbors = (
            mapping_neighbors
            if mapping_neighbors is not None
            else self.cfg.mapping.triangulation_neighbors
        )
        self.loop_closer = None
        if enable_loop_closing:
            from .loop_closing import LoopCloser

            self.loop_closer = LoopCloser(self.cfg, self.tracker)
        if enable_mapping:
            self.tracker.mapping_hook = self._on_new_keyframe
            self.tracker.mapper_idle_hook = self.mapper_idle
        self.tracker.reset_hook = self._discard_pending
        self.localization_only = False
        self.mapping_device = mapping_device
        # in-flight asynchronous mapping pass: (pending map pytree, kf_id)
        self._pending_map = None
        self._pending_kf = -1
        self._pending_counters = None
        self._mapping_enqueued_frame = -(10**9)
        # staged (abortable) pass state + chunk accounting (observable by
        # tests: a forced insertion mid-BA must leave chunks unissued)
        self._stage = None
        self.ba_chunks_issued = 0
        self.ba_chunks_aborted = 0

    # ------------------------------------------------------------------
    # Pipelined dataflow: the analogue of the reference's LocalMapping
    # thread + keyframe queue (src/System.cc:156, src/LocalMapping.cc:50-137).
    # mapping_step is enqueued on the device WITHOUT blocking; tracking keeps
    # running on the previous (immutable) map snapshot, and the result is
    # adopted once the device finishes. NeedNewKeyFrame's c1b "local mapper
    # idle" condition (src/Tracking.cc:1267) maps onto "no mapping in
    # flight" — exactly the throttle the reference's thread provides.
    # ------------------------------------------------------------------
    def _discard_pending(self):
        """Drop any in-flight async mapping pass (registered as the tracker's
        reset_hook): adopting a pass computed from a pre-reset snapshot would
        resurrect old keyframes into a session whose host mirrors
        (n_kf_host, ref_kf, BoW index) have restarted from zero."""
        self._pending_map = None
        self._pending_kf = -1
        self._pending_counters = None
        self._stage = None
        if self.loop_closer is not None:
            self.loop_closer.discard_pending_gba()

    def _on_new_keyframe(self, kf_id: int):
        if self.localization_only:
            return
        t = self.tracker
        args = (
            t.m, jnp.asarray(kf_id), t.K, t.scale_factors, t.sigma2,
            t.inv_sigma2,
        )
        if self.mapping_device is not None:
            # pipeline parallelism: ship the snapshot to the mapper chip
            args = jax.device_put(args, self.mapping_device)
        if self.cfg.tracking.abortable_ba:
            # staged pipeline: structure pass now; BA chunks are issued from
            # subsequent polls (and skipped entirely when a forced insertion
            # aborts — the mbAbortBA analogue, src/LocalMapping.cc:127)
            m2, prob, cam_ids, point_ids = _mapping_pre_jit(
                *args, self.cfg, n_neighbors=self.mapping_neighbors,
            )
            self._stage = dict(
                name="pre", kf=kf_id, m=m2, prob=prob,
                cam_ids=cam_ids, point_ids=point_ids,
                ba_state=None, chunks_left=self._n_ba_chunks,
            )
            self._pending_map = None
        else:
            self._pending_map = _mapping_step_jit(
                *args, self.cfg, n_neighbors=self.mapping_neighbors,
            )
            self._stage = None
        self._pending_kf = kf_id
        # snapshot of the found/visible counters at enqueue time: tracking
        # keeps incrementing them while the pass is in flight, and adoption
        # must not lose those increments (IncreaseVisible/IncreaseFound feed
        # the 0.25 found-ratio culling gate — src/LocalMapping.cc:190)
        self._pending_counters = (t.m.mp_visible, t.m.mp_found)
        self._mapping_enqueued_frame = t.frame_id

    # -- staged-BA scheduler -------------------------------------------
    @property
    def _n_ba_chunks(self) -> int:
        o = self.cfg.optim
        per = max(self.cfg.tracking.ba_chunk_iters, 1)
        return -(-o.local_ba_iters2 // per)  # ceil

    def _advance_stage(self, abort: bool = False, eager: bool = False) -> bool:
        """Advance the staged mapping pass by launching the next device
        program once the current one resolved. abort=True skips every
        remaining BA chunk and finalizes from the best-so-far state
        (mbAbortBA); eager=True launches the next program without waiting
        for readiness (device queues are FIFO, so a blocking drain can chain
        everything and wait once). Returns True when the final map future is
        in self._pending_map."""
        from ..optim.local_ba import (
            BA_LAMBDA_INIT, ba_finalize, ba_phase1, ba_phase2_chunk,
        )

        s = self._stage
        if s is None:
            return self._pending_map is not None
        cfg = self.cfg
        if s["name"] == "pre":
            if not (abort or eager or _ready(s["m"])):
                return False
            if abort or s["prob"] is None:
                # fully aborted before BA started: write-back skipped
                self.ba_chunks_aborted += s["chunks_left"] + 1
                self._pending_map = _mapping_finish_jit(
                    s["m"], jnp.asarray(s["kf"]), None, None, None, None,
                    cfg,
                )
                self._stage = None
                return True
            s["ba_state"] = ba_phase1(
                s["prob"], n_iters=cfg.optim.local_ba_iters1,
            )
            s["name"] = "ba"
            self.ba_chunks_issued += 1
            return False
        if s["name"] == "ba":
            if not (abort or eager or _ready(s["ba_state"])):
                return False
            cam_pose, points, lam, inlier = s["ba_state"]
            if not abort and s["chunks_left"] > 0:
                s["ba_state"] = (
                    *ba_phase2_chunk(
                        s["prob"], cam_pose, points,
                        jnp.asarray(BA_LAMBDA_INIT)
                        if s["chunks_left"] == self._n_ba_chunks else lam,
                        inlier, n_iters=cfg.tracking.ba_chunk_iters,
                    ),
                    inlier,
                )
                s["chunks_left"] -= 1
                self.ba_chunks_issued += 1
                return False
            # done (or aborted mid-BA): finalize best-so-far + write back
            self.ba_chunks_aborted += s["chunks_left"] if abort else 0
            res = ba_finalize(s["prob"], cam_pose, points)
            self._pending_map = _mapping_finish_jit(
                s["m"], jnp.asarray(s["kf"]), res, s["prob"],
                s["cam_ids"], s["point_ids"], cfg,
            )
            self._stage = None
            return True
        raise AssertionError(s["name"])

    def mapper_idle(self, force: bool = False, abort: bool = False) -> bool:
        """Adopt a finished mapping pass; True when no pass is in flight.
        force=True blocks until the pass is adopted. abort=True additionally
        skips every not-yet-issued BA chunk, adopting the best-so-far BA
        state — the InterruptBA analogue for forced keyframe insertion
        (src/Tracking.cc:1287-1303, src/LocalMapping.cc:127,681-684);
        force without abort (finish/shutdown) drains the FULL schedule."""
        chained = False
        if self._stage is not None:
            if abort:
                self._advance_stage(abort=True)
            elif force or (
                self.tracker.frame_id - self._mapping_enqueued_frame
                >= self.cfg.tracking.mapping_latency_frames
            ):
                # the mapper has had its latency budget (or a blocking
                # drain): chain every remaining stage now — device queues
                # are FIFO, so this reproduces the fused pass's turnaround;
                # abortability covers the polls BEFORE the floor, which is
                # when c1c forced insertions actually fire
                while self._stage is not None:
                    self._advance_stage(eager=True)
                chained = True
            else:
                # advance lazily: launch the next stage only once its
                # predecessor resolved, keeping later chunks unissued so a
                # forced insertion can still abort them
                progressed = True
                while self._stage is not None and progressed:
                    before = (
                        self._stage["name"], self._stage["chunks_left"],
                    )
                    self._advance_stage()
                    progressed = (
                        self._stage is not None
                        and (self._stage["name"], self._stage["chunks_left"])
                        != before
                    )
        if self._pending_map is None:
            return self._stage is None
        # frame-based latency floor: the per-frame scalar sync drains the
        # device queue (so is_ready alone would report idle immediately);
        # this models the reference mapper's multi-frame turnaround
        busy_frames = self.tracker.frame_id - self._mapping_enqueued_frame
        if not force and busy_frames < self.cfg.tracking.mapping_latency_frames:
            return False
        # `chained`: the staged schedule was fully issued this poll because
        # the floor already expired — adopt now (the swap is an async pytree
        # exchange; device FIFO ordering keeps every consumer correct), so
        # staged and fused pipelines share the same adoption frame
        if not (force or chained or self._pending_map.kf_pose.is_ready()):
            return False
        # resolve pipelined tracked frames BEFORE swapping the map: a late
        # keyframe decision must freeze into the map those frames were
        # tracked on. The resolution itself may re-enter this method (idle
        # check inside NeedNewKeyFrame), adopt this pass, and enqueue a new
        # one — re-check the token instead of adopting a stale reference.
        kf_token = self._pending_kf
        self.tracker.flush_pending()
        if self._pending_kf != kf_token:
            return self._pending_map is None and self._stage is None
        m = self._pending_map
        kf_id = self._pending_kf
        snap_counters = self._pending_counters
        self._pending_map = None
        self._pending_kf = -1
        self._pending_counters = None
        t = self.tracker
        if self.mapping_device is not None:
            # back to the tracking map's device
            m = jax.device_put(m, t.m.kf_pose.devices().pop())
        # re-apply the visible/found counter increments tracking recorded
        # while the pass was in flight (the adopted map was computed from the
        # enqueue-time snapshot; dropping the deltas would undercount the
        # IncreaseVisible/IncreaseFound statistics feeding found-ratio culling)
        if snap_counters is not None:
            m = _apply_counter_deltas(
                m, t.m.mp_visible, t.m.mp_found,
                snap_counters[0], snap_counters[1],
            )
        prev_kf_valid = t.m.kf_valid
        t.m = m
        self._reanchor_culled_trajectory(prev_kf_valid)
        # mapping may have adjusted poses: refresh the cached last pose when
        # the tracker is still referencing the mapped keyframe AND no newer
        # frame pose has been chained since (pipelined mode advances
        # last_Tcw past the keyframe)
        if t.ref_kf == kf_id and t.last_kf_frame == t.frame_id:
            t.last_Tcw = t.m.kf_pose[kf_id]
        if self.loop_closer is not None:
            self.loop_closer.on_keyframe(kf_id)
        return True

    def _reanchor_culled_trajectory(self, prev_kf_valid) -> None:
        """Re-anchor trajectory entries whose reference keyframe was culled
        by the just-adopted mapping pass: rewrite (T_cr, ref) to the first
        SURVIVING spanning-tree ancestor via the relative pose at cull time
        — the mTcp mechanism of KeyFrame::SetBadFlag (src/KeyFrame.cc:
        460-552), consumed by trajectory export (src/System.cc:435-442).
        Unlike baking to an absolute pose, the re-anchored entries keep
        receiving every later loop/GBA correction through their new parent.
        The exported pose is unchanged at re-anchor time:
        T_cr' @ T_p == (T_cr @ T_c @ T_p^-1) @ T_p == T_cr @ T_c."""
        t = self.tracker
        if not t.trajectory:
            return
        m = t.m
        culled = np.flatnonzero(
            np.asarray(prev_kf_valid & ~m.kf_valid)
        )
        if culled.size == 0:
            return
        valid_np = np.asarray(m.kf_valid)
        parent_np = np.asarray(m.kf_parent)
        from ..geometry import se3

        for c in culled.tolist():
            p = int(parent_np[c])
            hops = 0
            while p >= 0 and not valid_np[p] and hops < len(parent_np):
                p = int(parent_np[p])
                hops += 1
            if p >= 0 and valid_np[p]:
                # culled poses stay readable in their slot until compaction
                T_cp = m.kf_pose[c] @ se3.inv(m.kf_pose[p])
                new_ref = p
            else:
                T_cp = m.kf_pose[c]  # no surviving ancestor: bake absolute
                new_ref = -1
            from .tracker import _mat

            for i, (ts, T_cr, ref) in enumerate(t.trajectory):
                if ref == c:
                    t.trajectory[i] = (ts, _mat(T_cr) @ T_cp, new_ref)
            # in-flight pipelined records recorded this slot as their anchor:
            # remap them at resolution time (tracker.culled_remap); chain
            # earlier remaps that pointed AT the newly culled slot
            for k, (T_prev, r_prev) in list(t.culled_remap.items()):
                if r_prev == c:
                    t.culled_remap[k] = (T_prev @ T_cp, new_ref)
            t.culled_remap[c] = (T_cp, new_ref)
            if t.ref_kf == c and new_ref >= 0:
                t.ref_kf = new_ref

    def finish(self):
        """Drain the pipeline (System::Shutdown analogue,
        src/System.cc:382-399): resolve any pipelined tracked frames and
        block until any in-flight mapping pass AND any concurrent global BA
        are adopted. Call before map export/eval."""
        self.tracker.flush_pending()
        self.mapper_idle(force=True)
        if self.loop_closer is not None:
            self.loop_closer.poll_global_ba(force=True)

    # ------------------------------------------------------------------
    def compact(self):
        """Re-pack valid keyframes/points to the front of the fixed-capacity
        pools and remap every reference (slam_map/compaction.py) — lets
        arbitrarily long sequences run inside XLA's static shapes. Invoked
        automatically when the keyframe pool is nearly exhausted."""
        self.finish()
        from ..slam_map.compaction import compact_map

        t = self.tracker
        m_old = t.m
        m2, kf_map, mp_map = compact_map(m_old)
        kf_map_np = np.asarray(kf_map)

        # trajectory anchors: entries whose keyframe was dropped are baked
        # into absolute poses (ref = -1); survivors are renumbered
        if t.trajectory:
            T_cr = t._traj_stack()
            refs = np.asarray([r for _, _, r in t.trajectory])
            refs_safe = np.maximum(refs, 0)
            culled_now = (refs >= 0) & (kf_map_np[refs_safe] < 0)
            baked = jnp.where(
                jnp.asarray(culled_now)[:, None, None],
                T_cr @ m_old.kf_pose[jnp.asarray(refs_safe)],
                T_cr,
            )
            new_refs = np.where(refs >= 0, kf_map_np[refs_safe], -1)
            new_refs = np.where(culled_now, -1, new_refs)
            t.trajectory = [
                (ts, baked[i], int(new_refs[i]))
                for i, (ts, _, _) in enumerate(t.trajectory)
            ]

        t.m = m2
        t.n_kf_host = int(kf_map_np.max()) + 1 if (kf_map_np >= 0).any() else 0
        rk = int(kf_map_np[t.ref_kf]) if 0 <= t.ref_kf < len(kf_map_np) else -1
        t.ref_kf = rk if rk >= 0 else max(t.n_kf_host - 1, 0)
        if t.last_obs is not None:
            t.last_obs = jnp.where(
                t.last_obs >= 0, mp_map[jnp.maximum(t.last_obs, 0)], -1
            )
        # the pipeline was drained by finish(): no in-flight records can
        # reference pre-compaction slots, so the remap table resets
        t.culled_remap.clear()
        t.bow.permute(kf_map)
        if self.loop_closer is not None:
            lc = self.loop_closer
            lc.consistency_counts.clear()
            if lc.last_loop_kf >= 0:
                lc.last_loop_kf = int(kf_map_np[lc.last_loop_kf])
            lc.loop_edges = [
                (int(kf_map_np[i]), int(kf_map_np[j]), S)
                for (i, j, S) in lc.loop_edges
                if kf_map_np[i] >= 0 and kf_map_np[j] >= 0
            ]

    # ------------------------------------------------------------------
    def _pre_frame(self):
        self.mapper_idle()  # adopt a finished mapping pass, never blocks
        # adopt a finished concurrent global BA — only while no mapping pass
        # is in flight (the pass's snapshot predates the BA adoption and
        # would overwrite its corrections)
        if (
            self.loop_closer is not None
            and self._pending_map is None
            and self._stage is None
        ):
            self.loop_closer.poll_global_ba()
        # keyframe pool nearly exhausted -> compact (ids are never reused,
        # so long sequences outgrow the static pool even after culling).
        # Only worth the pipeline drain + full-map permutation when culling
        # actually freed slots; otherwise keyframe insertion just stays
        # blocked (_need_new_keyframe checks n_kf_host) until culls land.
        t = self.tracker
        if t.n_kf_host >= t.m.max_kf - 2:
            reclaimable = t.n_kf_host - int(t.m.kf_valid.sum())
            if reclaimable >= 2:
                self.compact()

    def track_monocular(self, image: np.ndarray, timestamp: float) -> TrackerOutput:
        """Per-frame entry (System::TrackMonocular, src/System.cc:307-361).
        image: (H, W) grayscale float or uint8."""
        self._pre_frame()
        img = (
            image
            if getattr(image, "dtype", None) == np.uint8
            else np.asarray(image, dtype=np.float32)
        )
        return self.tracker.process_frame(img, timestamp)

    def track_rgbd(
        self, image: np.ndarray, depth: np.ndarray, timestamp: float
    ) -> TrackerOutput:
        """RGB-D entry (System::TrackRGBD, src/System.cc:260-305):
        depth-based initialization + depth-backed new map points."""
        self._pre_frame()
        return self.tracker.process_frame(
            image
            if getattr(image, "dtype", None) == np.uint8
            else np.asarray(image, np.float32),
            timestamp,
            depth=np.asarray(depth, np.float32),
        )

    def track_stereo(
        self, left: np.ndarray, right: np.ndarray, timestamp: float
    ) -> TrackerOutput:
        """Stereo entry (System::TrackStereo, src/System.cc:215-258):
        row-banded stereo matching supplies per-feature depth. uint8 frames
        ship as-is (4x fewer host->device bytes); device programs cast."""
        self._pre_frame()
        u8 = lambda a: (  # noqa: E731
            a if getattr(a, "dtype", None) == np.uint8
            else np.asarray(a, np.float32)
        )
        return self.tracker.process_frame(
            u8(left), timestamp, image_right=u8(right),
        )

    def activate_localization_mode(self):
        """Tracking-only mode (System::ActivateLocalizationMode,
        src/System.cc:364)."""
        self.localization_only = True
        self.tracker.allow_keyframes = False

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.tracker.allow_keyframes = True

    def reset(self):
        """System::Reset (src/System.cc:375)."""
        self._discard_pending()
        self.tracker.reset()
        self.tracker.trajectory.clear()
        self.tracker.frame_id = -1

    # ------------------------------------------------------------------
    def distributed_gba(self, mesh=None, axis: str = "ba", iters=None):
        """Full-map global bundle adjustment SHARDED over a device mesh and
        adopted into the live session — the multi-chip form of
        LoopClosing::RunGlobalBundleAdjustment (src/LoopClosing.cc:658-758).
        Points (and their observation planes) are partitioned across the
        mesh axis; each device accumulates its shard's normal equations and
        the reduced camera system is psum'd across the mesh
        (parallel/sharded_ba.py). mesh=None builds a 1-axis mesh over all
        visible devices. Drains the pipeline first; returns the BAResult
        (final_cost is the replicated global robust cost)."""
        from ..optim.ba_extract import extract_global_ba
        from ..parallel.sharded_ba import (
            make_ba_mesh, shard_problem, solve_ba_sharded,
        )
        from ..slam_map.point_stats import refresh_point_stats
        from .loop_closing import _adopt_gba

        self.finish()
        t = self.tracker
        if mesh is None:
            mesh = make_ba_mesh(axis=axis)
        n_iters = iters if iters is not None else self.cfg.optim.global_ba_iters
        gauge = int(np.flatnonzero(np.asarray(t.m.kf_valid))[0])
        prob, cam_ids, point_ids = extract_global_ba(
            t.m, t.K, t.inv_sigma2, gauge_kf=gauge,
            bf=self.cfg.camera.baseline_times_fx,
        )
        prob_s = shard_problem(prob, mesh, axis)
        res = solve_ba_sharded(
            prob_s, mesh, iters1=5, iters2=max(n_iters - 5, 1), axis=axis,
        )
        # gather the sharded outputs back to the session's device before
        # adoption (the map pytree is single-device)
        dev = t.m.kf_pose.devices().pop()
        cam_pose = jax.device_put(np.asarray(res.cam_pose), dev)
        points = jax.device_put(np.asarray(res.points), dev)
        old_ref_pose = t.m.kf_pose[t.ref_kf]
        t.m = _adopt_gba(
            t.m, cam_pose, cam_ids, points, point_ids,
            jnp.asarray(t.n_kf_host, jnp.int32),
        )
        t.m = refresh_point_stats(t.m, t.scale_factors)
        if t.last_Tcw is not None:
            t.last_Tcw = (
                t.last_Tcw @ se3_inv(old_ref_pose) @ t.m.kf_pose[t.ref_kf]
            )
        t.velocity = None
        return res

    # ------------------------------------------------------------------
    def save_map(self, path: str):
        """Checkpoint the full map state (the reference's unimplemented
        SaveMap TODO — include/System.h:119-121)."""
        from ..slam_map.checkpoint import save_map

        save_map(path, self.map)

    def load_map(self, path: str):
        """Load a checkpointed map and restore a live session around it
        (host mirrors, BoW database, reference keyframe). The session enters
        LOST and relocalizes on the next tracked frame; combine with
        activate_localization_mode() for pure localization against the map."""
        from ..slam_map.checkpoint import load_map

        self.finish()
        m, _extra = load_map(path)
        self.tracker.load_map(m)

    # ------------------------------------------------------------------
    @property
    def map(self):
        self.finish()  # external views see a drained pipeline
        return self.tracker.m

    def n_keyframes(self) -> int:
        return int(self.map.kf_valid.sum())

    def n_map_points(self) -> int:
        return int(self.map.mp_valid.sum())

    # ------------------------------------------------------------------
    def save_trajectory_tum(self, path: str):
        self.finish()
        ts, Twc = self.tracker.trajectory_Twc()
        traj_io.save_tum(path, ts, Twc)

    def save_trajectory_kitti(self, path: str):
        self.finish()
        _, Twc = self.tracker.trajectory_Twc()
        traj_io.save_kitti(path, Twc)

    def save_keyframe_trajectory_tum(self, path: str):
        """Keyframe-only export (SaveKeyFrameTrajectoryTUM,
        src/System.cc:457-491)."""
        m = self.map
        valid = np.asarray(m.kf_valid)
        Tcw = np.asarray(m.kf_pose)[valid]
        ts = np.asarray(m.kf_timestamp)[valid]
        traj_io.save_tum(path, ts, np.linalg.inv(Tcw))
