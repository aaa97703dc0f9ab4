"""Globally-consistent SLAM front/back-end: keyframe tracking state machine.

JAX re-design of the reference's GCSLAM class
(ref: GCSLAM/GCSLAM.{h,cpp} — update_frame :256-356 with the keyframe
decision :315-327, update_keyframe :52-185, select_closure_candidates
:6-50, updateMapOrigin :187-254) orchestrating jitted kernels:
feature extraction, two-view registration, loop-closure scoring and
FastBA all run on device; this module is the host-side control flow
(the reference's is C++ on the tracking thread).

Keyframe promotion (ref: GCSLAM.cpp:315-327): a tracked frame becomes a
keyframe when disparity > 0.1, scale change > 0.4, or after 3 consecutive
tracking failures; blurred frames are blocked (ref: BasicAPI.cpp:1256).
Failure of all candidate registrations starts a new map origin
(ref: GCSLAM.cpp:149-161); only origin-0 frames are fused downstream
(ref: MobileFusion.cpp:245).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.config import PipelineConfig
from texturefusion_tpu.core import camera as cam
from texturefusion_tpu.core import se3
from texturefusion_tpu.slam import fastba, loopclosure
from texturefusion_tpu.slam.features import Keypoints, extract_features
from texturefusion_tpu.slam.matching import TwoViewResult, register_frames


@dataclasses.dataclass
class FrameRecord:
    index: int
    timestamp: float
    is_keyframe: bool = False
    keyframe_slot: int = -1            # slot of the owning keyframe
    rel_to_keyframe: np.ndarray = None  # [4,4]: p_kf = rel · p_frame
    tracking_success: bool = False
    origin_index: int = 0
    blurred: bool = False
    keypoints: Optional[Keypoints] = None  # kept for keyframes only
    rel_pose_dev: Optional[jnp.ndarray] = None  # device copy of rel pose


@dataclasses.dataclass
class KeyframeRecord:
    frame_index: int
    slot: int                          # index into the pose array
    origin_index: int
    local_frames: List[int] = dataclasses.field(default_factory=list)
    reg_success_count: int = 0


@jax.jit
def _match_store_append(midx, minl, e, row_idx, row_inl):
    return midx.at[e].set(row_idx), minl.at[e].set(row_inl)


def _next_bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class GCSLAM:
    def __init__(self, config: PipelineConfig):
        self.config = config
        self.cfg = config.tracking
        self.intr = cam.Intrinsics.from_config(config.camera)
        self.frames: List[FrameRecord] = []
        self.keyframes: List[KeyframeRecord] = []
        max_kf = config.ba.max_keyframes
        import threading
        self._poses_np = np.tile(np.eye(4, dtype=np.float32), (max_kf, 1, 1))
        self._poses_pending = None   # (device flat poses, bucket) from BA
        self._pose_lock = threading.Lock()
        self.edges = fastba.make_edges(config.ba.max_edges)
        self.n_edges = 0
        # raw per-edge matches (device): finalBA re-pre-integrates edges
        # with Huber weights at FINAL poses (ref: GCSLAM.h:32-39
        # initGraphHuberNorm) — needs the original correspondences
        pad = config.tracking.max_matches_pad
        self._edge_midx = jnp.zeros((config.ba.max_edges, pad), jnp.int32)
        self._edge_minl = jnp.zeros((config.ba.max_edges, pad), jnp.float32)
        self._edge_has = np.zeros(config.ba.max_edges, bool)
        self.db = loopclosure.KeyframeDescriptorDB(max_keyframes=max_kf)
        # device-side stacked keypoints + DB-row→slot map for the
        # single-dispatch promotion probe (slam/promote.py)
        from texturefusion_tpu.slam.promote import KeypointDB
        self.kp_db = KeypointDB(max_kf, config.tracking.max_features_pad)
        self._row_to_slot = jnp.full(max_kf, -1, jnp.int32)
        self.fail_count = 0
        self.origin_count = 1
        # deferred promotion: the probe dispatched at keyframe adoption,
        # consumed (edges + pose correction + BA) one frame later
        self._pending_promote: Optional[dict] = None
        # retroactive stale-frame refinement: frames finalized via the
        # stale-reference path re-register against their ADOPTED keyframe
        # asynchronously (results adopted when they land)
        self._pending_refine: List[dict] = []
        self.refine_dispatched = 0
        self.refine_adopted = 0
        self._key = jax.random.PRNGKey(42)
        # base for device-side per-frame key derivation (fold_in) — the
        # fused frame step needs no host-side split per frame
        self.base_key = jax.random.PRNGKey(7)
        self.last_ba_errors: List = []
        # last-keyframe depth/normals kept only when ICP is enabled
        self._kf_depth = None
        self._kf_normals = None
        # previous frame's keypoints: frame-to-frame fallback tracking
        self._prev_kp = None

    # ------------------------------------------------------------ helpers

    def _split_key(self) -> jax.Array:
        self._key, sub = jax.random.split(self._key)
        return sub

    @property
    def poses(self) -> np.ndarray:
        """Keyframe pose array; materializes any pending async BA result
        (the BA pose fetch is started async at promotion time and only
        synced on first use — usually a frame later, hiding the ~24 ms
        roundtrip behind the next frame's device work)."""
        self._sync_poses()
        return self._poses_np

    @poses.setter
    def poses(self, value: np.ndarray) -> None:
        with self._pose_lock:
            self._poses_pending = None
            self._poses_np = value

    def _sync_poses(self) -> None:
        # called from both the tracking and the fusion threads
        with self._pose_lock:
            if self._poses_pending is not None:
                dev, bucket, n_active = self._poses_pending
                self._poses_pending = None
                from texturefusion_tpu.utils.async_fetch import resolve
                fetched = np.asarray(resolve(dev)).reshape(bucket, 4, 4)
                # only the rows ACTIVE at dispatch time: a keyframe
                # promoted while the fetch was in flight lives in a
                # bucket row whose BA output is stale garbage
                self._poses_np[:n_active] = fetched[:n_active]


    @property
    def last_keyframe(self) -> Optional[KeyframeRecord]:
        return self.keyframes[-1] if self.keyframes else None

    def keyframe_pose(self, slot: int) -> np.ndarray:
        return self.poses[slot].copy()   # copy: read from two threads

    def keyframe_pose_peek(self, slot: int) -> np.ndarray:
        """Pose WITHOUT materializing a pending BA fetch (≤1 BA round
        stale). For provisional uses that are later re-validated against
        the synced pose (discovery prefetch, provisional promotion) —
        the device queue runs ~2 frames behind the host, so a fetch
        needed sooner than that after dispatch always stalls."""
        with self._pose_lock:
            return self._poses_np[slot].copy()

    def frame_pose(self, idx: int) -> np.ndarray:
        """World pose of any frame: keyframe pose ∘ stored relative pose
        (local-frame propagation, ref: MultiViewGeometry.cpp:1149-1156)."""
        f = self.frames[idx]
        kf_pose = self.poses[f.keyframe_slot]
        if f.is_keyframe:
            return kf_pose
        return np.asarray(kf_pose @ f.rel_to_keyframe)

    def trajectory(self) -> np.ndarray:
        self.consume_pending_refine(force=True)
        return np.stack([self.frame_pose(i) for i in range(len(self.frames))])

    # ------------------------------------------------------------ edges

    def _add_virtual_edge(self, kf_i_slot: int, kf_j_slot: int,
                          rel_pose: np.ndarray, n_pts: int = 64,
                          weight: float = 0.5) -> None:
        """Odometry-prior edge from a relative pose without shared
        features: virtual 3D points p = T_rel·q tie the two keyframes in
        FastBA when direct co-registration failed (chained tracking)."""
        if self.n_edges >= self.config.ba.max_edges:
            return
        rng = np.random.default_rng(kf_j_slot)
        q = rng.uniform(-1.0, 1.0, (n_pts, 3)).astype(np.float32)
        q[:, 2] += 2.0
        qj = jnp.asarray(q)
        pj = se3.transform_points(jnp.asarray(rel_pose.astype(np.float32)), qj)
        sums = fastba.preintegrate_edge(pj, qj, jnp.full(n_pts, weight))
        self.edges = fastba.append_edge(
            self.edges, jnp.int32(self.n_edges), kf_i_slot, kf_j_slot, *sums)
        self.n_edges += 1

    def _add_edge(self, kf_i_slot: int, kf_j_slot: int, kp_ref: Keypoints,
                  kp_src: Keypoints, res: TwoViewResult) -> None:
        """Pre-integrate a successful registration into the edge store
        (ref: FrameCorrespondence::preIntegrateWithHuberNorm
        MultiViewGeometry.h:245-311; edges appended GCSLAM.cpp:178-183)."""
        if self.n_edges >= self.config.ba.max_edges:
            return
        p = kp_ref.points3d[res.match_idx]
        q = kp_src.points3d
        sums = fastba.preintegrate_from_registration(
            p, q, res.inliers.astype(jnp.float32), res.pose,
            jnp.float32(self.config.ba.huber_delta))
        self.edges = fastba.append_edge(
            self.edges, jnp.int32(self.n_edges), kf_i_slot, kf_j_slot, *sums)
        self._store_edge_matches(self.n_edges, res.match_idx,
                                 res.inliers.astype(jnp.float32))
        self.n_edges += 1

    def _store_edge_matches(self, e: int, midx, minl) -> None:
        self._edge_midx, self._edge_minl = _match_store_append(
            self._edge_midx, self._edge_minl, jnp.int32(e), midx, minl)
        self._edge_has[e] = True

    def _run_ba(self) -> None:
        """FastBA over all keyframes (ref: optimizeKeyFrameMap
        MultiViewGeometry.cpp:1209-1217 called at every new keyframe).
        With parallel.n_devices > 1, edges are sharded over the device
        mesh and per-edge Hessian blocks psum-reduced (parallel/ba.py)."""
        n_kf = len(self.keyframes)
        if n_kf < 2 or self.n_edges < 1:
            return
        from texturefusion_tpu.utils.stopwatch import STOPWATCH as _SW
        bucket = _next_bucket(n_kf, lo=self.config.ba.kf_bucket_floor)
        with _SW.time("t_ba_possync"):
            poses = jnp.asarray(self.poses[:bucket])
        active = jnp.asarray(np.arange(bucket) < n_kf)
        # edge slice in a static-size bucket
        e_bucket = _next_bucket(self.n_edges,
                                lo=self.config.ba.edge_bucket_floor)

        n_dev = self.config.parallel.n_devices
        multi = bool(n_dev and n_dev > 1)
        # keyframe-partitioned Schur reduction once the dense solve would
        # dominate (BASELINE.json config 5; parallel/ba.py). Also engages
        # on a single device (1-device mesh) so the Schur path runs in
        # the live pipeline, not only under multi-device tests.
        want_schur = bucket >= self.config.ba.schur_min_keyframes
        if multi or want_schur:
            from texturefusion_tpu.parallel import ba as pba
            from texturefusion_tpu.parallel.mesh import make_mesh

            mesh = make_mesh(n_dev if multi else 1)
            edges_in = self.edges
            if multi:
                edges_in = pba.shard_edges(edges_in, mesh)
            use_schur = want_schur and bucket % mesh.size == 0
            # ONE compiled program: slice + pad + GN rounds + pruning
            new_poses, valid, errs_arr = pba.ba_rounds(
                poses, edges_in, bucket, active, self.config.ba, mesh,
                e_bucket, use_schur,
                self.config.ba.schur_separator_budget)
            errs = list(errs_arr)               # device; fetched lazily
        else:
            edges = jax.tree.map(lambda a: a[:e_bucket], self.edges)
            new_poses, edges, errs = fastba.optimize(
                poses, edges, bucket, active, self.config.ba)
            valid = edges.valid
        # keep errors device-resident (fetch only when read, e.g. tests);
        # poses: start an ASYNC flat fetch and adopt lazily on next read
        self.last_ba_errors = list(errs)
        from texturefusion_tpu.utils.async_fetch import fetch_async
        flat = fetch_async(new_poses.reshape(-1))
        # publish under the pose lock: _sync_poses (fusion thread) does a
        # read-then-clear of the same field — an unguarded store here can
        # interleave and silently drop a whole BA round's poses
        with self._pose_lock:
            self._poses_pending = (flat, bucket, n_kf)
        # write back pruned-edge validity
        self.edges = self.edges._replace(
            valid=self.edges.valid.at[:e_bucket].set(valid))

    # ------------------------------------------------------------ keyframes

    def _promote_keyframe(self, frame: FrameRecord, kp: Keypoints,
                          pose_world: np.ndarray) -> KeyframeRecord:
        slot = len(self.keyframes)
        # direct store: must NOT materialize a pending BA fetch (the
        # clobber hazard it used to guard is handled by _sync_poses
        # writing only rows active at dispatch time)
        with self._pose_lock:
            self._poses_np[slot] = pose_world
        kf = KeyframeRecord(frame_index=frame.index, slot=slot,
                            origin_index=frame.origin_index)
        self.keyframes.append(kf)
        frame.is_keyframe = True
        frame.keyframe_slot = slot
        frame.rel_to_keyframe = np.eye(4, dtype=np.float32)
        frame.keypoints = kp
        self.kp_db.add(slot, kp)
        return kf

    def _update_keyframe(self, frame: FrameRecord, kp: Keypoints,
                         tracked: Optional[TwoViewResult],
                         fallback_pose: Optional[np.ndarray] = None,
                         tracked_stats: Optional[np.ndarray] = None) -> None:
        """New-keyframe path: loop-closure candidates + registrations +
        edge insertion + FastBA (ref: GCSLAM.cpp:52-185 update_keyframe).

        Steady state runs the SINGLE-DISPATCH promotion probe
        (slam/promote.py): similarity + salient selection + vmapped
        registration + edge pre-integration in one program with one
        small fetch. The multi-origin case (rare) takes the legacy
        multi-dispatch path, which can probe arbitrary extra slots."""
        last_slot = self.last_keyframe.slot
        if (self.cfg.defer_promote and tracked is not None
                and tracked_stats is not None
                and self.origin_count == 1 and len(self.db) > 0):
            # steady state with a valid tracked pose already on host:
            # adopt the keyframe NOW, consume the probe one frame later
            # (ref contrast: GCSLAM.cpp:52-185 blocks the tracking thread)
            self._promote_dispatch(frame, kp, tracked_stats)
            return
        probe = None
        if self.origin_count == 1 and len(self.db) > 0:
            results, probe = self._probe_candidates(kp, tracked_stats)
        else:
            results = self._legacy_candidates(kp, tracked, tracked_stats,
                                              last_slot)

        if not results:
            if fallback_pose is not None:
                # no direct keyframe registration, but frame-to-frame
                # chaining kept a valid pose: promote in the SAME origin
                # with an odometry-prior edge for BA
                frame.origin_index = self.keyframes[last_slot].origin_index
                frame.tracking_success = True
                kf = self._promote_keyframe(frame, kp,
                                            fallback_pose.astype(np.float32))
                rel = np.linalg.inv(self.poses[last_slot]) @ fallback_pose
                self._add_virtual_edge(last_slot, kf.slot, rel)
                self._db_add(kf.slot, kp)
                self._run_ba()
                self.fail_count = 0
                return
            # registration failed everywhere → new map origin
            # (ref: GCSLAM.cpp:149-161)
            self.origin_count += 1
            frame.origin_index = self.origin_count - 1
            frame.tracking_success = False
            pose = self.poses[last_slot]  # continue from last pose
            kf = self._promote_keyframe(frame, kp, pose)
            self.fail_count = 0
            return

        # pose from the minimum-disparity successful match, preferring the
        # OLDEST origin so merges always re-anchor younger maps onto older
        # ones (ref: GCSLAM.cpp:124-147 best match; :187-254 origin merge)
        oldest = min(r[0].origin_index for r in results)
        candidates_oldest = [r for r in results if r[0].origin_index == oldest]
        best = min(candidates_oldest, key=lambda r: float(r[1][3]))
        kf_best = best[0]
        pose_world = self.poses[kf_best.slot] @ best[1][5:21].reshape(4, 4)
        frame.origin_index = kf_best.origin_index
        frame.tracking_success = True
        kf = self._promote_keyframe(frame, kp, pose_world.astype(np.float32))

        if probe is not None:
            self._append_probe_edges(probe, [r[2] for r in results], kf.slot)
        else:
            for kf_c, _stats, sums, matches in results:
                if self.n_edges < self.config.ba.max_edges:
                    self.edges = fastba.append_edge(
                        self.edges, jnp.int32(self.n_edges), kf_c.slot,
                        kf.slot, *sums)
                    if matches is not None:
                        self._store_edge_matches(self.n_edges, *matches)
                    self.n_edges += 1
        kf.reg_success_count = len(results)

        # map-origin merging (ref: GCSLAM.cpp:187-254 updateMapOrigin):
        # a keyframe registering to keyframes from several origins aligns
        # those origins — re-anchor the younger origin onto the adopted one
        adopted = kf.origin_index
        pose_new = self.poses[kf.slot]
        for kf_c, _stats, *_rest in results:
            o = kf_c.origin_index
            if o == adopted:
                continue
            pose_new_in_o = (self.keyframe_pose(kf_c.slot)
                             @ _stats[5:21].reshape(4, 4))
            t_align = (pose_new @ np.linalg.inv(pose_new_in_o)).astype(np.float32)
            for other in self.keyframes:
                if other.origin_index == o:
                    self.poses[other.slot] = t_align @ self.poses[other.slot]
                    other.origin_index = adopted
                    self.frames[other.frame_index].origin_index = adopted
            for f in self.frames:
                if f.origin_index == o:
                    f.origin_index = adopted

        # descriptor DB insertion gated on match count
        # (ref: GCSLAM.cpp:171-177 — skip if ≥4 successful matches)
        if len(results) < 4:
            self._db_add(kf.slot, kp)

        self._run_ba()
        self.fail_count = 0

    def _db_add(self, slot: int, kp: Keypoints) -> None:
        row = len(self.db)
        self.db.add(slot, kp.desc, kp.valid)
        if len(self.db) > row:    # actually inserted (capacity not hit)
            self._row_to_slot = self._row_to_slot.at[row].set(slot)

    def _dispatch_probe(self, kp: Keypoints,
                        tracked_stats: Optional[np.ndarray],
                        last_slot: int):
        """Launch the single-dispatch promotion probe against `last_slot`,
        the keyframe `tracked_stats` were measured against; returns
        (probe, n_cand, fetch handle) with the host copy in flight."""
        from texturefusion_tpu.slam import promote
        from texturefusion_tpu.utils.async_fetch import fetch_async
        n_cand = max(self.cfg.max_candidates, 2)
        have_tracked = tracked_stats is not None
        ts = (jnp.asarray(tracked_stats.astype(np.float32))
              if have_tracked else jnp.zeros(21, jnp.float32))
        probe = promote.promote_probe(
            self.kp_db.kp, self.db.desc, self.db.valid, self._row_to_slot,
            jnp.int32(len(self.db)), jnp.int32(last_slot),
            kp, ts, jnp.asarray(have_tracked), self._split_key(),
            self.cfg.salient_score_threshold, self.config.ba.huber_delta,
            self.cfg, self.intr, n_cand)
        return probe, n_cand, fetch_async(probe.fetch)

    def _probe_results(self, probe, n_cand: int, fetched: np.ndarray):
        """Probe fetch → [(KeyframeRecord, stats[21] np, candidate row)].
        LAZY: no device slicing here — edge insertion consumes the probe's
        stacked sums in one batched dispatch (_append_probe_edges)."""
        import os
        if os.environ.get("TF_DEBUG_LC"):
            print(f"[LC] kf={len(self.keyframes)} cands="
                  + " ".join(f"(slot {int(r[0])} ok {r[1]:.0f} "
                             f"ninl {r[3]:.0f} sim {r[23]:.0f} "
                             f"sal {r[24]:.2f})" for r in fetched))
        results = []
        seen = set()
        for i in range(n_cand):
            slot = int(fetched[i, 0])
            if fetched[i, 1] < 0.5 or slot in seen:
                continue
            seen.add(slot)
            results.append((self.keyframes[slot], fetched[i, 2:23], i))
        return results

    def _append_probe_edges(self, probe, rows: List[int],
                            kf_slot: int) -> int:
        """Append the taken probe candidates as edges + raw-match rows in
        ONE compiled dispatch. Returns the number appended."""
        space = self.config.ba.max_edges - self.n_edges
        rows = rows[:space]
        if not rows:
            return 0
        take = np.zeros(probe.cand_slots.shape[0], bool)
        take[rows] = True
        self.edges, self._edge_midx, self._edge_minl = \
            fastba.append_probe_edges(
                self.edges, self._edge_midx, self._edge_minl,
                jnp.int32(self.n_edges), probe.cand_slots,
                jnp.int32(kf_slot), probe.s_w, probe.s_p, probe.s_q,
                probe.s_pp, probe.s_qq, probe.s_pq,
                probe.midx, probe.minl, jnp.asarray(take))
        self._edge_has[self.n_edges: self.n_edges + len(rows)] = True
        self.n_edges += len(rows)
        return len(rows)

    def _promote_dispatch(self, frame: FrameRecord, kp: Keypoints,
                          tracked_stats: np.ndarray) -> None:
        """Adopt the keyframe immediately at the tracked pose, dispatch
        the loop-closure probe, and defer edges/pose-correction/BA to
        consume_pending_promote (typically the next frame's finalize) —
        the probe's readback leaves the tracking critical path.
        The provisional pose is the tracked relative pose composed onto
        the last keyframe; the consume step re-selects the reference
        minimum-disparity candidate pose (ref: GCSLAM.cpp:124-147)."""
        from texturefusion_tpu.utils.stopwatch import STOPWATCH as _SW
        with _SW.time("pd_consume"):
            self.consume_pending_promote()   # at most one in flight
        last_slot = self.last_keyframe.slot
        rel = tracked_stats[5:21].reshape(4, 4).astype(np.float32)
        with _SW.time("pd_pose"):
            # peek (≤1 BA round stale): the pending BA fetch lands ~2
            # frames after dispatch (device-queue lag), so syncing here
            # stalled ~60 ms per promotion. Consistency with BA's init is
            # restored at consume time, which RECOMPOSES this pose from
            # the by-then-synced parent before running BA — a stale-vs-
            # synced mismatch at the GN init made the between-round
            # outlier pruning remove good edges (32 → 758 mm ATE).
            pose_prov = (self.keyframe_pose_peek(last_slot) @ rel
                         ).astype(np.float32)
        frame.origin_index = self.keyframes[last_slot].origin_index
        frame.tracking_success = True
        with _SW.time("pd_adopt"):
            kf = self._promote_keyframe(frame, kp, pose_prov)
        with _SW.time("pd_probe"):
            # candidate 0 is the keyframe the frame was TRACKED against,
            # not the one just adopted
            probe, n_cand, handle = self._dispatch_probe(kp, tracked_stats,
                                                         last_slot)
        self._pending_promote = {
            "probe": probe, "n_cand": n_cand, "handle": handle,
            "kf_slot": kf.slot, "last_slot": last_slot, "rel": rel,
            "frame": len(self.frames)}
        self.fail_count = 0

    def consume_pending_promote(self, force: bool = True) -> None:
        """Apply a deferred promotion's probe results: loop-closure edges,
        minimum-disparity pose re-selection, descriptor-DB gating, BA
        (the deferred tail of ref GCSLAM.cpp:52-185 + optimizeKeyFrameMap).
        Idempotent. force=False consumes only once the probe's device
        values are ready, up to a 3-frame grace (then it resolves anyway
        so BA corrections never lag more than ~a keyframe interval)."""
        pend = self._pending_promote
        if pend is None:
            return
        if (not force and not pend["handle"].done()
                and len(self.frames) - pend["frame"] < 3):
            return
        self._pending_promote = None
        from texturefusion_tpu.utils.async_fetch import resolve
        from texturefusion_tpu.utils.stopwatch import STOPWATCH
        with STOPWATCH.time("t_promote_consume"):
            fetched = np.asarray(resolve(pend["handle"])).reshape(
                pend["n_cand"], 25)
        results = self._probe_results(pend["probe"], pend["n_cand"], fetched)
        kf = self.keyframes[pend["kf_slot"]]
        if not results:
            # candidate 0 carries the tracked stats validated at dispatch
            # time, so an empty result set means even the tracked
            # registration failed re-validation — mirror the sync path's
            # new-origin fallback (ref: GCSLAM.cpp:149-161) instead of
            # permanently tying a bad registration into the graph. The
            # consume runs within ≲3 frames, before the fusion cycle for
            # this keyframe fires, so the origin flip also blocks fusion
            # (only origin-0 keyframes fuse, ref: MobileFusion.cpp:245).
            self.origin_count += 1
            kf.origin_index = self.origin_count - 1
            fr = self.frames[kf.frame_index]
            fr.origin_index = kf.origin_index
            fr.tracking_success = False
            self._db_add(kf.slot, fr.keypoints)
            return
        # pose from the minimum-disparity successful match
        # (ref: GCSLAM.cpp:124-147); deferred path is single-origin.
        # ALWAYS recomposed here from the now-synced parent: promotion
        # composed it from a peeked (possibly one-BA-round-stale) parent,
        # and BA's init must be consistent with the poses it reads.
        best = min(results, key=lambda r: float(r[1][3]))
        from texturefusion_tpu.utils.stopwatch import STOPWATCH as _SW
        with _SW.time("cpp_pose"):
            if best[0].slot != pend["last_slot"]:
                pose_world = (self.poses[best[0].slot]
                              @ best[1][5:21].reshape(4, 4))
            else:
                pose_world = self.poses[pend["last_slot"]] @ pend["rel"]
            self.poses[kf.slot] = pose_world.astype(np.float32)
        with _SW.time("cpp_edges"):
            self._append_probe_edges(pend["probe"], [r[2] for r in results],
                                     kf.slot)
        kf.reg_success_count = len(results)
        if len(results) < 4:   # ref: GCSLAM.cpp:171-177 DB insertion gate
            with _SW.time("cpp_db"):
                self._db_add(kf.slot, self.frames[kf.frame_index].keypoints)
        import os as _os
        t0 = None
        if _os.environ.get("TF_SLOW_LOG"):
            import time as _t
            t0 = _t.perf_counter()
        with _SW.time("cpp_ba"):
            self._run_ba()
        if t0 is not None:
            import sys as _s
            import time as _t
            import traceback as _tb
            dt = (_t.perf_counter() - t0) * 1e3
            if dt > 50:
                import threading as _th
                stack = _tb.extract_stack(limit=6)
                chain = ">".join(f.name for f in stack[:-1])
                print(f"[cpp_ba-slow] {dt:.0f} ms frames={len(self.frames)} "
                      f"thread={_th.current_thread().name} via {chain}",
                      file=_s.stderr)

    def _probe_candidates(self, kp: Keypoints,
                          tracked_stats: Optional[np.ndarray]):
        """Single-dispatch candidate selection + registration + edge
        pre-integration (slam/promote.py). Returns
        ([(KeyframeRecord, stats[21] np, row)], probe)."""
        probe, n_cand, handle = self._dispatch_probe(
            kp, tracked_stats, self.last_keyframe.slot)
        from texturefusion_tpu.utils.async_fetch import resolve
        fetched = np.asarray(resolve(handle)).reshape(n_cand, 25)
        return self._probe_results(probe, n_cand, fetched), probe

    def _legacy_candidates(self, kp: Keypoints,
                           tracked: Optional[TwoViewResult],
                           tracked_stats: Optional[np.ndarray],
                           last_slot: int):
        """Multi-dispatch candidate path (multi-origin probing or empty
        DB). Same result format as _probe_candidates."""
        sims = self.db.similarity(kp.desc, kp.valid)
        rows = loopclosure.select_candidates(
            sims, self.cfg.salient_score_threshold, self.cfg.max_candidates)
        # DB rows → keyframe slots; previous keyframe always considered
        cand_slots = [last_slot]
        for r in rows:
            s = self.db.kf_ids[r]
            if s not in cand_slots:
                cand_slots.append(s)
        # disconnected origins: always probe each other origin's newest
        # keyframe so maps can re-merge (ref: updateMapOrigin intent)
        if self.origin_count > 1:
            seen_origins = {self.keyframes[last_slot].origin_index}
            for other in reversed(self.keyframes):
                if other.origin_index not in seen_origins:
                    seen_origins.add(other.origin_index)
                    if other.slot not in cand_slots:
                        cand_slots.append(other.slot)
        # bounded by construction: ≤ 1 + max_candidates + (origins − 1)
        # (select_candidates caps its rows; extra-origin probes are few
        # and deliberate — they let disconnected maps re-merge)
        results = []
        to_register = []
        for slot in cand_slots:
            kf_c = self.keyframes[slot]
            if kf_c.slot == last_slot and tracked is not None:
                st = (tracked_stats if tracked_stats is not None
                      else np.asarray(tracked.stats))
                kp_ref = self.frames[kf_c.frame_index].keypoints
                sums = fastba.preintegrate_from_registration(
                    kp_ref.points3d[tracked.match_idx], kp.points3d,
                    tracked.inliers.astype(jnp.float32), tracked.pose,
                    jnp.float32(self.config.ba.huber_delta))
                results.append((kf_c, st, sums,
                                (tracked.match_idx.astype(jnp.int32),
                                 tracked.inliers.astype(jnp.float32))))
                continue
            to_register.append(slot)
        if to_register:
            # ALL candidate registrations in one vmapped dispatch + one
            # 1D stats fetch (one dispatch and readback per candidate
            # would serialize them; ref loops them, GCSLAM.cpp:104)
            from texturefusion_tpu.slam.matching import (
                register_frames_batch, stack_keypoints)
            bucket = _next_bucket(len(to_register), lo=2)
            padded = to_register + [to_register[0]] * (bucket - len(to_register))
            kp_refs = stack_keypoints(
                [self.frames[self.keyframes[s].frame_index].keypoints
                 for s in padded])
            keys = jax.random.split(self._split_key(), bucket)
            bres = register_frames_batch(kp_refs, kp, keys,
                                         self.cfg, self.intr)
            stats_all = np.asarray(bres.stats.reshape(-1)).reshape(bucket, -1)
            for i, slot in enumerate(to_register):
                if stats_all[i, 0] > 0.5:
                    res_i = jax.tree.map(lambda a, i=i: a[i], bres)
                    kp_ref_i = self.frames[
                        self.keyframes[slot].frame_index].keypoints
                    sums = fastba.preintegrate_from_registration(
                        kp_ref_i.points3d[res_i.match_idx], kp.points3d,
                        res_i.inliers.astype(jnp.float32), res_i.pose,
                        jnp.float32(self.config.ba.huber_delta))
                    results.append((self.keyframes[slot], stats_all[i], sums,
                                    (res_i.match_idx.astype(jnp.int32),
                                     res_i.inliers.astype(jnp.float32))))
        return results

    # ------------------------------------------------------------ main entry

    def update_frame(self, gray: jnp.ndarray, depth: jnp.ndarray,
                     timestamp: float = 0.0,
                     blurred=False, kp=None, res=None,
                     res_kf_slot: Optional[int] = None,
                     stats: Optional[np.ndarray] = None,
                     res_ff=None,
                     stats_ff: Optional[np.ndarray] = None) -> FrameRecord:
        """Track one frame (ref: GCSLAM.cpp:256-356 update_frame).
        `blurred` may be a bool or a zero-arg callable evaluated lazily
        (only at keyframe-promotion time, avoiding a per-frame device
        sync for the blur score). `kp`/`res` accept precomputed feature
        extraction + registration-vs-last-keyframe results (the pipeline
        fuses them into one dispatch, models.reconstruction
        track_frame_fused). `res_kf_slot` states which keyframe `res`
        was computed against; if a NEWER keyframe exists by now (the
        pipelined tracker dispatches one frame ahead of decisions), the
        relative pose is re-anchored by host-side composition instead of
        a re-registration dispatch."""
        from texturefusion_tpu.utils.stopwatch import STOPWATCH as _SW
        with _SW.time("t_u_pp"):
            self.consume_pending_promote(force=False)  # deferred probe
            self.consume_pending_refine()              # stale-frame fixes
        frame = FrameRecord(index=len(self.frames), timestamp=timestamp,
                            blurred=False)
        self.frames.append(frame)
        if kp is None:
            kp = extract_features(gray, depth, self.cfg, self.intr)

        if not self.keyframes:
            frame.tracking_success = True
            kf = self._promote_keyframe(frame, kp, np.eye(4, dtype=np.float32))
            self._db_add(kf.slot, kp)
            self._store_icp_reference(depth)
            self._prev_kp = kp
            return frame

        last_kf = self.last_keyframe
        stale_ref = (res is not None and res_kf_slot is not None
                     and res_kf_slot != last_kf.slot)
        if stale_ref:
            return self._update_frame_stale(frame, kp, res, res_kf_slot,
                                            last_kf, stats=stats,
                                            stats_ff=stats_ff)
        kp_ref = self.frames[last_kf.frame_index].keypoints
        if res is None:
            res = register_frames(kp_ref, kp, self._split_key(),
                                  self.cfg, self.intr)
        # one fetch for all decision scalars (minimizes link roundtrips)
        from texturefusion_tpu.utils.stopwatch import STOPWATCH
        if stats is None:
            with STOPWATCH.time("t_stats_sync"):
                stats = np.asarray(res.stats)
        success = bool(stats[0] > 0.5)
        if not success and stats_ff is None:
            # borderline RANSAC draws are seed-dependent: one cheap retry
            # with a fresh key before declaring a tracking failure (only
            # when no same-dispatch f2f result exists to fall back on)
            with STOPWATCH.time("t_retry"):
                res = register_frames(kp_ref, kp, self._split_key(),
                                      self.cfg, self.intr)
                stats = np.asarray(res.stats)
            success = bool(stats[0] > 0.5)

        # frame-to-frame fallback: when the keyframe baseline got too wide
        # for direct registration, chain through the previous frame (high
        # overlap). Keyframe-overlap loss still counts toward promotion.
        # The pipelined step registers both pairs in ONE dispatch
        # (frame_step_tracked2) — stats_ff arrives prefetched; the
        # dispatching path below serves non-pipelined callers.
        chained_pose = None
        if not success and self._prev_kp is not None and len(self.frames) > 1:
            prev = self.frames[-2]
            if prev.keyframe_slot == last_kf.slot and prev.rel_to_keyframe is not None:
                if stats_ff is None:
                    res_ff = register_frames(self._prev_kp, kp,
                                             self._split_key(),
                                             self.cfg, self.intr)
                    stats_ff = np.asarray(res_ff.stats)
                if stats_ff[0] > 0.5:
                    rel = prev.rel_to_keyframe @ stats_ff[5:21].reshape(4, 4)
                    chained_pose = self.poses[last_kf.slot] @ rel
                    frame.rel_to_keyframe = rel.astype(np.float32)

        # optional dense ICP refinement against the keyframe depth
        # (ref: settings.yaml use_icp_registration; preIntegrateICP)
        if success and self.cfg.use_icp and self._kf_depth is not None:
            from texturefusion_tpu.slam import icp as icp_mod

            icp_res = icp_mod.icp_refine(self._kf_depth, self._kf_normals,
                                         depth, res.pose, self.intr)
            if bool(icp_res.success):
                # blend feature and ICP poses on the tangent space
                w = self.cfg.icp_weight
                delta = se3.se3_log(se3.compose(se3.inverse(res.pose),
                                                icp_res.pose))
                blended = se3.compose(res.pose, se3.se3_exp(delta * w))
                res = res._replace(pose=blended)
                # keep the fetched summary consistent (1D fetch only)
                stats = np.concatenate(
                    [stats[:5], np.asarray(blended.reshape(-1))])

        promote = False
        if success:
            disparity = float(stats[3])
            scale = float(stats[4])
            n_inl = float(stats[1])
            # promotion gates (ref: GCSLAM.cpp:315-327) plus an overlap
            # gate: when the inlier count vs the keyframe decays, promote
            # BEFORE tracking breaks on a wide baseline. A minimum frame
            # gap bounds the keyframe (and fusion-cycle) cadence
            # (ref: settings.yaml keyframe_minimum_distance: 4)
            overlap_low = n_inl < self.cfg.min_matches * 2
            far_enough = (frame.index - last_kf.frame_index
                          >= self.cfg.keyframe_min_distance)
            if far_enough and (disparity > self.cfg.minimum_disparity
                               or scale > self.cfg.scale_change_ratio
                               or overlap_low):
                is_blurred = blurred() if callable(blurred) else blurred
                frame.blurred = bool(is_blurred)
                promote = not is_blurred
        else:
            self.fail_count += 1
            if self.fail_count >= self.cfg.max_tracking_failures or \
                    chained_pose is not None:
                promote = True

        if success and not promote:
            frame.tracking_success = True
            frame.is_keyframe = False
            frame.keyframe_slot = last_kf.slot
            frame.rel_to_keyframe = stats[5:21].reshape(4, 4).copy()
            frame.rel_pose_dev = res.pose   # device-resident, no upload
            frame.origin_index = last_kf.origin_index
            last_kf.local_frames.append(frame.index)
            self.fail_count = 0
            self._prev_kp = kp
            return frame

        if promote:
            with STOPWATCH.time("t_promote"):
                self._update_keyframe(frame, kp, res if success else None,
                                      fallback_pose=chained_pose,
                                      tracked_stats=stats if success else None)
            self._store_icp_reference(depth)
            self._prev_kp = kp
            return frame

        # tracking failed but not yet promoting: hold the LAST frame's
        # pose (constant-position model) rather than snapping back to the
        # keyframe (ref: main loop keeps the previous pose on failure)
        frame.tracking_success = False
        frame.is_keyframe = False
        frame.keyframe_slot = last_kf.slot
        if frame.rel_to_keyframe is None:
            prev = self.frames[-2] if len(self.frames) > 1 else None
            if prev is not None and prev.keyframe_slot == last_kf.slot \
                    and prev.rel_to_keyframe is not None:
                frame.rel_to_keyframe = prev.rel_to_keyframe.copy()
            else:
                frame.rel_to_keyframe = np.eye(4, dtype=np.float32)
        if chained_pose is not None:
            frame.tracking_success = True
        frame.origin_index = last_kf.origin_index
        self._prev_kp = kp
        return frame

    def _update_frame_stale(self, frame: FrameRecord, kp,
                            res, res_kf_slot: int,
                            last_kf: KeyframeRecord,
                            stats: Optional[np.ndarray] = None,
                            stats_ff: Optional[np.ndarray] = None
                            ) -> FrameRecord:
        """Finalize a frame whose registration ran against a keyframe
        that has since been superseded (1-frame pipelined tracking).
        The pose re-anchors by composition p_new_kf⁻¹ · p_old_kf · rel;
        promotion gates are skipped for this single frame (its disparity
        stats are vs the OLD keyframe — the next frame registers against
        the new one)."""
        from texturefusion_tpu.utils.stopwatch import STOPWATCH
        if stats is None:
            with STOPWATCH.time("t_stats_sync"):
                stats = np.asarray(res.stats)
        success = bool(stats[0] > 0.5)
        frame.keyframe_slot = last_kf.slot
        frame.origin_index = last_kf.origin_index
        frame.is_keyframe = False
        if success:
            rel_old = stats[5:21].reshape(4, 4)
            # peeked snapshot for BOTH reads: only the RELATIVE transform
            # between the two keyframes matters here, so a consistent
            # (possibly one-BA-round-stale) snapshot is exact up to the
            # correction BA applies to their relative pose — and the
            # async re-registration below replaces this composition
            # anyway. Syncing stalled on the BA dispatched moments
            # earlier in the same frame's consume (~100 ms per stale
            # frame on the tracking thread).
            with self._pose_lock:     # one lock → one consistent snapshot
                pose_old_kf = self._poses_np[res_kf_slot].copy()
                pose_new_kf = self._poses_np[last_kf.slot].copy()
            rel_new = np.linalg.inv(pose_new_kf) @ pose_old_kf @ rel_old
            frame.tracking_success = True
            frame.rel_to_keyframe = rel_new.astype(np.float32)
            last_kf.local_frames.append(frame.index)
            self.fail_count = 0
            # the composed pose chains two wide-baseline registrations;
            # re-register DIRECTLY against the adopted keyframe (small
            # baseline) off the critical path and adopt the result when
            # it lands — restores unpipelined tracking accuracy at
            # pipeline_depth ≥ 2 without blocking (no reference analog:
            # its tracking thread never runs ahead of its decisions)
            if self.cfg.refine_stale:
                self._dispatch_refine(frame, kp, last_kf)
        else:
            # registration vs the SUPERSEDED keyframe failed (its
            # baseline is a keyframe interval wider than the adopted
            # one's). Chain through the same-dispatch frame-to-frame
            # result when available, else hold the previous pose; either
            # way the async re-registration against the ADOPTED keyframe
            # below recovers the true pose one frame later (without it,
            # these frames carried 80-170 mm errors at pipeline_depth 2).
            prev = self.frames[-2] if len(self.frames) > 1 else None
            chained = None
            if (stats_ff is not None and stats_ff[0] > 0.5
                    and prev is not None
                    and prev.keyframe_slot == last_kf.slot
                    and prev.rel_to_keyframe is not None):
                chained = prev.rel_to_keyframe @ stats_ff[5:21].reshape(4, 4)
            if chained is not None:
                frame.tracking_success = True
                frame.rel_to_keyframe = chained.astype(np.float32)
                last_kf.local_frames.append(frame.index)
                self.fail_count = 0
            else:
                self.fail_count += 1
                frame.tracking_success = False
                if prev is not None and prev.keyframe_slot == last_kf.slot \
                        and prev.rel_to_keyframe is not None:
                    frame.rel_to_keyframe = prev.rel_to_keyframe.copy()
                else:
                    frame.rel_to_keyframe = np.eye(4, dtype=np.float32)
            if self.cfg.refine_stale:
                self._dispatch_refine(frame, kp, last_kf)
        self._prev_kp = kp
        return frame

    def _dispatch_refine(self, frame: FrameRecord, kp,
                         last_kf: KeyframeRecord) -> None:
        """Launch an async re-registration of a stale-finalized frame
        against its adopted keyframe (lite settings: the baseline is a
        keyframe interval, far smaller than RANSAC needs for the fresh
        wide-baseline case)."""
        import dataclasses as _dc
        kp_ref = self.frames[self.keyframes[last_kf.slot].frame_index].keypoints
        cfg_lite = _dc.replace(
            self.cfg,
            ransac_iterations=max(self.cfg.ransac_iterations // 4, 64),
            use_fine_search=False)
        res = register_frames(kp_ref, kp, self._split_key(), cfg_lite,
                              self.intr)
        from texturefusion_tpu.utils.async_fetch import fetch_async
        self._pending_refine.append({
            "frame": frame.index, "kf_slot": last_kf.slot,
            "fetch": fetch_async(res.stats)})
        self.refine_dispatched += 1

    def consume_pending_refine(self, force: bool = False) -> None:
        """Adopt landed stale-frame re-registrations: replace the
        composed relative pose with the direct one (better-conditioned).
        Failed refinements keep the composed pose. Non-blocking unless
        force=True."""
        if not self._pending_refine:
            return
        keep = []
        from texturefusion_tpu.utils.async_fetch import resolve
        for p in self._pending_refine:
            if not force and not p["fetch"].done():
                keep.append(p)
                continue
            st = np.asarray(resolve(p["fetch"]))
            f = self.frames[p["frame"]]
            if (st[0] > 0.5 and not f.is_keyframe
                    and f.keyframe_slot == p["kf_slot"]):
                f.rel_to_keyframe = st[5:21].reshape(4, 4).astype(
                    np.float32).copy()
                f.rel_pose_dev = None
                # a frame whose wide-baseline stale registration failed
                # is rescued by this direct one
                f.tracking_success = True
                self.refine_adopted += 1
        self._pending_refine = keep

    def _store_icp_reference(self, depth) -> None:
        if self.cfg.use_icp:
            from texturefusion_tpu.ops import preprocess
            self._kf_depth = depth
            self._kf_normals = preprocess.extract_normal_map(depth, self.intr)

    def final_ba(self) -> None:
        """Final global optimization (ref: GCSLAM.h:32-39 finalBA):
        re-pre-integrate every edge with Huber weights evaluated at the
        CURRENT optimized poses (initGraphHuberNorm semantics) before the
        last Gauss-Newton — weights frozen at registration time overvalue
        correspondences that later turned out inconsistent."""
        self.consume_pending_promote()
        self.consume_pending_refine(force=True)
        if self.n_edges > 0 and self._edge_has[: self.n_edges].any():
            self._sync_poses()
            e_bucket = _next_bucket(self.n_edges, lo=16)
            kf_bucket = _next_bucket(max(len(self.keyframes), 1))
            edges = jax.tree.map(lambda a: a[:e_bucket], self.edges)
            new = fastba.reweight_edges(
                jnp.asarray(self._poses_np[:kf_bucket]), edges,
                self.kp_db.kp.points3d,
                self._edge_midx[:e_bucket], self._edge_minl[:e_bucket],
                jnp.asarray(self._edge_has[:e_bucket]),
                jnp.float32(self.config.ba.huber_delta))
            self.edges = fastba.EdgeSums(
                *(full.at[:e_bucket].set(part)
                  for full, part in zip(self.edges, new)))
        self._run_ba()
