"""End-to-end reconstruction pipeline: tracking + fusion + meshing (+texture).

JAX re-design of MobileFusion + the main loop
(ref: GCFusion/MobileFusion.{h,cpp} — tsdfFusion :274-406,
ReIntegrateKeyframe :114-221, IntegrateFrame :223-250,
clearRedudentFrameMemory :71-90, updateGlobalMap/MapManagement :92-112;
main.cpp:102-211 per-frame loop).

The reference splits tracking and fusion across two barrier-synchronized
boost threads; here both are streams of device work launched from one
host loop — fusion work (keyframe-rate) overlaps tracking (frame-rate)
naturally through JAX's async dispatch (SURVEY.md §2.3 mapping).

Per-keyframe fusion cycle (= reference's map-thread tsdfFusion):
  1. drift-based de/re-integration of old keyframes (dynamics.py)
  2. integrate the newest *finished* keyframe (color+quality) and a
     subsample of its tracked local frames (depth-only)
  3. incremental meshing of dirty chunks
  4. texture view-selection / patches / atlas (texture/, wired in by
     TexturedPipeline below when enabled)
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, List, Optional

# env-gated trace of the per-frame stats fetch latency (perf debugging):
# (age at finalize, landing latency | -1 if still pending) tuples, dumped
# by bench.py at end of run
_FETCH_TRACE = bool(os.environ.get("TF_FETCH_TRACE"))
_FETCH_LOG: list = []
_COMPUTE_LOG: list = []   # dispatch→compute-ready ms (trace only)

import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.config import PipelineConfig
from texturefusion_tpu.core import camera as cam
from texturefusion_tpu.fusion import dynamics
from texturefusion_tpu.fusion.chunkmap import TSDFVolume
from texturefusion_tpu.fusion.mesher import IncrementalMesher
from texturefusion_tpu.ops import preprocess
from texturefusion_tpu.slam.gcslam import GCSLAM
from texturefusion_tpu.utils.stopwatch import STOPWATCH

import jax

# the stale-frame keyframe-refinement fallback runs outside the fused
# frame step; uncompiled it dispatched ~90 eager primitives (~60 ms of
# host time per call — cProfile r5)
_fuse_depth_jit = jax.jit(preprocess.fuse_depth_into_keyframe,
                          static_argnames=("intr",))


@dataclasses.dataclass
class KeyframeFusionState:
    """Host-side cache of everything needed to (re-)integrate a keyframe."""

    kf_slot: int
    frame_index: int
    depth: "jnp.ndarray"           # refined depth, DEVICE-resident
    rgb: "jnp.ndarray"             # uint8, DEVICE-resident (~1MB/kf at VGA)
    quality: "jnp.ndarray"         # device-resident
    local_depths: List["jnp.ndarray"]       # subsampled local-frame depths
    local_rel_poses: List[np.ndarray]       # frame→keyframe relative poses
    local_frame_idx: List[int] = dataclasses.field(default_factory=list)
    depth_weight: Optional["jnp.ndarray"] = None  # running fusion weight
    integrated_pose: Optional[np.ndarray] = None   # pose_sophus[1]
    integrated: bool = False
    rgb_host: Optional[np.ndarray] = None   # lazy uint8 host copy
    integrated_slots: Optional[np.ndarray] = None  # chunk set at integration

    def rgb_np(self) -> np.ndarray:
        """Host uint8 copy, fetched once (texture blits / PNG export)."""
        if self.rgb_host is None:
            self.rgb_host = np.asarray(self.rgb)
        return self.rgb_host

    def release_device_memory(self) -> None:
        """Stage out device buffers an integrated keyframe no longer
        needs at frame rate (ref: clearRedudentFrameMemory
        MobileFusion.cpp:71-90 + staged Frame memory release
        frame.h:102-136): local depths and quality move to host (they
        are re-uploaded only on drift reintegration, which is rare) and
        the running refinement weight is dropped (only the NEWEST
        keyframe refines). Bounds device residency to ~2 MB/keyframe."""
        self.local_depths = [np.asarray(d) if not isinstance(d, np.ndarray)
                             else d for d in self.local_depths]
        if self.quality is not None and not isinstance(self.quality,
                                                       np.ndarray):
            self.quality = np.asarray(self.quality)
        self.depth_weight = None


class ReconstructionPipeline:
    def __init__(self, config: PipelineConfig):
        self.config = config
        self.intr = cam.Intrinsics.from_config(config.camera)
        self.slam = GCSLAM(config)
        sharding = None
        if config.parallel.tsdf_sharded:
            # chunk-slot axis partitioned over the device mesh: the SAME
            # integrate/mesh programs run sharded, XLA inserting the
            # neighbor-gather collectives (SURVEY.md §2.3)
            from texturefusion_tpu.parallel import mesh as pmesh
            m = pmesh.make_mesh(config.parallel.n_devices,
                                axis=config.parallel.data_axis)
            sharding = pmesh.shard_leading(m, config.parallel.data_axis)
        self.volume = TSDFVolume(config, sharding=sharding)
        self.mesher = IncrementalMesher(self.volume)
        self.streamer = None
        if config.tsdf.max_resident_chunks > 0:
            from texturefusion_tpu.fusion.streaming import ChunkStreamer
            self.streamer = ChunkStreamer(
                self.volume, config.tsdf.max_resident_chunks,
                offload_radius=config.tsdf.streaming_radius)
            self.volume.streamer = self.streamer
        self.kf_states: Dict[int, KeyframeFusionState] = {}
        self._disco_prefetch: Dict[int, object] = {}  # kf_slot → dispatch
        # kf_slot → in-flight fresh discovery: keyframes whose prefetched
        # candidate set went stale integrate ONE CYCLE LATER with the
        # re-discovered set (integrated when the fetch lands; blocking on
        # a fresh discovery cost ~100-180 ms of queued fetch per cycle)
        self._deferred_integration: Dict[int, object] = {}
        self._last_seen_kf = -1
        self._inflight: List[dict] = []  # pipelined pending frames (FIFO)
        self._gc_pending = None         # deferred GC occupancy probe
        self._dispatch_count = 0
        self._kp_prev = None        # previous frame's keypoints (device)
        self.stats = {"frames": 0, "keyframes": 0, "reintegrations": 0}
        # optional fusion worker thread (ref: the map thread,
        # MobileFusion.cpp:99-112) — fusion cycles run off the tracking
        # critical path; cycles stay serialized with each other
        self._fusion_executor = None
        self._fusion_future = None
        if config.parallel.async_fusion:
            import concurrent.futures
            self._fusion_executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="fusion")

    def _submit_fusion(self, slot: int) -> None:
        if self._fusion_executor is None:
            self.fusion_cycle(slot)
            return
        prev = self._fusion_future

        def run():
            if prev is not None:
                prev.result()   # cycles remain ordered
            self.fusion_cycle(slot)

        self._fusion_future = self._fusion_executor.submit(run)

    def _drain_fusion(self) -> None:
        if self._fusion_future is not None:
            self._fusion_future.result()
            self._fusion_future = None

    # --------------------------------------------------------------- frames

    def process_frame(self, depth_raw: jnp.ndarray,
                      rgb: Optional[jnp.ndarray] = None,
                      timestamp: float = 0.0,
                      host_packed: Optional[np.ndarray] = None) -> None:
        """Track one frame; fuse at keyframe boundaries
        (ref: main.cpp:102-211 per-frame loop).

        Fastest input: a single packed [H, W, 5] uint8 frame
        (preprocess.pack_frame) as depth_raw with rgb=None — one
        host→device transfer per frame. Separate float/u16/u8 depth + rgb
        arrays also accepted.

        Tracking is 1-frame software-pipelined (unless
        parallel.pipelined_tracking is off): this call dispatches frame
        N's device step, then finalizes frame N-1's decisions while N
        computes — the ~24 ms dispatch→sync roundtrip and fusion-queue
        contention hide behind the next frame's device work. (The
        reference hides the same latency with its tracking∥map threads,
        MobileFusion.cpp:92-112.)

        `host_packed`: the HOST copy of the packed frame, if the caller
        kept one (io.prefetch keep_host). The keyframe branch then takes
        its atlas-blit rgb from these bytes instead of downloading back
        the very pixels the host just uploaded (saves a ~1 MB d2h + one
        ~23 ms stream stall per keyframe)."""
        pending = self._dispatch_frame(depth_raw, rgb, timestamp)
        pending["host_packed"] = host_packed
        if self.config.parallel.pipelined_tracking:
            self._inflight.append(pending)
            depth = max(1, self.config.parallel.pipeline_depth)
            ride = self.config.parallel.pipeline_max_ride
            bound = max(depth + 1, ride if ride > 0 else 0)
            while len(self._inflight) > depth:
                # ADAPTIVE depth: past the nominal depth, finalize only
                # frames whose decision stats have landed — let the rest
                # ride (bounded at `bound`) instead of stalling the
                # tracking thread on the contended link. The stale-ref
                # re-anchoring path absorbs the extra frames.
                head = self._inflight[0]
                if (len(self._inflight) <= bound
                        and head["stats2"] is not None
                        and hasattr(head["stats2"], "done")
                        and not head["stats2"].done()):
                    break
                self._finalize_frame(self._inflight.pop(0))
        else:
            self._finalize_frame(pending)
        # per-frame TRANSFER-WINDOW flush: every deferred fetch queued
        # since the last frame (mesh counts, GC/quality probes, texture
        # outputs, discovery ids, promotion probes) launches in ONE
        # burst here — co-issued transfers share a single ~23 ms
        # device-stream stall (measured: 1 fetch ≈ 23 ms stall, 10
        # co-issued ≈ 26 ms) instead of paying one stall per call site.
        # Deliberately NOT fused with the stats fetch above: sharing
        # that window delayed the latency-critical stats landing behind
        # the bulk payloads (+10 ms t_stats_sync).
        from texturefusion_tpu.utils.async_fetch import flush_fetches
        flush_fetches()

    def flush_tracking(self) -> None:
        """Finalize the in-flight pipelined frames, if any."""
        while self._inflight:
            self._finalize_frame(self._inflight.pop(0))

    def _dispatch_frame(self, depth_raw, rgb, timestamp: float) -> dict:
        """Launch one frame's device step; NO host sync."""
        intr = self.intr
        kp = res = None
        fused_kf = None
        last_kf = self.slam.last_keyframe
        with STOPWATCH.time("preprocess"):
            res_ff = stats2 = None
            if last_kf is not None:
                # steady state: preprocessing + features + registration
                # against BOTH the last keyframe and the previous frame +
                # keyframe depth refinement in ONE dispatch
                # (models.reconstruction.frame_step_tracked2)
                from texturefusion_tpu.models.reconstruction import \
                    frame_step_tracked2
                kp_ref = self.slam.frames[last_kf.frame_index].keypoints
                kp_prev = self._kp_prev if self._kp_prev is not None \
                    else kp_ref
                st_ref = self.kf_states.get(last_kf.slot)
                if st_ref is not None:
                    # read ONCE into a local: the fusion thread's budget
                    # pass may set st_ref.depth_weight=None concurrently
                    # (release_device_memory) between a check and a reuse
                    kf_depth = st_ref.depth
                    w_local = st_ref.depth_weight
                    if w_local is None:
                        w_local = (jnp.asarray(kf_depth) > 0
                                   ).astype(jnp.float32)
                        st_ref.depth_weight = w_local
                    kf_weight = w_local
                else:
                    kf_depth = jnp.zeros((intr.height, intr.width),
                                         jnp.float32)
                    kf_weight = jnp.zeros((intr.height, intr.width),
                                          jnp.float32)
                bundle, kp, res, res_ff, stats2, f_depth, f_weight = \
                    frame_step_tracked2(
                        depth_raw, rgb, kp_ref, kp_prev, kf_depth, kf_weight,
                        self.slam.base_key,
                        np.int32(self._dispatch_count), intr,
                        self.config.tracking, self.config.camera.depth_scale)
                fused_kf = (f_depth, f_weight)
                self._kp_prev = kp
                # the readback lands on the helper thread
                from texturefusion_tpu.utils.async_fetch import fetch_async
                if _FETCH_TRACE:
                    import threading as _th
                    import time as _tm
                    dev_val, t_disp = stats2, _tm.perf_counter()

                    def _probe(v=dev_val, t0=t_disp):
                        jax.block_until_ready(v)
                        _COMPUTE_LOG.append((_tm.perf_counter() - t0) * 1e3)
                    _th.Thread(target=_probe, daemon=True).start()
                stats2 = fetch_async(stats2)
            else:
                bundle = preprocess.preprocess_bundle(
                    depth_raw, rgb, intr,
                    depth_scale=self.config.camera.depth_scale)
        self._dispatch_count += 1
        return {"bundle": bundle, "kp": kp, "res": res, "res_ff": res_ff,
                "stats2": stats2, "fused_kf": fused_kf,
                "kf_slot": last_kf.slot if last_kf is not None else None,
                "timestamp": timestamp}

    def _finalize_frame(self, p: dict) -> None:
        """Consume one dispatched frame's results: SLAM decisions,
        keyframe promotion, local-frame bookkeeping, fusion submission."""
        intr = self.intr
        depth_refined, normals, quality, gray, _blur, rgb = p["bundle"]
        kp, res, fused_kf = p["kp"], p["res"], p["fused_kf"]

        # blur gate blocks keyframe promotion (ref: BasicAPI.cpp:1256-1266,
        # GCSLAM.cpp:315); threshold ≤ 0 disables (synthetic scenes score
        # below the real-image threshold). The blur score rides the
        # per-frame stats fetch; only the first frame (no tracked
        # dispatch) falls back to the lazy scalar fetch.
        blur_thresh = self.config.tracking.blur_threshold
        if blur_thresh > 0:
            blurred = lambda: bool(float(_blur) < blur_thresh)  # noqa: E731
        else:
            blurred = False

        stats = stats_ff = None
        if p["stats2"] is not None:
            with STOPWATCH.time("t_stats_sync"):
                s2 = p["stats2"]
                if _FETCH_TRACE and hasattr(s2, "t_created"):
                    import time as _t
                    now = _t.perf_counter()
                    land = s2.t_landed
                    _FETCH_LOG.append((
                        (now - s2.t_created) * 1e3,
                        (land - s2.t_created) * 1e3 if land else -1.0))
                s2 = s2.result() if hasattr(s2, "result") else np.asarray(s2)
            stats, stats_ff = s2[:21], s2[21:42]
            if blur_thresh > 0:
                blurred = bool(s2[42] < blur_thresh)
        with STOPWATCH.time("tracking"):
            frame = self.slam.update_frame(gray, depth_refined,
                                           p["timestamp"],
                                           blurred=blurred, kp=kp, res=res,
                                           res_kf_slot=p["kf_slot"],
                                           stats=stats,
                                           res_ff=p["res_ff"],
                                           stats_ff=stats_ff)
        self.stats["frames"] += 1
        self._refresh_disco_prefetch()

        if frame.is_keyframe:
            rgb_u8 = (rgb * 255).astype(jnp.uint8)
            hp = p.get("host_packed")
            if hp is not None and hp.ndim == 3 and hp.shape[-1] == 5:
                # atlas-blit rgb from the retained HOST packed bytes —
                # bit-identical to rgb_u8 (preprocess passes raw rgb
                # through), no 1 MB download of pixels the host uploaded
                host_rgb = np.ascontiguousarray(hp[..., 2:5])
            else:
                host_rgb = None
                try:
                    # atlas blits need the host copy ~1 cycle later;
                    # start the ~1 MB transfer now so rgb_np() is landed
                    rgb_u8.copy_to_host_async()
                except Exception:
                    pass
            self.kf_states[frame.keyframe_slot] = KeyframeFusionState(
                kf_slot=frame.keyframe_slot,
                frame_index=frame.index,
                depth=depth_refined,                      # device-resident
                rgb=rgb_u8,                               # device-resident
                quality=quality,                          # device-resident
                rgb_host=host_rgb,
                local_depths=[], local_rel_poses=[])
            self.stats["keyframes"] += 1
            # previous keyframe is now finished → fusion cycle
            # (ref: MobileFusion.cpp:274-406 runs on kflist.size()-2)
            # dispatch chunk discovery for THIS keyframe now — it is
            # consumed a whole keyframe interval later, when the NEXT
            # promotion triggers this keyframe's integration, so the
            # fetch has a full interval to land instead of milliseconds.
            # The dispatch pose is recorded: loop-closure BA corrections
            # inside that window can be cm-scale, so the consume side
            # re-validates the pose delta and falls back to a fresh
            # discovery when the candidate set may have shifted.
            # peek: syncing would stall on the in-flight BA fetch; the
            # consume-side guard below re-validates against the synced
            # pose anyway before trusting the candidate set
            disco_pose = self.slam.keyframe_pose_peek(frame.keyframe_slot)
            self._disco_prefetch[frame.keyframe_slot] = (
                self.volume.dispatch_discovery(
                    jnp.asarray(depth_refined), jnp.asarray(disco_pose)),
                disco_pose)
            # evict only prefetches whose keyframe ALREADY integrated or
            # can never fuse (other origins) — when fusion cycles back
            # up, several un-fused keyframes legitimately queue, and a
            # size-based eviction discarded exactly the prefetch the
            # next cycle needed (21 of 27 lost → ~130 ms blocking
            # re-discovery each). Handles are ~48 KB each.
            for s in list(self._disco_prefetch):
                st_s = self.kf_states.get(s)
                if (st_s is None or st_s.integrated
                        or self.slam.keyframes[s].origin_index != 0):
                    self._disco_prefetch.pop(s)
            while len(self._disco_prefetch) > 16:   # runaway backstop
                self._disco_prefetch.pop(min(self._disco_prefetch))
            prev = frame.keyframe_slot - 1
            if prev >= 0:
                self._submit_fusion(prev)
        else:
            # accumulate local-frame depth for keyframe refinement +
            # depth-only integration (ref: refineKeyframesSIMD usage
            # main.cpp:124-135; MobileFusion.cpp:187-203)
            st = self.kf_states.get(frame.keyframe_slot)
            if st is not None and frame.tracking_success:
                n_keep = self.config.tsdf.local_frames_per_keyframe
                if len(st.local_depths) < n_keep:
                    st.local_depths.append(depth_refined)  # device-resident
                    st.local_rel_poses.append(frame.rel_to_keyframe)
                    st.local_frame_idx.append(frame.index)
                if not st.integrated:
                    # adopt the keyframe depth refined INSIDE the fused
                    # frame step (ref: refineKeyframesSIMD
                    # BasicAPI.cpp:506-635) — zero extra dispatches
                    with STOPWATCH.time("kf_refine"):
                        if fused_kf is not None \
                                and st.kf_slot == p["kf_slot"] \
                                and frame.keyframe_slot == p["kf_slot"]:
                            st.depth, st.depth_weight = fused_kf
                        else:
                            if st.depth_weight is None:
                                st.depth_weight = (
                                    jnp.asarray(st.depth) > 0
                                ).astype(jnp.float32)
                            rel = (frame.rel_pose_dev
                                   if frame.rel_pose_dev is not None
                                   else jnp.asarray(frame.rel_to_keyframe))
                            st.depth, st.depth_weight = _fuse_depth_jit(
                                jnp.asarray(st.depth), st.depth_weight,
                                depth_refined, rel, intr)

    def _consume_deferred_integration(self, force: bool = False) -> None:
        """Integrate keyframes whose candidate set had to be
        re-discovered (stale prefetch): the fresh discovery has landed by
        the next cycle, so the integration runs with an exact set and
        ZERO blocking fetches — one cycle later than usual, which the
        drift-reintegration machinery already tolerates."""
        for slot in list(self._deferred_integration):
            fut = self._deferred_integration[slot]
            if not force and not fut[0].done():
                continue
            del self._deferred_integration[slot]
            st = self.kf_states.get(slot)
            if st is None or st.integrated:
                continue
            with STOPWATCH.time("integration_deferred"):
                self._integrate_keyframe(st, sign=1.0, prefetched=fut)

    def _refresh_disco_prefetch(self) -> None:
        """Re-dispatch the newest keyframe's chunk-discovery prefetch
        once its deferred promotion has been consumed: the promotion-time
        dispatch used the provisional (peeked) pose, and the consume's
        reference re-selection + BA init can move it enough that the
        consume-side guard would reject the candidate set (measured 17
        of 27 prefetches dropped → a ~100 ms queued fresh-discovery
        fetch on the fusion thread each cycle). The refresh still runs a
        full keyframe interval before the set is needed."""
        if not self._disco_prefetch or self.slam._pending_promote is not None:
            return
        # ALL queued prefetches: when fusion cycles back up, several
        # un-fused keyframes hold prefetches whose provisional poses BA
        # keeps correcting; a re-dispatch is ~0.2 ms + a 48 KB fetch,
        # while a stale set costs a delta top-up round later
        for slot in list(self._disco_prefetch):
            pre, pose0 = self._disco_prefetch[slot]
            st = self.kf_states.get(slot)
            if st is None or st.integrated:
                continue
            pose1 = self.slam.keyframe_pose_peek(slot)
            delta = float(np.linalg.norm(pose1[:3, 3] - pose0[:3, 3]))
            cosang = (np.trace(pose1[:3, :3].T @ pose0[:3, :3]) - 1) / 2
            ang = float(np.arccos(np.clip(cosang, -1.0, 1.0)))
            if (delta + ang * self.intr.far * 0.5
                    > 0.25 * self.volume.extent):
                self._disco_prefetch[slot] = (
                    self.volume.dispatch_discovery(
                        jnp.asarray(st.depth), jnp.asarray(pose1)), pose1)

    def finish(self) -> None:
        """Flush: fuse remaining keyframes and run final re-integration
        at optimized poses (ref: main.cpp:213-317 finalization)."""
        self.flush_tracking()
        self._drain_fusion()
        self.slam.final_ba()
        for slot in range(len(self.slam.keyframes)):
            st = self.kf_states.get(slot)
            if st is not None and not st.integrated:
                self.fusion_cycle(slot)
        async_mode = self.config.parallel.async_cycle_results
        if async_mode:
            # drain deferred results BEFORE the final sync remesh — the
            # pending counts predate it and must not overwrite its counts
            self._consume_cycle_results(force=True)
        # re-integrate any keyframe whose pose moved since integration.
        # The final BA's pose fetch must be materialized first — the
        # steady-state path deliberately reads peeked poses.
        self.slam._sync_poses()
        self._reintegrate_drifted(max_updates=len(self.slam.keyframes))
        self.mesher.update_meshes()
        if async_mode:
            # one synchronous texture catch-up cycle over the final
            # observations/labels, then a final GC pass
            self._texture_final()
            freed = self.volume.gc_new_chunks()
            if len(freed):
                self.mesher.drop(freed)

    # --------------------------------------------------------------- fusion

    def _integrate_keyframe(self, st: KeyframeFusionState, sign: float,
                            prefetched=None) -> None:
        with STOPWATCH.time("i_pose"):
            pose = (st.integrated_pose if sign < 0
                    else self.slam.keyframe_pose(st.kf_slot))
            pose_j = jnp.asarray(pose)
        kf_id = st.kf_slot
        if sign < 0 and st.integrated_slots is not None:
            # de-integration must touch EXACTLY the integrated chunk set;
            # reusing it also skips the discovery fetch
            slots = st.integrated_slots
        else:
            with STOPWATCH.time("i_disco"):
                slots = self.volume.discover_chunks(
                    jnp.asarray(st.depth), pose_j, allocate=sign > 0,
                    prefetched=prefetched)
        with STOPWATCH.time("i_frame"):
            slots = self.volume.integrate_frame(
                jnp.asarray(st.depth),
                jnp.asarray(st.rgb.astype(np.float32) / 255.0),
                jnp.asarray(st.quality), pose_j, keyframe_id=kf_id,
                sign=sign, slots=slots)
        if sign > 0 and not st.integrated and st.local_frame_idx:
            # adopt any retroactively-refined stale-frame rel poses
            # (gcslam.consume_pending_refine) BEFORE first integration;
            # frozen afterwards so de/re-integration cancels exactly
            st.local_rel_poses = [
                self.slam.frames[i].rel_to_keyframe
                for i in st.local_frame_idx]
        # local frames: depth-only, reusing the keyframe's chunk set — the
        # local frames view (almost) the same volume (tracked below the
        # disparity gate), so re-discovery per frame is redundant; all of
        # them integrate in ONE scanned dispatch
        # (ref: MobileFusion.cpp:187-203)
        if st.local_depths:
            with STOPWATCH.time("i_locals"):
                self.volume.integrate_local_depths(
                    st.local_depths,
                    [pose @ rel for rel in st.local_rel_poses],
                    slots, sign=sign)
        if sign > 0:
            st.integrated_pose = np.asarray(pose)
            st.integrated_slots = slots
            st.integrated = True
        else:
            st.integrated = False

    def _consume_cycle_results(self, force: bool = False) -> None:
        """Apply prior cycles' deferred device results. By default only
        fetches whose device values are READY are consumed (the rest
        wait one more cycle — the fusion thread never stalls on
        in-flight device work); force=True drains everything (finish)."""
        with STOPWATCH.time("consume_mesh"):
            self.mesher.consume_counts(ready_only=not force)
        with STOPWATCH.time("consume_tex"):
            self._texture_consume(force=force)
        with STOPWATCH.time("consume_deferred_int"):
            self._consume_deferred_integration(force=force)
        with STOPWATCH.time("consume_gc"):
            pend, self._gc_pending = self._gc_pending, None
            if pend is not None:
                if force:
                    pend.pop("defer_ok", None)
                with STOPWATCH.time("gcc_probe"):
                    out = self.volume.gc_consume(pend)
                if isinstance(out, dict):
                    self._gc_pending = out   # probe still in flight
                elif len(out):
                    with STOPWATCH.time("gcc_drop"):
                        self.mesher.drop(out)
            with STOPWATCH.time("gcc_flush"):
                self.volume.flush_observations(ready_only=not force)

    def fusion_cycle(self, finished_slot: int) -> None:
        """One map-thread cycle (ref: MobileFusion.cpp:274-406 tsdfFusion).

        With parallel.async_cycle_results (the default), the cycle first
        CONSUMES the previous cycle's deferred results, then only
        DISPATCHES this cycle's device work and starts the copies — the
        fusion thread never blocks on a readback."""
        async_mode = self.config.parallel.async_cycle_results
        if async_mode:
            self._consume_cycle_results()
        with STOPWATCH.time("reintegration"):
            self._reintegrate_drifted()
        st = self.kf_states.get(finished_slot)
        if st is not None and not st.integrated:
            if self.slam.keyframes[finished_slot].origin_index == 0:
                # only origin-0 frames are fused (ref: MobileFusion.cpp:245)
                pre = self._disco_prefetch.pop(finished_slot, None)
                if pre is not None:
                    pre, disco_pose = pre
                    # the prefetch ran with a provisional pose; a BA
                    # correction since then can shift the truncation-band
                    # chunk set. The prefetched set is ALWAYS used (a
                    # fresh blocking discovery paid ~100-180 ms of queued
                    # fetch on the fusion thread); when the pose moved
                    # beyond the drift-reuse threshold, a fresh discovery
                    # is dispatched too and any chunks it adds are
                    # topped-up NEXT cycle (voxel updates are per-chunk
                    # independent, so integrating the keyframe into the
                    # missing rows later composes exactly;
                    # ref validChunks reuse: MobileFusion.cpp:128-143).
                    pose_now = self.slam.keyframe_pose(finished_slot)
                    delta = float(np.linalg.norm(pose_now[:3, 3]
                                                 - disco_pose[:3, 3]))
                    cosang = (np.trace(pose_now[:3, :3].T
                                       @ disco_pose[:3, :3]) - 1) / 2
                    ang = float(np.arccos(np.clip(cosang, -1.0, 1.0)))
                    if (delta + ang * self.intr.far * 0.5
                            > 0.75 * self.volume.extent):
                        # set went stale: re-discover at the current pose
                        # and integrate NEXT cycle when the fetch lands
                        self._deferred_integration[finished_slot] = \
                            self.volume.dispatch_discovery(
                                jnp.asarray(st.depth), jnp.asarray(pose_now))
                        pre = None
                        STOPWATCH.counts["disco_pref_defer"] += 1
                    else:
                        STOPWATCH.counts["disco_pref_used"] += 1
                else:
                    STOPWATCH.counts["disco_pref_miss"] += 1
                if finished_slot not in self._deferred_integration:
                    with STOPWATCH.time("integration"):
                        self._integrate_keyframe(st, sign=1.0,
                                                 prefetched=pre)
        with STOPWATCH.time("meshing"):
            if async_mode:
                self.mesher.update_meshes_async()
            else:
                self.mesher.update_meshes()
        self._texture_cycle()
        # post-cycle housekeeping (ref: FinalizeIntegrateChunks GC,
        # Chisel.h:184-216; clearRedudentFrameMemory MobileFusion.cpp:71-90)
        with STOPWATCH.time("gc"):
            if async_mode:
                # a still-deferred probe keeps priority; new candidates
                # stay in new_since_gc for the next dispatch
                if self._gc_pending is None:
                    self._gc_pending = self.volume.gc_dispatch()
            else:
                freed = self.volume.gc_new_chunks()
                if len(freed):
                    self.mesher.drop(freed)
            # keyframe memory bound: stage out the OLDEST integrated
            # keyframes when the device-resident keyframe state exceeds
            # its budget (offload itself costs link bandwidth)
            budget = self.config.tsdf.keyframe_device_budget_mb * 2**20
            newest = max(self.kf_states, default=-1)
            resident = [
                (s, st2) for s, st2 in sorted(self.kf_states.items())
                if st2.integrated and st2.depth_weight is not None
                and s != newest]   # tracking still refines the newest
            approx = sum(self._kf_device_bytes(st2) for _, st2 in resident)
            for s, st2 in resident:
                if approx <= budget:
                    break
                approx -= self._kf_device_bytes(st2)
                st2.release_device_memory()
            if (self.streamer is not None
                    and self.volume.n_active()
                    > self.config.tsdf.max_resident_chunks):
                cam_pos = self.slam.keyframe_pose(finished_slot)[:3, 3]
                # meshes of offloaded chunks stay exportable under their
                # chunk ids (slots get recycled)
                act_before = set(self.volume.active_slots().tolist())
                self.streamer.offload_cold(cam_pos)
                gone = act_before - set(self.volume.active_slots().tolist())
                if gone:
                    self.mesher.freeze(np.asarray(sorted(gone)))

    @staticmethod
    def _kf_device_bytes(st: KeyframeFusionState) -> int:
        """Approximate device-resident bytes of a keyframe's stageable
        state (local depths + quality + refinement weight)."""
        n = 0
        for d in st.local_depths:
            if not isinstance(d, np.ndarray):
                n += d.size * 4
        if st.quality is not None and not isinstance(st.quality, np.ndarray):
            n += st.quality.size * 4
        if st.depth_weight is not None:
            n += st.depth_weight.size * 4
        return n

    def _texture_cycle(self) -> None:
        """Hook for the texture stage (overridden by TexturedPipeline)."""

    def _texture_consume(self, force: bool = False) -> None:
        """Hook: apply the previous cycle's deferred texture results."""

    def _texture_final(self) -> None:
        """Hook: one synchronous catch-up texture cycle at finish()."""

    def _reintegrate_drifted(self, max_updates: int = 4) -> None:
        """De-integrate at the old pose, re-integrate at the optimized pose
        (ref: MobileFusion.cpp:114-221 ReIntegrateKeyframe; scheduling
        :289-315)."""
        slots = [s for s, st in list(self.kf_states.items()) if st.integrated]
        if not slots:
            return
        # peeked poses: drift selection and the correction target may lag
        # one BA round; the next cycle's pass picks up the residual (the
        # de-integration always uses the RECORDED integrated_pose, so
        # consistency never depends on this read being fresh). Syncing
        # here stalled the fusion thread on the in-flight BA fetch.
        current = np.stack([self.slam.keyframe_pose_peek(s) for s in slots])
        integrated = np.stack([self.kf_states[s].integrated_pose for s in slots])
        costs = dynamics.pose_drift_costs(current, integrated)
        picked = dynamics.select_keyframes_to_update(costs, max_updates)
        import os
        if os.environ.get("TF_DEBUG_DRIFT"):
            print(f"[DRIFT] max_cost={costs.max():.2e} "
                  f"mean={costs.mean():.2e} picked={picked}")
        for i in picked:
            st = self.kf_states[slots[i]]
            pose_new = self.slam.keyframe_pose_peek(st.kf_slot)
            pose_old = st.integrated_pose
            # the recorded chunk set (ref: kf.validChunks reuse,
            # MobileFusion.cpp:128-143) stays valid when the corrected
            # pose moved less than a fraction of the chunk extent:
            # camera translation plus the far-plane sweep of the rotation
            delta = float(np.linalg.norm(pose_new[:3, 3] - pose_old[:3, 3]))
            cosang = (np.trace(pose_new[:3, :3].T @ pose_old[:3, :3]) - 1) / 2
            ang = float(np.arccos(np.clip(cosang, -1.0, 1.0)))
            # rotation sweep scored at HALF the far plane (band chunks
            # cluster around the observed surface, not the frustum rim);
            # a fringe chunk missed by reuse costs a sliver of truncation
            # band that the next integration of the area restores
            sweep = delta + ang * self.intr.far * 0.5
            reuse = (st.integrated_slots is not None
                     and sweep < 0.75 * self.volume.extent)
            with STOPWATCH.time("r_retract"):
                self.volume.retract_observations(st.kf_slot)
            if reuse:
                # fused de+re-integration: one program over one gather of
                # the recorded chunk rows, zero discovery fetches
                with STOPWATCH.time("r_fused"):
                    self.volume.reintegrate_frame(
                        jnp.asarray(st.depth),
                        jnp.asarray(st.rgb.astype(np.float32) / 255.0),
                        jnp.asarray(st.quality),
                        jnp.asarray(pose_old), jnp.asarray(pose_new),
                        st.kf_slot, st.integrated_slots)
                    if st.local_depths:
                        self.volume.reintegrate_local_depths(
                            st.local_depths,
                            [pose_old @ r for r in st.local_rel_poses],
                            [pose_new @ r for r in st.local_rel_poses],
                            st.integrated_slots)
                st.integrated_pose = np.asarray(pose_new)
            else:
                with STOPWATCH.time("r_deint"):
                    self._integrate_keyframe(st, sign=-1.0)  # @ old pose
                with STOPWATCH.time("r_reint"):
                    self._integrate_keyframe(st, sign=+1.0)  # @ new pose
            self.stats["reintegrations"] += 1

    # --------------------------------------------------------------- export

    def export_mesh(self, path: str, weld: bool = True) -> int:
        """PLY export; `weld` merges the duplicated chunk-boundary
        vertices (each chunk owns its 9³ edge grid, so shared-face
        vertices appear twice) via fine vertex clustering
        (ref: CompressMeshes Chisel.cpp:112-147)."""
        from texturefusion_tpu.io import ply
        from texturefusion_tpu.ops.simplify import simplify_by_clustering

        verts, faces, colors, normals = self.mesher.full_mesh()
        if weld and len(verts):
            cell = self.config.tsdf.voxel_resolution * 0.25
            verts, faces, colors, normals = simplify_by_clustering(
                verts, faces, cell, colors, normals)
        ply.save_ply(path, verts, faces, colors, normals)
        return len(verts)

    def trajectory(self) -> np.ndarray:
        return self.slam.trajectory()

    def save_trajectory(self, path: str, timestamps=None) -> None:
        traj = self.trajectory()
        if timestamps is None:
            timestamps = [f.timestamp for f in self.slam.frames]
        from texturefusion_tpu.io import ply as _ply
        _ply.save_trajectory_tum(path, timestamps, traj)

    def save_keyframe_textures(self, out_dir: str) -> int:
        """Per-keyframe %06d.cam + %06d.png dump (ref: main.cpp:287-313):
        camera file holds the world-to-camera pose row-major + intrinsics."""
        import os

        from texturefusion_tpu.io.image import write_png

        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for slot, st in sorted(self.kf_states.items()):
            pose = self.slam.keyframe_pose(slot)
            w2c = np.linalg.inv(pose)
            with open(os.path.join(out_dir, f"{slot:06d}.cam"), "w") as f:
                vals = list(w2c[:3].reshape(-1)) + [
                    self.intr.fx, self.intr.fy, self.intr.cx, self.intr.cy]
                f.write(" ".join(f"{v:.8f}" for v in vals) + "\n")
            write_png(os.path.join(out_dir, f"{slot:06d}.png"), st.rgb_np())
            n += 1
        return n

    def memory_stats(self) -> Dict[str, float]:
        """Approximate memory accounting in MB
        (ref: Frame::GetOccupiedMemorySize frame.h:68-99)."""
        vol = self.volume
        dev = sum(np.prod(a.shape) * 4 for a in vol.batch) + vol.origins.size * 4
        kf = sum(st.depth.nbytes + st.rgb.nbytes + st.quality.nbytes
                 + sum(d.nbytes for d in st.local_depths)
                 for st in self.kf_states.values())
        meshes = sum(sum(a.nbytes for a in m)
                     for m in self.mesher.meshes.values())
        return {"device_tsdf_mb": float(dev) / 2**20,
                "keyframe_cache_mb": float(kf) / 2**20,
                "mesh_cache_mb": float(meshes) / 2**20,
                "chunks_active": float(vol.n_active())}

    def save_stats(self, out_dir: str) -> None:
        """stat.txt / chunk.txt equivalents (ref: main.cpp:213-235)."""
        import os

        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "stat.txt"), "w") as f:
            f.write(STOPWATCH.report() + "\n")
            for k, v in self.stats.items():
                f.write(f"{k}: {v}\n")
            for k, v in self.memory_stats().items():
                f.write(f"{k}: {v:.2f}\n")
        with open(os.path.join(out_dir, "chunk.txt"), "w") as f:
            f.write(f"chunks_created {self.volume.chunks_created} "
                    f"active {self.volume.n_active()} "
                    f"meshed {len(self.mesher.meshes)}\n")


class TexturedPipeline(ReconstructionPipeline):
    """Full pipeline with online texturing — the reference's complete
    TextureFusion behavior (ref: MobileFusion.cpp:356-384 texture stages
    of tsdfFusion)."""

    def __init__(self, config: PipelineConfig):
        super().__init__(config)
        from texturefusion_tpu.texture.manager import TextureManager
        self.texture = TextureManager(config)

    def _tex_states(self) -> dict:
        import types
        tex_states = {}
        # snapshot: the tracking thread adds keyframes concurrently.
        # rgb stays the DEVICE uint8 buffer (projection converts on
        # device); atlas blits use the lazily cached host copy.
        for slot, st in list(self.kf_states.items()):
            tex_states[slot] = types.SimpleNamespace(
                pose=self.slam.keyframe_pose(slot),
                rgb=st.rgb,
                rgb_host=st.rgb_np,
                depth=st.depth)
        return tex_states

    def _texture_cycle(self) -> None:
        if not self.slam.keyframes:
            return
        async_mode = self.config.parallel.async_cycle_results
        with STOPWATCH.time("texture"):
            self.texture.update_dispatch(
                self.volume, self.mesher, self._tex_states(),
                newest_kf=len(self.slam.keyframes) - 1,
                remeshed=self.mesher.last_remeshed,
                flush_obs=not async_mode)
            if not async_mode:
                self.texture.update_consume()

    def _texture_consume(self, force: bool = False) -> None:
        self.texture.update_consume(force=force)

    def _texture_final(self) -> None:
        """Synchronous catch-up cycle: every meshed chunk re-selected and
        (re)patched against the FINAL observations and BA poses."""
        if not self.slam.keyframes:
            return
        want = set(np.nonzero(self.mesher.tcount[:-1] > 0)[0].tolist())
        for _ in range(16):     # budget-limited passes until caught up
            self.texture.update(self.volume, self.mesher,
                                self._tex_states(),
                                newest_kf=len(self.slam.keyframes) - 1,
                                remeshed=want)
            want = set()
            if not self.texture._carry or self.texture.atlas.overflowed:
                break   # caught up, or no atlas space left to place work

    def export_textured(self, out_dir: str, name: str = "model") -> str:
        return self.texture.export_textured(self.mesher, out_dir, name)
