"""Chunked TSDF volume: slot-indexed device arrays + host-side allocator.

JAX replacement for open_chisel's pointer-based chunk hash map
(ref: Structure/ChunkManager.h:119-1306 ChunkManager;
open_chisel/geometry/Chunk.h — Chunk/DistVoxel/ColorVoxel) and the Chisel
facade's integration scan (ref: Structure/Chisel.h:103-249
PrepareIntersectChunks / IntegrateDepthScanColor / FinalizeIntegrateChunks).

Design (SURVEY.md §7): the TSDF lives in dense [capacity, 512] arrays on
device; a host dict maps integer ChunkID → slot with a free list. Per-frame
updates gather a fixed-size batch of chunk rows, run the jitted voxel
kernel, and scatter back — shapes are static so everything compiles once.
Slot `capacity` is a trash row absorbing padded scatter lanes.

The per-(chunk, keyframe) observation-quality table that feeds the texture
MRF (ref: Chunk.h:170-172 `observations`; Structure/sparse_matrix.h) is kept
host-side as a dict of dicts, updated from the kernel's per-chunk sums.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.config import PipelineConfig
from texturefusion_tpu.core import camera as cam
from texturefusion_tpu.core import geometry
from texturefusion_tpu.ops import tsdf as tsdf_ops


@jax.jit
def _row_occupancy(weight: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(jnp.abs(jnp.take(weight, idx, axis=0)), axis=-1)


@jax.jit
def _set_origin_rows(origins: jnp.ndarray, idx: jnp.ndarray,
                     vals: jnp.ndarray) -> jnp.ndarray:
    return origins.at[idx].set(vals)


@jax.jit
def _reset_rows(batch: "tsdf_ops.ChunkBatch",
                idx: jnp.ndarray) -> "tsdf_ops.ChunkBatch":
    return tsdf_ops.ChunkBatch(
        sdf=batch.sdf.at[idx].set(tsdf_ops.RESET_SDF),
        weight=batch.weight.at[idx].set(0.0),
        color=batch.color.at[idx].set(0.0),
        color_count=batch.color_count.at[idx].set(0.0),
    )


class TSDFVolume:
    def __init__(self, config: PipelineConfig,
                 sharding: Optional[object] = None):
        self.config = config
        self.cfg = config.tsdf
        self.intr = cam.Intrinsics.from_config(config.camera)
        self.sharding = sharding
        if sharding is not None:
            # slot axis must divide evenly over the mesh; grow capacity
            # so (capacity + trash row) is a multiple of the shard count
            import dataclasses as _dc
            n_sh = sharding.mesh.size
            cap = -(-(self.cfg.capacity + 1) // n_sh) * n_sh - 1
            if cap != self.cfg.capacity:
                self.cfg = _dc.replace(self.cfg, capacity=cap)
        cap = self.cfg.capacity
        v = self.cfg.chunk_size ** 3
        self.n_voxels = v
        # +1 trash slot for padded scatter lanes
        self.batch = tsdf_ops.make_empty_batch(cap + 1, v)
        self.origins = jnp.zeros((cap + 1, 3), jnp.float32)
        if sharding is not None:
            self.batch = jax.tree.map(lambda a: jax.device_put(a, sharding), self.batch)
            self.origins = jax.device_put(self.origins, sharding)

        # host-side allocator: native C++ hash map when available
        # (native/chunk_alloc.cpp), Python fallback otherwise
        from texturefusion_tpu.native.allocator import make_allocator
        self.alloc = make_allocator(cap)
        self.slot_of: Dict[Tuple[int, int, int], int] = {}  # synced view
        self.ids = np.zeros((cap, 3), np.int32)             # synced view
        self.used = np.zeros(cap, bool)                     # synced view
        # per-(chunk, keyframe) observation quality as DENSE host arrays
        # [cap+1, max_kf] — presence is _obs_mask; every consumer
        # (flush, GC checks, retraction, MRF data-cost assembly) is a
        # vectorized numpy op. The previous dict-of-dicts burned ~100 ms
        # of GIL-held Python per fusion cycle in per-entry loops, which
        # starved the 2-core host's tracking thread. Updates are DEFERRED
        # device fetches (each sync waits for a readback) — flushed
        # lazily on first read.
        self._max_kf = config.ba.max_keyframes
        self._obs_q = np.zeros((cap + 1, self._max_kf), np.float32)
        self._obs_mask = np.zeros((cap + 1, self._max_kf), bool)
        self._pending_obs: List[tuple] = []   # (slots, quality_dev, updated_dev, kf_id, sign)
        self.dirty_mesh: Set[int] = set()       # slots needing remesh
        self.chunks_created: int = 0
        # per-slot last-touched integration generation: lets a DEFERRED
        # GC consume skip candidates whose occupancy probe went stale
        # (integrated again between probe and consume)
        self._gen: int = 0
        self._touch_gen = np.zeros(cap + 1, np.int64)
        # slots allocated since the last GC pass (candidates for the
        # empty-chunk garbage collection each fusion cycle,
        # ref: Chisel.h:184-216 GC of empty new chunks)
        self.new_since_gc: Set[int] = set()
        # optional ChunkStreamer (fusion/streaming.py): restores offloaded
        # chunks on revisit before slot assignment
        self.streamer = None

    @property
    def observations(self) -> Dict[int, Dict[int, float]]:
        """Dict-of-dicts SNAPSHOT of the observation table (flushed).
        For checkpointing / inspection — the hot paths read the dense
        arrays via obs_arrays()/obs_row() instead."""
        self.flush_observations()
        out: Dict[int, Dict[int, float]] = {}
        rows, cols = np.nonzero(self._obs_mask[: self.cfg.capacity])
        for s, k in zip(rows.tolist(), cols.tolist()):
            out.setdefault(s, {})[k] = float(self._obs_q[s, k])
        return out

    @observations.setter
    def observations(self, value: Dict[int, Dict[int, float]]) -> None:
        self._pending_obs = []
        self._obs_q[:] = 0.0
        self._obs_mask[:] = False
        for s, d in value.items():
            for kf, q in d.items():
                self._obs_q[int(s), int(kf)] = q
                self._obs_mask[int(s), int(kf)] = True

    def obs_arrays(self, flush: bool = True):
        """The dense observation arrays (q [cap+1, max_kf] f32,
        mask [cap+1, max_kf] bool) — the hot-path view.

        flush=False skips resolving pending device fetches. Staleness
        contract: entries from integrations whose quality fetch has not
        been flushed are missing, and entries retracted by a
        de-integration whose flush is pending are still present — both
        self-correct at the next flush (the async texture cycle reads
        this view and tolerates the one-cycle lag; the final catch-up
        cycle always reads the flushed view)."""
        if flush:
            self.flush_observations()
        return self._obs_q, self._obs_mask

    def obs_row(self, slot: int) -> Dict[int, float]:
        """One slot's {keyframe: quality} dict (streaming offload)."""
        k = np.nonzero(self._obs_mask[slot])[0]
        return {int(j): float(self._obs_q[slot, j]) for j in k.tolist()}

    def set_obs_row(self, slot: int, d: Dict[int, float]) -> None:
        self._obs_q[slot] = 0.0
        self._obs_mask[slot] = False
        for kf, q in d.items():
            self._obs_q[slot, int(kf)] = q
            self._obs_mask[slot, int(kf)] = True

    def poison_observation(self, slot: int, kf: int) -> None:
        """Mark a wrong-mapping (chunk, keyframe) pair so the MRF never
        re-selects it (ref: MobileFusion.cpp:330-343 datacost removal).
        The entry stays PRESENT (GC must still treat the chunk as
        observed) with a strongly negative quality."""
        if self._obs_mask[slot, kf]:
            self._obs_q[slot, kf] = -1e11

    def flush_observations(self, ready_only: bool = False) -> None:
        """Apply deferred per-chunk observation-quality updates
        (ONE batched device_get for all pending integrations).
        ready_only=True applies only the ready PREFIX (dispatch order
        preserved) and leaves the rest pending for the next cycle."""
        if not self._pending_obs:
            return
        pend, self._pending_obs = self._pending_obs, []
        if ready_only:
            n_ready = 0
            for p in pend:
                if not p[1].done():
                    break
                n_ready += 1
            self._pending_obs = pend[n_ready:]
            pend = pend[:n_ready]
            if not pend:
                return
        self._apply_obs(pend)

    def _apply_obs(self, pend: List[tuple]) -> None:
        from texturefusion_tpu.utils.async_fetch import resolve
        from texturefusion_tpu.utils.stopwatch import STOPWATCH
        with STOPWATCH.time("obs_resolve"):
            fetched = [resolve(qu) for _, qu, _, _ in pend]
        with STOPWATCH.time("obs_apply"):
            for (slots, _, kf_id, sign), (q_np, u_np) in zip(pend, fetched):
                sl = np.asarray(slots, np.int64)
                # quality/updated are padded to the dispatch bucket —
                # only the first len(slots) lanes are real
                q_arr = np.asarray(q_np)[: len(sl)]
                up = np.asarray(u_np, bool)[: len(sl)]
                sl = sl[up]
                if sign > 0:
                    self._obs_q[sl, kf_id] = q_arr[up]
                    self._obs_mask[sl, kf_id] = True
                else:
                    self._obs_q[sl, kf_id] = 0.0
                    self._obs_mask[sl, kf_id] = False

    @property
    def free(self) -> List[int]:
        """Unallocated slots (derived view; allocation order is owned by
        the backend allocator)."""
        return [s for s in range(self.cfg.capacity) if not self.used[s]]

    def _register_new(self, new_slots: np.ndarray) -> None:
        """Sync host views + device origins for freshly allocated slots."""
        if len(new_slots) == 0:
            return
        ids_all, used_all = self.alloc.export()
        new_ids = ids_all[new_slots]
        self.ids[new_slots] = new_ids
        self.used[new_slots] = True
        for s, cid in zip(new_slots.tolist(), map(tuple, new_ids.tolist())):
            self.slot_of[cid] = int(s)
        self.chunks_created += len(new_slots)
        self.new_since_gc.update(int(s) for s in new_slots)
        origins = new_ids.astype(np.float32) * self.extent
        # BUCKETED jitted scatter: a fresh slot-count every keyframe would
        # otherwise compile a new eager scatter each time. Pad rows hit
        # the trash row.
        padded = self._bucket_slots(np.asarray(new_slots, np.int64),
                                    self.cfg.capacity)
        vals = np.zeros((len(padded), 3), np.float32)
        vals[: len(new_slots)] = origins
        self.origins = _set_origin_rows(self.origins, jnp.asarray(padded),
                                        jnp.asarray(vals))

    # ---------------------------------------------------------- allocator

    @property
    def extent(self) -> float:
        return self.cfg.chunk_size * self.cfg.voxel_resolution

    def n_active(self) -> int:
        return int(self.used.sum())

    def allocate(self, ids: np.ndarray) -> np.ndarray:
        """Get-or-create slots for integer chunk IDs (N, 3). Returns (N,)
        slot indices; -1 where the pool is exhausted."""
        ids = np.asarray(ids, np.int32)
        _, new_slots = self.alloc.touch(ids, allocate=True)
        self._register_new(new_slots)
        return self.alloc.lookup(ids)

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """Slots for chunk IDs without allocating; -1 for absent."""
        return self.alloc.lookup(np.asarray(ids, np.int32))

    @staticmethod
    def _bucket_slots(slots: np.ndarray, pad_value: int,
                      lo: int = 256) -> np.ndarray:
        """Pad a slot list to a power-of-two bucket so jitted consumers
        compile once per size class, not once per distinct count.
        lo=256 makes the common case (alloc/GC/drop batches of ≤256) a
        SINGLE shape for the whole session: with lo=64 the 64→128→256
        ladder re-entered the compile/cache-load path mid-run on the
        fusion thread (the gc_release/gcc_drop spikes)."""
        b = lo
        while b < len(slots):
            b *= 2
        return np.concatenate(
            [slots, np.full(b - len(slots), pad_value, np.int64)])

    def release(self, slots: np.ndarray) -> None:
        """Free chunk slots and reset their device rows
        (ref: Chisel.h:184-216 GC of empty new chunks)."""
        slots = np.asarray([s for s in np.atleast_1d(slots) if s >= 0], np.int64)
        if len(slots) == 0:
            return
        # pending updates must not resurrect released slots' entries:
        # flush the pending PREFIX up to the last entry touching them
        # (those fetches are a cycle old — landed); younger unrelated
        # entries stay asynchronous
        rel = set(slots.tolist())
        last = -1
        for k, p in enumerate(self._pending_obs):
            if rel.intersection(p[0].tolist()):
                last = k
        if last >= 0:
            prefix = self._pending_obs[: last + 1]
            self._pending_obs = self._pending_obs[last + 1:]
            self._apply_obs(prefix)
        self.alloc.release(slots)
        self._obs_q[slots] = 0.0
        self._obs_mask[slots] = False
        for s in slots.tolist():
            cid = tuple(self.ids[s])
            if self.slot_of.get(cid) == s:
                del self.slot_of[cid]
            self.used[s] = False
            self.dirty_mesh.discard(s)
        # bucketed reset (pad rows hit the trash slot, already reset)
        idx = jnp.asarray(self._bucket_slots(slots, self.cfg.capacity))
        self.batch = _reset_rows(self.batch, idx)

    # ---------------------------------------------------------- integration

    def dispatch_discovery(self, depth: jnp.ndarray,
                           cam_to_world: jnp.ndarray,
                           max_out: Optional[int] = None):
        """Launch the on-device candidate dedup WITHOUT fetching and start
        the device→host copy. Every fetch waits for a readback, so
        callers dispatch discovery as early as possible
        (e.g. at keyframe promotion, a whole fusion-cycle ahead) and the
        later fetch in discover_chunks finds the bytes already on host."""
        stride = max(1, self.intr.width // 320)
        if max_out is None:
            max_out = self.cfg.max_update_chunks * 4
        ids, n = tsdf_ops.candidate_chunks_unique(
            depth, cam_to_world, self.intr, self.cfg, stride=stride,
            max_out=max_out)
        from texturefusion_tpu.utils.async_fetch import fetch_async
        return fetch_async((ids, n)), max_out

    def discover_chunks(self, depth: jnp.ndarray, cam_to_world: jnp.ndarray,
                        allocate: bool = True,
                        prefetched=None) -> np.ndarray:
        """Chunk IDs intersecting this frame's truncation band → slots
        (ref: Chisel.h:103-182 PrepareIntersectChunks). Allocates new slots
        unless allocate=False (de-integration touches existing only).
        `prefetched` takes a dispatch_discovery result to skip the
        dispatch (and usually the fetch wait)."""
        # on-device sort-dedup: only [max_out, 3] ids + count are read back.
        # Discovery stride scales with resolution: at VGA a stride-2 pixel
        # footprint is far below the chunk extent, so nothing is missed.
        from texturefusion_tpu.utils.async_fetch import resolve
        from texturefusion_tpu.utils.stopwatch import STOPWATCH
        while True:
            if prefetched is not None:
                fut, max_out = prefetched
                prefetched = None
            else:
                fut, max_out = self.dispatch_discovery(depth, cam_to_world)
            # fetch runs on the helper thread; usually already landed
            with STOPWATCH.time("disco_fetch"):
                ids, n = resolve(fut)
            n = int(n)
            if n < max_out:
                break
            # overflow: the unique set filled the static budget and may
            # have silently dropped surface (ref culling covers the whole
            # frustum, ChunkManager.h:380-559) — retry with a bigger cap
            import warnings
            warnings.warn(
                f"discover_chunks: candidate budget hit ({n}); "
                f"retrying with max_out={max_out * 2}")
            prefetched = self.dispatch_discovery(depth, cam_to_world,
                                                 max_out=max_out * 2)
        if n == 0:
            return np.zeros((0,), np.int64)
        ids = ids[:n]
        if self.streamer is not None and allocate:
            # revisited space: restore offloaded chunks before assignment
            self.streamer.ensure_resident(ids)
        # slot assignment (+dedup safety) in one native pass
        with STOPWATCH.time("disco_alloc"):
            slots, new_slots = self.alloc.touch(ids, allocate=allocate)
            self._register_new(new_slots)
        return slots[slots >= 0]

    def _padded(self, slots: np.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Pad slot list to the static budget; excess chunks are dropped
        with a warning count (no silent truncation)."""
        budget = self.cfg.max_update_chunks
        if len(slots) > budget:
            # keep deterministic order; caller may loop for the rest
            slots = slots[:budget]
        pad = budget - len(slots)
        trash = self.cfg.capacity
        padded = np.concatenate([slots, np.full(pad, trash, np.int64)])
        active = np.concatenate([np.ones(len(slots), bool), np.zeros(pad, bool)])
        return jnp.asarray(padded), jnp.asarray(active)

    def integrate_frame(
        self,
        depth: jnp.ndarray,
        rgb: Optional[jnp.ndarray],
        quality_map: Optional[jnp.ndarray],
        cam_to_world: jnp.ndarray,
        keyframe_id: Optional[int] = None,
        sign: float = 1.0,
        slots: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Integrate (sign=+1) or de-integrate (sign=-1) one frame.

        Mirrors Chisel::IntegrateDepthScanColor (ref: Chisel.h:218-249):
        updates voxels, records per-chunk observation quality under
        `keyframe_id`, marks updated chunks (and their 6-neighbors) dirty
        for meshing. Returns the touched slots.
        """
        if slots is None:
            slots = self.discover_chunks(depth, cam_to_world, allocate=sign > 0)
        if len(slots) == 0:
            return slots
        all_slots = slots
        with_color = rgb is not None
        if rgb is None:
            rgb = jnp.zeros((self.intr.height, self.intr.width, 3), jnp.float32)
        if quality_map is None:
            quality_map = jnp.zeros((self.intr.height, self.intr.width), jnp.float32)

        for start in range(0, len(all_slots), self.cfg.max_update_chunks):
            chunk_slots = all_slots[start:start + self.cfg.max_update_chunks]
            idx, active = self._padded(chunk_slots)
            # fused gather→update→scatter: ONE dispatch, donated buffers
            self.batch, quality, updated = tsdf_ops.integrate_frame_fused(
                self.batch, self.origins, idx, active, depth, rgb,
                quality_map, cam_to_world, jnp.float32(sign), self.intr,
                self.cfg, with_color=with_color)

            if with_color and keyframe_id is not None:
                # start the device→host fetch now on the helper thread;
                # the flush (up to a cycle later) reads host-cached bytes
                # instead of waiting for the readback
                from texturefusion_tpu.utils.async_fetch import fetch_async
                self._pending_obs.append(
                    (chunk_slots, fetch_async((quality, updated)),
                     keyframe_id, sign))
            # dirty superset: every touched slot (fetching the exact
            # `updated` mask would cost a sync; the superset only adds
            # already-meshed empty chunks, which emit nothing)
            self._mark_dirty(chunk_slots)
        return all_slots

    def reintegrate_frame(
        self,
        depth: jnp.ndarray,
        rgb: jnp.ndarray,
        quality_map: jnp.ndarray,
        pose_old: jnp.ndarray,
        pose_new: jnp.ndarray,
        keyframe_id: int,
        slots: np.ndarray,
    ) -> np.ndarray:
        """Fused de-integrate @ pose_old + re-integrate @ pose_new over a
        KNOWN chunk set (the keyframe's recorded integrated slots — the
        reference reuses kf.validChunks the same way,
        ref: MobileFusion.cpp:128-143): one program, one row gather, no
        discovery fetch. Caller must retract the keyframe's observations
        first; the re-integration's quality entries are re-added here."""
        for start in range(0, len(slots), self.cfg.max_update_chunks):
            chunk_slots = slots[start:start + self.cfg.max_update_chunks]
            idx, active = self._padded(chunk_slots)
            self.batch, quality, updated = tsdf_ops.reintegrate_frame_fused(
                self.batch, self.origins, idx, active, depth, rgb,
                quality_map, pose_old, pose_new, self.intr, self.cfg)
            from texturefusion_tpu.utils.async_fetch import fetch_async
            self._pending_obs.append(
                (chunk_slots, fetch_async((quality, updated)),
                 keyframe_id, 1.0))
            self._mark_dirty(chunk_slots)
        return slots

    def reintegrate_local_depths(self, depths: List[jnp.ndarray],
                                 poses_old: List[np.ndarray],
                                 poses_new: List[np.ndarray],
                                 slots: np.ndarray) -> None:
        """Fused de+re-integration of a keyframe's local depth frames:
        old-pose frames enter with sign −1 and new-pose frames with +1
        in ONE combined pass over the chunk rows (the running average
        commutes — see integrate_depths_batched)."""
        if len(depths) == 0 or len(slots) == 0:
            return
        f_max = max(self.cfg.local_frames_per_keyframe, len(depths))
        zero = jnp.zeros((self.intr.height, self.intr.width), jnp.float32)
        pad_n = f_max - len(depths)
        d1 = [jnp.asarray(x) for x in depths] + [zero] * pad_n
        d = jnp.stack(d1 + d1)
        eye = [np.eye(4)] * pad_n
        p = jnp.asarray(np.stack(
            list(poses_old) + eye + list(poses_new) + eye).astype(np.float32))
        signs = jnp.asarray([-1.0] * f_max + [1.0] * f_max, jnp.float32)
        for start in range(0, len(slots), self.cfg.max_update_chunks):
            idx, active = self._padded(
                slots[start:start + self.cfg.max_update_chunks])
            self.batch = tsdf_ops.integrate_depths_batched(
                self.batch, self.origins, idx, active, d, p,
                signs, self.intr, self.cfg)

    def integrate_local_depths(self, depths: List[jnp.ndarray],
                               cam_to_worlds: List[np.ndarray],
                               slots: np.ndarray,
                               sign: float = 1.0) -> None:
        """Depth-only integration of several local frames into an
        already-discovered chunk set: ONE device dispatch for all frames
        (ref: MobileFusion.cpp:187-203 — the per-keyframe local-frame
        loop). No host fetches: dirty marks come from the keyframe pass
        that shares the same slots."""
        if len(depths) == 0 or len(slots) == 0:
            return
        # pad to the static per-keyframe budget (zero depth = no-op
        # frame) so the program compiles exactly once
        f_max = max(self.cfg.local_frames_per_keyframe, len(depths))
        d = jnp.stack([jnp.asarray(x) for x in depths]
                      + [jnp.zeros((self.intr.height, self.intr.width),
                                   jnp.float32)] * (f_max - len(depths)))
        p = jnp.asarray(np.stack(
            list(cam_to_worlds)
            + [np.eye(4)] * (f_max - len(cam_to_worlds))).astype(np.float32))
        for start in range(0, len(slots), self.cfg.max_update_chunks):
            idx, active = self._padded(slots[start:start + self.cfg.max_update_chunks])
            self.batch = tsdf_ops.integrate_depths_batched(
                self.batch, self.origins, idx, active, d, p,
                jnp.float32(sign), self.intr, self.cfg)

    def _mark_dirty(self, slots: np.ndarray) -> None:
        """Updated chunks and their 6-neighbors need remeshing
        (ref: Chisel.h:184-216 FinalizeIntegrateChunks dirty marks)."""
        if len(slots) == 0:
            return
        self._gen += 1
        self._touch_gen[np.asarray(slots, np.int64)] = self._gen
        ids = self.ids[slots]
        nbrs = np.asarray(geometry.neighbor_offsets_6(), np.int32)
        nb = (ids[:, None, :] + nbrs[None]).reshape(-1, 3)
        res = self.alloc.lookup(nb)     # one batched native lookup
        self.dirty_mesh.update(res[res >= 0].tolist())
        self.dirty_mesh.update(int(s) for s in slots.tolist())

    def garbage_collect(self, slots: np.ndarray) -> np.ndarray:
        """Free chunks among `slots` with no observed voxels
        (ref: Chisel.h:472-477 GarbageCollect). Returns freed slots."""
        if len(slots) == 0:
            return slots
        # bucketed occupancy probe (variable shapes recompile per cycle)
        padded = self._bucket_slots(np.asarray(slots, np.int64),
                                    self.cfg.capacity)
        occ = np.asarray(_row_occupancy(self.batch.weight,
                                        jnp.asarray(padded)))[: len(slots)]
        empty = np.asarray(slots)[occ <= 0.0]
        self.release(empty)
        return empty

    def gc_dispatch(self) -> Optional[dict]:
        """Dispatch the empty-chunk occupancy probe for slots allocated
        since the last pass and START its host copy — no blocking round
        trip (pair with gc_consume one fusion cycle later; ref GC role:
        Chisel.h:184-216). Uses the CURRENT observation dict without
        flushing (a flush would sync on copies still queued behind this
        cycle's integrations); candidates are re-checked at consume."""
        if not self.new_since_gc:
            return None
        cand = np.asarray(sorted(self.new_since_gc), np.int64)
        cand = cand[self.used[cand] & ~self._obs_mask[cand].any(axis=1)]
        self.new_since_gc.clear()
        if len(cand) == 0:
            return None
        padded = self._bucket_slots(cand, self.cfg.capacity)
        occ = _row_occupancy(self.batch.weight, jnp.asarray(padded))
        from texturefusion_tpu.utils.async_fetch import fetch_async
        return {"cand": cand, "ids": self.ids[cand].copy(),
                "occ": fetch_async(occ), "gen": self._gen,
                "defer_ok": True}

    def gc_consume(self, pending: Optional[dict]) -> np.ndarray:
        """Release the probe's empty chunks. Safe against the one-cycle
        gap: nothing integrates between the probe (end of cycle k) and
        this consume (start of cycle k+1), and candidates are re-verified
        (still allocated, same chunk id, still observation-free after the
        deferred flush) before release."""
        if pending is None:
            return np.zeros(0, np.int64)
        if pending.get("defer_ok") and not pending["occ"].done():
            # probe still in flight: GC can wait one more cycle (the
            # reference GCs lazily too, Chisel.h:184-216) — hand the
            # pending probe back instead of stalling the fusion thread
            return pending
        self.flush_observations(ready_only=bool(pending.get("defer_ok")))
        from texturefusion_tpu.utils.async_fetch import resolve
        from texturefusion_tpu.utils.stopwatch import STOPWATCH
        cand, ids0 = pending["cand"], pending["ids"]
        with STOPWATCH.time("gc_occ_resolve"):
            occ = np.asarray(resolve(pending["occ"]))[: len(cand)]
        probe_gen = pending.get("gen", self._gen)
        ok = ((occ <= 0.0) & self.used[cand]
              & (self.ids[cand] == ids0).all(axis=1)
              & ~self._obs_mask[cand].any(axis=1))
        # probe went stale (re-integrated while the consume was
        # deferred): re-probe next pass instead of freeing on stale
        # occupancy
        stale = ok & (self._touch_gen[cand] > probe_gen)
        self.new_since_gc.update(cand[stale].tolist())
        empty = cand[ok & ~stale]
        with STOPWATCH.time("gc_release"):
            self.release(empty)
        return empty

    def gc_new_chunks(self) -> np.ndarray:
        """GC pass over chunks allocated since the last pass — frees
        slots that never produced an observation entry (frustum-culled
        allocations outside the truncation band; the reference GCs these
        every integrate, Chisel.h:184-216). Candidates lacking an
        observation entry are confirmed empty with a device occupancy
        probe before release: depth-only local-frame integration
        (integrate_depths_scan) adds real TSDF weight without creating
        observations, and the reference's Chisel GC probes actual voxel
        occupancy before freeing. Returns freed slots."""
        if not self.new_since_gc:
            return np.zeros(0, np.int64)
        self.flush_observations()
        cand = np.asarray(sorted(self.new_since_gc), np.int64)
        cand = cand[self.used[cand] & ~self._obs_mask[cand].any(axis=1)]
        self.new_since_gc.clear()
        if len(cand) == 0:
            return cand
        cand = self.garbage_collect(cand)
        return cand

    def retract_observations(self, keyframe_id: int) -> List[int]:
        """Remove a keyframe's observation-quality entries before
        re-integration (ref: MobileFusion.cpp:252-272 RetractObservations).
        Only THIS keyframe's pending fetches are resolved first (its
        integration is at least a cycle old, so they have landed); other
        keyframes' in-flight fetches stay asynchronous. Returns affected
        slots."""
        mine = [p for p in self._pending_obs if p[2] == keyframe_id]
        if mine:
            # entries of different keyframes commute; same-keyframe
            # entries apply here in their original dispatch order
            self._pending_obs = [p for p in self._pending_obs
                                 if p[2] != keyframe_id]
            self._apply_obs(mine)
        touched = np.nonzero(self._obs_mask[:, keyframe_id])[0]
        self._obs_mask[touched, keyframe_id] = False
        self._obs_q[touched, keyframe_id] = 0.0
        return touched.tolist()

    # ---------------------------------------------------------- queries

    def active_slots(self) -> np.ndarray:
        return np.nonzero(self.used)[0]

    def sdf_at(self, points_w: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Trilinear TSDF sample at world points (N, 3) → (sdf, valid).
        (ref: Chisel.h:251-342 GetDistanceFromSurface;
        ChunkManager.cpp:1043-1168 GetSDF/GetSDFAndGradient)."""
        return sample_sdf_trilinear(self.batch.sdf, self.batch.weight,
                                    self._slot_table(), points_w,
                                    self.cfg.chunk_size, self.cfg.voxel_resolution)

    def _slot_table(self) -> "SlotTable":
        """Dense chunk-ID → slot lookup over the active bounding box,
        rebuilt on demand for device-side queries."""
        act = self.active_slots()
        trash = self.cfg.capacity
        if len(act) == 0:
            lo = np.zeros(3, np.int32)
            table = np.full((1, 1, 1), trash, np.int32)
        else:
            ids = self.ids[act]
            lo = ids.min(0)
            hi = ids.max(0)
            table = np.full(tuple((hi - lo + 1).tolist()), trash, np.int32)
            rel = ids - lo
            table[rel[:, 0], rel[:, 1], rel[:, 2]] = act
        return SlotTable(jnp.asarray(table), jnp.asarray(lo, jnp.int32), trash)


class SlotTable:
    """Device-side dense chunk-ID → slot map over the map's bounding box."""

    def __init__(self, table: jnp.ndarray, lo: jnp.ndarray, trash: int):
        self.table = table   # [X, Y, Z] int32, trash slot where absent
        self.lo = lo         # [3] int32
        self.trash = trash

    def slots_for(self, ids: jnp.ndarray) -> jnp.ndarray:
        """(..., 3) int chunk IDs -> slot (trash slot when absent)."""
        rel = ids - self.lo
        shp = jnp.asarray(self.table.shape, rel.dtype)
        inb = jnp.all((rel >= 0) & (rel < shp), axis=-1)
        relc = jnp.clip(rel, 0, shp - 1)
        s = self.table[relc[..., 0], relc[..., 1], relc[..., 2]]
        return jnp.where(inb, s, self.trash)


def sample_sdf_trilinear(sdf: jnp.ndarray, weight: jnp.ndarray,
                         table: SlotTable, points_w: jnp.ndarray,
                         chunk_size: int, resolution: float):
    """Trilinear SDF interpolation across chunk boundaries.

    Gathers the 8 surrounding voxel centers (possibly in different chunks)
    via the dense slot table (ref: ChunkManager.cpp:1043-1168)."""
    # voxel-center grid coordinate
    g = points_w / resolution - 0.5
    g0 = jnp.floor(g).astype(jnp.int32)
    frac = g - g0.astype(g.dtype)
    w8 = geometry.trilinear_weights(frac)  # (..., 8)
    corners = jnp.asarray(
        [[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)], jnp.int32)
    vox = g0[..., None, :] + corners                                     # (...,8,3)
    cid = jnp.floor_divide(vox, chunk_size)
    local = vox - cid * chunk_size
    slot = table.slots_for(cid)
    lin = (local[..., 0] + local[..., 1] * chunk_size
           + local[..., 2] * chunk_size * chunk_size)
    s8 = sdf[slot, lin]
    w8v = weight[slot, lin]
    ok = jnp.all((w8v > 0) & (s8 < tsdf_ops.RESET_SDF * 0.5), axis=-1)
    val = jnp.sum(w8 * s8, axis=-1)
    return jnp.where(ok, val, tsdf_ops.RESET_SDF), ok
