"""Incremental meshing orchestration over the chunked TSDF volume.

Replaces ChunkManager::RecomputeMeshes' parallel_for over dirty chunks
(ref: Structure/ChunkManager.cpp:232-264) with batched device meshing into
a DEVICE-RESIDENT mesh pool (ops/marching_cubes.py MeshPool): only chunks
marked dirty by integration are remeshed each cycle, their meshes stay on
device for the texture stage to gather, and the host fetches mesh data
only on demand (export, freeze). The reference reads its meshes from CPU
memory for free; here a per-cycle device→host→device mesh round trip
would move every mesh twice, so residency is the design point.
"""

from __future__ import annotations

import functools
import warnings
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.core import geometry
from texturefusion_tpu.fusion.chunkmap import TSDFVolume
from texturefusion_tpu.ops import marching_cubes as mc


class IncrementalMesher:
    def __init__(self, volume: TSDFVolume):
        self.volume = volume
        cfg = volume.config.mesh
        cap = volume.cfg.capacity
        self.p_cap = cfg.pool_verts_per_chunk
        self.t_cap = cfg.pool_tris_per_chunk
        self.pool = mc.make_mesh_pool(cap, self.p_cap, self.t_cap)
        if volume.sharding is not None:
            # pool rows live on the same chunk-slot shards as the TSDF
            self.pool = jax.tree.map(
                lambda a: jax.device_put(a, volume.sharding), self.pool)
        self.vcount = np.zeros(cap + 1, np.int32)   # host mirror
        self.tcount = np.zeros(cap + 1, np.int32)
        # chunk-id -> mesh of an OFFLOADED chunk (streaming): its slot was
        # recycled but the surface still exists and must export
        self.frozen: Dict[Tuple[int, int, int], tuple] = {}
        self.last_remeshed: set = set()
        self._host_cache: Dict[int, tuple] = {}
        self._cache_valid = False
        self._warned_overflow = False
        self._pending_counts: list = []   # (seq, slots, fetch), unapplied
        # monotonic dispatch sequence + per-slot last-drop sequence: a
        # deferred count fetch must not resurrect counts of a slot
        # dropped AFTER its dispatch (drop() then stays non-blocking)
        self._seq = 0
        self._drop_seq = np.full(cap + 1, -1, np.int64)

    # ------------------------------------------------------------- remesh

    _CORNER_OFFS = np.asarray([(1, 0, 0), (0, 1, 0), (1, 1, 0), (0, 0, 1),
                               (1, 0, 1), (0, 1, 1), (1, 1, 1)], np.int32)

    def _neighbor_slots(self, slots: np.ndarray) -> np.ndarray:
        """[U, 8] slot of self + 7 positive-corner neighbors (trash if absent)
        (ref: ChunkManager.cpp:608-633 neighbor pointer table). One batched
        native lookup — a python dict loop here cost ~8·U GIL-held gets
        per remesh on the fusion thread."""
        vol = self.volume
        ids = vol.ids[slots]
        trash = vol.cfg.capacity
        out = np.full((len(slots), 8), trash, np.int64)
        out[:, 0] = slots
        nb = (ids[:, None, :] + self._CORNER_OFFS[None]).reshape(-1, 3)
        res = vol.lookup(nb).reshape(len(slots), 7)
        out[:, 1:] = np.where(res >= 0, res, trash)
        return out

    def update_meshes_async(self, max_chunks: int = 0) -> int:
        """Dispatch remeshing of all dirty chunks into the device pool and
        START the count copies — NO blocking round trip. The host count
        mirrors are applied by consume_counts (typically one fusion cycle
        later, when the async copies have already landed) or lazily by
        the host-view accessors (meshes/_fetch_rows). Returns the number
        of chunks dispatched."""
        vol = self.volume
        dirty = sorted(vol.dirty_mesh)
        if max_chunks:
            dirty = dirty[:max_chunks]
        self.last_remeshed = set(dirty)
        if not dirty:
            return 0
        budget = self.volume.config.mesh.max_mesh_chunks
        for start in range(0, len(dirty), budget):
            self._pending_counts.append(
                self._remesh(np.asarray(dirty[start:start + budget],
                                        np.int64)))
        for s in dirty:
            vol.dirty_mesh.discard(s)
        self._cache_valid = False
        return len(dirty)

    def consume_counts(self, ready_only: bool = False) -> int:
        """Apply the host count mirrors of prior update_meshes_async calls
        (ONE batched fetch — free when the async copies finished).
        ready_only=True consumes only fetches whose device values are
        computed, deferring the rest one more cycle instead of stalling
        the fusion thread on in-flight device work."""
        pending, self._pending_counts = self._pending_counts, []
        if ready_only:
            # consume only a READY PREFIX: count mirrors must apply in
            # dispatch order (a later remesh of the same slot would
            # otherwise be overwritten by an earlier deferred fetch)
            n_ready = 0
            for p in pending:
                if not p[2].done():
                    break
                n_ready += 1
            self._pending_counts = pending[n_ready:]
            pending = pending[:n_ready]
        if not pending:
            return 0
        n = 0
        from texturefusion_tpu.utils.async_fetch import resolve
        from texturefusion_tpu.utils.stopwatch import STOPWATCH
        key = ("mesh_counts_resolve" if ready_only
               else "mesh_counts_forced")
        with STOPWATCH.time(key):
            fetched = [resolve(fut) for _, _, fut in pending]
        for (seq, slots, _), (vc, tc) in zip(pending, fetched):
            # skip slots dropped after this remesh was dispatched
            keep = self._drop_seq[slots] < seq
            slots = slots[keep]
            n_real = len(slots)
            n += n_real
            vc_kept = vc[: len(keep)][keep]
            tc_kept = tc[: len(keep)][keep]
            self.vcount[slots] = vc_kept
            self.tcount[slots] = tc_kept
            # overflow check on the APPLIED (drop-masked) counts only — a
            # slot dropped after dispatch must not fire a spurious warning
            if not self._warned_overflow and (
                    (vc_kept >= self.p_cap).any()
                    or (tc_kept >= self.t_cap).any()):
                self._warned_overflow = True
                warnings.warn("mesh pool per-chunk capacity clamped a "
                              "chunk; raise MeshConfig.pool_verts_per_chunk")
        return n

    def update_meshes(self, max_chunks: int = 0) -> int:
        """Remesh all dirty chunks into the device pool. Returns number
        remeshed (ref: Chisel.h:479-481 UpdateMeshes)."""
        n = self.update_meshes_async(max_chunks)
        self.consume_counts()
        return n

    def _remesh(self, slots: np.ndarray):
        """Dispatch one remesh batch; returns (slots, vcount, tcount)
        device handles with their host copies already in flight."""
        vol = self.volume
        nbr = self._neighbor_slots(slots)
        origins = vol.ids[slots].astype(np.float32) * vol.extent
        n_real = len(slots)
        # 256-floor: one mesh_chunks_pooled shape covers nearly every
        # cycle (the 32→64→128 ladder re-compiled/cache-loaded the heavy
        # meshing program mid-run; device cost of the padding is ~0.3 ms)
        bucket = 256
        while bucket < n_real:
            bucket *= 2
        pad = bucket - n_real
        trash = vol.cfg.capacity
        slots_p = np.concatenate([slots, np.full(pad, trash, np.int64)])
        nbr_p = np.concatenate([nbr, np.full((pad, 8), trash, np.int64)])
        origins_p = np.concatenate([origins, np.zeros((pad, 3), np.float32)])
        active = jnp.asarray(np.arange(bucket) < n_real)
        self.pool, vcount, tcount = mc.mesh_chunks_pooled(
            self.pool, vol.batch.sdf, vol.batch.weight, vol.batch.color,
            vol.batch.color_count, jnp.asarray(slots_p), jnp.asarray(nbr_p),
            jnp.asarray(origins_p), active,
            vol.cfg.chunk_size, vol.cfg.voxel_resolution)
        from texturefusion_tpu.utils.async_fetch import fetch_async
        self._seq += 1
        return self._seq, slots, fetch_async((vcount, tcount))

    # ------------------------------------------------------------- host views

    def _fetch_rows(self, slots: np.ndarray) -> Dict[int, tuple]:
        """Fetch pool rows for `slots` → {slot: (verts, faces, colors,
        normals)} host arrays (export/freeze path)."""
        self.consume_counts()   # host mirrors must be current
        out: Dict[int, tuple] = {}
        todo = [int(s) for s in np.atleast_1d(slots).tolist()
                if self.tcount[int(s)] > 0]
        if not todo:
            return out
        b = 32
        while b < len(todo):
            b *= 2
        padded = np.asarray(todo + [todo[0]] * (b - len(todo)), np.int64)
        v, cp, npk, tr, vc, tc = jax.device_get(
            mc.gather_pool_rows(self.pool, jnp.asarray(padded)))
        for i, s in enumerate(todo):
            nv, nt = int(vc[i]), int(tc[i])
            if nt == 0:
                continue
            col = mc.unpack_u32_channels(cp[i, :nv]) / 255.0
            nrm = (mc.unpack_u32_channels(npk[i, :nv]) - 127.0) / 127.0
            out[s] = (v[i, :nv], tr[i, :nt].astype(np.int32), col, nrm)
        return out

    @property
    def meshes(self) -> Dict[int, tuple]:
        """Host view of all chunk meshes, fetched lazily from the device
        pool and cached until the next remesh."""
        if not self._cache_valid:
            self.consume_counts()
            slots = np.nonzero(self.tcount[:-1] > 0)[0]
            self._host_cache = self._fetch_rows(slots)
            self._cache_valid = True
        return self._host_cache

    def freeze(self, slots) -> None:
        """Move offloaded chunks' meshes to chunk-id keys (their slots
        are being recycled by the streamer)."""
        rows = self._fetch_rows(np.atleast_1d(slots))
        for s, m in rows.items():
            self.frozen[tuple(self.volume.ids[s].tolist())] = m
        self.drop(np.atleast_1d(slots))

    def drop(self, slots) -> None:
        slots = np.atleast_1d(slots).astype(np.int64)
        if len(slots) == 0:
            return
        # non-blocking: pending count fetches dispatched BEFORE this drop
        # are masked out at consume time via the drop-sequence stamp
        self._seq += 1
        self._drop_seq[slots] = self._seq
        self.vcount[slots] = 0
        self.tcount[slots] = 0
        # BUCKETED scatter: GC frees a different slot count every cycle,
        # and an exact-length index would compile a fresh program per
        # count. Pad lanes hit the trash row, whose counts are never read.
        padded = self.volume._bucket_slots(slots, self.volume.cfg.capacity)
        self.pool = _zero_counts(self.pool, jnp.asarray(padded))
        self._cache_valid = False

    def full_mesh(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Concatenate all chunk meshes (resident + offloaded-frozen):
        (verts, faces, colors, normals)."""
        vs, fs, cs, ns = [], [], [], []
        base = 0
        meshes = self.meshes
        for slot in sorted(meshes):
            v, f, c, n = meshes[slot]
            vs.append(v)
            fs.append(f + base)
            cs.append(c)
            ns.append(n)
            base += len(v)
        for cid in sorted(self.frozen):
            if self.volume.slot_of.get(cid) is not None:
                continue   # restored + remeshed under its new slot
            v, f, c, n = self.frozen[cid]
            vs.append(v)
            fs.append(f + base)
            cs.append(c)
            ns.append(n)
            base += len(v)
        if not vs:
            z = np.zeros((0, 3), np.float32)
            return z, np.zeros((0, 3), np.int32), z, z
        return (np.concatenate(vs), np.concatenate(fs),
                np.concatenate(cs), np.concatenate(ns))

    def chunk_adjacency_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(meshed_slots [S], nbr_slots [S, 6]) — 6-neighbor slots that
        also have meshes, −1 where absent (the texture MRF chunk graph,
        ref: TexMap.cpp:50-61 update_chunkgraph). One batched native
        lookup over all meshed chunks × 6 offsets; fully vectorized so
        the fusion thread never loops per chunk."""
        vol = self.volume
        nbrs = np.asarray(geometry.neighbor_offsets_6(), np.int32)
        meshed = np.nonzero(self.tcount[:-1] > 0)[0]
        if len(meshed) == 0:
            return meshed, np.zeros((0, 6), np.int64)
        ids = vol.ids[meshed]
        nb = (ids[:, None, :] + nbrs[None]).reshape(-1, 3)
        res = vol.lookup(nb).reshape(len(meshed), len(nbrs))
        is_meshed = np.zeros(vol.cfg.capacity + 1, bool)
        is_meshed[meshed] = True
        ok = (res >= 0) & is_meshed[np.clip(res, 0, vol.cfg.capacity)]
        return meshed, np.where(ok, res, -1)

    def chunk_adjacency(self) -> Dict[int, np.ndarray]:
        """Dict view of chunk_adjacency_arrays (compat/inspection)."""
        meshed, nbr = self.chunk_adjacency_arrays()
        return {int(s): row[row >= 0] for s, row in
                zip(meshed.tolist(), nbr)}


@functools.partial(jax.jit, donate_argnames=("pool",))
def _zero_counts(pool: mc.MeshPool, slots: jnp.ndarray) -> mc.MeshPool:
    return pool._replace(vcount=pool.vcount.at[slots].set(0),
                         tcount=pool.tcount.at[slots].set(0))
