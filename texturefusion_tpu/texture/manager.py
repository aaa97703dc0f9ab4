"""Texture manager: view selection → patches → atlas → color compensation.

Host orchestration mirroring the texture stages of the reference's map
cycle (ref: GCFusion/MobileFusion.cpp:330-384 — wrong-mapping datacost
removal :330-343, texManager updates :356-359, view_selection :362-369,
GeneratePatches :374, CompensateColor :380, UpdateAtlas :382), driving the
batched device kernels in texture/{mrf,patch,color,kfstack}.py.

INCREMENTAL design (ref: the incremental view_selection variant,
TexMap.cpp:257-406): the MRF solves globally every cycle (cheap — [N, 16]
costs), but projection/uv/wrong-mapping run only for chunks whose label
flipped or whose mesh changed. Keyframe images live in persistent device
stacks written once per keyframe (kfstack.py); per-chunk color moments
stay device-resident so the global per-keyframe color compensation still
sees every patched vertex. One device program + ONE fetch per cycle.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.config import PipelineConfig
from texturefusion_tpu.core import camera as cam
from texturefusion_tpu.texture import patch as patch_ops
from texturefusion_tpu.texture.atlas import Atlas
from texturefusion_tpu.texture.kfstack import KeyframeStack
from texturefusion_tpu.texture.mrf import ViewSelector


class ChunkTexture:
    __slots__ = ("label", "atlas_uv", "uv_valid", "color_adjust", "wrong",
                 "tex_color", "vox_color")

    def __init__(self):
        self.label = -1
        self.atlas_uv: Optional[np.ndarray] = None     # [P, 2] in [0,1]
        self.uv_valid: Optional[np.ndarray] = None     # [P]
        self.color_adjust: Optional[np.ndarray] = None  # [P, 3]
        self.wrong = False
        # cached per-vertex color samples for compensation (tex = sampled
        # from the keyframe at patch uv, vox = fused voxel colors)
        self.tex_color: Optional[np.ndarray] = None    # [P, 3]
        self.vox_color: Optional[np.ndarray] = None    # [P, 3]


class TextureManager:
    def __init__(self, config: PipelineConfig):
        self.config = config
        self.cfg = config.texture
        self.intr = cam.Intrinsics.from_config(config.camera)
        self.selector = ViewSelector(
            max_labels=self.cfg.max_labels,
            potts_weight=self.cfg.mrf_potts_weight,
            edge_weight=self.cfg.mrf_edge_weight,
            sweeps=self.cfg.mrf_sweeps,
            bucket_floor=self.cfg.problem_bucket_floor)
        self.atlas = Atlas(self.cfg, config.tsdf.voxel_resolution)
        self.chunk_tex: Dict[int, ChunkTexture] = {}
        self.kf_stack = KeyframeStack(self.intr.height, self.intr.width,
                                      initial=self.cfg.kf_stack_initial)
        # device-resident per-chunk state (lazily sized to the pool)
        self._labels_dev = None      # [S+1] int32 keyframe label per slot
        self._stats_dev = None       # [S+1, STATS_W] f32 color moments
        self._carry: set = set()     # remeshed chunks deferred past budget
        self._kf_transfer: Optional[dict] = None
        self._pending_cycle: Optional[dict] = None  # dispatched, unconsumed

    def _ensure_state(self, mesher) -> None:
        s1 = mesher.pool.verts.shape[0]
        if self._labels_dev is None:
            self._labels_dev = jnp.full((s1,), -1, jnp.int32)
            self._stats_dev = jnp.zeros((s1, patch_ops.STATS_W), jnp.float32)

    # ------------------------------------------------------------- cycle

    def add_keyframe_images(self, kf_slot: int, rgb_u8, depth,
                            pose: np.ndarray) -> None:
        """Write one keyframe's images into the device stack (called at
        integration time — the depth is final by then)."""
        if kf_slot not in self.kf_stack.present:
            self.kf_stack.add(kf_slot, rgb_u8, depth, pose)

    def update_dispatch(self, volume, mesher, kf_states: Dict[int, object],
                        newest_kf: int, remeshed: Optional[set] = None,
                        flush_obs: bool = True) -> None:
        """DISPATCH one texture cycle's device program and start the
        result copies — no blocking round trip. Pair with update_consume
        (typically at the start of the next fusion cycle, when the async
        copies have landed; ref role: TexMap.cpp:257-406 view_selection +
        GeneratePatches, pipelined one keyframe deep here)."""
        from texturefusion_tpu.utils.stopwatch import STOPWATCH
        if self._pending_cycle is not None:
            # the previous cycle's results are still in flight (its
            # consume was deferred): skip this dispatch — clobbering the
            # pending record would lose a whole cycle's labels/uv — and
            # carry the remeshed set so the next cycle covers it
            self._carry |= set(remeshed or ())
            return
        with STOPWATCH.time("tex_adjacency"):
            meshed, nbr = mesher.chunk_adjacency_arrays()
        if len(meshed) == 0:
            return
        self._ensure_state(mesher)
        with STOPWATCH.time("tex_build"):
            # async cycles read the UNFLUSHED observation arrays —
            # flushing would sync on copies still queued behind this
            # cycle's integrations; the newest keyframe's entries land
            # next cycle (staleness contract on obs_arrays)
            obs_q, obs_mask = volume.obs_arrays(flush=flush_obs)
            problem, slots, label_kf_np = self.selector.build_problem_arrays(
                obs_q, obs_mask, meshed, nbr, volume.ids, newest_kf)
            if problem is None:
                return
            n = problem.unary.shape[0]
            trash = mesher.pool.verts.shape[0] - 1
            slot_idx = np.full(n, trash, np.int32)
            slot_idx[: len(slots)] = slots
            # keyframe stack rows (idempotent) + current BA poses
            for kf in sorted(kf_states):
                st = kf_states[kf]
                self.add_keyframe_images(kf, st.rgb, st.depth, st.pose)
                self.kf_stack.set_pose(kf, st.pose)
            want = (remeshed or set()) | self._carry
            rmask = np.zeros(n, bool)
            if want:
                rmask[: len(slots)] = np.isin(
                    slots, np.fromiter(want, np.int64, len(want)))
            fallback_kf = max(newest_kf - 1, 0)

        with STOPWATCH.time("tex_device"):
            self._labels_dev, self._stats_dev, out = \
                patch_ops.texture_cycle_incremental(
                    problem, jnp.asarray(slot_idx), self._labels_dev,
                    self._stats_dev, jnp.asarray(rmask),
                    mesher.pool.verts, mesher.pool.col_packed,
                    mesher.pool.vcount, mesher.pool.tcount,
                    self.kf_stack.rgb_packed, self.kf_stack.depth,
                    jnp.asarray(self.kf_stack.poses),
                    jnp.int32(fallback_kf), self.intr, self.cfg,
                    self.cfg.mrf_sweeps, self.cfg.patch_project_budget)
        with STOPWATCH.time("tex_startcopy"):
            from texturefusion_tpu.utils.async_fetch import fetch_async
            # background: ~0.5 MB payload — done() must mean LANDED or
            # the deferred consume stalls ~60 ms on the tail of the copy
            out = fetch_async(tuple(out), background=True)
        self._pending_cycle = {
            "out": out, "slots": slots, "want": want,
            "adjacency_slots": set(slots.tolist()), "volume": volume,
            "mesher": mesher, "kf_states": dict(kf_states)}

    def update_consume(self, force: bool = True) -> None:
        """Apply a prior update_dispatch's results: atlas blits, uv/label
        bookkeeping, wrong-mapping poisoning, per-keyframe transfers.
        force=False defers (returns) while the device results are still
        in flight instead of stalling the caller."""
        from texturefusion_tpu.utils.stopwatch import STOPWATCH
        p = self._pending_cycle
        if not p:
            return
        if not force and not p["out"].done():
            return
        self._pending_cycle = None
        volume, mesher = p["volume"], p["mesher"]
        slots, want = p["slots"], p["want"]
        adjacency = p["adjacency_slots"]
        kf_states = p["kf_states"]
        with STOPWATCH.time("tex_fetch"):
            from texturefusion_tpu.utils.async_fetch import resolve
            (rows, proj_kf, n_changed, uv16, uv_ok, bmin, bmax, wrong,
             t_np, mt_np, mv_np) = resolve(p["out"])

        with STOPWATCH.time("tex_host"):
            m = int(min(int(n_changed), self.cfg.patch_project_budget))
            projected = set()
            for i in range(m):
                r = int(rows[i])
                if r >= len(slots):
                    continue
                s = int(slots[r])
                kf = int(proj_kf[i])
                projected.add(s)
                tex = self.chunk_tex.setdefault(s, ChunkTexture())
                if wrong[i] or kf not in kf_states:
                    if wrong[i] and kf >= 0:
                        # poison so the MRF re-selects next cycle
                        # (ref: MobileFusion.cpp:330-343)
                        volume.poison_observation(s, kf)
                    tex.wrong = True
                    continue
                rec = self.atlas.patches.get(s)
                # re-blit when new patch, label change, or the remeshed
                # surface outgrew the stored bbox (atlas_uv clamps
                # against the STORED bbox)
                escaped = (rec is not None and rec.kf_id == kf
                           and ((bmin[i] < rec.bbox_min - 0.5).any()
                                or (bmax[i] > rec.bbox_max + 0.5).any()))
                if rec is None or rec.kf_id != kf or escaped:
                    st = kf_states[kf]
                    rgb_host = (st.rgb_host() if hasattr(st, "rgb_host")
                                else st.rgb)
                    rec = self.atlas.add_or_update_patch(
                        s, kf, bmin[i], bmax[i], rgb_host)
                    if rec is None:
                        # atlas full — stop (ref: overflow Atlas.cpp:52-53);
                        # drop the carry so catch-up loops don't spin on
                        # work that can never be placed
                        self._carry = set()
                        return
                nv = int(mesher.vcount[s])
                tex.label = kf
                tex.wrong = False
                self.selector.labels[s] = kf
                tex.atlas_uv = self.atlas.atlas_uv(
                    s, uv16[i, :nv].astype(np.float32) / 16.0)
                tex.uv_valid = uv_ok[i, :nv]
            # remeshed chunks past the projection budget carry over so
            # their uv refresh lands next cycle
            if int(n_changed) > m:
                self._carry = {s for s in want
                               if s not in projected and s in adjacency}
            else:
                self._carry = set()
            # per-keyframe color transfers for export-time baking
            self._kf_transfer = {
                kf: (t_np[kf], mt_np[kf], mv_np[kf])
                for kf in sorted(kf_states) if kf < len(t_np)
            }

    def update(self, volume, mesher, kf_states: Dict[int, object],
               newest_kf: int, remeshed: Optional[set] = None) -> None:
        """One SYNCHRONOUS texture cycle: dispatch + immediate consume
        (final flush / non-pipelined callers)."""
        self.update_dispatch(volume, mesher, kf_states, newest_kf,
                             remeshed=remeshed)
        self.update_consume()

    def bake_compensation_into_atlas(self) -> int:
        """Apply each patch's keyframe color transfer to its atlas tile so
        exported textures carry the global color consistency (the
        reference does this in the shader per vertex). Returns number of
        tiles baked."""
        transfers = getattr(self, "_kf_transfer", None)
        if not transfers:
            return 0
        n = 0
        ps = self.atlas.patch_size
        for slot, rec in self.atlas.patches.items():
            tr = transfers.get(rec.kf_id)
            if tr is None:
                continue
            t, mu_t, mu_v = tr
            ox, oy = self.atlas._slot_origin(rec.slot_index)
            tile = self.atlas.image[oy:oy + ps, ox:ox + ps].astype(np.float32) / 255.0
            fixed = (tile - mu_t) @ t.T + mu_v
            self.atlas.image[oy:oy + ps, ox:ox + ps] = np.clip(
                fixed * 255.0, 0, 255).astype(np.uint8)
            n += 1
        self._kf_transfer = None  # baked exactly once
        return n

    # ------------------------------------------------------------- export

    def _sample_atlas(self, uv: np.ndarray) -> np.ndarray:
        """Bilinear sample of the atlas image at normalized uv [P, 2]
        (v up, OBJ convention) → [P, 3] float 0..1."""
        # exact inverse of Atlas.atlas_uv's /size normalization (a *(sz-1)
        # scale here would shift samples up to ~1 texel for tiles far from
        # the atlas origin and bleed neighboring patches' texels)
        # the image is row-lazy: clamp rows to the MATERIALIZED height
        sz = self.atlas.size
        y_max = self.atlas.image.shape[0] - 1
        x = np.clip(uv[:, 0] * sz, 0, sz - 1)
        y = np.clip((1.0 - uv[:, 1]) * sz, 0, y_max)
        x0 = np.floor(x).astype(np.int64)
        y0 = np.floor(y).astype(np.int64)
        x1 = np.minimum(x0 + 1, sz - 1)
        y1 = np.minimum(y0 + 1, y_max)
        fx = (x - x0)[:, None]
        fy = (y - y0)[:, None]
        img = self.atlas.image     # uint8: convert only the sampled texels

        def tex(yy, xx):
            return img[yy, xx].astype(np.float32) / 255.0

        return ((tex(y0, x0) * (1 - fx) + tex(y0, x1) * fx) * (1 - fy)
                + (tex(y1, x0) * (1 - fx) + tex(y1, x1) * fx) * fy)

    def export_textured(self, mesher, out_dir: str, name: str = "model") -> str:
        """Textured OBJ+MTL+PNG of all patched chunks with PER-VERTEX
        compensated colors (ref: Atlas.cpp:93-179 SaveTexturedModel;
        per-vertex corrected colors Chisel.cpp:270-284 + the wrong-mapping
        voxel-color fallback draw_mesh.vert:29-70).

        The keyframe color transfer is baked per-pixel into the atlas
        tiles; each vertex additionally carries its corrected color
        (delta = corrected − raw sample, stored in ChunkTexture
        .color_adjust exactly like the reference packs it for the
        shader), with vertices whose projection is invalid falling back
        to the fused voxel color."""
        # raw per-vertex samples BEFORE the bake (delta base)
        raw_samples = {}
        for slot in sorted(self.chunk_tex):
            tex = self.chunk_tex[slot]
            if tex.atlas_uv is not None:
                raw_samples[slot] = self._sample_atlas(tex.atlas_uv)
        self.bake_compensation_into_atlas()
        vs, fs, uvs, cols = [], [], [], []
        base = 0
        for slot in sorted(self.chunk_tex):
            tex = self.chunk_tex[slot]
            if tex.atlas_uv is None or slot not in mesher.meshes:
                continue
            v, f, c, n = mesher.meshes[slot]
            k = min(len(v), len(tex.atlas_uv))
            corrected = self._sample_atlas(tex.atlas_uv[:k])
            tex.color_adjust = corrected - raw_samples[slot][:k]
            col = corrected
            if tex.uv_valid is not None:
                # wrong-mapping fallback: invalid projections show the
                # globally consistent fused voxel color
                ok = np.asarray(tex.uv_valid[:k], bool)
                col = np.where(ok[:, None], col, c[:k])
            vs.append(v[:k])
            uvs.append(tex.atlas_uv[:k])
            cols.append(col)
            f_ok = f[(f < k).all(axis=1)]
            fs.append(f_ok + base)
            base += k
        if not vs:
            raise RuntimeError("no textured chunks to export")
        return self.atlas.save_textured_model(
            out_dir, np.concatenate(vs), np.concatenate(fs),
            np.concatenate(uvs), name,
            vertex_colors=np.concatenate(cols))
