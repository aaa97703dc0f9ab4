"""Texture atlas: fixed-size patch allocator + textured model export.

Host-side re-design of chisel::Atlas (ref: Structure/Atlas.{h,cpp} —
13824² RGB8 atlas Atlas.h:29-31, patch slot size floor(4800·res)
Atlas.h:62-65, AddPatch linear allocator Atlas.cpp:43-64, ROI blit with
resize UpdateBuffer :71-91, hot-region tracking for partial uploads,
SaveTexturedModel OBJ+MTL+PNG export :93-179).

The atlas is a numpy RGB image; patches are square slots in a grid. Each
chunk's patch blits the selected keyframe's bbox ROI (resized into the
slot). Vertex atlas-UVs map bbox-relative coordinates into the slot.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np

from texturefusion_tpu.config import TextureConfig
from texturefusion_tpu.io.image import resize_bilinear, write_png


@dataclasses.dataclass
class PatchRecord:
    slot_index: int            # linear patch slot in the atlas grid
    kf_id: int
    bbox_min: np.ndarray       # [2] in keyframe image coords
    bbox_max: np.ndarray


class Atlas:
    def __init__(self, cfg: TextureConfig, voxel_resolution: float):
        self.cfg = cfg
        self.patch_size = max(int(cfg.patch_scale * voxel_resolution), 16)
        self.size = cfg.atlas_size
        self.grid = self.size // self.patch_size
        self.capacity = self.grid * self.grid
        # ROW-LAZY image buffer: slots allocate low indices (top rows)
        # first, so only the used rows are ever materialized. A full
        # 13824² buffer is 573 MB of RAM and minutes of PNG encoding at
        # export; a typical room-scale session uses ~10-20 patch rows.
        self._rows = self.patch_size * 4
        self.image = np.zeros((self._rows, self.size, 3), np.uint8)
        self.patches: Dict[int, PatchRecord] = {}   # chunk slot -> record
        self.free = list(range(self.capacity - 1, -1, -1))
        self.hot_region: Optional[Tuple[int, int, int, int]] = None
        self.overflowed = False

    def _slot_origin(self, slot_index: int) -> Tuple[int, int]:
        gy, gx = divmod(slot_index, self.grid)
        return gx * self.patch_size, gy * self.patch_size

    def add_or_update_patch(self, chunk_slot: int, kf_id: int,
                            bbox_min: np.ndarray, bbox_max: np.ndarray,
                            kf_rgb: np.ndarray) -> Optional[PatchRecord]:
        """Allocate (or reuse) a slot and blit the keyframe ROI
        (ref: Atlas.cpp:43-91). kf_rgb: [H, W, 3] float 0..1.
        Returns None when the atlas is full (ref: overflow stop
        Atlas.cpp:52-53)."""
        rec = self.patches.get(chunk_slot)
        if rec is None:
            if not self.free:
                self.overflowed = True
                return None
            rec = PatchRecord(self.free.pop(), kf_id,
                              np.asarray(bbox_min), np.asarray(bbox_max))
            self.patches[chunk_slot] = rec
        rec.kf_id = kf_id
        rec.bbox_min = np.asarray(bbox_min)
        rec.bbox_max = np.asarray(bbox_max)

        x0, y0 = int(rec.bbox_min[0]), int(rec.bbox_min[1])
        x1, y1 = int(rec.bbox_max[0]) + 1, int(rec.bbox_max[1]) + 1
        x1 = max(x1, x0 + 1)
        y1 = max(y1, y0 + 1)
        if kf_rgb.dtype == np.uint8:
            roi = np.ascontiguousarray(kf_rgb[y0:y1, x0:x1])
        else:
            roi = (np.clip(kf_rgb[y0:y1, x0:x1] * 255.0, 0, 255)
                   ).astype(np.uint8)
        tile = resize_bilinear(roi, self.patch_size, self.patch_size)
        ox, oy = self._slot_origin(rec.slot_index)
        self._ensure_rows(oy + self.patch_size)
        self.image[oy:oy + self.patch_size, ox:ox + self.patch_size] = tile
        self._grow_hot(ox, oy)
        return rec

    def _ensure_rows(self, rows: int) -> None:
        if rows <= self._rows:
            return
        new_rows = self._rows
        while new_rows < rows:
            new_rows *= 2
        new_rows = min(new_rows, self.size)
        grown = np.zeros((new_rows, self.size, 3), np.uint8)
        grown[: self._rows] = self.image
        self._rows, self.image = new_rows, grown

    def _grow_hot(self, ox: int, oy: int) -> None:
        p = self.patch_size
        if self.hot_region is None:
            self.hot_region = (ox, oy, ox + p, oy + p)
        else:
            x0, y0, x1, y1 = self.hot_region
            self.hot_region = (min(x0, ox), min(y0, oy),
                               max(x1, ox + p), max(y1, oy + p))

    def release(self, chunk_slot: int) -> None:
        rec = self.patches.pop(chunk_slot, None)
        if rec is not None:
            self.free.append(rec.slot_index)

    def atlas_uv(self, chunk_slot: int, uv_img: np.ndarray) -> np.ndarray:
        """Map keyframe-image uv ([N, 2]) of a chunk's vertices to atlas
        texture coordinates in [0, 1] (v flipped for OBJ convention)."""
        rec = self.patches[chunk_slot]
        span = np.maximum(rec.bbox_max - rec.bbox_min, 1.0)
        rel = (uv_img - rec.bbox_min) / span          # 0..1 inside the bbox
        rel = np.clip(rel, 0.0, 1.0)
        ox, oy = self._slot_origin(rec.slot_index)
        px = (ox + rel[:, 0] * (self.patch_size - 1)) / self.size
        py = (oy + rel[:, 1] * (self.patch_size - 1)) / self.size
        return np.stack([px, 1.0 - py], axis=-1)

    # ------------------------------------------------------------- export

    def save_textured_model(self, out_dir: str, verts: np.ndarray,
                            faces: np.ndarray, atlas_uvs: np.ndarray,
                            name: str = "model",
                            vertex_colors: Optional[np.ndarray] = None
                            ) -> str:
        """OBJ + MTL + PNG export (ref: Atlas.cpp:93-179 SaveTexturedModel).
        `vertex_colors` [N, 3] float 0..1 appends per-vertex compensated
        colors to the `v` records (widely-read OBJ extension) — the
        per-vertex quantity the reference feeds its shader
        (ref: Chisel.cpp:270-284)."""
        os.makedirs(out_dir, exist_ok=True)
        png = os.path.join(out_dir, f"{name}.png")
        # export only the USED rows (patch slots fill top rows first) and
        # rescale the OBJ v coordinates to the cropped height — a full
        # atlas_size² PNG encode took minutes for a mostly-empty image
        h_used = self._rows
        if self.patches:
            h_used = max(self._slot_origin(r.slot_index)[1]
                         + self.patch_size for r in self.patches.values())
        h_used = max(min(h_used, self._rows), self.patch_size)
        write_png(png, self.image[:h_used])
        if len(atlas_uvs):
            atlas_uvs = atlas_uvs.copy()
            # uv v was normalized against the full logical size:
            # py = 1 - v in [0, h_used/size] → renormalize to h_used
            atlas_uvs[:, 1] = 1.0 - (1.0 - atlas_uvs[:, 1]) \
                * (self.size / h_used)
        mtl_path = os.path.join(out_dir, f"{name}.mtl")
        with open(mtl_path, "w") as f:
            f.write(f"newmtl textured\nKa 1 1 1\nKd 1 1 1\nKs 0 0 0\n"
                    f"map_Kd {name}.png\n")
        obj_path = os.path.join(out_dir, f"{name}.obj")
        with open(obj_path, "w") as f:
            f.write(f"mtllib {name}.mtl\nusemtl textured\n")
            if vertex_colors is not None:
                for v, c in zip(verts, np.clip(vertex_colors, 0.0, 1.0)):
                    f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} "
                            f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n")
            else:
                for v in verts:
                    f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            for t in atlas_uvs:
                f.write(f"vt {t[0]:.6f} {t[1]:.6f}\n")
            for tri in faces + 1:
                f.write(f"f {tri[0]}/{tri[0]} {tri[1]}/{tri[1]} {tri[2]}/{tri[2]}\n")
        return obj_path
