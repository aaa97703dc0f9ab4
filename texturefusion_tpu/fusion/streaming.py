"""TSDF chunk streaming: host offload of cold chunks.

BASELINE.json config 4 ("large multi-room sequence with TSDF chunk
streaming"): the device slot pool is finite; chunks far from the camera
are offloaded to host memory and their slots recycled, then restored
transparently when the camera revisits. The reference has no equivalent
(its chunk map lives in CPU RAM and is bounded only by the machine);
here it is what keeps device memory bounded while the map grows without
limit.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.fusion.chunkmap import TSDFVolume
from texturefusion_tpu.ops import tsdf as tsdf_ops


class ChunkStreamer:
    def __init__(self, volume: TSDFVolume, max_resident: int,
                 offload_radius: float = 6.0):
        self.volume = volume
        self.max_resident = max_resident
        self.offload_radius = offload_radius
        # chunk id -> host copies of (sdf, weight, color, color_count, obs)
        self.cold: Dict[Tuple[int, int, int], tuple] = {}

    def n_cold(self) -> int:
        return len(self.cold)

    def offload_cold(self, camera_position: np.ndarray) -> int:
        """Move chunks beyond offload_radius (or beyond the resident
        budget, farthest first) to host memory. Returns count offloaded."""
        vol = self.volume
        act = vol.active_slots()
        if len(act) == 0:
            return 0
        centers = (vol.ids[act].astype(np.float64) + 0.5) * vol.extent
        dist = np.linalg.norm(centers - np.asarray(camera_position), axis=-1)
        over_budget = max(len(act) - self.max_resident, 0)
        far = dist > self.offload_radius
        victims = act[far]
        if over_budget > len(victims):
            order = np.argsort(-dist)
            victims = act[order[:max(over_budget, len(victims))]]
        if len(victims) == 0:
            return 0
        idx = jnp.asarray(victims)
        sdf = np.asarray(vol.batch.sdf[idx])
        w = np.asarray(vol.batch.weight[idx])
        col = np.asarray(vol.batch.color[idx])
        cnt = np.asarray(vol.batch.color_count[idx])
        vol.flush_observations()   # offloaded rows carry final entries
        for row, s in enumerate(victims.tolist()):
            cid = tuple(vol.ids[s])
            self.cold[cid] = (sdf[row], w[row], col[row], cnt[row],
                              vol.obs_row(s))
        vol.release(victims)
        return len(victims)

    def ensure_resident(self, ids: np.ndarray) -> int:
        """Restore any offloaded chunks among `ids` (N, 3) to device slots.
        Call before integrating a frame that may revisit old space.
        Returns count restored."""
        vol = self.volume
        hits = [tuple(c) for c in np.asarray(ids, np.int32).tolist()
                if tuple(c) in self.cold]
        if not hits:
            return 0
        id_arr = np.asarray(hits, np.int32)
        slots = vol.allocate(id_arr)
        ok = slots >= 0
        if not ok.any():
            return 0
        rows = [self.cold[h] for h, k in zip(hits, ok) if k]
        slot_arr = jnp.asarray(slots[ok])
        vol.batch = tsdf_ops.ChunkBatch(
            sdf=vol.batch.sdf.at[slot_arr].set(
                jnp.asarray(np.stack([r[0] for r in rows]))),
            weight=vol.batch.weight.at[slot_arr].set(
                jnp.asarray(np.stack([r[1] for r in rows]))),
            color=vol.batch.color.at[slot_arr].set(
                jnp.asarray(np.stack([r[2] for r in rows]))),
            color_count=vol.batch.color_count.at[slot_arr].set(
                jnp.asarray(np.stack([r[3] for r in rows]))),
        )
        kept = [h for h, k in zip(hits, ok) if k]
        for s, h, r in zip(slots[ok].tolist(), kept, rows):
            vol.set_obs_row(int(s), r[4])
            vol.dirty_mesh.add(int(s))
            del self.cold[h]
        return int(ok.sum())
