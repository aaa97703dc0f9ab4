"""Checkpoint / resume for the reconstruction pipeline.

The reference has NO mid-run snapshot capability (SURVEY.md §5 — only
terminal artifact export, main.cpp:213-313). This is a new capability this
framework adds: every piece of pipeline state is a serializable
tensor or small host structure, so a run can stop and resume exactly.

Format: one .npz for dense device arrays + one pickle for host
structures, written atomically (tmp + rename).
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np


def _atomic_write(path: str, writer) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        writer(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_pipeline(pipe, path: str) -> None:
    """Snapshot a ReconstructionPipeline/TexturedPipeline to `path`
    (.npz + .pkl sidecar)."""
    if hasattr(pipe, "flush_tracking"):
        pipe.flush_tracking()       # finalize any in-flight pipelined frame
    if hasattr(pipe, "_drain_fusion"):
        pipe._drain_fusion()
    vol = pipe.volume
    slam = pipe.slam
    arrays: Dict[str, np.ndarray] = {
        "sdf": np.asarray(vol.batch.sdf),
        "weight": np.asarray(vol.batch.weight),
        "color": np.asarray(vol.batch.color),
        "color_count": np.asarray(vol.batch.color_count),
        "origins": np.asarray(vol.origins),
        "poses": slam.poses,
        "chunk_ids": vol.ids,
        "used": vol.used,
    }
    for name, arr in zip(slam.edges._fields, slam.edges):
        arrays[f"edge_{name}"] = np.asarray(arr)

    meta: Dict[str, Any] = {
        "slot_of": vol.slot_of,
        "observations": vol.observations,
        "dirty_mesh": vol.dirty_mesh,
        "chunks_created": vol.chunks_created,
        "n_edges": slam.n_edges,
        "origin_count": slam.origin_count,
        "fail_count": slam.fail_count,
        "frames": [
            {k: getattr(f, k) for k in
             ("index", "timestamp", "is_keyframe", "keyframe_slot",
              "tracking_success", "origin_index", "blurred")}
            | {"rel_to_keyframe": f.rel_to_keyframe}
            for f in slam.frames
        ],
        "keyframes": [
            {"frame_index": k.frame_index, "slot": k.slot,
             "origin_index": k.origin_index, "local_frames": k.local_frames,
             "reg_success_count": k.reg_success_count}
            for k in slam.keyframes
        ],
        "db_kf_ids": slam.db.kf_ids,
        "kf_states": {
            s: {"kf_slot": st.kf_slot, "frame_index": st.frame_index,
                "depth": st.depth, "rgb": st.rgb, "quality": st.quality,
                "local_depths": st.local_depths,
                "local_rel_poses": st.local_rel_poses,
                "local_frame_idx": st.local_frame_idx,
                "depth_weight": st.depth_weight,
                "integrated_pose": st.integrated_pose,
                "integrated": st.integrated}
            for s, st in pipe.kf_states.items()
        },
        "stats": pipe.stats,
    }
    arrays["db_desc"] = np.asarray(slam.db.desc)
    arrays["db_valid"] = np.asarray(slam.db.valid)
    # device keypoint DB + DB-row→slot map: the single-dispatch promotion
    # probe gathers candidate keypoints from these (gcslam.py kp_db /
    # _row_to_slot); without them a resumed run registers loop-closure
    # candidates against all-zero keypoints
    arrays["row_to_slot"] = np.asarray(slam._row_to_slot)
    for name, arr in zip(slam.kp_db.kp._fields, slam.kp_db.kp):
        arrays[f"kpdb_{name}"] = np.asarray(arr)
    # raw per-edge matches: finalBA's Huber re-weighting needs them
    arrays["edge_midx"] = np.asarray(slam._edge_midx)
    arrays["edge_minl"] = np.asarray(slam._edge_minl)
    arrays["edge_has"] = slam._edge_has

    # keyframe keypoints (needed to register future frames after resume)
    if slam.keyframes:
        kp_list = [slam.frames[k.frame_index].keypoints for k in slam.keyframes]
        for name in kp_list[0]._fields:
            arrays[f"kp_{name}"] = np.stack(
                [np.asarray(getattr(kp, name)) for kp in kp_list])

    def write_npz(tmp):
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)

    _atomic_write(path, write_npz)
    _atomic_write(path + ".meta", lambda p: pickle.dump(
        meta, open(p, "wb"), protocol=pickle.HIGHEST_PROTOCOL))


def load_pipeline(pipe, path: str) -> None:
    """Restore state saved by save_pipeline into a freshly-constructed
    pipeline with the same config."""
    from texturefusion_tpu.fusion.pipeline import KeyframeFusionState
    from texturefusion_tpu.ops import tsdf as tsdf_ops
    from texturefusion_tpu.slam import fastba
    from texturefusion_tpu.slam.gcslam import FrameRecord, KeyframeRecord

    data = np.load(path, allow_pickle=False)
    meta = pickle.load(open(path + ".meta", "rb"))

    vol = pipe.volume
    vol.batch = tsdf_ops.ChunkBatch(
        sdf=jnp.asarray(data["sdf"]), weight=jnp.asarray(data["weight"]),
        color=jnp.asarray(data["color"]),
        color_count=jnp.asarray(data["color_count"]))
    vol.origins = jnp.asarray(data["origins"])
    vol.ids = data["chunk_ids"].copy()
    vol.used = data["used"].copy()
    vol.slot_of = dict(meta["slot_of"])
    active = np.nonzero(vol.used)[0].astype(np.int64)
    vol.alloc.import_state(active, vol.ids[active])
    vol.observations = {int(k): dict(v) for k, v in meta["observations"].items()}
    vol.dirty_mesh = set(meta["dirty_mesh"])
    vol.chunks_created = meta["chunks_created"]

    slam = pipe.slam
    slam.poses = data["poses"].copy()
    slam.edges = fastba.EdgeSums(
        **{name: jnp.asarray(data[f"edge_{name}"])
           for name in fastba.EdgeSums._fields})
    slam.n_edges = meta["n_edges"]
    slam.origin_count = meta["origin_count"]
    slam.fail_count = meta["fail_count"]
    slam.frames = [FrameRecord(**f) for f in meta["frames"]]
    slam.keyframes = [KeyframeRecord(**k) for k in meta["keyframes"]]
    if slam.keyframes and "kp_uv" in data:
        from texturefusion_tpu.slam.features import Keypoints
        for i, k in enumerate(slam.keyframes):
            slam.frames[k.frame_index].keypoints = Keypoints(
                **{name: jnp.asarray(data[f"kp_{name}"][i])
                   for name in Keypoints._fields})
    slam.db.kf_ids = list(meta["db_kf_ids"])
    slam.db.desc = jnp.asarray(data["db_desc"])
    slam.db.valid = jnp.asarray(data["db_valid"])
    if "edge_midx" in data:
        slam._edge_midx = jnp.asarray(data["edge_midx"])
        slam._edge_minl = jnp.asarray(data["edge_minl"])
        slam._edge_has = data["edge_has"].copy()
    if "row_to_slot" in data:
        slam._row_to_slot = jnp.asarray(data["row_to_slot"])
        from texturefusion_tpu.slam.features import Keypoints
        slam.kp_db.kp = Keypoints(
            **{name: jnp.asarray(data[f"kpdb_{name}"])
               for name in Keypoints._fields})
    else:
        # legacy checkpoint: rebuild the device keypoint DB from the
        # per-keyframe keypoints saved above
        for k in slam.keyframes:
            kp = slam.frames[k.frame_index].keypoints
            if kp is not None:
                slam.kp_db.add(k.slot, kp)
        rts = np.full(slam.kp_db.max_kf, -1, np.int32)
        for row, s in enumerate(slam.db.kf_ids):
            rts[row] = s
        slam._row_to_slot = jnp.asarray(rts)

    pipe.kf_states = {int(s): KeyframeFusionState(**st)
                      for s, st in meta["kf_states"].items()}
    pipe.stats = dict(meta["stats"])
    # meshes are derived state: mark everything dirty and remesh lazily
    vol.dirty_mesh.update(vol.active_slots().tolist())
