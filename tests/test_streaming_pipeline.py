"""Chunk streaming wired into the fusion cycle: device residency stays
bounded over a long sweep and offloaded surface still exports."""

import dataclasses

import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.config import tiny_test_config
from texturefusion_tpu.core import camera as cam
from texturefusion_tpu.fusion.pipeline import ReconstructionPipeline
from texturefusion_tpu.io import synthetic


def test_streaming_bounds_residency():
    base = tiny_test_config()
    cfg = base.replace(tsdf=dataclasses.replace(
        base.tsdf, max_resident_chunks=160, streaming_radius=1.0,
        keyframe_device_budget_mb=0.05))
    intr = cam.Intrinsics.from_config(cfg.camera)
    scene = synthetic.BoxRoomScene()
    # a wide sweep visiting several wall regions so chunks go cold
    poses = synthetic.orbit_trajectory(24, angle_range=2.4)
    depths, rgbs = synthetic.render_sequence(scene, intr, poses)

    pipe = ReconstructionPipeline(cfg)
    assert pipe.streamer is not None
    peaks = []
    for i in range(len(poses)):
        pipe.process_frame(jnp.asarray(depths[i]), jnp.asarray(rgbs[i]),
                           timestamp=float(i))
        peaks.append(pipe.volume.n_active())
    pipe.finish()

    # residency stays within budget + one frame's worth of new chunks
    # (the offload pass runs at keyframe rate)
    slack = cfg.tsdf.max_update_chunks
    assert max(peaks) <= cfg.tsdf.max_resident_chunks + slack, max(peaks)

    # keyframe device memory is staged out for integrated keyframes
    released = [st for st in pipe.kf_states.values()
                if st.integrated and st.depth_weight is None]
    assert released, "no keyframe released its refinement weight"

    # offloaded chunks (if any went cold) still export through the
    # frozen-mesh path; the mesh is substantial either way
    verts, faces, colors, normals = pipe.mesher.full_mesh()
    assert len(verts) > 200
    assert np.isfinite(verts).all()


def test_gc_frees_empty_chunks():
    cfg = tiny_test_config()
    intr = cam.Intrinsics.from_config(cfg.camera)
    scene = synthetic.BoxRoomScene()
    poses = synthetic.orbit_trajectory(8)
    depths, rgbs = synthetic.render_sequence(scene, intr, poses)
    pipe = ReconstructionPipeline(cfg)
    for i in range(len(poses)):
        pipe.process_frame(jnp.asarray(depths[i]), jnp.asarray(rgbs[i]),
                           timestamp=float(i))
    pipe.finish()
    # every remaining active chunk actually holds observations
    act = pipe.volume.active_slots()
    occ = np.asarray(jnp.sum(jnp.abs(pipe.volume.batch.weight[jnp.asarray(act)]),
                             axis=-1))
    # the gc pass runs at cycle rate; chunks allocated after the last
    # cycle may still be empty — but the vast majority must be occupied
    assert (occ > 0).mean() > 0.5, (occ > 0).mean()
