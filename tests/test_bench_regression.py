"""Accuracy regression gate over a FROZEN bench-shaped scenario:
every perf change must keep tracking and map
accuracy — nothing else in the suite fails when a latency optimization
quietly degrades ATE or the fused surface.

The scenario is the r4 hardened bench at CPU scale: the same 360° loop
(120 frames — the bench's 3°/frame angular rate; fewer frames makes the
rotation rate untrackable) in the same box room, WITH lens distortion,
sensor depth noise, a ⅔-stop exposure step and a motion-blur burst, at
quarter-VGA. Seeds, trajectory and thresholds are FROZEN — do not retune
them to make a regression pass; fix the regression.

Measured at freeze time (r5, CPU backend, pipeline_depth=2):
ATE 13.9 mm, map RMS 20.5 mm, 30 keyframes, 65 edges, 20 reintegrations.
"""

import numpy as np
import pytest

import jax.numpy as jnp

pytestmark = pytest.mark.slow

N_FRAMES = 120
BLUR_FRAMES = (46, 47, 48)
EXPOSURE_GAIN = 1.55
EXPOSURE_RANGE = (60, 95)

ATE_GATE_MM = 25.0
MAP_RMS_GATE_MM = 32.0


@pytest.fixture(scope="module")
def ran():
    from texturefusion_tpu.config import (BAConfig, CameraConfig,
                                          MeshConfig, ParallelConfig,
                                          PipelineConfig, TextureConfig,
                                          TrackingConfig, TSDFConfig)
    from texturefusion_tpu.core import camera as cam
    from texturefusion_tpu.fusion.pipeline import TexturedPipeline
    from texturefusion_tpu.io import synthetic
    from texturefusion_tpu.io.image import gaussian_blur
    from texturefusion_tpu.ops.preprocess import pack_frame

    config = PipelineConfig(
        camera=CameraConfig(width=320, height=240, fx=262.5, fy=262.5,
                            cx=159.5, cy=119.5, far_plane=6.0,
                            d0=-0.03, d1=0.005),
        tracking=TrackingConfig(max_features=512, max_features_pad=512,
                                max_matches_pad=512, ransac_iterations=256,
                                min_matches=16, blur_threshold=3.0),
        ba=BAConfig(max_keyframes=64, max_edges=512,
                    schur_min_keyframes=16),
        tsdf=TSDFConfig(voxel_resolution=0.04, capacity=4096,
                        max_update_chunks=768),
        mesh=MeshConfig(max_mesh_chunks=1024),
        texture=TextureConfig(atlas_size=4096),
        parallel=ParallelConfig(async_fusion=True, pipeline_depth=2),
    )
    intr = cam.Intrinsics.from_config(config.camera)
    poses = synthetic.loop_trajectory(N_FRAMES, radius=1.5)
    scene = synthetic.BoxRoomScene(room_min=(-2.6, -1.5, -2.6),
                                   room_max=(2.6, 1.5, 2.6))
    depths, rgbs = synthetic.render_sequence(scene, intr, poses)
    rng = np.random.default_rng(3)

    pipe = TexturedPipeline(config)
    for i, (d, c) in enumerate(zip(depths, rgbs)):
        d = np.asarray(d)
        c = np.asarray(c)
        noise = rng.normal(0.0, 0.016, d.shape).astype(np.float32) \
            * np.maximum(d, 0.5)
        d = np.where(d > 0, d + noise, 0.0)
        if EXPOSURE_RANGE[0] <= i < EXPOSURE_RANGE[1]:
            c = np.clip(c * EXPOSURE_GAIN, 0.0, 1.0)
        if i in BLUR_FRAMES:
            c = gaussian_blur(c, 3.0)
        packed = pack_frame(
            (d * config.camera.depth_scale).astype(np.uint16),
            (c * 255).astype(np.uint8))
        pipe.process_frame(jnp.asarray(packed), timestamp=float(i))
    pipe.finish()
    return pipe, np.stack(poses), scene


def test_ate_gate(ran):
    from texturefusion_tpu.io import tum
    pipe, gt, _ = ran
    est = pipe.trajectory()
    ate = tum.ate_rmse(est, gt[: len(est)])
    assert ate * 1e3 <= ATE_GATE_MM, f"ATE {ate * 1e3:.1f} mm regressed"


def test_map_quality_gate(ran):
    from texturefusion_tpu.io import tum
    pipe, gt, scene = ran
    est = pipe.trajectory()
    verts, _, _, _ = pipe.mesher.full_mesh()
    assert len(verts) > 1000
    rot, t = tum.align_umeyama(est, gt[: len(est)])
    verts = verts @ rot.T + t
    d = np.abs(np.asarray(scene.sdf(jnp.asarray(verts))))
    rms = float(np.sqrt(np.mean(d ** 2))) * 1e3
    assert rms <= MAP_RMS_GATE_MM, f"map RMS {rms:.1f} mm regressed"


def test_loop_closure_exercised(ran):
    pipe, _, _ = ran
    # the 360° loop must actually close and correct drift — a perf change
    # that silently disables reintegration or loop closure fails here
    assert pipe.stats["reintegrations"] > 0
    assert pipe.slam.n_edges > len(pipe.slam.keyframes) - 1, \
        "no loop-closure edges beyond the odometry chain"
    assert len(pipe.slam.keyframes) >= 20
