import os

import jax.numpy as jnp
import numpy as np
import pytest

from texturefusion_tpu.config import tiny_test_config
from texturefusion_tpu.core import camera as cam
from texturefusion_tpu.fusion.pipeline import ReconstructionPipeline
from texturefusion_tpu.io import synthetic
from texturefusion_tpu.ops.simplify import simplify_by_clustering
from texturefusion_tpu.utils import checkpoint

CFG = tiny_test_config()
INTR = cam.Intrinsics.from_config(CFG.camera)
SCENE = synthetic.BoxRoomScene()


@pytest.fixture(scope="module")
def seq():
    poses = synthetic.orbit_trajectory(6)
    depths, rgbs = synthetic.render_sequence(SCENE, INTR, poses)
    return poses, depths, rgbs


def test_checkpoint_roundtrip(seq, tmp_path):
    poses, depths, rgbs = seq
    pipe = ReconstructionPipeline(CFG)
    for i in range(4):
        pipe.process_frame(jnp.asarray(depths[i]), jnp.asarray(rgbs[i]),
                           timestamp=float(i))
    ckpt = str(tmp_path / "state.ckpt")
    checkpoint.save_pipeline(pipe, ckpt)

    pipe2 = ReconstructionPipeline(CFG)
    checkpoint.load_pipeline(pipe2, ckpt)
    # state equality
    np.testing.assert_array_equal(np.asarray(pipe.volume.batch.sdf),
                                  np.asarray(pipe2.volume.batch.sdf))
    assert pipe2.volume.slot_of == pipe.volume.slot_of
    assert len(pipe2.slam.frames) == len(pipe.slam.frames)
    assert pipe2.slam.n_edges == pipe.slam.n_edges
    # the promotion-probe state must survive: the device keypoint DB and
    # the DB-row→slot map feed loop closure after resume
    np.testing.assert_array_equal(np.asarray(pipe.slam._row_to_slot),
                                  np.asarray(pipe2.slam._row_to_slot))
    np.testing.assert_array_equal(np.asarray(pipe.slam.kp_db.kp.desc),
                                  np.asarray(pipe2.slam.kp_db.kp.desc))
    assert np.asarray(pipe2.slam.kp_db.kp.valid).any(), \
        "restored keypoint DB is empty — promote_probe would register " \
        "candidates against all-zero keypoints"

    # resumed pipeline keeps working: feed remaining frames
    for i in range(4, 6):
        pipe2.process_frame(jnp.asarray(depths[i]), jnp.asarray(rgbs[i]),
                            timestamp=float(i))
    pipe2.finish()
    assert pipe2.stats["frames"] == 6
    # trajectories agree with a fresh full run on the shared prefix
    traj = pipe2.trajectory()
    assert traj.shape == (6, 4, 4)
    assert np.isfinite(traj).all()


def test_checkpoint_resume_loop_closure(tmp_path):
    """Resume must keep loop closure ALIVE: after restore, run enough
    frames that new keyframes promote — their registrations probe the
    restored device keypoint DB (all-zero before the fix, so every
    candidate registration failed silently)."""
    poses = synthetic.orbit_trajectory(16, angle_range=3.0)
    depths, rgbs = synthetic.render_sequence(SCENE, INTR, poses)
    pipe = ReconstructionPipeline(CFG)
    for i in range(8):
        pipe.process_frame(jnp.asarray(depths[i]), jnp.asarray(rgbs[i]),
                           timestamp=float(i))
    pipe.flush_tracking()
    ckpt = str(tmp_path / "mid.ckpt")
    checkpoint.save_pipeline(pipe, ckpt)
    kf_before = len(pipe.slam.keyframes)
    edges_before = pipe.slam.n_edges

    pipe2 = ReconstructionPipeline(CFG)
    checkpoint.load_pipeline(pipe2, ckpt)
    for i in range(8, 16):
        pipe2.process_frame(jnp.asarray(depths[i]), jnp.asarray(rgbs[i]),
                            timestamp=float(i))
    pipe2.finish()
    assert len(pipe2.slam.keyframes) > kf_before, \
        "no keyframe promoted after resume"
    # every new keyframe must have registered against a RESTORED
    # keyframe (edge added) — impossible with a zeroed keypoint DB
    assert pipe2.slam.n_edges > edges_before, \
        "no edges created after resume — loop closure silently broken"
    assert pipe2.slam.origin_count == 1, \
        "tracking lost after resume (new map origin created)"


def test_simplify_by_clustering():
    # a dense grid plane: clustering at 2x spacing quarters the vertices
    xs, ys = np.meshgrid(np.arange(10) * 0.01, np.arange(10) * 0.01)
    verts = np.stack([xs.ravel(), ys.ravel(), np.zeros(100)], -1).astype(np.float32)
    faces = []
    for r in range(9):
        for c in range(9):
            a = r * 10 + c
            faces.append([a, a + 1, a + 10])
            faces.append([a + 1, a + 11, a + 10])
    faces = np.asarray(faces, np.int32)
    colors = np.ones_like(verts) * 0.5
    v2, f2, c2, _ = simplify_by_clustering(verts, faces, 0.02, colors)
    assert len(v2) < len(verts) * 0.5
    assert len(f2) > 0
    assert (f2 < len(v2)).all()
    np.testing.assert_allclose(c2, 0.5, atol=1e-6)


def test_cli_synthetic_mode(tmp_path, monkeypatch):
    # shrink the synthetic run via a custom camera by patching the sensor
    from texturefusion_tpu.io import sensors

    orig = sensors.SyntheticSensor

    def small(n_frames=30, camera=None):
        return orig(n_frames=4, camera=CFG.camera)

    monkeypatch.setattr(sensors, "SyntheticSensor", small)
    from texturefusion_tpu.__main__ import main
    out = str(tmp_path / "out")
    rc = main(["", "", "0.05", "4", "--out", out, "--max-frames", "4",
               "--no-texture"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "trajectory.txt"))
    assert os.path.exists(os.path.join(out, "fused.ply"))


def test_params_yaml_loading(tmp_path):
    from texturefusion_tpu.__main__ import apply_params, load_params_yaml
    yaml = tmp_path / "settings.yaml"
    yaml.write_text("%YAML:1.0\n\nmax_feature_num: 800\n"
                    "minimum_disparity:        0.2\n"
                    "hamming_distance_threshold:       40\n"
                    "far_plane_distance:               5\n")
    params = load_params_yaml(str(yaml))
    assert params["max_feature_num"] == 800
    cfg = apply_params(CFG, params)
    assert cfg.tracking.max_features == 800
    assert cfg.tracking.minimum_disparity == 0.2
    assert cfg.tracking.hamming_threshold == 40
    assert cfg.camera.far_plane == 5.0


def test_cli_synthetic_with_texture(tmp_path, monkeypatch):
    from texturefusion_tpu.io import sensors

    orig = sensors.SyntheticSensor

    def small(n_frames=30, camera=None):
        return orig(n_frames=6, camera=CFG.camera)

    monkeypatch.setattr(sensors, "SyntheticSensor", small)
    from texturefusion_tpu.__main__ import main
    out = str(tmp_path / "out_tex")
    rc = main(["", "", "0.05", "4", "--out", out, "--max-frames", "6"])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "fused.ply"))
    assert os.path.exists(os.path.join(out, "stat.txt"))
    # textured model may legitimately be skipped only if no chunk got a
    # patch; with 6 frames of the box room it must exist
    assert os.path.exists(os.path.join(out, "model.obj"))
    assert os.path.exists(os.path.join(out, "model.png"))
