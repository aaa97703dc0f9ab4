"""Deferred keyframe promotion registers the new keyframe against the
keyframe it was tracked against: no self-edges in the pose graph, and
BA never has to pull a provisional keyframe pose back into place."""

import jax
import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.config import tiny_test_config
from texturefusion_tpu.core import camera as cam
from texturefusion_tpu.fusion.pipeline import ReconstructionPipeline
from texturefusion_tpu.io import synthetic, tum


def test_deferred_promotion_edges_link_distinct_keyframes():
    cfg = tiny_test_config()
    assert cfg.tracking.defer_promote
    intr = cam.Intrinsics.from_config(cfg.camera)
    poses = synthetic.orbit_trajectory(16, angle_range=3.0)
    depths, rgbs = synthetic.render_sequence(synthetic.BoxRoomScene(), intr,
                                             poses)
    pipe = ReconstructionPipeline(cfg)
    for i in range(len(poses)):
        pipe.process_frame(jnp.asarray(depths[i]), jnp.asarray(rgbs[i]),
                           timestamp=float(i))
    pipe.finish()
    slam = pipe.slam
    assert len(slam.keyframes) >= 3
    e = jax.tree.map(np.asarray, slam.edges)
    valid = e.valid[:slam.n_edges]
    ki, kj = e.kf_i[:slam.n_edges][valid], e.kf_j[:slam.n_edges][valid]
    assert len(ki) >= len(slam.keyframes) - 1
    assert (ki != kj).all(), list(zip(ki, kj))
    # every keyframe is tied to an earlier one
    assert set(kj.tolist()) >= set(range(1, len(slam.keyframes)))
    assert tum.ate_rmse(pipe.trajectory(), np.stack(poses)) < 0.02
