import jax
import jax.numpy as jnp
import numpy as np
import pytest

from texturefusion_tpu.config import BAConfig, tiny_test_config
from texturefusion_tpu.core import camera as cam, se3
from texturefusion_tpu.parallel import ba as pba
from texturefusion_tpu.parallel import mesh as pmesh
from texturefusion_tpu.parallel import sharded_tsdf
from texturefusion_tpu.slam import fastba

from test_fastba import _make_pose_graph


def test_mesh_has_8_devices():
    m = pmesh.make_mesh()
    assert m.size == 8


def test_distributed_ba_matches_single_device():
    poses, edges, active, gt, n_total = _make_pose_graph(noise=0.05)
    cfg = BAConfig(gn_rounds=1, gn_iterations_per_round=5)
    # single-device result
    ref_poses, e0_ref, e1_ref = fastba.gauss_newton_rounds(
        poses, edges, n_total, active, cfg)
    # distributed over the 8-device CPU mesh
    m = pmesh.make_mesh()
    edges_p = pba.pad_edges_for_mesh(edges, m.size)
    edges_s = pba.shard_edges(edges_p, m)
    out, e0, e1 = pba.distributed_gn(poses, edges_s, n_total, active, cfg, m)
    np.testing.assert_allclose(float(e0), float(e0_ref), rtol=1e-4)
    np.testing.assert_allclose(float(e1), float(e1_ref), rtol=1e-2, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref_poses),
                               rtol=1e-3, atol=1e-5)


def test_distributed_ba_converges_to_gt():
    poses, edges, active, gt, n_total = _make_pose_graph(noise=0.05, seed=7)
    cfg = BAConfig(gn_rounds=1, gn_iterations_per_round=6)
    m = pmesh.make_mesh()
    edges_s = pba.shard_edges(pba.pad_edges_for_mesh(edges, m.size), m)
    out, e0, e1 = pba.distributed_gn(poses, edges_s, n_total, active, cfg, m)
    out = np.asarray(out)
    for k in range(6):
        d = np.asarray(se3.pose_distance(jnp.asarray(out[k]), jnp.asarray(gt[k])))
        assert d < 1e-6, (k, d)


def test_sharded_tsdf_integration_matches_dense():
    cfg = tiny_test_config()
    intr = cam.Intrinsics.from_config(cfg.camera)
    m = pmesh.make_mesh()
    cap = 64  # divisible by 8
    n_vox = cfg.tsdf.chunk_size ** 3
    batch, origins = sharded_tsdf.make_sharded_batch(cap, n_vox, m)
    # a couple of chunks in front of a synthetic wall depth map
    from texturefusion_tpu.io import synthetic
    scene = synthetic.BoxRoomScene()
    pose = jnp.asarray(synthetic.orbit_trajectory(1)[0])
    depth, rgb = synthetic.render_frame(scene, intr, pose)
    origins_np = np.zeros((cap, 3), np.float32)
    active_np = np.zeros(cap, bool)
    # chunks along the wall at z≈2 (in camera world coords)
    ext = cfg.tsdf.chunk_size * cfg.tsdf.voxel_resolution
    k = 0
    for x in range(-4, 4):
        for y in range(-2, 2):
            origins_np[k] = [x * ext, y * ext, 1.8]
            active_np[k] = True
            k += 1
    origins = jax.device_put(jnp.asarray(origins_np), pmesh.shard_leading(m))
    active = jax.device_put(jnp.asarray(active_np), pmesh.shard_leading(m))

    step = sharded_tsdf.sharded_integrate_step(m, intr, cfg.tsdf)
    quality = jnp.zeros_like(depth)
    new_batch, cq = step(batch, origins, active, depth, rgb, quality, pose,
                         jnp.float32(1.0))
    w = np.asarray(new_batch.weight)
    assert w.sum() > 0
    # compare against the plain (unsharded) kernel
    from texturefusion_tpu.ops import tsdf as tsdf_ops
    plain = tsdf_ops.make_empty_batch(cap, n_vox)
    ref, q_ref, _ = tsdf_ops.integrate_chunks(
        plain, jnp.asarray(origins_np), jnp.asarray(active_np), depth, rgb,
        quality, pose, jnp.float32(1.0), intr, cfg.tsdf, with_color=True)
    np.testing.assert_allclose(w, np.asarray(ref.weight), atol=1e-6)
    np.testing.assert_allclose(np.asarray(new_batch.sdf), np.asarray(ref.sdf),
                               atol=1e-4)


def test_gcslam_with_distributed_ba():
    """Full SLAM with the edge-sharded BA backend over the 8-device mesh."""
    import dataclasses

    import jax.numpy as jnp

    from texturefusion_tpu.config import ParallelConfig, tiny_test_config
    from texturefusion_tpu.io import synthetic, tum
    from texturefusion_tpu.ops import preprocess
    from texturefusion_tpu.slam.gcslam import GCSLAM

    cfg = tiny_test_config().replace(parallel=ParallelConfig(n_devices=8))
    intr = cam.Intrinsics.from_config(cfg.camera)
    scene = synthetic.BoxRoomScene()
    poses = synthetic.orbit_trajectory(8)
    depths, rgbs = synthetic.render_sequence(scene, intr, poses)
    slam = GCSLAM(cfg)
    for i in range(8):
        gray = preprocess.rgb_to_gray(jnp.asarray(rgbs[i])) * 255.0
        slam.update_frame(gray, jnp.asarray(depths[i]), timestamp=float(i))
    est = slam.trajectory()
    rmse = tum.ate_rmse(est, np.stack(poses))
    assert rmse < 0.02, rmse


def test_real_pipeline_sharded_matches_single_device():
    """The LIVE ReconstructionPipeline with tsdf_sharded=True runs its
    integrate/mesh programs chunk-partitioned over the 8-device mesh and
    reproduces the single-device reconstruction."""
    import jax.numpy as jnp

    from texturefusion_tpu.config import ParallelConfig, tiny_test_config
    from texturefusion_tpu.fusion.pipeline import ReconstructionPipeline
    from texturefusion_tpu.io import synthetic

    scene = synthetic.BoxRoomScene()
    base = tiny_test_config()
    intr = cam.Intrinsics.from_config(base.camera)
    poses = synthetic.orbit_trajectory(8)
    depths, rgbs = synthetic.render_sequence(scene, intr, poses)

    def run(cfg):
        pipe = ReconstructionPipeline(cfg)
        for i in range(len(poses)):
            pipe.process_frame(jnp.asarray(depths[i]), jnp.asarray(rgbs[i]),
                               timestamp=float(i))
        pipe.finish()
        return pipe

    ref = run(base)
    shd = run(base.replace(parallel=ParallelConfig(tsdf_sharded=True,
                                                   n_devices=8)))
    assert shd.volume.sharding is not None
    assert (shd.volume.cfg.capacity + 1) % 8 == 0
    # identical map structure + near-identical voxel state
    assert shd.volume.n_active() == ref.volume.n_active()
    w_ref = float(jnp.sum(ref.volume.batch.weight))
    w_shd = float(jnp.sum(shd.volume.batch.weight))
    np.testing.assert_allclose(w_shd, w_ref, rtol=1e-5)
    np.testing.assert_allclose(shd.trajectory(), ref.trajectory(),
                               atol=1e-6)
    v_ref, f_ref, _, _ = ref.mesher.full_mesh()
    v_shd, f_shd, _, _ = shd.mesher.full_mesh()
    assert len(v_shd) == len(v_ref)
    assert len(f_shd) == len(f_ref)


def _make_chain_graph(n_kf=32, n_pts=80, noise=0.03, seed=3, n_loops=3):
    """Long keyframe chain + a few loop edges — big enough that the
    8-device partition has real interior keyframes to eliminate."""
    rng = np.random.default_rng(seed)
    gt = []
    for k in range(n_kf):
        xi = np.asarray([0.25 * k, 0.01 * k, 0.002 * k * k,
                         0.0, 0.03 * k, 0.001 * k], np.float32)
        gt.append(np.asarray(se3.se3_exp(jnp.asarray(xi))))
    gt = np.stack(gt)
    pts_w = rng.uniform(-3, 3, (n_pts, 3)).astype(np.float32)
    pts_w[:, 2] += 5.0
    pairs = [(k, k + 1) for k in range(n_kf - 1)]
    pairs += [(rng.integers(0, n_kf // 2), n_kf - 1 - i)
              for i in range(n_loops)]
    cap = 64
    edges = fastba.make_edges(cap)
    cols = {k: np.asarray(getattr(edges, k)).copy() for k in edges._fields}
    for e, (i, j) in enumerate(pairs):
        ti, tj = np.linalg.inv(gt[i]), np.linalg.inv(gt[j])
        p = pts_w @ ti[:3, :3].T + ti[:3, 3]
        q = pts_w @ tj[:3, :3].T + tj[:3, 3]
        s = fastba.preintegrate_edge(jnp.asarray(p), jnp.asarray(q),
                                     jnp.ones(n_pts))
        cols["kf_i"][e], cols["kf_j"][e] = i, j
        for name, val in zip(("s_w", "s_p", "s_q", "s_pp", "s_qq", "s_pq"), s):
            cols[name][e] = np.asarray(val)
        cols["valid"][e] = True
    edges = fastba.EdgeSums(**{k: jnp.asarray(v) for k, v in cols.items()})
    poses = gt.copy()
    for k in range(1, n_kf):
        xi = rng.normal(0, noise, 6).astype(np.float32)
        poses[k] = np.asarray(se3.se3_exp(jnp.asarray(xi))) @ poses[k]
    active = jnp.asarray(np.ones(n_kf, bool))
    return jnp.asarray(poses), edges, active, gt, n_kf


def test_schur_gn_matches_dense():
    """Keyframe-partitioned Schur reduction reproduces the dense GN
    solution (interior keyframes exist: 32 kfs over 8 devices)."""
    poses, edges, active, gt, n_kf = _make_chain_graph()
    cfg = BAConfig(gn_rounds=1, gn_iterations_per_round=4)
    ref_poses, e0_ref, e1_ref = fastba.gauss_newton_rounds(
        poses, edges, n_kf, active, cfg)
    m = pmesh.make_mesh()
    edges_s = pba.shard_edges(pba.pad_edges_for_mesh(edges, m.size), m)
    out, e0, e1 = pba.schur_gn(poses, edges_s, n_kf, active, cfg, m,
                               sep_budget=24)
    np.testing.assert_allclose(float(e0), float(e0_ref), rtol=1e-4)
    # both solves drive the residual to ~numerical zero; compare on the
    # scale of the initial error rather than the converged noise floor
    # 3e-5·e0: both residuals sit at the converged float32 noise floor,
    # whose exact value shifts with contraction order (the Schur path now
    # runs jitted; XLA reorders the reductions)
    assert abs(float(e1) - float(e1_ref)) < 3e-5 * float(e0)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref_poses),
                               rtol=2e-3, atol=2e-4)


def test_schur_gn_separator_overflow_falls_back_dense():
    """With sep_budget smaller than the separator set the iteration must
    take the dense fallback and still match the reference solve."""
    poses, edges, active, gt, n_kf = _make_chain_graph(n_loops=6)
    cfg = BAConfig(gn_rounds=1, gn_iterations_per_round=3)
    ref_poses, _, _ = fastba.gauss_newton_rounds(poses, edges, n_kf,
                                                 active, cfg)
    m = pmesh.make_mesh()
    edges_s = pba.shard_edges(pba.pad_edges_for_mesh(edges, m.size), m)
    out, _, _ = pba.schur_gn(poses, edges_s, n_kf, active, cfg, m,
                             sep_budget=2)   # forces overflow
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref_poses),
                               rtol=1e-3, atol=1e-5)


def test_schur_gn_converges_to_gt():
    poses, edges, active, gt, n_kf = _make_chain_graph(noise=0.02, seed=11)
    cfg = BAConfig(gn_rounds=1, gn_iterations_per_round=6)
    m = pmesh.make_mesh()
    edges_s = pba.shard_edges(pba.pad_edges_for_mesh(edges, m.size), m)
    out, e0, e1 = pba.schur_gn(poses, edges_s, n_kf, active, cfg, m)
    assert float(e1) < float(e0) * 1e-3
    out = np.asarray(out)
    for k in range(n_kf):
        d = np.asarray(se3.pose_distance(jnp.asarray(out[k]),
                                         jnp.asarray(gt[k])))
        assert d < 1e-5, (k, d)
