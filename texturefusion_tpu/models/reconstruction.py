"""Flagship jittable reconstruction steps (single-chip and multi-chip).

These compose the framework's kernels into the two canonical entry
points — the equivalents of the reference's per-frame hot path
(ref: main.cpp:102-211 + MobileFusion.cpp:274-406 rolled into pure
array programs):

  * frame_step        — preprocess + normals + quality + TSDF integrate,
                        one frame into a chunk batch (single chip)
  * multichip_step    — the full "training step" analog: chunk-sharded
                        TSDF integration + edge-sharded distributed BA
                        Gauss-Newton, under one device mesh
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from texturefusion_tpu.config import BAConfig, PipelineConfig, TSDFConfig
from texturefusion_tpu.core import camera as cam
from texturefusion_tpu.ops import preprocess, tsdf as tsdf_ops
from texturefusion_tpu.slam import fastba
from texturefusion_tpu.slam.fastba import EdgeSums


@functools.partial(jax.jit, static_argnames=("intr", "cfg"),
                   donate_argnums=(2,))
def frame_step(
    depth_raw: jnp.ndarray,      # [H, W] raw depth (0 invalid)
    rgb: jnp.ndarray,            # [H, W, 3] float 0..1
    batch: tsdf_ops.ChunkBatch,  # chunk rows being updated (donated)
    origins: jnp.ndarray,        # [U, 3]
    active: jnp.ndarray,         # [U]
    cam_to_world: jnp.ndarray,   # [4, 4]
    intr: cam.Intrinsics,
    cfg: TSDFConfig,
) -> Tuple[tsdf_ops.ChunkBatch, jnp.ndarray, jnp.ndarray]:
    """One fused frame step: the per-frame device work of the pipeline
    as a single XLA program. Returns (batch, chunk quality, normals)."""
    depth = preprocess.frame_preprocess(depth_raw, intr)
    normals = preprocess.extract_normal_map(depth, intr)
    depth = preprocess.refine_depth_with_normals(depth, normals, intr)
    quality = preprocess.observation_quality_map(rgb, depth, normals, intr)
    new_batch, chunk_q, _ = tsdf_ops.integrate_chunks(
        batch, origins, active, depth, rgb, quality, cam_to_world,
        jnp.float32(1.0), intr, cfg, with_color=True)
    return new_batch, chunk_q, normals


@functools.partial(jax.jit,
                   static_argnames=("intr", "tcfg", "depth_scale"))
def track_frame_fused(packed_or_depth, rgb, kp_ref, key,
                      intr: cam.Intrinsics, tcfg, depth_scale: float):
    """The ENTIRE per-frame tracking path as one compiled program:
    preprocessing bundle + feature extraction + registration against the
    last keyframe. One dispatch + one stats fetch per frame — the
    steady-state hot loop (ref: main.cpp:106-135 per-frame work).

    Returns (bundle tuple, Keypoints, TwoViewResult)."""
    from texturefusion_tpu.slam.features import extract_features
    from texturefusion_tpu.slam.matching import register_frames

    bundle = preprocess.preprocess_bundle(packed_or_depth, rgb, intr,
                                          depth_scale=depth_scale)
    depth_refined, normals, quality, gray, blur, rgb_f = bundle
    kp = extract_features(gray, depth_refined, tcfg, intr)
    res = register_frames(kp_ref, kp, key, tcfg, intr)
    return bundle, kp, res


@functools.partial(jax.jit,
                   static_argnames=("intr", "tcfg", "depth_scale"))
def frame_step_tracked(packed_or_depth, rgb, kp_ref, kf_depth, kf_weight,
                       base_key, frame_idx,
                       intr: cam.Intrinsics, tcfg, depth_scale: float):
    """The COMPLETE steady-state per-frame device program in one
    dispatch: preprocessing bundle + feature extraction + registration
    against the last keyframe + running-weight keyframe depth refinement
    (ref: the whole per-frame loop main.cpp:106-135 including
    refineKeyframesSIMD BasicAPI.cpp:506-635).

    Every dispatch and every readback costs host latency, so the frame
    path is exactly ONE dispatch + ONE 1D stats fetch. The
    PRNG key derives from (base_key, frame_idx) on device — no per-frame
    host-side key splitting.

    The refined keyframe depth/weight outputs are gated on registration
    success inside the program; the host adopts them only when the frame
    stays a local frame of the current keyframe.

    Returns (bundle, kp, res, fused_kf_depth, fused_kf_weight)."""
    from texturefusion_tpu.slam.features import extract_features
    from texturefusion_tpu.slam.matching import register_frames

    key = jax.random.fold_in(base_key, frame_idx)
    bundle = preprocess.preprocess_bundle(packed_or_depth, rgb, intr,
                                          depth_scale=depth_scale)
    depth_refined = bundle[0]
    kp = extract_features(bundle[3], depth_refined, tcfg, intr)
    res = register_frames(kp_ref, kp, key, tcfg, intr)
    fused, w = preprocess.fuse_depth_into_keyframe(
        kf_depth, kf_weight, depth_refined, res.pose, intr)
    ok = res.success
    fused = jnp.where(ok, fused, kf_depth)
    w = jnp.where(ok, w, kf_weight)
    return bundle, kp, res, fused, w


@functools.partial(jax.jit,
                   static_argnames=("intr", "tcfg", "depth_scale"))
def frame_step_tracked2(packed_or_depth, rgb, kp_ref, kp_prev,
                        kf_depth, kf_weight, base_key, frame_idx,
                        intr: cam.Intrinsics, tcfg, depth_scale: float):
    """frame_step_tracked with TWO references in one dispatch: the last
    keyframe AND the previous frame. When keyframe registration fails
    (wide baseline near promotion), the frame-to-frame result is already
    on device — no retry/fallback dispatch (each costs a ~24 ms
    roundtrip). (ref: the per-frame loop main.cpp:106-135; the reference
    has no f2f fallback — ours chains through it to survive wide
    baselines.)

    Returns (bundle, kp, res_kf, res_ff, fetchvec, fused_depth, fused_w)
    where fetchvec = [43] flat: stats vs keyframe (21) ‖ stats vs prev
    frame (21) ‖ blur score (1) — ONE fetch carries every per-frame
    decision scalar including the blur gate (a separate lazy blur fetch
    added a blocking readback at every keyframe promotion).
    """
    from texturefusion_tpu.slam.features import extract_features
    from texturefusion_tpu.slam.matching import register_frames

    import dataclasses

    key = jax.random.fold_in(base_key, frame_idx)
    k1, k2 = jax.random.split(key)
    bundle = preprocess.preprocess_bundle(packed_or_depth, rgb, intr,
                                          depth_scale=depth_scale)
    depth_refined = bundle[0]
    kp = extract_features(bundle[3], depth_refined, tcfg, intr)
    res_kf = register_frames(kp_ref, kp, k1, tcfg, intr)
    # the f2f fallback sees a tiny baseline (consecutive frames): a light
    # config (¼ hypotheses, no fine search) is ample and halves its cost
    tcfg_lite = dataclasses.replace(tcfg,
                                    ransac_iterations=max(
                                        tcfg.ransac_iterations // 4, 64),
                                    use_fine_search=False)
    res_ff = register_frames(kp_prev, kp, k2, tcfg_lite, intr)
    stats2 = jnp.concatenate([res_kf.stats, res_ff.stats,
                              bundle[4].reshape(1)])
    fused, w = preprocess.fuse_depth_into_keyframe(
        kf_depth, kf_weight, depth_refined, res_kf.pose, intr)
    ok = res_kf.success
    fused = jnp.where(ok, fused, kf_depth)
    w = jnp.where(ok, w, kf_weight)
    return bundle, kp, res_kf, res_ff, stats2, fused, w


class MultichipState(NamedTuple):
    batch: tsdf_ops.ChunkBatch   # chunk-sharded TSDF rows
    origins: jnp.ndarray         # [S, 3] chunk-sharded
    active: jnp.ndarray          # [S] chunk-sharded
    poses: jnp.ndarray           # [K, 4, 4] replicated keyframe poses
    edges: EdgeSums              # edge-sharded pre-integrated pose graph


class MultichipFullState(NamedTuple):
    """State for the FULL multi-chip cycle: TSDF + texture datacost."""

    batch: tsdf_ops.ChunkBatch   # chunk-sharded TSDF rows
    origins: jnp.ndarray         # [S, 3] chunk-sharded
    active: jnp.ndarray          # [S] chunk-sharded
    datacost: jnp.ndarray        # [S, K] chunk-sharded observation quality
    poses: jnp.ndarray           # [K, 4, 4] replicated keyframe poses
    edges: EdgeSums              # edge-sharded pre-integrated pose graph


def make_multichip_full_step(mesh: Mesh, intr: cam.Intrinsics,
                             tsdf_cfg: TSDFConfig, ba_cfg: BAConfig,
                             n_kf: int, mesh_u: int,
                             vert_cap: int = 4096, tri_cap: int = 8192,
                             axis: str = "shard"):
    """The COMPLETE map-cycle as one compiled multi-chip program:

      chunk discovery → chunk-sharded TSDF integrate → marching-cubes
      meshing over a chunk batch (cross-device neighbor gathers become
      XLA collectives) → texture datacost update → MRF view-selection
      ICM sweeps → edge-sharded distributed-BA Gauss-Newton round.

    This is the dryrun/scale-out target: every stage of the reference
    map thread
    (ref: MobileFusion.cpp:274-406 tsdfFusion) compiles and executes
    under a device mesh."""
    from texturefusion_tpu.ops import marching_cubes as mc_ops
    from texturefusion_tpu.texture import mrf as mrf_ops

    sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    batch_sh = tsdf_ops.ChunkBatch(sdf=sh, weight=sh, color=sh, color_count=sh)
    edges_sh = jax.tree.map(lambda _: sh, EdgeSums(
        kf_i=0, kf_j=0, s_w=0, s_p=0, s_q=0, s_pp=0, s_qq=0, s_pq=0, valid=0))
    state_sh = MultichipFullState(batch=batch_sh, origins=sh, active=sh,
                                  datacost=sh, poses=rep, edges=edges_sh)
    mrf_rep = jax.tree.map(lambda _: rep, mrf_ops.MRFProblem(
        unary=0, label_kf=0, neighbors=0, parity=0, init_label=0, n_valid=0))

    def ba_round(poses, edges, active_kf):
        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(), jax.tree.map(lambda _: P(axis), edges), P()),
            out_specs=P(),
        )
        def run(poses, edge_shard, active_kf):
            def gn_iter(_, p):
                blocks = fastba._edge_blocks(p, edge_shard)
                h, b = fastba.assemble_dense(
                    *blocks, edge_shard.kf_i, edge_shard.kf_j, n_kf)
                h = jax.lax.psum(h, axis)
                b = jax.lax.psum(b, axis)
                diag = jnp.arange(n_kf * 6)
                first_active = jnp.argmax(active_kf)
                pin = (jnp.arange(n_kf) == first_active) | (~active_kf)
                h = h.at[diag, diag].add(
                    jnp.where(jnp.repeat(pin, 6), 1e12, 0.0)
                    + ba_cfg.levenberg_lambda)
                dx = -jnp.linalg.solve(h, b)
                dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx,
                               jnp.zeros_like(dx))
                from texturefusion_tpu.core import se3
                xi = jnp.where(active_kf[:, None], dx.reshape(n_kf, 6), 0.0)
                upd = se3.compose(se3.se3_exp(xi), p)
                return jnp.where(active_kf[:, None, None], upd, p)

            return jax.lax.fori_loop(0, ba_cfg.gn_iterations_per_round,
                                     gn_iter, poses)

        return run(poses, edges, active_kf)

    @functools.partial(
        jax.jit,
        in_shardings=(state_sh, rep, rep, rep, rep, rep, rep, rep, mrf_rep),
        out_shardings=(state_sh, rep, rep, rep),
        donate_argnums=(0,),
        static_argnums=(),
    )
    def step(state: MultichipFullState, depth, rgb, quality, cam_to_world,
             kf_index, active_kf, mesh_slots, mrf_problem):
        # 1. chunk discovery (replicated compute; allocation is host-side)
        ids, n_found = tsdf_ops.candidate_chunks_unique(
            depth, cam_to_world, intr, tsdf_cfg,
            stride=max(1, intr.width // 320), max_out=1024)
        # 2. chunk-sharded integration (each device updates its rows)
        new_batch, chunk_q, _ = tsdf_ops.integrate_chunks(
            state.batch, state.origins, state.active, depth, rgb, quality,
            cam_to_world, jnp.float32(1.0), intr, tsdf_cfg, with_color=True)
        # 3. texture datacost update (ref: TexMap.cpp:63-105)
        dc = jax.lax.dynamic_update_slice(
            state.datacost, chunk_q[:, None], (0, kf_index))
        # 4. meshing a chunk batch — neighbor row gathers may cross
        #    devices; XLA inserts the collectives
        nbr = jnp.broadcast_to(mesh_slots[:, None], (mesh_u, 8))
        flat = mc_ops.mesh_chunks_compact(
            new_batch.sdf, new_batch.weight, new_batch.color,
            new_batch.color_count, nbr,
            state.origins[mesh_slots],
            jnp.ones(mesh_u, bool), tsdf_cfg.chunk_size,
            tsdf_cfg.voxel_resolution, vert_cap, tri_cap)
        # 5. MRF view-selection sweeps (ref: TexMap view_selection)
        labels = mrf_ops.solve_icm(mrf_problem, 1.0, 0.5, sweeps=2)
        # 6. distributed BA round
        new_poses = ba_round(state.poses, state.edges, active_kf)
        new_state = state._replace(batch=new_batch, datacost=dc,
                                   poses=new_poses)
        return new_state, n_found, flat.vcount, labels

    return step


def make_multichip_step(mesh: Mesh, intr: cam.Intrinsics,
                        tsdf_cfg: TSDFConfig, ba_cfg: BAConfig,
                        n_kf: int, axis: str = "shard"):
    """Build the jitted multi-chip step: sharded TSDF integrate + one
    distributed-BA GN round in a single compiled program."""
    sh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    batch_sh = tsdf_ops.ChunkBatch(sdf=sh, weight=sh, color=sh, color_count=sh)
    edges_sh = jax.tree.map(lambda _: sh, EdgeSums(
        kf_i=0, kf_j=0, s_w=0, s_p=0, s_q=0, s_pp=0, s_qq=0, s_pq=0, valid=0))
    state_sh = MultichipState(batch=batch_sh, origins=sh, active=sh,
                              poses=rep, edges=edges_sh)

    def ba_round(poses, edges, active_kf):
        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(), jax.tree.map(lambda _: P(axis), edges), P()),
            out_specs=P(),
        )
        def run(poses, edge_shard, active_kf):
            def gn_iter(_, p):
                blocks = fastba._edge_blocks(p, edge_shard)
                h, b = fastba.assemble_dense(
                    *blocks, edge_shard.kf_i, edge_shard.kf_j, n_kf)
                h = jax.lax.psum(h, axis)
                b = jax.lax.psum(b, axis)
                diag = jnp.arange(n_kf * 6)
                first_active = jnp.argmax(active_kf)
                pin = (jnp.arange(n_kf) == first_active) | (~active_kf)
                h = h.at[diag, diag].add(
                    jnp.where(jnp.repeat(pin, 6), 1e12, 0.0)
                    + ba_cfg.levenberg_lambda)
                dx = -jnp.linalg.solve(h, b)
                dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx,
                               jnp.zeros_like(dx))
                from texturefusion_tpu.core import se3
                xi = jnp.where(active_kf[:, None], dx.reshape(n_kf, 6), 0.0)
                upd = se3.compose(se3.se3_exp(xi), p)
                return jnp.where(active_kf[:, None, None], upd, p)

            return jax.lax.fori_loop(0, ba_cfg.gn_iterations_per_round,
                                     gn_iter, poses)

        return run(poses, edges, active_kf)

    @functools.partial(jax.jit,
                       in_shardings=(state_sh, rep, rep, rep, rep, rep),
                       out_shardings=state_sh,
                       donate_argnums=(0,))
    def step(state: MultichipState, depth, rgb, quality, cam_to_world,
             active_kf) -> MultichipState:
        new_batch, _, _ = tsdf_ops.integrate_chunks(
            state.batch, state.origins, state.active, depth, rgb, quality,
            cam_to_world, jnp.float32(1.0), intr, tsdf_cfg, with_color=True)
        new_poses = ba_round(state.poses, state.edges, active_kf)
        return state._replace(batch=new_batch, poses=new_poses)

    return step
