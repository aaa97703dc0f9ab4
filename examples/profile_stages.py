"""Fine-grained device timing of every hot-path stage (run on the GPU).

Times each jitted sub-stage of the steady-state frame path separately
(block_until_ready), so optimization effort follows measured cost.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()


def timeit(name, fn, n=10):
    jax.block_until_ready(fn())  # warmup/compile
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    print(f"{name:>40s}: {dt * 1000:8.1f} ms")
    return out


def main():
    from texturefusion_tpu.config import (CameraConfig, PipelineConfig,
                                          TrackingConfig, TSDFConfig)
    from texturefusion_tpu.core import camera as cam
    from texturefusion_tpu.fusion.chunkmap import TSDFVolume
    from texturefusion_tpu.io import synthetic
    from texturefusion_tpu.models.reconstruction import frame_step_tracked
    from texturefusion_tpu.ops import preprocess, tsdf as T
    from texturefusion_tpu.ops import marching_cubes as mc
    from texturefusion_tpu.slam.features import extract_features
    from texturefusion_tpu.slam.matching import register_frames

    config = PipelineConfig(
        camera=CameraConfig(far_plane=6.0),
        tracking=TrackingConfig(blur_threshold=0.0),
        tsdf=TSDFConfig(voxel_resolution=0.02, capacity=16384,
                        max_update_chunks=1024))
    intr = cam.Intrinsics.from_config(config.camera)
    tcfg = config.tracking
    scene = synthetic.BoxRoomScene()
    poses = synthetic.orbit_trajectory(2)
    depths, rgbs = synthetic.render_sequence(scene, intr, poses)
    from texturefusion_tpu.ops.preprocess import pack_frame
    packed = [pack_frame((d * config.camera.depth_scale).astype(np.uint16),
                         (c * 255).astype(np.uint8)) for d, c in zip(depths, rgbs)]
    p0 = jnp.asarray(packed[0])
    p1 = jnp.asarray(packed[1])
    key = jax.random.PRNGKey(0)

    # --- preprocess bundle alone
    pb = jax.jit(lambda p: preprocess.preprocess_bundle(
        p, None, intr, depth_scale=config.camera.depth_scale),
        static_argnames=())
    bundle0 = timeit("preprocess_bundle", lambda: pb(p0))
    depth0, normals0, quality0, gray0, blur0, rgb0 = bundle0
    bundle1 = pb(p1)
    depth1, gray1 = bundle1[0], bundle1[3]

    # --- features alone
    ef = jax.jit(lambda g, d: extract_features(g, d, tcfg, intr))
    kp0 = timeit("extract_features", lambda: ef(gray0, depth0))
    kp1 = ef(gray1, depth1)

    # --- registration alone
    rf = jax.jit(lambda a, b, k: register_frames(a, b, k, tcfg, intr))
    res = timeit("register_frames", lambda: rf(kp0, kp1, key))

    # --- keyframe depth fusion alone
    w0 = (depth0 > 0).astype(jnp.float32)
    fd = jax.jit(lambda kd, kw, d, p: preprocess.fuse_depth_into_keyframe(
        kd, kw, d, p, intr))
    timeit("fuse_depth_into_keyframe",
           lambda: fd(depth0, w0, depth1, res.pose))

    # --- the whole fused step
    timeit("frame_step_tracked (full)",
           lambda: frame_step_tracked(
               p1, None, kp0, depth0, w0, key, jnp.int32(1), intr, tcfg,
               config.camera.depth_scale))

    # --- integration
    vol = TSDFVolume(config)
    pose = jnp.asarray(poses[0])
    slots = vol.discover_chunks(depths[0], pose)
    print(f"{'n chunks discovered':>40s}: {len(slots)}")
    idx, active = vol._padded(slots)

    d0 = jnp.asarray(np.ascontiguousarray(depths[0], np.float32))
    r0 = jnp.asarray(np.ascontiguousarray(rgbs[0], np.float32))

    def integ():
        out, q, upd = T.integrate_frame_fused(
            vol.batch, vol.origins, idx, active, d0, r0, quality0, pose,
            jnp.float32(1.0), intr, config.tsdf)
        vol.batch = out   # batch is donated — must adopt the new buffers
        return q
    timeit("integrate_frame_fused", integ)

    # actually integrate so there is surface to mesh
    vol.integrate_frame(d0, r0, quality0, pose, keyframe_id=0, sign=1.0)

    # --- meshing at the real dirty-set size
    from texturefusion_tpu.fusion.mesher import IncrementalMesher
    mesher = IncrementalMesher(vol)
    dirty = sorted(vol.dirty_mesh)
    print(f"{'n dirty chunks':>40s}: {len(dirty)}")

    # --- host compaction cost (first call compiles; second is steady state)
    t0 = time.perf_counter()
    mesher.update_meshes()
    print(f"{'mesher.update_meshes (compile)':>40s}: "
          f"{(time.perf_counter() - t0) * 1000:8.1f} ms")
    vol.dirty_mesh = set(dirty)
    t0 = time.perf_counter()
    mesher.update_meshes()
    print(f"{'mesher.update_meshes (steady)':>40s}: "
          f"{(time.perf_counter() - t0) * 1000:8.1f} ms")
    nverts = sum(len(m[0]) for m in mesher.meshes.values())
    ntris = sum(len(m[1]) for m in mesher.meshes.values())
    print(f"{'total verts / tris':>40s}: {nverts} / {ntris}")

    # --- breakdown of the pooled meshing path at bucket 512
    n_part = min(len(dirty), 512)
    part = np.asarray(dirty[:n_part] + [vol.cfg.capacity] * (512 - n_part),
                      np.int64)
    nbr = mesher._neighbor_slots(part)
    og = jnp.asarray(vol.ids[np.minimum(part, vol.cfg.capacity - 1)]
                     .astype(np.float32) * vol.extent)
    sl = jnp.asarray(part)
    nb = jnp.asarray(nbr)
    act = jnp.asarray(np.arange(512) < n_part)

    def pooled_mc():
        pool, vcnt, tcnt = mc.mesh_chunks_pooled(
            mesher.pool, vol.batch.sdf, vol.batch.weight, vol.batch.color,
            vol.batch.color_count, sl, nb, og, act, vol.cfg.chunk_size,
            vol.cfg.voxel_resolution)
        mesher.pool = pool   # pool is donated — must adopt the new buffers
        return vcnt, tcnt
    counts = timeit("  mesh_chunks_pooled[512] device", pooled_mc, n=5)
    timeit("  counts fetch", lambda: jax.device_get(counts), n=5)
    timeit("  pool row fetch",
           lambda: mesher._fetch_rows(np.asarray(dirty[:n_part])), n=5)


if __name__ == "__main__":
    main()
