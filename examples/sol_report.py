"""Speed-of-light report: per-kernel device time vs the HBM roofline.

Measures the hot device programs of the pipeline in isolation (median of
repeated block_until_ready runs) and compares each against its
bytes-moved / peak-memory-bandwidth lower bound — the reporting the
reference gets from stat.txt (ref: main.cpp:223-235), extended with the
achieved-fraction-of-roofline column BASELINE.md asks for. Prints the
report as one JSON line at the end. Needs a GPU listed in PEAKS.

Run: python examples/sol_report.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()

# published dense peaks per device_kind at the full power limit
# (NVIDIA H100 SXM data sheet): memory GB/s, float32 TFLOP/s outside the
# tensor cores
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbs": 3350.0, "f32_tflops": 67.0},
}


def device_peaks() -> dict:
    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise RuntimeError(f"no published peaks for device {kind!r}; "
                           f"add it to PEAKS with its source")
    return PEAKS[kind]


def timeit(fn, *args, n=20, **kw):
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def main():
    from texturefusion_tpu.config import (CameraConfig, PipelineConfig,
                                          TrackingConfig, TSDFConfig)
    from texturefusion_tpu.core import camera as cam
    from texturefusion_tpu.ops import tsdf as tsdf_ops

    config = PipelineConfig(
        camera=CameraConfig(far_plane=6.0),
        tracking=TrackingConfig(blur_threshold=0.0),
        tsdf=TSDFConfig(voxel_resolution=0.02, capacity=16384,
                        max_update_chunks=1024),
    )
    intr = cam.Intrinsics.from_config(config.camera)
    cfg = config.tsdf
    H, W = intr.height, intr.width
    U = cfg.max_update_chunks
    V = cfg.chunk_size ** 3
    S = cfg.capacity

    rng = np.random.default_rng(0)
    depth_np = np.clip(rng.normal(2.0, 0.3, (H, W)), 0.3, 5.0
                       ).astype(np.float32)
    rgb_np = rng.random((H, W, 3), np.float32)
    depth = jnp.asarray(depth_np)
    rgb = jnp.asarray(rgb_np)
    quality = jnp.asarray(rng.random((H, W), np.float32))
    pose = jnp.eye(4)

    batch = tsdf_ops.make_empty_batch(S + 1, V)
    origins = jnp.asarray(
        rng.integers(-20, 20, (S + 1, 3)).astype(np.float32) * 0.16)
    n_real = 400   # realistic per-frame intersect count at 2 cm voxels
    idx_np = np.concatenate([rng.choice(S, n_real, replace=False),
                             np.full(U - n_real, S)]).astype(np.int64)
    idx = jnp.asarray(idx_np)
    active = jnp.asarray(np.arange(U) < n_real)

    rows = []
    peak_hbm_gbs = device_peaks()["hbm_gbs"]

    def report(name, t, bytes_moved=0, flops=0, calls_per_cycle=1.0):
        sol = bytes_moved / (peak_hbm_gbs * 1e9) if bytes_moved else 0.0
        rows.append({
            "kernel": name, "ms": round(t * 1e3, 3),
            "bytes_mb": round(bytes_moved / 2**20, 2),
            "sol_ms": round(sol * 1e3, 3),
            "frac_of_roofline": round(sol / t, 4) if t > 0 else 0.0,
            "calls_per_cycle": calls_per_cycle,
        })
        print(f"{name:32s} {t*1e3:9.3f} ms   SoL {sol*1e3:8.3f} ms   "
              f"({100*sol/max(t,1e-12):5.1f}% of roofline)")

    # ---- voxel update (integrate_frame_fused)
    def run_int(b):
        return tsdf_ops.integrate_frame_fused(
            b, origins, idx, active, depth, rgb, quality, pose,
            jnp.float32(1.0), intr, cfg, with_color=True)

    # rows touched: read+write 6 f32 lanes (sdf, weight, color3, ccnt)
    row_bytes = n_real * V * 6 * 4 * 2
    img_bytes = H * W * 5 * 4          # packed image read once (cached)
    gather_bytes = n_real * V * 5 * 4  # image gather traffic
    t, out = timeit(lambda: run_int(batch), n=10)
    batch = out[0]
    report("integrate_frame_fused", t, row_bytes + img_bytes + gather_bytes)

    # ---- fused de+re-integration (one program, two poses)
    if hasattr(tsdf_ops, "reintegrate_frame_fused"):
        pose2 = jnp.asarray(np.eye(4, dtype=np.float32))

        def run_reint(b):
            return tsdf_ops.reintegrate_frame_fused(
                b, origins, idx, active, depth, rgb, quality, pose, pose2,
                intr, cfg)

        t, out = timeit(lambda: run_reint(batch), n=10)
        batch = out[0]
        report("reintegrate_frame_fused", t,
               row_bytes + 2 * (img_bytes + gather_bytes))

    # ---- local depths (batched, 6 frames)
    F = cfg.local_frames_per_keyframe
    depths = jnp.stack([depth] * F)
    poses = jnp.stack([jnp.eye(4)] * F)

    def run_loc(b):
        return tsdf_ops.integrate_depths_batched(
            b, origins, idx, active, depths, poses, jnp.float32(1.0),
            intr, cfg)

    t, batch = timeit(lambda: run_loc(batch), n=10)
    report("integrate_depths_batched(6)", t,
           n_real * V * 2 * 4 * 2 + F * (H * W * 4 + n_real * V * 4))

    # ---- discovery
    def run_disco():
        return tsdf_ops.candidate_chunks_unique(
            depth, pose, intr, cfg, stride=2, max_out=U * 4)

    t, _ = timeit(run_disco, n=10)
    n_cand = (H // 2) * (W // 2) * 5
    report("candidate_chunks_unique", t, n_cand * 4 * 2 * 4)  # ~sort passes

    # ---- meshing
    from texturefusion_tpu.ops import marching_cubes as mc
    pool = mc.make_mesh_pool(S, 256, 384)
    nbr = jnp.asarray(np.tile(idx_np[:512, None], (1, 8)))
    org512 = origins[idx[:512]]
    act512 = jnp.asarray(np.arange(512) < n_real)

    def run_mesh(p):
        return mc.mesh_chunks_pooled(
            p, batch.sdf, batch.weight, batch.color, batch.color_count,
            idx[:512], nbr, org512, act512, cfg.chunk_size,
            cfg.voxel_resolution)

    t, out = timeit(lambda: run_mesh(pool), n=10)
    pool = out[0]
    report("mesh_chunks_pooled(512)", t,
           n_real * (9 ** 3) * 8 * 4 + n_real * (256 * 3 + 384 * 3) * 4)

    # ---- tracking frame step
    from texturefusion_tpu.models.reconstruction import frame_step_tracked2
    from texturefusion_tpu.ops.preprocess import pack_frame
    from texturefusion_tpu.slam.features import extract_features
    packed = jnp.asarray(pack_frame(
        (depth_np * 5000).astype(np.uint16),
        (rgb_np * 255).astype(np.uint8)))
    kp = extract_features(jnp.mean(rgb, -1), depth, config.tracking, intr)
    kf_w = (depth > 0).astype(jnp.float32)
    key = jax.random.PRNGKey(0)

    def run_track():
        return frame_step_tracked2(packed, None, kp, kp, depth, kf_w, key,
                                   np.int32(0), intr, config.tracking,
                                   config.camera.depth_scale)

    t, _ = timeit(run_track, n=10)
    report("frame_step_tracked2", t, H * W * 5 * 4 * 6)

    # ---- promotion probe
    from texturefusion_tpu.slam.promote import KeypointDB, promote_probe
    db = KeypointDB(config.ba.max_keyframes, config.tracking.max_features_pad)
    for s in range(8):
        db.add(s, kp)
    desc = jnp.zeros((config.ba.max_keyframes,
                      config.tracking.max_features_pad, 8), jnp.uint32)
    dvalid = jnp.zeros((config.ba.max_keyframes,
                        config.tracking.max_features_pad), bool)
    r2s = jnp.arange(config.ba.max_keyframes, dtype=jnp.int32)

    def run_probe():
        return promote_probe(
            db.kp, desc, dvalid, r2s, jnp.int32(8), jnp.int32(7), kp,
            jnp.zeros(21, jnp.float32), jnp.asarray(False), key,
            config.tracking.salient_score_threshold,
            config.ba.huber_delta, config.tracking, intr, 5)

    t, _ = timeit(run_probe, n=10)
    report("promote_probe(5 cand)", t, 0)

    # ---- one-device scaling rows (BASELINE.md reporting points)
    scaling = {}
    try:
        import bench_multichip as bm
        scaling["1chip_sharded_tsdf_steps_s"] = round(
            bm.bench_sharded_tsdf(1, 4096, n_iters=10), 2)
        scaling["1chip_distributed_ba_gn_iters_s"] = round(
            bm.bench_distributed_ba(1, n_iters=5), 1)
        # BA at the configured capacity limits: dense vs Schur crossover
        # (ref: optimizeKeyFrameMapRobust's sparse LDLT,
        # MultiViewGeometry.cpp:1067-1098)
        scaling["1chip_ba_scale"] = bm.bench_ba_scale(1)
        print("1-chip scaling rows:", scaling)
    except Exception as e:
        scaling["error"] = repr(e)
    dev = jax.devices()[0]
    print(json.dumps({"device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())},
                      "peak_hbm_gbs": peak_hbm_gbs,
                      "kernels": rows,
                      "scaling": scaling}))


if __name__ == "__main__":
    main()
