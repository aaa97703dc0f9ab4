"""Benchmark: end-to-end TEXTURED pipeline throughput per chip.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "extra"}.
Baseline target: ≥30 fps fusion+texture per chip (BASELINE.md — the
reference's real-time operating point on CPU).

Measures steady-state frames/s of the complete TextureFusion behavior
(preprocessing → tracking → keyframe promotion → loop closure + FastBA →
drift-scheduled de/re-integration → TSDF fusion with local frames →
incremental meshing → MRF view selection → patches → atlas → color
compensation) on VGA synthetic RGB-D frames over a 360° loop with:
  * sensor depth noise,
  * Brown-Conrady lens distortion (the keypoint-undistortion path runs
    against genuinely distorted images, ref: BasicAPI.cpp:195-241),
  * a ~2/3-stop exposure step over the far half of the loop (color
    compensation measured, ref: CompensateColor Chisel.cpp:198-286),
  * a burst of motion-blurred frames (blur gate exercised,
    ref: blurriness BasicAPI.cpp:1256-1266).
The revisit produces loop-closure edges and BA pose corrections, so the
drift-scheduled reintegration path (ref: MobileFusion.cpp:289-315) is
exercised, not skipped. Besides ATE, the run reports a MAP-quality
metric: RMS/median distance of exported mesh vertices to the analytic
scene surface — reintegration/texture regressions move a number.
"""

import json
import os
import sys
import time

if os.environ.get("TF_SWITCHINTERVAL"):
    sys.setswitchinterval(float(os.environ["TF_SWITCHINTERVAL"]))

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp
import numpy as np

BLUR_FRAMES = (46, 47, 48)
EXPOSURE_GAIN = 1.55          # ~2/3 stop step
EXPOSURE_RANGE = (60, 95)


def make_frames(config, intr, n_frames):
    """Hardened loop: distortion + noise + exposure step + blur burst."""
    from texturefusion_tpu.io import synthetic
    from texturefusion_tpu.io.image import gaussian_blur
    from texturefusion_tpu.ops.preprocess import pack_frame

    # a full 360° loop in a mid-size room, camera looking outward at the
    # walls: mid-loop keyframes share no view with the start, odometry
    # drift accumulates, and the detected closure at the end forces BA
    # corrections → drift-scheduled reintegration fires
    # (ref scheduling: MobileFusion.cpp:289-315, MapMaintain.hpp:175-258)
    poses = synthetic.loop_trajectory(n_frames, radius=1.5)
    scene = synthetic.BoxRoomScene(room_min=(-2.6, -1.5, -2.6),
                                   room_max=(2.6, 1.5, 2.6))
    depths, rgbs = synthetic.render_sequence(scene, intr, poses)
    rng = np.random.default_rng(3)
    packed = []
    for i, (d, c) in enumerate(zip(depths, rgbs)):
        noise = rng.normal(0.0, 0.016, d.shape).astype(np.float32) \
            * np.maximum(d, 0.5)
        dn = np.where(d > 0, d + noise, 0.0)
        if EXPOSURE_RANGE[0] <= i < EXPOSURE_RANGE[1]:
            c = np.clip(c * EXPOSURE_GAIN, 0.0, 1.0)
        if i in BLUR_FRAMES:
            c = gaussian_blur(c, 3.0)
        packed.append(pack_frame(
            (dn * config.camera.depth_scale).astype(np.uint16),
            (c * 255).astype(np.uint8)))
    return packed, np.stack(poses), scene


def run(pipe_cls, config, packed, n_warm, timed_range):
    from texturefusion_tpu.io.prefetch import prefetch_frames

    pipe = pipe_cls(config)
    for i in range(n_warm):
        pipe.process_frame(jnp.asarray(packed[i]), timestamp=float(i))

    from texturefusion_tpu.utils.stopwatch import STOPWATCH
    STOPWATCH.reset()   # drop warmup/compile time from per-stage averages

    stream = prefetch_frames(((float(i), packed[i]) for i in timed_range),
                             keep_host=True)
    print(f"[bench] timed pass begin ({time.strftime('%H:%M:%S')})",
          file=sys.stderr)
    probe_stop, probe_lat = [], []
    if os.environ.get("TF_FETCH_TRACE"):
        # independent device-stream probe: a tiny jit on a cached input,
        # dispatched every ~50 ms — its dispatch→ready time measures the
        # device-stream backlog seen by NEW work, with no h2d dependency
        import threading

        @jax.jit
        def _tiny(a):
            return a * 1.0001

        seed_arr = jnp.ones(64, jnp.float32)
        jax.block_until_ready(_tiny(seed_arr))

        def _probe():
            while not probe_stop:
                tp = time.perf_counter()
                jax.block_until_ready(_tiny(seed_arr))
                probe_lat.append((time.perf_counter() - tp) * 1e3)
                time.sleep(0.05)
        threading.Thread(target=_probe, daemon=True).start()
    t0 = time.perf_counter()
    for ts, frame, host in stream:
        pipe.process_frame(frame, timestamp=ts, host_packed=host[1])
    pipe.flush_tracking()
    pipe._drain_fusion()
    jax.block_until_ready(pipe.volume.batch.sdf)
    dt = time.perf_counter() - t0
    probe_stop.append(True)
    if probe_lat:
        pl = sorted(probe_lat)
        print(f"[ftrace] stream-probe ms p10={pl[len(pl)//10]:.0f} "
              f"med={pl[len(pl)//2]:.0f} p90={pl[9*len(pl)//10]:.0f} "
              f"n={len(pl)}", file=sys.stderr)
    return pipe, len(timed_range) / dt


def map_error_mm(pipe, scene, est, gt) -> dict:
    """Distance of exported mesh vertices to the analytic scene surface
    (the map-quality number ATE cannot see — reintegration, fusion and
    meshing regressions move it). The map lives in the SLAM frame
    (first keyframe = identity); align it into the ground-truth world
    frame with the trajectory's Umeyama transform before evaluating."""
    from texturefusion_tpu.io import tum
    verts, _, _, _ = pipe.mesher.full_mesh()
    if len(verts) == 0:
        return {"map_rms_mm": float("nan"), "map_median_mm": float("nan")}
    rot, t = tum.align_umeyama(est, gt[: len(est)])
    verts = verts @ rot.T + t
    d = np.abs(np.asarray(scene.sdf(jnp.asarray(verts))))
    return {"map_rms_mm": round(float(np.sqrt(np.mean(d ** 2))) * 1e3, 2),
            "map_median_mm": round(float(np.median(d)) * 1e3, 2)}


def bench_config():
    """The benchmark's pipeline configuration (VGA, 2 cm voxels)."""
    from texturefusion_tpu.config import (BAConfig, CameraConfig,
                                          ParallelConfig, PipelineConfig,
                                          TrackingConfig, TSDFConfig)

    return PipelineConfig(
        # mild Brown-Conrady distortion — the bench frames are rendered
        # through this model, the tracker undistorts keypoints against it
        camera=CameraConfig(far_plane=6.0, d0=-0.03, d1=0.005),
        # blur gate ON: synthetic sharp frames score ~5-9 on the
        # mean-|Laplacian| metric, the σ=3 blurred burst ~1-2
        tracking=TrackingConfig(blur_threshold=3.0),
        # schur_min_keyframes=16 puts the Schur-complement BA path in the
        # live run (1-device mesh) once the loop has ≥16 keyframes
        ba=BAConfig(schur_min_keyframes=16),
        tsdf=TSDFConfig(voxel_resolution=0.02, capacity=16384,
                        max_update_chunks=1024),
        # pipeline_depth=2: frames arrive back-to-back here (no sensor
        # cadence), so the per-frame stats readback gets ~2 frames of
        # device work to land behind. Stale-finalized frames are
        # re-registered against their adopted keyframe asynchronously
        # (tracking.refine_stale), so the depth costs no tracking
        # accuracy (CPU sweep ATE: depth1 15.1 mm, depth2 14.5, depth3
        # 13.0) — but depth 3 delays promotions ~1 frame further (25 vs
        # 30 keyframes on this loop), thinning the map, so 2 is the
        # operating point.
        parallel=ParallelConfig(async_fusion=True, pipeline_depth=2),
    )


def main():
    from texturefusion_tpu.core import camera as cam
    from texturefusion_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    from texturefusion_tpu.fusion.pipeline import TexturedPipeline
    from texturefusion_tpu.io import tum

    config = bench_config()
    intr = cam.Intrinsics.from_config(config.camera)
    n_frames = 120
    n_warm = 20
    packed, gt_poses, scene = make_frames(config, intr, n_frames)

    # warmup pass: play the WHOLE sequence once through a throwaway
    # pipeline — compiles every jit variant the timed pass will hit
    # (late-appearing bucket sizes: BA keyframe/edge buckets, mesher
    # batch buckets, texture patch buckets)
    warm, _ = run(TexturedPipeline, config, packed, 0, range(n_frames))
    del warm
    # the warm pipeline holds ~10^5 device buffers in reference CYCLES
    # (pipeline↔volume↔mesher backrefs): without an explicit collect they
    # are freed by the cycle collector DURING the timed pass
    import gc as _gc
    _gc.collect()
    jax.block_until_ready(jnp.zeros(8).sum())
    time.sleep(1.0)

    pipe, fps = run(TexturedPipeline, config, packed, n_warm,
                    range(n_warm, n_frames))

    from texturefusion_tpu.utils.stopwatch import STOPWATCH
    pipe.finish()
    est = pipe.trajectory()
    ate = tum.ate_rmse(est, gt_poses[: len(est)])
    merr = map_error_mm(pipe, scene, est, gt_poses)
    print("stats:", pipe.stats, file=sys.stderr)
    print(f"loop-closure/BA edges: {pipe.slam.n_edges} "
          f"keyframes: {len(pipe.slam.keyframes)}", file=sys.stderr)
    print(f"ATE RMSE: {ate * 1000:.1f} mm over {len(est)} frames",
          file=sys.stderr)
    print(f"map error: {merr}", file=sys.stderr)
    print(STOPWATCH.report(), file=sys.stderr)
    if os.environ.get("TF_FETCH_TRACE"):
        from texturefusion_tpu.fusion.pipeline import _FETCH_LOG
        lands = sorted(l for _, l in _FETCH_LOG[-100:] if l > 0)
        pend = sum(1 for _, l in _FETCH_LOG[-100:] if l < 0)
        if lands:
            print(f"[ftrace] landings ms p10={lands[len(lands)//10]:.0f} "
                  f"med={lands[len(lands)//2]:.0f} "
                  f"p90={lands[9*len(lands)//10]:.0f} "
                  f"pending_at_finalize={pend}", file=sys.stderr)
        from texturefusion_tpu.fusion.pipeline import _COMPUTE_LOG
        comp = sorted(_COMPUTE_LOG[-100:])
        if comp:
            print(f"[ftrace] compute-ready ms p10={comp[len(comp)//10]:.0f} "
                  f"med={comp[len(comp)//2]:.0f} "
                  f"p90={comp[9*len(comp)//10]:.0f}", file=sys.stderr)
    if pipe.stats["reintegrations"] == 0:
        print("WARNING: reintegration path not exercised", file=sys.stderr)

    print(json.dumps({
        "metric": "textured_pipeline_fps_per_chip",
        "value": round(fps, 2),
        "unit": "frames/s (VGA, SLAM+fusion+texture, 2cm voxels, "
                "360-loop w/ distortion+exposure-step+blur)",
        "vs_baseline": round(fps / 30.0, 3),
        "extra": {"ate_rmse_mm": round(ate * 1e3, 2), **merr,
                  "keyframes": len(pipe.slam.keyframes),
                  "reintegrations": pipe.stats["reintegrations"]},
    }))


if __name__ == "__main__":
    main()
