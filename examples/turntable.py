"""Offline turntable renderer: fuse a synthetic scene, then raycast a
360° orbit of novel views straight off the device-resident TSDF —
shaded with the fused voxel colors and a headlight diffuse term.

This is the offline counterpart of the reference's interactive viewer
(ref: GCFusion/MobileGUI.hpp:17-198 + Shaders/draw_mesh.vert:29-70):
the GL display loop is out of scope (SURVEY.md §2), but the same
"look at the model from anywhere" capability exists as a render batch —
every frame is one `ops/raycast.raycast_volume` dispatch over the live
volume, no mesh export in the loop.

Usage:
  python examples/turntable.py [--frames 24] [--fuse 24] [--out DIR]

Writes out/turn_###.png plus a contact-sheet summary line; PASS if every
frame hits >50% of pixels (the orbit stays inside the fused room).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax
import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.utils.cache import enable_compilation_cache

enable_compilation_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24,
                    help="orbit render frames")
    ap.add_argument("--fuse", type=int, default=24,
                    help="synthetic frames fused before rendering")
    ap.add_argument("--out", default="/tmp/turntable")
    ap.add_argument("--voxel", type=float, default=0.03)
    args = ap.parse_args()

    from texturefusion_tpu.config import (CameraConfig, PipelineConfig,
                                          TSDFConfig)
    from texturefusion_tpu.core import camera as cam
    from texturefusion_tpu.fusion.chunkmap import TSDFVolume
    from texturefusion_tpu.io import synthetic
    from texturefusion_tpu.io.image import write_png
    from texturefusion_tpu.ops import preprocess, raycast

    camera = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                          cx=159.5, cy=119.5, far_plane=6.0)
    config = PipelineConfig(
        camera=camera,
        tsdf=TSDFConfig(voxel_resolution=args.voxel, capacity=8192,
                        max_update_chunks=1024))
    intr = cam.Intrinsics.from_config(camera)
    print("devices:", jax.devices())

    scene = synthetic.BoxRoomScene()
    poses = synthetic.loop_trajectory(args.fuse, radius=1.2)
    depths, rgbs = synthetic.render_sequence(scene, intr, poses)

    vol = TSDFVolume(config)
    t0 = time.time()
    for i, (p, d, c) in enumerate(zip(poses, depths, rgbs)):
        d = jnp.asarray(d)
        c = jnp.asarray(c)
        dpre = preprocess.frame_preprocess(d, intr)
        normals = preprocess.extract_normal_map(dpre, intr)
        quality = preprocess.observation_quality_map(c, dpre, normals, intr)
        vol.integrate_frame(dpre, c, quality, jnp.asarray(p), keyframe_id=i)
    jax.block_until_ready(vol.batch.sdf)
    print(f"fused {args.fuse} frames in {time.time() - t0:.1f}s")

    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    hit_fracs = []
    for k in range(args.frames):
        # full 360° yaw orbit riding INSIDE the fused viewing band (the
        # fusion pass observed the walls from radius ~1.2 looking
        # outward; novel views from a nearby radius see fused surface
        # almost everywhere, views from the center mostly see unfused
        # floor/ceiling)
        a = 2.0 * np.pi * k / args.frames
        eye = np.asarray([0.9 * np.sin(a), 0.0, 0.9 * np.cos(a)])
        fwd = np.asarray([np.sin(a), 0.0, np.cos(a)])
        up = np.asarray([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 0], pose[:3, 1] = right, np.cross(fwd, right)
        pose[:3, 2], pose[:3, 3] = fwd, eye
        res = raycast.raycast_volume(vol, pose)
        hit = np.asarray(res.hit)
        col = np.asarray(res.color)
        nrm = np.asarray(res.normals)
        # headlight diffuse: |n · view| — the offline stand-in for the
        # viewer's shader lighting (ref: draw_mesh.vert:29-70)
        shade = np.clip(np.abs(nrm @ fwd), 0.25, 1.0)[..., None]
        img = np.where(hit[..., None], col * shade, 0.08)
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        write_png(os.path.join(args.out, f"turn_{k:03d}.png"), img)
        hit_fracs.append(float(hit.mean()))
    dt = time.time() - t0
    print(f"rendered {args.frames} novel views in {dt:.1f}s "
          f"({args.frames / dt:.1f} fps), hit fraction "
          f"min {min(hit_fracs):.2f} mean {np.mean(hit_fracs):.2f}")
    ok = min(hit_fracs) > 0.5
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
