"""Generate a TUM-fr1-matched synthetic RGB-D dataset ON DISK and run the
FULL CLI over it — an ATE proxy for runs without the real TUM data
(ref: BasicAPI.cpp:1032-1134).

Sensor model (matched to TUM freiburg1 + Kinect-v1 error literature):
  * fr1 intrinsics (fx 517.3, fy 516.5, cx 318.6, cy 255.3, 640x480)
  * asymmetric Brown-Conrady distortion incl. tangential terms — frames
    are RENDERED through the distorted camera, the tracker undistorts
  * depth quantized to uint16 at the TUM factor 5000 (0.2 mm steps)
  * multiplicative depth noise σ(z) = 1.2 mm + 1.9 mm·(z−0.4)² — the
    Khoshelham & Elberink Kinect axial error model
  * depth shadowing: pixels near strong depth edges drop out (the IR
    projector baseline shadow), plus salt speckle dropout
  * exposure flicker: per-frame gain jitter (rolling auto-exposure) on
    top of a ⅔-stop step over half the loop
  * a motion-blur burst (σ=3 Gaussian, 3 frames)

Usage:
  python examples/make_tum_proxy.py [--frames 120] [--out DIR] [--run]

--run executes the exact dataset path end-to-end:
  python -m texturefusion_tpu DIR "" 0.02 0 --out DIR/out
(associate.txt → pack_frame → pipeline → trajectory.txt → ATE), then
prints the trajectory ATE against the on-disk groundtruth.txt.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np


FR1_CAMERA = dict(width=640, height=480, fx=517.3, fy=516.5,
                  cx=318.6, cy=255.3, depth_scale=5000.0, far_plane=6.0,
                  # moderate asymmetric Brown-Conrady set (k1, k2, p1, p2):
                  # fr1's own k-series is stronger but diverges the
                  # iterative inverse at the frame corners; this keeps
                  # >5 px of correction at the border, which is what the
                  # keypoint-undistortion path has to get right
                  d0=0.12, d1=-0.18, d2=-0.004, d3=0.003)

BLUR_FRAMES = (46, 47, 48)
EXPOSURE_GAIN = 1.55
EXPOSURE_RANGE = (60, 95)


def kinect_depth_noise(rng, depth):
    """Khoshelham & Elberink axial error: σ(z) = 1.2 + 1.9·(z−0.4)² mm."""
    sigma = (0.0012 + 0.0019 * np.square(np.maximum(depth, 0.4) - 0.4))
    return np.where(depth > 0,
                    depth + rng.normal(0.0, 1.0, depth.shape) * sigma,
                    0.0).astype(np.float32)


def depth_shadow_dropout(rng, depth, edge_mm=40.0, speckle=0.004):
    """Projector-shadow dropout near strong depth edges + salt speckle
    (real Kinect frames lose the occlusion boundary strip)."""
    gx = np.abs(np.diff(depth, axis=1, prepend=depth[:, :1]))
    gy = np.abs(np.diff(depth, axis=0, prepend=depth[:1]))
    edge = (np.maximum(gx, gy) > edge_mm * 1e-3)
    # dilate the edge band one step to the right (IR baseline is horizontal)
    band = edge | np.roll(edge, 1, axis=1) | np.roll(edge, 2, axis=1)
    drop = band | (rng.random(depth.shape) < speckle)
    return np.where(drop, 0.0, depth).astype(np.float32)


def generate(out_dir: str, n_frames: int = 120, seed: int = 11):
    import jax.numpy as jnp

    from texturefusion_tpu.config import CameraConfig
    from texturefusion_tpu.core import camera as cam
    from texturefusion_tpu.core import se3
    from texturefusion_tpu.io import synthetic
    from texturefusion_tpu.io.image import gaussian_blur, write_png

    camera = CameraConfig(**FR1_CAMERA)
    intr = cam.Intrinsics.from_config(camera)
    # keep per-frame motion at the nominal 120-frame cadence: short runs
    # render a short ARC of the loop, not the whole 360° compressed into
    # n_frames (36°/frame at n=10 is untrackable by design, not a proxy)
    base = max(n_frames, 120)
    poses = synthetic.loop_trajectory(base, radius=1.5)[:n_frames]
    scene = synthetic.BoxRoomScene(room_min=(-2.6, -1.5, -2.6),
                                   room_max=(2.6, 1.5, 2.6))
    depths, rgbs = synthetic.render_sequence(scene, intr, poses)

    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    rng = np.random.default_rng(seed)
    # groundtruth in a DIFFERENT world frame (like a mocap rig's), so the
    # ATE alignment is exercised for real
    t_off = np.eye(4, dtype=np.float32)
    t_off[:3, :3] = np.asarray(se3.matrix_from_quaternion(
        jnp.asarray([0.18, -0.05, 0.3, 0.936], dtype=np.float32)))
    t_off[:3, 3] = (0.7, -0.2, 1.1)

    assoc, gt_lines, rgb_lines, depth_lines = [], [], [], []
    for i, (d, c) in enumerate(zip(depths, rgbs)):
        ts = 1305030000.0 + i / 30.0
        d = np.asarray(d)
        c = np.asarray(c)
        d = kinect_depth_noise(rng, d)
        d = depth_shadow_dropout(rng, d)
        gain = 1.0 + rng.normal(0.0, 0.02)          # AE flicker
        if EXPOSURE_RANGE[0] <= i < EXPOSURE_RANGE[1]:
            gain *= EXPOSURE_GAIN
        c = np.clip(c * gain, 0.0, 1.0)
        if i in BLUR_FRAMES:
            c = gaussian_blur(c, 3.0)
        rp, dp = f"rgb/{ts:.6f}.png", f"depth/{ts:.6f}.png"
        write_png(os.path.join(out_dir, rp), (c * 255).astype(np.uint8))
        write_png(os.path.join(out_dir, dp),
                  np.round(d * camera.depth_scale).astype(np.uint16))
        assoc.append(f"{ts:.6f} {rp} {ts:.6f} {dp}")
        rgb_lines.append(f"{ts:.6f} {rp}")
        depth_lines.append(f"{ts:.6f} {dp}")
        g = t_off @ poses[i]
        q = np.asarray(se3.quaternion_from_matrix(jnp.asarray(g[:3, :3])))
        gt_lines.append(f"{ts:.6f} " + " ".join(
            f"{v:.6f}" for v in (*g[:3, 3], *q)))

    with open(os.path.join(out_dir, "associate.txt"), "w") as f:
        f.write("\n".join(assoc) + "\n")
    with open(os.path.join(out_dir, "rgb.txt"), "w") as f:
        f.write("# ts filename\n" + "\n".join(rgb_lines) + "\n")
    with open(os.path.join(out_dir, "depth.txt"), "w") as f:
        f.write("# ts filename\n" + "\n".join(depth_lines) + "\n")
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("# ts tx ty tz qx qy qz qw\n" + "\n".join(gt_lines) + "\n")
    with open(os.path.join(out_dir, "calib.txt"), "w") as f:
        f.write(f"{camera.fx} {camera.fy} {camera.cx} {camera.cy} "
                f"{camera.width} {camera.height} {camera.depth_scale} "
                f"{camera.d0} {camera.d1} {camera.d2} {camera.d3} "
                f"{camera.d4}\n")
    print(f"wrote {n_frames}-frame fr1-proxy dataset to {out_dir}")
    return out_dir


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--out", default="/tmp/tum_fr1_proxy")
    ap.add_argument("--run", action="store_true",
                    help="run the full CLI over the generated dataset")
    args = ap.parse_args()
    generate(args.out, args.frames)
    if args.run:
        from texturefusion_tpu.__main__ import main as cli_main
        rc = cli_main([args.out, "", "0.02", "0",
                       "--out", os.path.join(args.out, "out")])
        sys.exit(rc)


if __name__ == "__main__":
    main()
