"""TUM RGB-D dataset loader and ATE evaluation.

Replaces the reference's offline dataset path (ref: BasicAPI.cpp:1032-1134
initOfflineData — associate.txt / groundtruth.txt / calib.txt parsing;
Tools/DatasetWrapper.hpp:15-263) and the external ATE evaluation the
reference relies on (SURVEY.md §4).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from texturefusion_tpu.config import CameraConfig


@dataclasses.dataclass
class TumSequence:
    root: str
    rgb_files: List[str]
    depth_files: List[str]
    timestamps: np.ndarray                  # (N,) rgb timestamps
    camera: CameraConfig
    gt_timestamps: Optional[np.ndarray] = None
    gt_poses: Optional[np.ndarray] = None   # (M, 4, 4)

    def __len__(self) -> int:
        return len(self.rgb_files)

    def load_frame(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (depth_meters[H,W] f32, rgb[H,W,3] f32 in [0,1])."""
        depth_raw, rgb_raw = self.load_frame_raw(i)
        return (depth_raw.astype(np.float32) / self.camera.depth_scale,
                rgb_raw.astype(np.float32) / 255.0)

    def load_frame_raw(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Compact sensor formats (depth uint16, rgb uint8) — preferred
        for feeding the pipeline: 3× less host→device traffic, converted
        on device by preprocess_bundle."""
        from texturefusion_tpu.io.image import read_png

        rgb = read_png(self.rgb_files[i])
        if rgb.dtype != np.uint8 or rgb.ndim != 3:
            raise ValueError(f"{self.rgb_files[i]}: expected 8-bit RGB")
        depth_raw = read_png(self.depth_files[i])
        if depth_raw.ndim != 2:
            raise ValueError(f"{self.depth_files[i]}: expected grayscale")
        return depth_raw.astype(np.uint16), rgb


def _parse_calib(path: str) -> CameraConfig:
    """13-field calib.txt: fx fy cx cy width height scale [d0..d4]
    (ref: BasicAPI.cpp:1108-1133)."""
    vals = [float(x) for x in open(path).read().split()]
    kw = dict(fx=vals[0], fy=vals[1], cx=vals[2], cy=vals[3],
              width=int(vals[4]), height=int(vals[5]), depth_scale=vals[6])
    if len(vals) >= 12:
        kw.update(d0=vals[7], d1=vals[8], d2=vals[9], d3=vals[10], d4=vals[11])
    return CameraConfig(**kw)


def read_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """groundtruth.txt or trajectory.txt: `ts tx ty tz qx qy qz qw` per
    line (ref: BasicAPI.cpp:1084-1106). Returns (timestamps, poses)."""
    import jax.numpy as jnp

    from texturefusion_tpu.core import se3

    ts, poses = [], []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(x) for x in line.split()]
        if len(vals) < 8:
            continue
        ts.append(vals[0])
        rot = np.asarray(se3.matrix_from_quaternion(jnp.asarray(vals[4:8], dtype=np.float32)))
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = rot
        pose[:3, 3] = vals[1:4]
        poses.append(pose)
    return np.asarray(ts), np.stack(poses) if poses else np.zeros((0, 4, 4))


def load_tum_sequence(root: str, camera: Optional[CameraConfig] = None) -> TumSequence:
    """Load via associate.txt (`ts_rgb rgb_path ts_depth depth_path`) with
    calib.txt and optional groundtruth.txt, like the reference's
    initOfflineData."""
    assoc = os.path.join(root, "associate.txt")
    rgb_files, depth_files, timestamps = [], [], []
    for line in open(assoc):
        parts = line.split()
        if len(parts) < 4:
            continue
        timestamps.append(float(parts[0]))
        # reference convention: col1=rgb path, col3=depth path
        rgb_files.append(os.path.join(root, parts[1]))
        depth_files.append(os.path.join(root, parts[3]))
    # the on-disk calib ALWAYS wins for dataset runs (ref:
    # BasicAPI.cpp:1108-1133 reads calib.txt unconditionally); the
    # passed camera is only a fallback for calib-less directories.
    calib = os.path.join(root, "calib.txt")
    if os.path.exists(calib):
        camera = _parse_calib(calib)
    elif camera is None:
        camera = CameraConfig()
    gt_ts = gt_poses = None
    gt_path = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_path):
        gt_ts, gt_poses = read_trajectory(gt_path)
    return TumSequence(root=root, rgb_files=rgb_files, depth_files=depth_files,
                       timestamps=np.asarray(timestamps), camera=camera,
                       gt_timestamps=gt_ts, gt_poses=gt_poses)


def align_umeyama(est_poses: np.ndarray, gt_poses: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """SE3 (Umeyama, no scale) alignment est→gt from matched poses.
    Returns (rot[3,3], t[3]): p_gt ≈ rot @ p_est + t. The estimated map
    lives in the SLAM frame (first keyframe = identity); this is the
    transform that carries it into the ground-truth world frame."""
    est_t = est_poses[:, :3, 3]
    gt_t = gt_poses[:, :3, 3]
    mu_e, mu_g = est_t.mean(0), gt_t.mean(0)
    xe, xg = est_t - mu_e, gt_t - mu_g
    cov = xg.T @ xe / len(est_t)
    u, _, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u @ vt) < 0:
        s[2, 2] = -1
    rot = u @ s @ vt
    t = mu_g - rot @ mu_e
    return rot, t


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """Absolute trajectory error RMSE after SE3 (Umeyama, no scale) alignment.

    est_poses/gt_poses: (N, 4, 4) with matching indices. This is the metric
    the reference's trajectory.txt is evaluated with externally."""
    rot, t = align_umeyama(est_poses, gt_poses)
    aligned = est_poses[:, :3, 3] @ rot.T + t
    err = aligned - gt_poses[:, :3, 3]
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def associate_timestamps(ts_a: np.ndarray, ts_b: np.ndarray,
                         max_dt: float = 0.02) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp association (like TUM associate.py)."""
    pairs = []
    j = 0
    for i, t in enumerate(ts_a):
        j = int(np.searchsorted(ts_b, t))
        best, best_dt = -1, max_dt
        for k in (j - 1, j):
            if 0 <= k < len(ts_b) and abs(ts_b[k] - t) <= best_dt:
                best, best_dt = k, abs(ts_b[k] - t)
        if best >= 0:
            pairs.append((i, best))
    return pairs
