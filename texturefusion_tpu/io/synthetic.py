"""Synthetic RGB-D scene generator for tests and benchmarks.

The reference has no test suite; SURVEY.md §4 prescribes golden-trajectory
tests on rendered synthetic scenes with known poses (no dataset download).
This renders axis-aligned-box rooms and spheres with a ray-caster in jnp,
producing depth + color + ground-truth poses — enough to exercise the whole
pipeline: tracking features come from a checkerboard/noise texture, fusion
geometry from the analytic SDF.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.core import camera as cam
from texturefusion_tpu.core import se3


@dataclasses.dataclass(frozen=True)
class BoxRoomScene:
    """A room interior: the camera is inside an axis-aligned box, looking at
    textured walls; optional spheres add curved geometry."""

    room_min: Tuple[float, float, float] = (-2.0, -1.5, -2.0)
    room_max: Tuple[float, float, float] = (2.0, 1.5, 2.0)
    spheres: Tuple[Tuple[float, float, float, float], ...] = (
        (0.6, 0.3, 0.8, 0.4),   # (cx, cy, cz, radius)
        (-0.8, 0.5, -0.5, 0.3),
    )
    checker_scale: float = 4.0  # checkerboard frequency on walls

    def sdf(self, pts: jnp.ndarray) -> jnp.ndarray:
        """Analytic signed distance: negative inside solid matter.

        The "solid" is the region OUTSIDE the room box, plus the spheres.
        Points in the open room interior have positive distance to the
        nearest surface.
        """
        mn = jnp.asarray(self.room_min)
        mx = jnp.asarray(self.room_max)
        # distance to box walls from inside (positive inside the room)
        d_walls = jnp.minimum(jnp.min(pts - mn, axis=-1), jnp.min(mx - pts, axis=-1))
        d = d_walls
        for (cx, cy, cz, r) in self.spheres:
            d_s = jnp.linalg.norm(pts - jnp.asarray([cx, cy, cz]), axis=-1) - r
            d = jnp.minimum(d, d_s)
        return d

    def color(self, pts: jnp.ndarray) -> jnp.ndarray:
        """Procedural albedo (..., 3) in [0,1]: hash-noise cells at two
        scales — spatially NON-repetitive so binary descriptors are
        distinctive (repetitive checkerboards alias feature matching),
        plus high-frequency cell borders that give FAST corners."""

        def hash_noise(cells: jnp.ndarray, salt: float) -> jnp.ndarray:
            h = (cells[..., 0] * 12.9898 + cells[..., 1] * 78.233
                 + cells[..., 2] * 37.719 + salt)
            return jnp.mod(jnp.sin(h) * 43758.5453, 1.0)

        s = self.checker_scale
        coarse = jnp.floor(pts * s)
        fine = jnp.floor(pts * s * 3.0)
        n1 = hash_noise(coarse, 0.0)
        n2 = hash_noise(fine, 17.0)
        base = 0.2 + 0.6 * n1
        r = jnp.clip(base * (0.6 + 0.6 * n2), 0.0, 1.0)
        g = jnp.clip(base * (0.6 + 0.6 * hash_noise(fine, 29.0)), 0.0, 1.0)
        b = jnp.clip(base * (0.6 + 0.6 * hash_noise(coarse, 43.0)), 0.0, 1.0)
        return jnp.stack([r, g, b], axis=-1)


def _raymarch(scene: BoxRoomScene, origins: jnp.ndarray, dirs: jnp.ndarray,
              max_dist: float = 8.0, n_steps: int = 96) -> jnp.ndarray:
    """Sphere-trace the scene SDF. origins/dirs: (..., 3). Returns hit distance
    (inf-like max_dist if no hit)."""

    def body(_, t):
        p = origins + dirs * t[..., None]
        d = scene.sdf(p)
        # negative steps allowed: backtrack after overshoot so rays settle
        # exactly on the zero crossing instead of tunneling into the solid
        return t + jnp.clip(d, -0.25, 0.5)

    t = jax.lax.fori_loop(0, n_steps, body, jnp.zeros(origins.shape[:-1]))
    p = origins + dirs * t[..., None]
    hit = jnp.abs(scene.sdf(p)) < 5e-3
    return jnp.where(hit, t, max_dist)


def render_frame(scene: BoxRoomScene, intr: cam.Intrinsics,
                 pose_c2w: jnp.ndarray,
                 depth_noise: float = 0.0,
                 seed: int = 0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Render (depth[H,W] meters, rgb[H,W,3] float in [0,1]) from a
    camera-to-world pose. Depth is z-depth (not ray length), like a real
    RGB-D sensor."""
    u, v = cam.pixel_grid(intr)
    if intr.has_distortion:
        # render through the DISTORTED camera: each distorted pixel's ray
        # comes from the iteratively-undistorted normalized coords (the
        # same inverse Brown model the tracker applies to keypoints,
        # core/camera.py undistort_points — so a pipeline configured with
        # the matching d0-d4 exercises its undistortion path for real)
        uv_u = cam.undistort_points(intr, jnp.stack([u, v], axis=-1))
        rays_cam = cam.unproject(intr, uv_u[..., 0], uv_u[..., 1],
                                 jnp.ones_like(u))
    else:
        rays_cam = cam.unproject(intr, u, v, jnp.ones_like(u))  # z=1 plane
    dirs_cam = rays_cam / jnp.linalg.norm(rays_cam, axis=-1, keepdims=True)
    rot = pose_c2w[:3, :3]
    dirs_w = jnp.matmul(dirs_cam, rot.T, precision=jax.lax.Precision.HIGHEST)
    origin = jnp.broadcast_to(pose_c2w[:3, 3], dirs_w.shape)
    t = _raymarch(scene, origin, dirs_w)
    pts_w = origin + dirs_w * t[..., None]
    # z-depth = ray length * cos(angle to optical axis) = t * dirs_cam.z
    depth = t * dirs_cam[..., 2]
    depth = jnp.where(t < 7.9, depth, 0.0)  # 0 = invalid, like real sensors
    rgb = scene.color(pts_w)
    rgb = jnp.where(depth[..., None] > 0, rgb, 0.0)
    if depth_noise > 0:
        key = jax.random.PRNGKey(seed)
        noise = jax.random.normal(key, depth.shape) * depth_noise * depth
        depth = jnp.where(depth > 0, depth + noise, 0.0)
    return depth, rgb


def orbit_trajectory(n_frames: int, radius: float = 0.8,
                     center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                     angle_range: float = 1.2) -> List[np.ndarray]:
    """Camera-to-world poses orbiting inside the room, looking outward at a
    target region; smooth so consecutive frames track easily."""
    poses = []
    look_at = np.asarray([0.0, 0.0, 1.8])  # look toward +z wall area
    for i in range(n_frames):
        a = (i / max(n_frames - 1, 1) - 0.5) * angle_range
        eye = np.asarray(center) + np.asarray(
            [radius * np.sin(a), 0.1 * np.sin(2 * a), -0.2 + 0.1 * np.cos(a)]
        )
        z_axis = look_at - eye
        z_axis = z_axis / np.linalg.norm(z_axis)
        up = np.asarray([0.0, -1.0, 0.0])  # camera y points down
        x_axis = np.cross(up, z_axis)
        x_axis /= np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        rot = np.stack([x_axis, y_axis, z_axis], axis=-1)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = rot
        pose[:3, 3] = eye
        poses.append(pose)
    return poses


def loop_trajectory(n_frames: int, radius: float = 1.6,
                    center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                    revolutions: float = 1.05) -> List[np.ndarray]:
    """A closed 360° loop inside the room: the camera rides a circle
    looking radially OUTWARD at the nearby walls. Mid-loop views share
    nothing with the start, so odometry drift accumulates until the loop
    closes — the classic loop-closure / reintegration scenario."""
    poses = []
    up_hint = np.asarray([0.0, -1.0, 0.0])
    for i in range(n_frames):
        a = 2.0 * np.pi * revolutions * i / max(n_frames - 1, 1)
        eye = np.asarray(center) + np.asarray(
            [radius * np.sin(a), 0.05 * np.sin(3 * a), radius * np.cos(a)])
        outward = np.asarray([np.sin(a), 0.0, np.cos(a)])
        z_axis = outward / np.linalg.norm(outward)
        x_axis = np.cross(up_hint, z_axis)
        x_axis = x_axis / np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 0] = x_axis
        pose[:3, 1] = y_axis
        pose[:3, 2] = z_axis
        pose[:3, 3] = eye
        poses.append(pose)
    return poses


def render_sequence(scene: BoxRoomScene, intr: cam.Intrinsics,
                    poses: List[np.ndarray], depth_noise: float = 0.0):
    """Render a full sequence; returns (depths[N,H,W], rgbs[N,H,W,3]) numpy.

    Frames come back as ONE flat vector per frame: one device→host copy
    per frame for depth and colour together."""
    h, w = intr.height, intr.width

    @jax.jit
    def render_flat(p):
        d, c = render_frame(scene, intr, p)
        return jnp.concatenate([d.reshape(-1), c.reshape(-1)])

    depths, rgbs = [], []
    for i, p in enumerate(poses):
        flat = np.asarray(render_flat(jnp.asarray(p)))
        depths.append(flat[: h * w].reshape(h, w))
        rgbs.append(flat[h * w:].reshape(h, w, 3))
    return np.stack(depths), np.stack(rgbs)


def perturbed_poses(poses: List[np.ndarray], trans_sigma: float = 0.01,
                    rot_sigma: float = 0.005, seed: int = 0) -> List[np.ndarray]:
    """Ground-truth poses with noise — odometry initialization for BA tests."""
    rng = np.random.default_rng(seed)
    out = []
    for p in poses:
        xi = np.concatenate([
            rng.standard_normal(3) * trans_sigma,
            rng.standard_normal(3) * rot_sigma,
        ]).astype(np.float32)
        out.append(np.asarray(se3.compose(jnp.asarray(p), se3.se3_exp(jnp.asarray(xi)))))
    return out
