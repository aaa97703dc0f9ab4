"""Image preprocessing kernels as jitted XLA ops.

Batched re-design of the reference's AVX2 per-pixel kernels in BasicAPI
(ref: BasicAPI.cpp — framePreprocess :942, extractNormalMapSIMD :849,
refineDepthUseNormalSIMD :728, checkColorQuality :783, estimateColorQuality
:815, refineKeyframesSIMD :506, refineNewframesSIMD :378, blurriness :1256).
Every kernel is a pure function over (H, W[, C]) arrays; XLA fuses the
elementwise pipelines, stencils are expressed as static shifted slices.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.core import camera as cam


def _shift(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Shifted copy with edge padding: out[y, x] = img[y+dy, x+dx]."""
    pad_y = (max(-dy, 0), max(dy, 0))
    pad_x = (max(-dx, 0), max(dx, 0))
    padded = jnp.pad(img, (pad_y, pad_x), mode="edge")
    h, w = img.shape
    return jax.lax.dynamic_slice(padded, (pad_y[0] + dy, pad_x[0] + dx), (h, w))


def depth_clamp(depth: jnp.ndarray, near: float, far: float) -> jnp.ndarray:
    """Zero out depth outside [near, far] (ref: framePreprocess depth clamp,
    BasicAPI.cpp:942-997). 0 encodes invalid."""
    valid = (depth > near) & (depth < far)
    return jnp.where(valid, depth, 0.0)


@functools.partial(jax.jit, static_argnames=("radius",))
def bilateral_filter(depth: jnp.ndarray, radius: int = 4,
                     sigma_space: float = 4.5, sigma_range: float = 0.03) -> jnp.ndarray:
    """Edge-preserving depth smoothing, 9×9 default window.

    Matches cv::bilateralFilter(9, 0.03, ~4.5) in framePreprocess
    (ref: BasicAPI.cpp:942-997; DatasetWrapper.hpp:188). Invalid (0) depths
    contribute nothing and stay 0; borders replicate the edge pixel.

    The 81 shifted taps are static slices of one padded image; XLA fuses
    the whole stencil into a single elementwise loop.
    """
    valid = depth > 0
    acc = jnp.zeros_like(depth)
    wacc = jnp.zeros_like(depth)
    inv_2sr = 1.0 / (2.0 * sigma_range * sigma_range)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb = _shift(depth, dy, dx)
            nb_valid = nb > 0
            w_s = np.exp(-(dy * dy + dx * dx) * (1.0 / (2.0 * sigma_space * sigma_space)))
            diff = nb - depth
            w = w_s * jnp.exp(-(diff * diff) * inv_2sr)
            w = jnp.where(nb_valid, w, 0.0)
            acc = acc + w * nb
            wacc = wacc + w
    out = acc / jnp.maximum(wacc, 1e-12)
    return jnp.where(valid & (wacc > 1e-12), out, 0.0)


@jax.jit
def rgb_to_gray(rgb: jnp.ndarray) -> jnp.ndarray:
    """(H, W, 3) float -> (H, W) luminance."""
    return rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114


def extract_normal_map(depth: jnp.ndarray, intr: cam.Intrinsics) -> jnp.ndarray:
    """Cross-product normals from backprojected depth gradients
    (ref: extractNormalMapSIMD BasicAPI.cpp:849-905; MapMaintain.hpp:15-66).

    Returns (H, W, 3) unit normals pointing toward the camera (-z half-space);
    zero where depth invalid.
    """
    pts = cam.backproject_depth_map(intr, depth)
    right = jnp.roll(pts, -1, axis=1)
    down = jnp.roll(pts, -1, axis=0)
    dx = right - pts
    dy = down - pts
    n = jnp.cross(dy, dx)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-12)
    # flip to face the camera (dot with view direction must be negative)
    view = pts / jnp.maximum(jnp.linalg.norm(pts, axis=-1, keepdims=True), 1e-12)
    flip = jnp.sum(n * view, axis=-1, keepdims=True) > 0
    n = jnp.where(flip, -n, n)
    valid = (depth > 0) & (jnp.roll(depth, -1, 1) > 0) & (jnp.roll(depth, -1, 0) > 0)
    valid = valid & (norm[..., 0] > 1e-12)
    return jnp.where(valid[..., None], n, 0.0)


def view_angle_cos(depth: jnp.ndarray, normals: jnp.ndarray,
                   intr: cam.Intrinsics) -> jnp.ndarray:
    """|view_dir · normal| per pixel — the observation-angle factor used by
    color-quality and depth-refinement gates."""
    pts = cam.backproject_depth_map(intr, depth)
    view = pts / jnp.maximum(jnp.linalg.norm(pts, axis=-1, keepdims=True), 1e-12)
    return jnp.abs(jnp.sum(view * normals, axis=-1))


def refine_depth_with_normals(depth: jnp.ndarray, normals: jnp.ndarray,
                              intr: cam.Intrinsics,
                              min_cos: float = 0.1) -> jnp.ndarray:
    """Zero depth at grazing observation angles |view·normal| < 0.1
    (ref: refineDepthUseNormalSIMD BasicAPI.cpp:728-780)."""
    cos = view_angle_cos(depth, normals, intr)
    has_normal = jnp.sum(normals * normals, axis=-1) > 1e-12
    keep = (cos >= min_cos) & has_normal
    return jnp.where(keep, depth, 0.0)


def color_valid_flag(depth: jnp.ndarray, normals: jnp.ndarray,
                     intr: cam.Intrinsics, min_cos: float = 0.2) -> jnp.ndarray:
    """Per-pixel flag: color observation usable if |view·normal| ≥ 0.2
    (ref: checkColorQuality BasicAPI.cpp:783-813)."""
    cos = view_angle_cos(depth, normals, intr)
    has_normal = jnp.sum(normals * normals, axis=-1) > 1e-12
    return (cos >= min_cos) & has_normal & (depth > 0)


def sobel_magnitude(gray: jnp.ndarray) -> jnp.ndarray:
    """|Sobel| gradient magnitude of (H, W)."""
    gx = (_shift(gray, -1, 1) + 2 * _shift(gray, 0, 1) + _shift(gray, 1, 1)
          - _shift(gray, -1, -1) - 2 * _shift(gray, 0, -1) - _shift(gray, 1, -1))
    gy = (_shift(gray, 1, -1) + 2 * _shift(gray, 1, 0) + _shift(gray, 1, 1)
          - _shift(gray, -1, -1) - 2 * _shift(gray, -1, 0) - _shift(gray, -1, 1))
    return jnp.sqrt(gx * gx + gy * gy)


def observation_quality_map(rgb: jnp.ndarray, depth: jnp.ndarray,
                            normals: jnp.ndarray, intr: cam.Intrinsics) -> jnp.ndarray:
    """Per-pixel texture-observation quality: Sobel(gray) × |view·normal|
    (ref: estimateColorQuality BasicAPI.cpp:815-847). Feeds per-chunk MRF
    data costs via the TSDF integrator."""
    gray = rgb_to_gray(rgb)
    grad = sobel_magnitude(gray)
    cos = view_angle_cos(depth, normals, intr)
    q = grad * cos
    return jnp.where(depth > 0, q, 0.0)


@jax.jit
def laplacian_blurriness(gray: jnp.ndarray) -> jnp.ndarray:
    """Mean |Laplacian| sharpness score; below threshold ⇒ blurred frame,
    blocked from keyframe promotion (ref: blurriness BasicAPI.cpp:1256-1266;
    gate at GCSLAM.cpp:315). Expects gray in [0, 255] scale for threshold 3.0."""
    lap = (_shift(gray, 0, 1) + _shift(gray, 0, -1) + _shift(gray, 1, 0)
           + _shift(gray, -1, 0) - 4.0 * gray)
    return jnp.mean(jnp.abs(lap))


def _bilinear_depth(depth: jnp.ndarray, uv: jnp.ndarray
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Validity-aware bilinear depth sample at float uv [N, 2]
    (ref: Patch.cpp:110-170 bilinear_depth). Returns (d, ok)."""
    h, w = depth.shape
    x = jnp.clip(uv[..., 0], 0.0, w - 1.001)
    y = jnp.clip(uv[..., 1], 0.0, h - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    flat = depth.reshape(-1)
    base = y0 * w + x0
    d00 = jnp.take(flat, base)
    d01 = jnp.take(flat, base + 1)
    d10 = jnp.take(flat, base + w)
    d11 = jnp.take(flat, base + w + 1)
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    ws = (w00 * (d00 > 0) + w01 * (d01 > 0)
          + w10 * (d10 > 0) + w11 * (d11 > 0))
    d = (w00 * d00 + w01 * d01 + w10 * d10 + w11 * d11)
    ok = ws > 0.5    # majority of the bilinear mass on valid samples
    return jnp.where(ok, d / jnp.maximum(ws, 1e-12), 0.0), ok


def _warped_depth_obs(target_depth: jnp.ndarray, source_depth: jnp.ndarray,
                      rel_source_to_target: jnp.ndarray,
                      intr: cam.Intrinsics, consistency: float
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """For each TARGET pixel with an estimate: project into the source
    frame, bilinearly sample its depth, lift the sample back to the
    target frame. Returns (z_obs [H,W], agree [H,W]).

    Gather formulation of the reference's reproject+bilinear fusion
    (ref: refineKeyframesSIMD BasicAPI.cpp:506-635) — forward splatting
    is a scatter with colliding writes; the backward warp is pure
    gathers."""
    from texturefusion_tpu.core import se3

    pts_t = cam.backproject_depth_map(intr, target_depth)
    rel_t_to_s = se3.inverse(rel_source_to_target)
    pts_s = se3.transform_points(rel_t_to_s, pts_t.reshape(-1, 3))
    uv, z_exp = cam.project(intr, pts_s)
    d_s, ok_s = _bilinear_depth(source_depth, uv)
    valid = ((target_depth.reshape(-1) > 0) & (z_exp > intr.near)
             & cam.in_image(intr, uv) & ok_s & (d_s > 0))
    agree = valid & (jnp.abs(d_s - z_exp)
                     < consistency * jnp.maximum(z_exp, 1e-3))
    # lift: point along the source ray through uv at sampled depth
    x_s = cam.unproject(intr, uv[..., 0], uv[..., 1], d_s)
    x_t = se3.transform_points(rel_source_to_target, x_s)
    z_obs = x_t[..., 2]
    shape = target_depth.shape
    return (jnp.where(agree, z_obs, 0.0).reshape(shape),
            agree.reshape(shape))


def fuse_depth_into_keyframe(kf_depth: jnp.ndarray, kf_weight: jnp.ndarray,
                             new_depth: jnp.ndarray,
                             rel_pose_new_to_kf: jnp.ndarray,
                             intr: cam.Intrinsics,
                             consistency: float = 0.05) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Running weighted fusion of a tracked frame's depth into its keyframe.

    Gather re-design of refineKeyframesSIMD (ref: BasicAPI.cpp:506-635):
    each keyframe pixel warps into the new frame, bilinearly samples its
    depth, and — when consistent — updates the keyframe's running
    (depth, weight) average. Pure-gather backward warp (see
    _warped_depth_obs)."""
    z_obs, agree = _warped_depth_obs(kf_depth, new_depth,
                                     rel_pose_new_to_kf, intr, consistency)
    den = agree.astype(jnp.float32)
    fused = ((kf_depth * kf_weight + z_obs)
             / jnp.maximum(kf_weight + den, 1e-12))
    have_any = (kf_weight + den) > 0
    out_d = jnp.where(have_any, fused, 0.0)
    return out_d, kf_weight + den


def refine_new_frame_from_keyframe(new_depth: jnp.ndarray,
                                   kf_depth: jnp.ndarray,
                                   rel_pose_new_to_kf: jnp.ndarray,
                                   intr: cam.Intrinsics,
                                   consistency: float = 0.05,
                                   kf_trust: float = 1.0) -> jnp.ndarray:
    """Refine a tracked frame's depth FROM its keyframe — the reverse
    direction (ref: refineNewframesSIMD BasicAPI.cpp:378-505, chosen
    per-frame at main.cpp:124-135): each new-frame pixel warps into the
    keyframe, samples the accumulated keyframe depth, and blends where
    consistent."""
    from texturefusion_tpu.core import se3
    z_obs, agree = _warped_depth_obs(
        new_depth, kf_depth, se3.inverse(rel_pose_new_to_kf), intr,
        consistency)
    den = agree.astype(jnp.float32) * kf_trust
    fused = (new_depth + z_obs * kf_trust) / jnp.maximum(1.0 + den, 1e-12)
    return jnp.where(new_depth > 0, jnp.where(agree, fused, new_depth), 0.0)


def frame_preprocess(depth_raw: jnp.ndarray, intr: cam.Intrinsics,
                     bilateral_radius: int = 4) -> jnp.ndarray:
    """Full depth preprocessing: clamp to [near, far] then bilateral smooth
    (ref: framePreprocess BasicAPI.cpp:942-997)."""
    d = depth_clamp(depth_raw, intr.near, intr.far)
    return bilateral_filter(d, radius=bilateral_radius)


def pack_frame(depth_u16: np.ndarray, rgb_u8: np.ndarray) -> np.ndarray:
    """Host-side: pack (uint16 depth, uint8 rgb) into one [H, W, 5] uint8
    buffer so a frame crosses the host→device link in a single transfer.
    preprocess_bundle(packed, None, ...) unpacks on device."""
    h, w = depth_u16.shape
    out = np.empty((h, w, 5), np.uint8)
    out[..., 0] = depth_u16 & 0xFF
    out[..., 1] = depth_u16 >> 8
    out[..., 2:5] = rgb_u8
    return out


def devignette(rgb: jnp.ndarray, intr: cam.Intrinsics,
               strength: float = 0.3) -> jnp.ndarray:
    """Radial vignetting correction (ref: DatasetWrapper.hpp optional
    'radical devignetting'): divide by a cos⁴-style falloff model."""
    u, v = cam.pixel_grid(intr)
    r2 = (((u - intr.cx) / intr.fx) ** 2 + ((v - intr.cy) / intr.fy) ** 2)
    gain = 1.0 + strength * r2 * (1.0 + r2)
    return jnp.clip(rgb * gain[..., None], 0.0, 1.0)


def remove_boundary_depth(depth: jnp.ndarray, iterations: int = 2
                          ) -> jnp.ndarray:
    """Erode depth at discontinuity boundaries — flying-pixel removal
    (ref: MapMaintain.hpp:131-172 removeBoundary)."""
    d = depth
    for _ in range(iterations):
        neighbor_max = d
        neighbor_min = jnp.where(d > 0, d, jnp.inf)
        for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            nb = _shift(d, dy, dx)
            neighbor_max = jnp.maximum(neighbor_max, nb)
            neighbor_min = jnp.minimum(neighbor_min,
                                       jnp.where(nb > 0, nb, jnp.inf))
        jump = (neighbor_max - jnp.where(jnp.isfinite(neighbor_min),
                                         neighbor_min, 0.0))
        keep = (d > 0) & (jump < 0.1 * jnp.maximum(d, 0.5))
        d = jnp.where(keep, d, 0.0)
    return d


@functools.partial(jax.jit, static_argnames=("intr", "depth_scale"))
def preprocess_bundle(depth_raw: jnp.ndarray, rgb: jnp.ndarray,
                      intr: cam.Intrinsics, depth_scale: float = 1.0):
    """The whole per-frame preprocessing chain as ONE compiled program —
    a single device dispatch per frame. Returns
    (depth_refined, normals, quality, gray255, blur_score).

    Accepts compact sensor formats to minimize host→device traffic:
    uint16 depth (divided by depth_scale) and uint8 rgb are converted on
    device; float inputs pass through (depth_scale then ignored for rgb).
    The most compact path is a single packed [H, W, 5] uint8 frame (see
    pack_frame) passed as `depth_raw` with rgb=None — ONE transfer per
    frame.
    """
    if rgb is None:
        packed = depth_raw
        depth_raw = (packed[..., 0].astype(jnp.float32)
                     + packed[..., 1].astype(jnp.float32) * 256.0) / depth_scale
        rgb = packed[..., 2:5].astype(jnp.float32) / 255.0
    if depth_raw.dtype != jnp.float32:
        depth_raw = depth_raw.astype(jnp.float32) / depth_scale
    if rgb.dtype != jnp.float32:
        rgb = rgb.astype(jnp.float32) / 255.0
    depth = frame_preprocess(depth_raw, intr)
    normals = extract_normal_map(depth, intr)
    depth_refined = refine_depth_with_normals(depth, normals, intr)
    quality = observation_quality_map(rgb, depth_refined, normals, intr)
    gray = rgb_to_gray(rgb) * 255.0
    blur = laplacian_blurriness(gray)
    return depth_refined, normals, quality, gray, blur, rgb
