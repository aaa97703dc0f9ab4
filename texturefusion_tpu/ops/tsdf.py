"""TSDF voxel-update kernels: projective integration / de-integration.

JAX re-design of open_chisel's AVX2 voxel kernel
(ref: 3rd_party/open_chisel/utils/ProjectionIntegrator.cpp:67-426
voxelUpdateSIMD; quadratic truncator
3rd_party/open_chisel/truncation/QuadraticTruncator.h:45-48).

Dense formulation: a batch of chunks is a [U, V, ...] tensor (V = chunk_size³
voxels, x-fastest). Each voxel center is projected into the depth image;
depth is fetched with an XLA gather; masks replace the AVX blends. Signed
weight implements de-integration exactly like the reference
(ref: ProjectionIntegrator.cpp:94-99 — integrateFlag flips the weight sign).

Semantics preserved from the reference's live (AVX) path:
  * truncation evaluated once per chunk at the chunk origin's camera depth
  * strict-interior pixel validity (0 < u < W-1, 0 < v < H-1)
  * SDF running average with +1e-4 sigma in the denominator
  * update band  -0.03 < dist < truncation + resolution·√3
  * weight ≤ 0.5 after update ⇒ voxel resets to (sdf=999, w=0)
  * color updated in band |dist| < resolution·√3/2 + 0.01 with saturation
    rescale (÷4 when an accumulator channel exceeds 120, byte scale)
  * per-chunk observation quality = Σ quality-map over color-updated voxels,
    poisoned to -1e11 when the chunk projects partially out of the image
    (ref: ProjectionIntegrator.cpp:212-238)
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.config import TSDFConfig
from texturefusion_tpu.core import camera as cam
from texturefusion_tpu.core import geometry

RESET_SDF = 999.0


class ChunkBatch(NamedTuple):
    """Per-chunk-slot TSDF arrays for a batch of U chunks."""

    sdf: jnp.ndarray           # [U, V] f32, RESET_SDF when unobserved
    weight: jnp.ndarray        # [U, V] f32
    color: jnp.ndarray         # [U, V, 3] f32 accumulators (byte scale 0-255)
    color_count: jnp.ndarray   # [U, V] f32 observation-count accumulator


def truncation_distance(z: jnp.ndarray, cfg: TSDFConfig) -> jnp.ndarray:
    """|q·z² + l·z + c| · scale (ref: QuadraticTruncator.h:45-48)."""
    return jnp.abs(cfg.truncation_quad * z * z + cfg.truncation_linear * z
                   + cfg.truncation_const) * cfg.truncation_scale


@functools.partial(jax.jit, static_argnames=("intr", "cfg", "with_color"))
def integrate_chunks(
    batch: ChunkBatch,
    origins: jnp.ndarray,          # [U, 3] world chunk origins (min corner)
    active: jnp.ndarray,           # [U] bool — padded rows are inert
    depth: jnp.ndarray,            # [H, W] meters, 0 = invalid
    rgb: jnp.ndarray,              # [H, W, 3] float 0..1 (ignored if not with_color)
    quality_map: jnp.ndarray,      # [H, W] observation quality (0 ok)
    cam_to_world: jnp.ndarray,     # [4, 4] camera pose
    sign: jnp.ndarray,             # scalar ±1.0: integrate / de-integrate
    intr: cam.Intrinsics,
    cfg: TSDFConfig,
    with_color: bool = True,
) -> Tuple[ChunkBatch, jnp.ndarray, jnp.ndarray]:
    """Returns (updated batch, per-chunk observation quality [U],
    per-chunk updated flag [U])."""
    from texturefusion_tpu.core import se3

    u_chunks, v_voxels = batch.sdf.shape
    res = cfg.voxel_resolution
    res_diag = float(np.sqrt(3.0)) * res

    centroids = jnp.asarray(geometry.voxel_centroids(cfg.chunk_size, res))  # [V,3]
    world = origins[:, None, :] + centroids[None, :, :]                     # [U,V,3]

    world_to_cam = se3.inverse(cam_to_world)
    pts_cam = se3.transform_points(world_to_cam, world.reshape(-1, 3)).reshape(u_chunks, v_voxels, 3)
    z_vox = pts_cam[..., 2]

    uv, _ = cam.project(intr, pts_cam)
    ui = jnp.round(uv[..., 0]).astype(jnp.int32)
    vi = jnp.round(uv[..., 1]).astype(jnp.int32)
    # strict interior like the reference's SIMD bounds checks
    in_img = ((ui > 0) & (ui < intr.width - 1) & (vi > 0) & (vi < intr.height - 1)
              & (z_vox > 0))
    flat = jnp.clip(vi, 0, intr.height - 1) * intr.width + jnp.clip(ui, 0, intr.width - 1)

    if with_color:
        # ONE gather for all per-pixel data: [HW, 5] = depth|rgb|quality
        # (three separate gathers triple the dominant HBM cost)
        packed = jnp.concatenate(
            [depth.reshape(-1, 1), rgb.reshape(-1, 3) * 255.0,
             quality_map.reshape(-1, 1)], axis=-1)
        g = packed[flat]                                                   # [U,V,5]
        d = jnp.where(in_img, g[..., 0], 0.0)
    else:
        depth_flat = depth.reshape(-1)
        d = jnp.where(in_img, depth_flat[flat], 0.0)                       # [U,V]
    surface_dist = d - z_vox

    # truncation once per chunk, at the chunk origin's camera depth
    origin_cam = se3.transform_points(world_to_cam, origins[:, None, :])[:, 0, :]
    trunc = truncation_distance(origin_cam[..., 2], cfg)                    # [U]

    depth_ok = (d > intr.near) & (d < intr.far)
    band = (surface_dist > -0.03) & (surface_dist < (trunc[:, None] + res_diag))
    upd = in_img & depth_ok & band & active[:, None]

    w_in = jnp.where(upd, cfg.integration_weight * sign, 0.0)
    new_w = batch.weight + w_in
    new_sdf = (batch.sdf * batch.weight + surface_dist * w_in) / (new_w + 1e-4)
    # voxels never touched keep their state exactly
    new_sdf = jnp.where(upd, new_sdf, batch.sdf)
    new_w = jnp.where(upd, new_w, batch.weight)
    # weight-validity reset (ref: weight ≤ 0.5 ⇒ sdf=999, w=0)
    dead = upd & (new_w <= cfg.min_weight)
    new_sdf = jnp.where(dead, RESET_SDF, new_sdf)
    new_w = jnp.where(dead, 0.0, new_w)

    quality = jnp.zeros((u_chunks,), batch.sdf.dtype)
    new_color = batch.color
    new_ccnt = batch.color_count
    if with_color:
        color_band = jnp.abs(surface_dist) < (res_diag * 0.5 + cfg.color_band_pad)
        cupd = in_img & depth_ok & color_band & active[:, None]
        rgb255 = jnp.where(cupd[..., None], g[..., 1:4], 0.0)               # [U,V,3]
        csign = jnp.where(cupd, sign, 0.0)
        new_color = batch.color + rgb255 * sign
        new_ccnt = batch.color_count + csign
        # saturation: any channel > 120 after an integrate ⇒ ÷4 (incl. count)
        sat = (jnp.max(new_color, axis=-1) > cfg.color_saturation) & (sign > 0) & cupd
        new_color = jnp.where(sat[..., None], new_color * 0.25, new_color)
        new_ccnt = jnp.where(sat, new_ccnt * 0.25, new_ccnt)
        new_color = jnp.where(cupd[..., None], new_color, batch.color)
        new_ccnt = jnp.where(cupd, new_ccnt, batch.color_count)

        qv = jnp.where(cupd, g[..., 4], 0.0)
        quality = jnp.sum(qv, axis=-1)
        # partial-observation veto: chunk has voxels projecting out of image
        partial = jnp.any(~in_img & active[:, None] & (z_vox > 0), axis=-1)
        behind = jnp.any(z_vox <= 0, axis=-1) & active
        quality = jnp.where(partial | behind, -1e11, quality)

    updated = jnp.any(upd, axis=-1)
    return (ChunkBatch(new_sdf, new_w, new_color, new_ccnt), quality, updated)


@functools.partial(jax.jit, static_argnames=("intr", "cfg", "stride", "n_band"))
def candidate_chunk_coords(
    depth: jnp.ndarray,
    cam_to_world: jnp.ndarray,
    intr: cam.Intrinsics,
    cfg: TSDFConfig,
    stride: int = 1,
    n_band: int = 5,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Chunk IDs whose truncation band is touched by this depth map.

    Replaces the reference's AVX chunk culling scan
    (ref: ChunkManager.h:303-636 GetBoundaryChunkID /
    CheckCornerIntersectingSIMD + GetChunkIDsObservedByCamera:380-559):
    instead of testing every chunk in a bounding box against the frustum,
    we go the other way — subsample the depth map, walk each ray across
    the truncation band, and emit the chunk ID containing every sample.
    Host code uniquifies. Returns ([N, 3] int32 ids, [N] valid mask).
    """
    from texturefusion_tpu.core import se3

    d = depth[::stride, ::stride]
    h, w = d.shape
    u = (jnp.arange(w, dtype=jnp.float32) * stride)[None, :].repeat(h, 0)
    v = (jnp.arange(h, dtype=jnp.float32) * stride)[:, None].repeat(w, 1)
    valid = (d > intr.near) & (d < intr.far)

    trunc = truncation_distance(d, cfg) + float(np.sqrt(3.0)) * cfg.voxel_resolution
    # band offsets spanning [-trunc, +trunc] in depth
    offs = jnp.linspace(-1.0, 1.0, n_band)
    z = d[None, ...] + offs[:, None, None] * trunc[None, ...]               # [B,h,w]
    pts_cam = cam.unproject(intr, u[None], v[None], z)
    pts_w = se3.transform_points(cam_to_world, pts_cam.reshape(-1, 3))
    extent = cfg.chunk_size * cfg.voxel_resolution
    ids = geometry.world_to_chunk(pts_w, extent)
    mask = jnp.broadcast_to(valid[None], z.shape).reshape(-1)
    return ids, mask


# Chunk-ID sort keys are packed 3×10 bits into int32 (x64 is disabled):
# chunk coords must lie in ±512, i.e. maps up to ±512·chunk_extent
# (±82m at 2cm voxels). Larger scenes should re-base chunk IDs around a
# moving map origin.
_KEY_BITS = 10
_KEY_OFF = 1 << (_KEY_BITS - 1)
_KEY_SENTINEL = jnp.iinfo(jnp.int32).max


@functools.partial(jax.jit,
                   static_argnames=("intr", "cfg", "stride", "n_band", "max_out"))
def candidate_chunks_unique(
    depth: jnp.ndarray,
    cam_to_world: jnp.ndarray,
    intr: cam.Intrinsics,
    cfg: TSDFConfig,
    stride: int = 1,
    n_band: int = 5,
    max_out: int = 4096,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """candidate_chunk_coords + ON-DEVICE dedup via sort-compaction.

    The raw candidate stream is ~1.5M IDs per VGA frame; transferring it
    to the host costs more than the whole voxel update. Here IDs are
    packed to int64 keys, sorted on device, compacted to the unique
    prefix, and only [max_out, 3] ids + a count are read back.
    Returns (ids [max_out, 3] int32, n_unique scalar). Overflow beyond
    max_out is dropped (callers can check n_unique == max_out).
    """
    ids, mask = candidate_chunk_coords(depth, cam_to_world, intr, cfg,
                                       stride=stride, n_band=n_band)
    x = jnp.clip(ids[:, 0] + _KEY_OFF, 0, 2 * _KEY_OFF - 1).astype(jnp.int32)
    y = jnp.clip(ids[:, 1] + _KEY_OFF, 0, 2 * _KEY_OFF - 1).astype(jnp.int32)
    z = jnp.clip(ids[:, 2] + _KEY_OFF, 0, 2 * _KEY_OFF - 1).astype(jnp.int32)
    in_range = (jnp.abs(ids) < _KEY_OFF).all(axis=-1)
    key = (x << (2 * _KEY_BITS)) | (y << _KEY_BITS) | z
    key = jnp.where(mask & in_range, key, _KEY_SENTINEL)
    skey = jnp.sort(key)
    first = jnp.concatenate([jnp.asarray([True]), skey[1:] != skey[:-1]])
    first = first & (skey != _KEY_SENTINEL)
    pos = jnp.cumsum(first) - 1
    dest = jnp.where(first & (pos < max_out), pos, max_out)
    out = jnp.full((max_out + 1,), _KEY_SENTINEL, jnp.int32)
    out = out.at[dest].min(jnp.where(first, skey, _KEY_SENTINEL))[:max_out]
    n = jnp.minimum(jnp.sum(first), max_out)
    mask21 = (1 << _KEY_BITS) - 1
    ox = ((out >> (2 * _KEY_BITS)) & mask21) - _KEY_OFF
    oy = ((out >> _KEY_BITS) & mask21) - _KEY_OFF
    oz = (out & mask21) - _KEY_OFF
    return jnp.stack([ox, oy, oz], axis=-1).astype(jnp.int32), n


@functools.partial(jax.jit, static_argnames=("intr", "cfg", "with_color"),
                   donate_argnames=("batch",))
def integrate_frame_fused(
    batch: ChunkBatch,             # FULL slot arrays [S+1, ...] (donated)
    origins_full: jnp.ndarray,     # [S+1, 3]
    idx: jnp.ndarray,              # [U] slot indices (trash-padded)
    active: jnp.ndarray,           # [U]
    depth: jnp.ndarray,
    rgb: jnp.ndarray,
    quality_map: jnp.ndarray,
    cam_to_world: jnp.ndarray,
    sign: jnp.ndarray,
    intr: cam.Intrinsics,
    cfg: TSDFConfig,
    with_color: bool = True,
) -> Tuple[ChunkBatch, jnp.ndarray, jnp.ndarray]:
    """Gather chunk rows, run the voxel update, scatter back — one
    compiled program, one dispatch, buffers donated (in-place on device).
    """
    sub = ChunkBatch(*(a[idx] for a in batch))
    sub, quality, updated = integrate_chunks(
        sub, origins_full[idx], active, depth, rgb, quality_map,
        cam_to_world, sign, intr, cfg, with_color=with_color)
    out = ChunkBatch(*(full.at[idx].set(part)
                       for full, part in zip(batch, sub)))
    return out, quality, updated


@functools.partial(jax.jit, static_argnames=("intr", "cfg", "with_color"),
                   donate_argnames=("batch",))
def reintegrate_frame_fused(
    batch: ChunkBatch,             # FULL slot arrays [S+1, ...] (donated)
    origins_full: jnp.ndarray,     # [S+1, 3]
    idx: jnp.ndarray,              # [U] slot indices (trash-padded)
    active: jnp.ndarray,           # [U]
    depth: jnp.ndarray,
    rgb: jnp.ndarray,
    quality_map: jnp.ndarray,
    pose_old: jnp.ndarray,         # de-integration pose (pose_sophus[1])
    pose_new: jnp.ndarray,         # re-integration pose (pose_sophus[0])
    intr: cam.Intrinsics,
    cfg: TSDFConfig,
    with_color: bool = True,
) -> Tuple[ChunkBatch, jnp.ndarray, jnp.ndarray]:
    """Fused de-integrate @ pose_old + re-integrate @ pose_new: ONE
    gather of the keyframe's chunk rows, two sequential voxel updates
    (bit-identical to separate de-/re-integration programs), one
    scatter — half the HBM row traffic and one dispatch instead of two
    (ref: ReIntegrateKeyframe runs the two passes back-to-back over the
    same recorded chunk set, MobileFusion.cpp:114-221). Returns the new
    batch plus the RE-integration's per-chunk observation quality and
    updated mask (the de-integration's obs entries are retracted host-side,
    ref: RetractObservations MobileFusion.cpp:252-272)."""
    sub = ChunkBatch(*(a[idx] for a in batch))
    origins = origins_full[idx]
    sub, _, _ = integrate_chunks(
        sub, origins, active, depth, rgb, quality_map, pose_old,
        jnp.float32(-1.0), intr, cfg, with_color=with_color)
    sub, quality, updated = integrate_chunks(
        sub, origins, active, depth, rgb, quality_map, pose_new,
        jnp.float32(1.0), intr, cfg, with_color=with_color)
    out = ChunkBatch(*(full.at[idx].set(part)
                       for full, part in zip(batch, sub)))
    return out, quality, updated


@functools.partial(jax.jit, static_argnames=("intr", "cfg"),
                   donate_argnames=("batch",))
def integrate_depths_scan(
    batch: ChunkBatch,             # FULL slot arrays [S+1, ...] (donated)
    origins_full: jnp.ndarray,     # [S+1, 3]
    idx: jnp.ndarray,              # [U] slot indices (trash-padded)
    active: jnp.ndarray,           # [U]
    depths: jnp.ndarray,           # [F, H, W] depth-only frames
    cam_to_worlds: jnp.ndarray,    # [F, 4, 4]
    sign: jnp.ndarray,
    intr: cam.Intrinsics,
    cfg: TSDFConfig,
) -> ChunkBatch:
    """Depth-only integration of F frames into one chunk set in a single
    compiled program (lax.scan over frames) — the reference integrates a
    keyframe's tracked local frames one by one on the map thread
    (ref: MobileFusion.cpp:187-203); here all of them cost ONE dispatch.
    """
    sub = ChunkBatch(*(a[idx] for a in batch))
    zero_img = jnp.zeros((intr.height, intr.width), depths.dtype)
    rgb = jnp.zeros((intr.height, intr.width, 3), depths.dtype)
    origins = origins_full[idx]

    def body(carry, fr):
        depth, pose = fr
        out, _, _ = integrate_chunks(carry, origins, active, depth, rgb,
                                     zero_img, pose, sign, intr, cfg,
                                     with_color=False)
        return out, None

    sub, _ = jax.lax.scan(body, sub, (depths, cam_to_worlds))
    return ChunkBatch(*(full.at[idx].set(part)
                        for full, part in zip(batch, sub)))


@functools.partial(jax.jit, static_argnames=("intr", "cfg"),
                   donate_argnames=("batch",))
def integrate_depths_batched(
    batch: ChunkBatch,             # FULL slot arrays [S+1, ...] (donated)
    origins_full: jnp.ndarray,     # [S+1, 3]
    idx: jnp.ndarray,              # [U] slot indices (trash-padded)
    active: jnp.ndarray,           # [U]
    depths: jnp.ndarray,           # [F, H, W] depth-only frames
    cam_to_worlds: jnp.ndarray,    # [F, 4, 4]
    sign: jnp.ndarray,
    intr: cam.Intrinsics,
    cfg: TSDFConfig,
) -> ChunkBatch:
    """Depth-only integration of F frames in ONE pass over the chunk
    arrays. The sequential running average commutes:
        s_F = (s_0 w_0 + Σ_f d_f a_f) / (w_0 + Σ_f a_f)
    so the per-frame projections/masks are computed batched [F, U, V] and
    reduced over F before a single read-modify-write of the chunk rows —
    integrate_depths_scan walks the rows F times (F× the HBM traffic for
    the same arithmetic). Semantics deviation vs the scan: the weight-
    validity reset (w ≤ 0.5 → sdf=999) applies once after the combined
    update instead of between frames — indistinguishable in practice and
    identical whenever no intermediate reset fires.
    (ref: MobileFusion.cpp:187-203 integrates local frames one by one.)
    """
    from texturefusion_tpu.core import se3

    u_chunks = idx.shape[0]
    res = cfg.voxel_resolution
    res_diag = float(np.sqrt(3.0)) * res
    v_voxels = batch.sdf.shape[1]

    sub = ChunkBatch(*(a[idx] for a in batch))
    origins = origins_full[idx]

    centroids = jnp.asarray(geometry.voxel_centroids(cfg.chunk_size, res))
    world = origins[:, None, :] + centroids[None, :, :]          # [U,V,3]

    def per_frame(depth, pose, sgn):
        world_to_cam = se3.inverse(pose)
        pts = se3.transform_points(world_to_cam, world.reshape(-1, 3)
                                   ).reshape(u_chunks, v_voxels, 3)
        z_vox = pts[..., 2]
        uv, _ = cam.project(intr, pts)
        ui = jnp.round(uv[..., 0]).astype(jnp.int32)
        vi = jnp.round(uv[..., 1]).astype(jnp.int32)
        in_img = ((ui > 0) & (ui < intr.width - 1) & (vi > 0)
                  & (vi < intr.height - 1) & (z_vox > 0))
        flat = (jnp.clip(vi, 0, intr.height - 1) * intr.width
                + jnp.clip(ui, 0, intr.width - 1))
        d = jnp.where(in_img, depth.reshape(-1)[flat], 0.0)
        surface_dist = d - z_vox
        origin_cam = se3.transform_points(world_to_cam,
                                          origins[:, None, :])[:, 0, :]
        trunc = truncation_distance(origin_cam[..., 2], cfg)
        depth_ok = (d > intr.near) & (d < intr.far)
        band = ((surface_dist > -0.03)
                & (surface_dist < (trunc[:, None] + res_diag)))
        upd = in_img & depth_ok & band & active[:, None]
        a = jnp.where(upd, cfg.integration_weight * sgn, 0.0)
        return a, a * surface_dist

    # sign may be a scalar (one pass) or [F] per-frame (fused de+re-
    # integration stacks old-pose frames with sign −1 and new-pose
    # frames with +1 — the weighted running average commutes, so one
    # combined read-modify-write is exact up to the reset note above)
    signs = jnp.broadcast_to(jnp.atleast_1d(sign), (depths.shape[0],))
    a_sum, ad_sum = jax.vmap(per_frame)(depths, cam_to_worlds, signs)
    a = jnp.sum(a_sum, axis=0)                                   # [U,V]
    ad = jnp.sum(ad_sum, axis=0)
    touched = a != 0.0
    new_w = sub.weight + a
    new_sdf = (sub.sdf * sub.weight + ad) / (new_w + 1e-4)
    new_sdf = jnp.where(touched, new_sdf, sub.sdf)
    new_w = jnp.where(touched, new_w, sub.weight)
    dead = touched & (new_w <= cfg.min_weight)
    new_sdf = jnp.where(dead, RESET_SDF, new_sdf)
    new_w = jnp.where(dead, 0.0, new_w)
    sub = ChunkBatch(new_sdf, new_w, sub.color, sub.color_count)
    return ChunkBatch(*(full.at[idx].set(part)
                        for full, part in zip(batch, sub)))


def make_empty_batch(u: int, v: int, dtype=jnp.float32) -> ChunkBatch:
    return ChunkBatch(
        sdf=jnp.full((u, v), RESET_SDF, dtype),
        weight=jnp.zeros((u, v), dtype),
        color=jnp.zeros((u, v, 3), dtype),
        color_count=jnp.zeros((u, v), dtype),
    )
