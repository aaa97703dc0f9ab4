"""TSDF raycasting: render depth/normal/color images from the volume.

Replaces open_chisel's DDA raycaster (ref: open_chisel/geometry/
Raycast.cpp) and stands in for the reference's OpenGL visualization
(ref: Shaders/draw_mesh.vert/frag + MobileShow MobileFusion.h:318-514)
with an offline, device-side renderer: sphere-trace every camera ray through
the trilinear-interpolated TSDF. Useful for verification (render the map
from any pose and compare against input frames) and for debugging
reconstruction quality without a GL stack.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from texturefusion_tpu.config import TSDFConfig
from texturefusion_tpu.core import camera as cam
from texturefusion_tpu.core import geometry
from texturefusion_tpu.core import se3
from texturefusion_tpu.ops.tsdf import RESET_SDF


class RaycastResult(NamedTuple):
    depth: jnp.ndarray    # [H, W] z-depth, 0 where no surface hit
    normals: jnp.ndarray  # [H, W, 3]
    color: jnp.ndarray    # [H, W, 3]
    hit: jnp.ndarray      # [H, W] bool


def _sample(table, lo, trash, sdf, weight, color, ccnt, pts, chunk_size, res):
    """Trilinear TSDF + color sample at world points (..., 3)."""
    g = pts / res - 0.5
    g0 = jnp.floor(g).astype(jnp.int32)
    frac = g - g0.astype(g.dtype)
    w8 = geometry.trilinear_weights(frac)
    corners = jnp.asarray(
        [[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)], jnp.int32)
    vox = g0[..., None, :] + corners
    cid = jnp.floor_divide(vox, chunk_size)
    local = vox - cid * chunk_size
    rel = cid - lo
    shp = jnp.asarray(table.shape, rel.dtype)
    inb = jnp.all((rel >= 0) & (rel < shp), axis=-1)
    relc = jnp.clip(rel, 0, shp - 1)
    slot = jnp.where(inb, table[relc[..., 0], relc[..., 1], relc[..., 2]], trash)
    lin = (local[..., 0] + local[..., 1] * chunk_size
           + local[..., 2] * chunk_size * chunk_size)
    s8 = sdf[slot, lin]
    w8v = weight[slot, lin]
    ok = jnp.all((w8v > 0) & (jnp.abs(s8) < RESET_SDF * 0.5), axis=-1)
    val = jnp.sum(w8 * s8, axis=-1)
    cnt = jnp.maximum(ccnt[slot, lin], 1e-6)
    c8 = color[slot, lin] / cnt[..., None] / 255.0
    col = jnp.sum(w8[..., None] * c8, axis=-2)
    return jnp.where(ok, val, RESET_SDF), ok, col


@functools.partial(jax.jit, static_argnames=("intr", "cfg", "n_steps"))
def raycast(sdf: jnp.ndarray, weight: jnp.ndarray, color: jnp.ndarray,
            color_count: jnp.ndarray, table: jnp.ndarray, lo: jnp.ndarray,
            trash: int, cam_to_world: jnp.ndarray, intr: cam.Intrinsics,
            cfg: TSDFConfig, n_steps: int = 128) -> RaycastResult:
    """Sphere-trace all rays of a virtual camera through the TSDF."""
    res = cfg.voxel_resolution
    u, v = cam.pixel_grid(intr)
    dirs_cam = cam.unproject(intr, u, v, jnp.ones_like(u))
    dirs_cam = dirs_cam / jnp.linalg.norm(dirs_cam, axis=-1, keepdims=True)
    rot = cam_to_world[:3, :3]
    dirs_w = jnp.einsum("hwj,ij->hwi", dirs_cam, rot,
                        precision=jax.lax.Precision.HIGHEST)
    origin = cam_to_world[:3, 3]

    # step while outside observed space: must stay below the truncation
    # shell thickness or rays leap straight over the surface band
    coarse = 3.0 * res

    def body(_, t):
        p = origin + dirs_w * t[..., None]
        s, ok, _ = _sample(table, lo, trash, sdf, weight, color, color_count,
                           p, cfg.chunk_size, res)
        # outside observed space: stride a chunk; inside: sphere-trace
        step = jnp.where(ok, jnp.clip(s, -2.0 * res, 4.0 * res), coarse)
        return t + step

    t0 = jnp.full(u.shape, intr.near)
    t = jax.lax.fori_loop(0, n_steps, body, t0)
    p = origin + dirs_w * t[..., None]
    s, ok, col = _sample(table, lo, trash, sdf, weight, color, color_count,
                         p, cfg.chunk_size, res)
    hit = ok & (jnp.abs(s) < 1.5 * res) & (t < intr.far * 2.0)

    # normals: central differences of the TSDF at the hit point
    eps = res

    def grad_axis(axis):
        e = jnp.zeros(3).at[axis].set(eps)
        sp, okp, _ = _sample(table, lo, trash, sdf, weight, color, color_count,
                             p + e, cfg.chunk_size, res)
        sm, okm, _ = _sample(table, lo, trash, sdf, weight, color, color_count,
                             p - e, cfg.chunk_size, res)
        return jnp.where(okp & okm, sp - sm, 0.0)

    n = jnp.stack([grad_axis(0), grad_axis(1), grad_axis(2)], axis=-1)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)

    depth = t * dirs_cam[..., 2]
    return RaycastResult(
        depth=jnp.where(hit, depth, 0.0),
        normals=jnp.where(hit[..., None], n, 0.0),
        color=jnp.where(hit[..., None], col, 0.0),
        hit=hit,
    )


@functools.partial(jax.jit, static_argnames=("intr", "cfg", "iters"))
def refine_depth_to_isosurface(sdf: jnp.ndarray, weight: jnp.ndarray,
                               table: jnp.ndarray, lo: jnp.ndarray,
                               trash: int, depth: jnp.ndarray,
                               cam_to_world: jnp.ndarray,
                               intr: cam.Intrinsics, cfg: TSDFConfig,
                               iters: int = 3) -> jnp.ndarray:
    """Snap a depth map onto the fused model's isosurface: iteratively
    move each depth sample along its ray by the local TSDF value
    (ref: Chisel.h:377-451 RefineFrameInVoxel — iterative
    depth-to-isosurface projection; GetDistanceFromSurface :251-342)."""
    res = cfg.voxel_resolution
    u, v = cam.pixel_grid(intr)
    origin = cam_to_world[:3, 3]
    rot = cam_to_world[:3, :3]
    dirs_cam = cam.unproject(intr, u, v, jnp.ones_like(u))
    ray_scale = jnp.linalg.norm(dirs_cam, axis=-1)        # |dir| per unit z
    dirs_w = jnp.einsum("hwj,ij->hwi", dirs_cam / ray_scale[..., None], rot,
                        precision=jax.lax.Precision.HIGHEST)

    zeros3 = jnp.zeros(sdf.shape + (3,))
    zeros1 = jnp.zeros(sdf.shape)

    def body(_, z):
        t = z * ray_scale
        p = origin + dirs_w * t[..., None]
        s, ok, _ = _sample(table, lo, trash, sdf, weight, zeros3, zeros1,
                           p, cfg.chunk_size, res)
        step = jnp.where(ok & (jnp.abs(s) < 3 * res), s, 0.0)
        return z + step / ray_scale

    z = jax.lax.fori_loop(0, iters, body, depth)
    return jnp.where(depth > 0, z, 0.0)


def raycast_volume(volume, cam_to_world, intr=None, n_steps: int = 128
                   ) -> RaycastResult:
    """Convenience wrapper over a TSDFVolume."""
    table = volume._slot_table()
    if intr is None:
        intr = volume.intr
    return raycast(volume.batch.sdf, volume.batch.weight, volume.batch.color,
                   volume.batch.color_count, table.table, table.lo,
                   table.trash, jnp.asarray(cam_to_world), intr,
                   volume.cfg, n_steps=n_steps)
