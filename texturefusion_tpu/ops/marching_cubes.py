"""Incremental marching cubes over TSDF chunks as a batched XLA program.

JAX re-design of open_chisel's per-chunk mesher
(ref: Structure/ChunkManager.cpp:595-1004 GenerateMeshEfficient): the
reference walks voxels serially, gathering cross-chunk SDF through neighbor
pointers and deduplicating vertices through 3×729 per-edge arrays
(ref: ChunkManager.cpp:645-647). Here the same per-edge-ownership trick
becomes the *output layout*: each chunk emits a dense [3·9³] edge-vertex
buffer plus a [8³·MAX_TRIS·3] index buffer of edge ids, computed by one
batched kernel over all dirty chunks at once. Host code compacts the
padded buffers into a render/export mesh.

Cross-chunk access: each chunk reads a 9³ SDF/weight/color block assembled
by gathering from itself + its 7 corner neighbors (+x, +y, +z, ... +xyz),
exactly the neighbor set of the reference's pointer table
(ref: ChunkManager.cpp:608-633). Normals are SDF gradients
(ref: ChunkManager.cpp:277-455 extractGradientFromCubic).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.ops import mc_tables
from texturefusion_tpu.ops.tsdf import RESET_SDF

B = 9               # block side: chunk 8³ + 1 shared layer
B3 = B * B * B      # 729
N_EDGE_VERTS = 3 * B3


def _block_luts(chunk_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """For each 9³ block voxel: (neighbor choice 0..7, linear index within
    that neighbor chunk). Neighbor choice bits: 1=+x, 2=+y, 4=+z."""
    s = chunk_size
    coords = np.stack(np.meshgrid(np.arange(B), np.arange(B), np.arange(B),
                                  indexing="ij"), axis=-1).reshape(-1, 3)
    nbr = (coords[:, 0] // s) + 2 * (coords[:, 1] // s) + 4 * (coords[:, 2] // s)
    local = coords % s
    lin = local[:, 0] + local[:, 1] * s + local[:, 2] * s * s  # x-fastest
    return nbr.astype(np.int32), lin.astype(np.int32)


def _grid_lin(coords: np.ndarray) -> np.ndarray:
    """9³ grid coords (..., 3) -> linear id (x*81 + y*9 + z)."""
    return (coords[..., 0] * B + coords[..., 1]) * B + coords[..., 2]


class ChunkMesh(NamedTuple):
    """Padded per-chunk mesh buffers (batch dimension U leading)."""

    positions: jnp.ndarray   # [U, 3·729, 3] world-space edge vertices
    normals: jnp.ndarray     # [U, 3·729, 3]
    colors: jnp.ndarray      # [U, 3·729, 3] in [0, 1]
    vert_valid: jnp.ndarray  # [U, 3·729] bool
    triangles: jnp.ndarray   # [U, 8³·MAX_TRIS, 3] int32 edge ids, -1 padded


@functools.partial(jax.jit, static_argnames=("chunk_size", "resolution"))
def mesh_chunks(
    sdf: jnp.ndarray,          # [S, V] full slot arrays
    weight: jnp.ndarray,       # [S, V]
    color: jnp.ndarray,        # [S, V, 3] accumulators (byte scale)
    color_count: jnp.ndarray,  # [S, V]
    slots: jnp.ndarray,        # [U] chunk slots to mesh
    nbr_slots: jnp.ndarray,    # [U, 8] slot of self+7 neighbors (trash if absent)
    origins: jnp.ndarray,      # [U, 3] world origin of each chunk
    chunk_size: int,
    resolution: float,
) -> ChunkMesh:
    # ---- assemble 9³ blocks by gathering self + 7 corner neighbors
    nbr_lut, lin_lut = _block_luts(chunk_size)
    nbr_lut = jnp.asarray(nbr_lut)
    lin_lut = jnp.asarray(lin_lut)
    src_slot = nbr_slots[:, nbr_lut]                  # [U, 729]
    # linearized 1D gathers (2D advanced indexing lowers to a general
    # gather)
    V = sdf.shape[1]
    flat_idx = src_slot * V + lin_lut                 # [U, 729]
    s_blk = jnp.take(sdf.reshape(-1), flat_idx)       # [U, 729]
    w_blk = jnp.take(weight.reshape(-1), flat_idx)
    cnt = jnp.maximum(jnp.take(color_count.reshape(-1), flat_idx), 1e-6)
    c_blk = (jnp.take(color.reshape(-1, 3), flat_idx.reshape(-1), axis=0)
             .reshape(flat_idx.shape + (3,)) / cnt[..., None] / 255.0)

    s3 = s_blk.reshape(-1, B, B, B)
    w3 = w_blk.reshape(-1, B, B, B)
    observed3 = (w3 > 0) & (jnp.abs(s3) < RESET_SDF * 0.5)

    # ---- SDF gradient at grid nodes (one-sided at block boundaries)
    def grad_axis(f, axis):
        upper = jnp.roll(f, -1, axis)
        lower = jnp.roll(f, 1, axis)
        n = f.shape[axis]
        idx = jnp.arange(n)
        shape = [1, 1, 1, 1]
        shape[axis] = n
        idx = idx.reshape(shape)
        central = (upper - lower) * 0.5
        fwd = upper - f
        bwd = f - lower
        g = jnp.where(idx == 0, fwd, jnp.where(idx == n - 1, bwd, central))
        return g

    gx = grad_axis(s3, 1)
    gy = grad_axis(s3, 2)
    gz = grad_axis(s3, 3)
    g3 = jnp.stack([gx, gy, gz], axis=-1).reshape(-1, B3, 3)

    # ---- per-edge vertices (dedup by ownership: axis × 9³ origin)
    coords = np.stack(np.meshgrid(np.arange(B), np.arange(B), np.arange(B),
                                  indexing="ij"), axis=-1).reshape(-1, 3)
    grid_pos = jnp.asarray(coords, jnp.float32)       # [729, 3]

    pos_list, nrm_list, col_list, val_list = [], [], [], []
    for axis in range(3):
        step = np.zeros(3, np.int32)
        step[axis] = 1
        nb_coords = coords + step
        in_range = (nb_coords < B).all(axis=-1)
        nb_lin = _grid_lin(np.clip(nb_coords, 0, B - 1))
        nb_lin = jnp.asarray(nb_lin)
        in_range = jnp.asarray(in_range)

        s0 = s_blk                                    # [U, 729]
        s1 = s_blk[:, nb_lin]
        ob0 = observed3.reshape(-1, B3)
        ob1 = ob0[:, nb_lin]
        crossing = (s0 * s1 < 0) & ob0 & ob1 & in_range[None, :]
        t = s0 / jnp.where(jnp.abs(s0 - s1) > 1e-12, s0 - s1, 1e-12)
        t = jnp.clip(t, 0.0, 1.0)
        p = (grid_pos[None] + t[..., None] * jnp.asarray(step, jnp.float32))
        pos_list.append(p)
        c0 = c_blk
        c1 = c_blk[:, nb_lin]
        col_list.append(c0 + (c1 - c0) * t[..., None])
        g0 = g3
        g1 = g3[:, nb_lin]
        n = g0 + (g1 - g0) * t[..., None]
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        nrm_list.append(n)
        val_list.append(crossing)

    positions = (jnp.concatenate(pos_list, axis=1) * resolution
                 + origins[:, None, :] + 0.5 * resolution)
    # +0.5·res because grid node (i,j,k) is the *center* of voxel (i,j,k)
    normals = jnp.concatenate(nrm_list, axis=1)
    colors = jnp.clip(jnp.concatenate(col_list, axis=1), 0.0, 1.0)
    vert_valid = jnp.concatenate(val_list, axis=1)

    # ---- per-voxel case index + triangle emission
    s = chunk_size
    vox = np.stack(np.meshgrid(np.arange(s), np.arange(s), np.arange(s),
                               indexing="ij"), axis=-1).reshape(-1, 3)  # [512,3]
    corner_lin = _grid_lin(vox[:, None, :] + mc_tables.CORNER_OFFSETS[None])  # [512,8]
    corner_lin = jnp.asarray(corner_lin)
    cs = s_blk[:, corner_lin]                         # [U, 512, 8]
    cob = observed3.reshape(-1, B3)[:, corner_lin]
    cell_ok = jnp.all(cob, axis=-1)
    bits = (cs < 0).astype(jnp.int32)
    case = jnp.sum(bits * (1 << jnp.arange(8, dtype=jnp.int32))[None, None, :], axis=-1)
    case = jnp.where(cell_ok, case, 0)

    tri_edges = jnp.asarray(mc_tables.TRI_TABLE)      # [256, MAX_TRIS*3]
    local_e = tri_edges[case]                         # [U, 512, MAX_TRIS*3]

    # map local edge id -> global grid edge id for each voxel
    e_axis = jnp.asarray(mc_tables.EDGE_AXIS)         # [12]
    e_origin_lin = _grid_lin(vox[:, None, :] + mc_tables.EDGE_ORIGIN[None])  # [512,12]
    e_global = jnp.asarray(e_origin_lin) + jnp.asarray(mc_tables.EDGE_AXIS)[None, :] * B3
    safe_local = jnp.maximum(local_e, 0)
    gid = jnp.take_along_axis(
        jnp.broadcast_to(e_global[None], (case.shape[0],) + e_global.shape),
        safe_local, axis=-1)
    gid = jnp.where(local_e >= 0, gid, -1)
    triangles = gid.reshape(case.shape[0], -1, 3)     # [U, 512*MAX_TRIS, 3]
    return ChunkMesh(positions, normals, colors, vert_valid, triangles)


class CompactMesh(NamedTuple):
    """Device-compacted mesh: flat arrays holding only REAL geometry.

    Fetching the padded ChunkMesh buffers costs ~60-80 MB over the
    host↔device link per 512-chunk batch; this on-device prefix-sum
    compaction reduces the transfer to bytes-proportional-to-surface
    (the reference reads its mesh directly from CPU memory,
    ref: Chisel.cpp:288-355 DrawMeshes — our equivalent must cross a
    link, so the compaction IS the hot-path design point).

    Vertex records pack all attributes into 5 u32 words so compaction is
    ONE scatter and the host fetch is ONE contiguous transfer:
      word 0-2: position xyz (f32 bitcast)
      word 3:   normal, 3×(int8+127) channels
      word 4:   color, 3×uint8 channels
    """

    vert_rec: jnp.ndarray    # [vert_cap, 5] uint32 packed records
    triangles: jnp.ndarray   # [tri_cap, 3] int32 CHUNK-LOCAL vertex ids
    vcount: jnp.ndarray      # [U] int32 vertices per chunk
    tcount: jnp.ndarray      # [U] int32 triangles per chunk


@functools.partial(jax.jit, static_argnames=("vert_cap", "tri_cap"))
def compact_mesh_device(mesh: ChunkMesh, active: jnp.ndarray,
                        vert_cap: int, tri_cap: int) -> CompactMesh:
    """On-device compaction of the padded per-chunk mesh buffers.

    Vertices of chunk u occupy rows [voff[u], voff[u]+vcount[u]) of the
    flat arrays; triangle indices are local to their chunk's compact
    vertex range (host splits by vcount/tcount — no remap needed)."""
    U, E = mesh.vert_valid.shape
    val = mesh.vert_valid & active[:, None]
    vali = val.astype(jnp.int32)
    vidx = jnp.cumsum(vali, axis=1) - vali          # local compact index
    vcount = jnp.sum(vali, axis=1)

    n8 = (jnp.clip(jnp.round(mesh.normals * 127.0), -127, 127)
          + 127.0).astype(jnp.uint32)
    npack = n8[..., 0] + (n8[..., 1] << 8) + (n8[..., 2] << 16)
    c8 = jnp.clip(jnp.round(mesh.colors * 255.0), 0, 255).astype(jnp.uint32)
    cpack = c8[..., 0] + (c8[..., 1] << 8) + (c8[..., 2] << 16)
    rec = jnp.concatenate([
        jax.lax.bitcast_convert_type(mesh.positions, jnp.uint32),
        npack[..., None], cpack[..., None]], axis=-1)   # [U, E, 5]

    # stream compaction WITHOUT scatter: output slot o holds the
    # (o+1)-th valid element in flat row-major order, found by binary
    # search over the flat inclusive prefix-sum (gathers only, no
    # colliding scatter writes)
    cflat = jnp.cumsum(vali.reshape(-1))
    o = jnp.arange(vert_cap)
    src = jnp.searchsorted(cflat, o + 1, side="left")
    src = jnp.minimum(src, U * E - 1)
    valid_o = o < cflat[-1]
    vert_rec = jnp.where(valid_o[:, None],
                         jnp.take(rec.reshape(-1, 5), src, axis=0), 0)

    t = mesh.triangles                               # [U, T, 3] edge ids
    safe = jnp.maximum(t, 0)
    cv = jnp.take_along_axis(val, safe.reshape(U, -1), axis=1).reshape(t.shape)
    tvalid = jnp.all(t >= 0, axis=-1) & jnp.all(cv, axis=-1) & active[:, None]
    tl = jnp.take_along_axis(vidx, safe.reshape(U, -1), axis=1).reshape(t.shape)
    tvi = tvalid.astype(jnp.int32)
    tcount = jnp.sum(tvi, axis=1)
    ctflat = jnp.cumsum(tvi.reshape(-1))
    ot = jnp.arange(tri_cap)
    srct = jnp.searchsorted(ctflat, ot + 1, side="left")
    srct = jnp.minimum(srct, tvi.size - 1)
    tris = jnp.where((ot < ctflat[-1])[:, None],
                     jnp.take(tl.reshape(-1, 3).astype(jnp.int32), srct,
                              axis=0), 0)
    return CompactMesh(vert_rec, tris, vcount, tcount)


def _mesh_core(sdf, weight, color, color_count, nbr_slots, origins,
               active, chunk_size, resolution):
    """Shared array-shaped marching-cubes core: neighbor blocks from
    contiguous ROW gathers + static-index remaps (instead of
    element-wise dynamic gathers and take_along_axis), the 12-edge table
    indirection as a one-hot-over-12 reduction, triangles emitted as
    chunk-local compact vertex ids.
    (ref semantics: Structure/ChunkManager.cpp:595-1004
    GenerateMeshEfficient incl. the 3×729 per-edge dedup arrays
    :645-647; normals from SDF gradient :277-455.)

    Returns (positions [U,E,3], npack [U,E] u32, cpack [U,E] u32,
    val [U,E] bool, vali [U,E] i32, vidx [U,E] i32,
    tl [U,T,3] i32 local compact vertex ids, tvalid [U,T] bool)."""
    U = nbr_slots.shape[0]
    V = sdf.shape[1]
    s = chunk_size

    # ---- neighbor blocks: row gather (contiguous) + static remap
    nbr_lut, lin_lut = _block_luts(s)
    flat_lut = jnp.asarray(nbr_lut.astype(np.int64) * V + lin_lut)  # [729]
    rows_s = jnp.take(sdf, nbr_slots.reshape(-1), axis=0).reshape(U, 8 * V)
    rows_w = jnp.take(weight, nbr_slots.reshape(-1), axis=0).reshape(U, 8 * V)
    rows_c = jnp.take(color, nbr_slots.reshape(-1), axis=0).reshape(U, 8 * V, 3)
    rows_n = jnp.take(color_count, nbr_slots.reshape(-1), axis=0).reshape(U, 8 * V)
    s_blk = rows_s[:, flat_lut]                       # [U, 729]
    w_blk = rows_w[:, flat_lut]
    cnt = jnp.maximum(rows_n[:, flat_lut], 1e-6)
    c_blk = rows_c[:, flat_lut] / cnt[..., None] / 255.0

    s3 = s_blk.reshape(-1, B, B, B)
    w3 = w_blk.reshape(-1, B, B, B)
    observed3 = (w3 > 0) & (jnp.abs(s3) < RESET_SDF * 0.5)

    # ---- SDF gradient at grid nodes (one-sided at block boundaries)
    def grad_axis(f, axis):
        upper = jnp.roll(f, -1, axis)
        lower = jnp.roll(f, 1, axis)
        n = f.shape[axis]
        idx = jnp.arange(n)
        shape = [1, 1, 1, 1]
        shape[axis] = n
        idx = idx.reshape(shape)
        return jnp.where(idx == 0, upper - f,
                         jnp.where(idx == n - 1, f - lower,
                                   (upper - lower) * 0.5))

    g3 = jnp.stack([grad_axis(s3, 1), grad_axis(s3, 2), grad_axis(s3, 3)],
                   axis=-1).reshape(-1, B3, 3)

    # ---- per-edge vertices (dedup by ownership: axis × 9³ origin)
    coords = np.stack(np.meshgrid(np.arange(B), np.arange(B), np.arange(B),
                                  indexing="ij"), axis=-1).reshape(-1, 3)
    grid_pos = jnp.asarray(coords, jnp.float32)       # [729, 3]
    ob = observed3.reshape(-1, B3)

    pos_l, nrm_l, col_l, val_l = [], [], [], []
    for axis in range(3):
        step = np.zeros(3, np.int32)
        step[axis] = 1
        nb_coords = coords + step
        in_range = jnp.asarray((nb_coords < B).all(axis=-1))
        nb_lin = jnp.asarray(_grid_lin(np.clip(nb_coords, 0, B - 1)))
        s0, s1 = s_blk, s_blk[:, nb_lin]
        crossing = (s0 * s1 < 0) & ob & ob[:, nb_lin] & in_range[None, :]
        t = jnp.clip(s0 / jnp.where(jnp.abs(s0 - s1) > 1e-12, s0 - s1, 1e-12),
                     0.0, 1.0)
        pos_l.append(grid_pos[None] + t[..., None]
                     * jnp.asarray(step, jnp.float32))
        c0 = c_blk
        col_l.append(c0 + (c_blk[:, nb_lin] - c0) * t[..., None])
        g0 = g3
        n = g0 + (g3[:, nb_lin] - g0) * t[..., None]
        nrm_l.append(n / jnp.maximum(
            jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12))
        val_l.append(crossing)

    positions = (jnp.concatenate(pos_l, axis=1) * resolution
                 + origins[:, None, :] + 0.5 * resolution)
    normals = jnp.concatenate(nrm_l, axis=1)
    colors = jnp.clip(jnp.concatenate(col_l, axis=1), 0.0, 1.0)
    val = jnp.concatenate(val_l, axis=1) & active[:, None]   # [U, 3·729]

    # ---- vertex records + local compact indices
    vali = val.astype(jnp.int32)
    vidx = jnp.cumsum(vali, axis=1) - vali

    n8 = (jnp.clip(jnp.round(normals * 127.0), -127, 127)
          + 127.0).astype(jnp.uint32)
    npack = n8[..., 0] + (n8[..., 1] << 8) + (n8[..., 2] << 16)
    c8 = jnp.clip(jnp.round(colors * 255.0), 0, 255).astype(jnp.uint32)
    cpack = c8[..., 0] + (c8[..., 1] << 8) + (c8[..., 2] << 16)

    # ---- triangles: case index → local edges → local compact vertex ids
    vox = np.stack(np.meshgrid(np.arange(s), np.arange(s), np.arange(s),
                               indexing="ij"), axis=-1).reshape(-1, 3)
    corner_lin = jnp.asarray(
        _grid_lin(vox[:, None, :] + mc_tables.CORNER_OFFSETS[None]))  # [512,8]
    cs = s_blk[:, corner_lin]                         # static idx: [U, 512, 8]
    cob = ob[:, corner_lin]
    cell_ok = jnp.all(cob, axis=-1)
    bits = (cs < 0).astype(jnp.int32)
    case = jnp.sum(bits * (1 << jnp.arange(8, dtype=jnp.int32))[None, None, :],
                   axis=-1)
    case = jnp.where(cell_ok, case, 0)

    tri_tab = jnp.asarray(mc_tables.TRI_TABLE)        # [256, MAX_TRIS*3]
    local_e = jnp.take(tri_tab, case.reshape(-1), axis=0
                       ).reshape(U, vox.shape[0], -1)  # [U, 512, MAX_TRIS*3]

    # per-(voxel, 12-edge) vertex info via STATIC edge-id gather
    e_glob = jnp.asarray(_grid_lin(vox[:, None, :] + mc_tables.EDGE_ORIGIN[None])
                         + mc_tables.EDGE_AXIS[None, :] * B3)  # [512, 12]
    vidx_e = vidx[:, e_glob.reshape(-1)].reshape(U, vox.shape[0], 12)
    val_e = val[:, e_glob.reshape(-1)].reshape(U, vox.shape[0], 12)

    # one-hot over the 12 edges replaces take_along_axis (15× faster)
    oh = local_e[..., None] == jnp.arange(12)[None, None, None, :]
    tl = jnp.sum(jnp.where(oh, vidx_e[:, :, None, :], 0), axis=-1)
    cv = jnp.any(jnp.where(oh, val_e[:, :, None, :], False), axis=-1)
    tl = tl.reshape(U, -1, 3)
    cv = cv.reshape(U, -1, 3)
    emitted = (local_e >= 0).reshape(U, -1, 3)
    tvalid = (jnp.all(emitted, axis=-1) & jnp.all(cv, axis=-1)
              & active[:, None])
    return positions, npack, cpack, val, vali, vidx, tl, tvalid


@functools.partial(jax.jit,
                   static_argnames=("chunk_size", "resolution",
                                    "vert_cap", "tri_cap"))
def mesh_chunks_compact(
    sdf: jnp.ndarray,          # [S, V] full slot arrays
    weight: jnp.ndarray,       # [S, V]
    color: jnp.ndarray,        # [S, V, 3] accumulators (byte scale)
    color_count: jnp.ndarray,  # [S, V]
    nbr_slots: jnp.ndarray,    # [U, 8] slot of self+7 neighbors (trash if absent)
    origins: jnp.ndarray,      # [U, 3] world origin of each chunk
    active: jnp.ndarray,       # [U] bool
    chunk_size: int,
    resolution: float,
    vert_cap: int,
    tri_cap: int,
) -> CompactMesh:
    """Marching cubes + GLOBAL stream compaction fused into ONE program
    (flat output across all chunks; see _mesh_core for the shaping)."""
    positions, npack, cpack, val, vali, vidx, tl, tvalid = _mesh_core(
        sdf, weight, color, color_count, nbr_slots, origins, active,
        chunk_size, resolution)
    vcount = jnp.sum(vali, axis=1)
    rec = jnp.concatenate([
        jax.lax.bitcast_convert_type(positions, jnp.uint32),
        npack[..., None], cpack[..., None]], axis=-1)   # [U, E, 5]

    cflat = jnp.cumsum(vali.reshape(-1))
    o = jnp.arange(vert_cap)
    src = jnp.minimum(jnp.searchsorted(cflat, o + 1, side="left"),
                      cflat.size - 1)
    vert_rec = jnp.where((o < cflat[-1])[:, None],
                         jnp.take(rec.reshape(-1, 5), src, axis=0), 0)

    tvi = tvalid.astype(jnp.int32)
    tcount = jnp.sum(tvi, axis=1)
    ctflat = jnp.cumsum(tvi.reshape(-1))
    ot = jnp.arange(tri_cap)
    srct = jnp.minimum(jnp.searchsorted(ctflat, ot + 1, side="left"),
                       ctflat.size - 1)
    tris = jnp.where((ot < ctflat[-1])[:, None],
                     jnp.take(tl.reshape(-1, 3), srct, axis=0), 0)
    return CompactMesh(vert_rec, tris, vcount, tcount)


class MeshPool(NamedTuple):
    """Device-resident per-chunk mesh pool (slot-indexed, +1 trash row).

    Meshes stay on device across cycles: the texture stage gathers
    vertex rows directly and the host fetches only at export — the
    per-cycle device→host→device mesh round-trip this replaces moved
    every mesh twice per cycle."""

    verts: jnp.ndarray       # [S+1, P, 3] f32 world-space
    col_packed: jnp.ndarray  # [S+1, P] uint32 3×u8 channels
    nrm_packed: jnp.ndarray  # [S+1, P] uint32 3×(int8+127)
    tris: jnp.ndarray        # [S+1, T, 3] int32 chunk-local vertex ids
    vcount: jnp.ndarray      # [S+1] int32
    tcount: jnp.ndarray      # [S+1] int32


def make_mesh_pool(capacity: int, p: int, t: int) -> MeshPool:
    return MeshPool(
        verts=jnp.zeros((capacity + 1, p, 3), jnp.float32),
        col_packed=jnp.zeros((capacity + 1, p), jnp.uint32),
        nrm_packed=jnp.zeros((capacity + 1, p), jnp.uint32),
        tris=jnp.zeros((capacity + 1, t, 3), jnp.int32),
        vcount=jnp.zeros(capacity + 1, jnp.int32),
        tcount=jnp.zeros(capacity + 1, jnp.int32),
    )


@functools.partial(jax.jit, static_argnames=("chunk_size", "resolution"),
                   donate_argnames=("pool",))
def mesh_chunks_pooled(
    pool: MeshPool,            # DONATED device mesh pool
    sdf: jnp.ndarray,          # [S, V] full slot arrays
    weight: jnp.ndarray,
    color: jnp.ndarray,
    color_count: jnp.ndarray,
    slots: jnp.ndarray,        # [U] chunk slots being remeshed
    nbr_slots: jnp.ndarray,    # [U, 8] slot of self+7 neighbors
    origins: jnp.ndarray,      # [U, 3]
    active: jnp.ndarray,       # [U]
    chunk_size: int,
    resolution: float,
) -> Tuple[MeshPool, jnp.ndarray, jnp.ndarray]:
    """Marching cubes + per-chunk compaction scattered straight into the
    device mesh pool. Returns (pool, vcount[U], tcount[U]); counts clamp
    at the pool's per-chunk capacity.

    Per-row compaction is top_k over the edge index (valid edges keep
    their slot id, invalid get a big sentinel): top_k vectorizes, and
    the payload gathers that follow are tiny ([U, P] rows) — the
    vmapped searchsorted + take_along_axis this replaces was the single
    hottest program in the pipeline."""
    p_cap = pool.verts.shape[1]
    t_cap = pool.tris.shape[1]
    positions, npk, cpk, val, vali, vidx, tl, tvalid = _mesh_core(
        sdf, weight, color, color_count, nbr_slots, origins, active,
        chunk_size, resolution)
    U, E = val.shape
    vcount = jnp.minimum(jnp.sum(vali, axis=1), p_cap)

    # first-P-valid edge slots per row, in ascending edge order
    key = jnp.where(val, jnp.arange(E, dtype=jnp.int32)[None, :], E)
    neg_small, _ = jax.lax.top_k(-key, p_cap)       # [U, P] ascending slots
    vsrc = -neg_small
    in_row = vsrc < E
    vsrc = jnp.minimum(vsrc, E - 1)
    pv = jnp.where(in_row[..., None],
                   jnp.take_along_axis(positions, vsrc[..., None], axis=1),
                   0.0)
    pn = jnp.where(in_row, jnp.take_along_axis(npk, vsrc, axis=1), 0)
    pc = jnp.where(in_row, jnp.take_along_axis(cpk, vsrc, axis=1), 0)

    # triangles: drop any touching vertices beyond the pool cap, then
    # compact rows the same top_k way
    T = tl.shape[1]
    tvalid = tvalid & jnp.all(tl < p_cap, axis=-1)
    tkey = jnp.where(tvalid, jnp.arange(T, dtype=jnp.int32)[None, :], T)
    tneg, _ = jax.lax.top_k(-tkey, t_cap)
    tsrc = -tneg
    t_in = tsrc < T
    tsrc = jnp.minimum(tsrc, T - 1)
    tcount = jnp.minimum(jnp.sum(tvalid.astype(jnp.int32), axis=1), t_cap)
    pt = jnp.where(t_in[..., None],
                   jnp.take_along_axis(tl, tsrc[..., None], axis=1), 0)

    sl = jnp.where(active, slots, pool.verts.shape[0] - 1)
    new_pool = MeshPool(
        verts=pool.verts.at[sl].set(pv),
        col_packed=pool.col_packed.at[sl].set(pc),
        nrm_packed=pool.nrm_packed.at[sl].set(pn),
        tris=pool.tris.at[sl].set(pt.astype(jnp.int32)),
        vcount=pool.vcount.at[sl].set(jnp.where(active, vcount, 0)),
        tcount=pool.tcount.at[sl].set(jnp.where(active, tcount, 0)),
    )
    return new_pool, vcount, tcount


@functools.partial(jax.jit, static_argnames=())
def gather_pool_rows(pool: MeshPool, slots: jnp.ndarray):
    """Fetchable copy of selected pool rows (export path)."""
    return (pool.verts[slots], pool.col_packed[slots],
            pool.nrm_packed[slots], pool.tris[slots],
            pool.vcount[slots], pool.tcount[slots])


def unpack_u32_channels(packed: np.ndarray) -> np.ndarray:
    """[...] uint32 → [..., 3] float 0..255 channel values."""
    return np.stack([packed & 0xFF, (packed >> 8) & 0xFF,
                     (packed >> 16) & 0xFF], axis=-1).astype(np.float32)


def unpack_vert_records(rec: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[N, 5] uint32 records → (positions f32 [N,3], colors [N,3] 0..1,
    normals [N,3] unit)."""
    pos = rec[:, :3].copy().view(np.float32)
    npk = rec[:, 3]
    nrm = (np.stack([npk & 0xFF, (npk >> 8) & 0xFF, (npk >> 16) & 0xFF],
                    axis=-1).astype(np.float32) - 127.0) / 127.0
    cpk = rec[:, 4]
    col = np.stack([cpk & 0xFF, (cpk >> 8) & 0xFF, (cpk >> 16) & 0xFF],
                   axis=-1).astype(np.float32) / 255.0
    return pos, col, nrm


def compact_mesh(mesh: ChunkMesh, active: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host-side compaction of padded chunk meshes into flat arrays.

    Returns (vertices [N,3], faces [M,3] int32, colors [N,3], normals [N,3]).
    Replaces the reference's DrawMeshes buffer fill (ref: Chisel.cpp:288-355).
    """
    pos = np.asarray(mesh.positions)
    nrm = np.asarray(mesh.normals)
    col = np.asarray(mesh.colors)
    val = np.asarray(mesh.vert_valid)
    tris = np.asarray(mesh.triangles)

    verts_out, faces_out, cols_out, nrms_out = [], [], [], []
    base = 0
    for u in range(pos.shape[0]):
        if not active[u]:
            continue
        v_mask = val[u]
        t = tris[u]
        t = t[(t >= 0).all(axis=-1)]
        if len(t) == 0:
            continue
        # a triangle is valid only if all three edge vertices are valid
        tv = v_mask[t].all(axis=-1)
        t = t[tv]
        if len(t) == 0:
            continue
        used = np.zeros(val.shape[1], bool)
        used[t.reshape(-1)] = True
        remap = np.full(val.shape[1], -1, np.int64)
        remap[used] = np.arange(used.sum()) + base
        verts_out.append(pos[u][used])
        cols_out.append(col[u][used])
        nrms_out.append(nrm[u][used])
        faces_out.append(remap[t])
        base += used.sum()
    if not verts_out:
        z = np.zeros((0, 3), np.float32)
        return z, np.zeros((0, 3), np.int32), z, z
    return (np.concatenate(verts_out).astype(np.float32),
            np.concatenate(faces_out).astype(np.int32),
            np.concatenate(cols_out).astype(np.float32),
            np.concatenate(nrms_out).astype(np.float32))
