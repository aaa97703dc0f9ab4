"""Texture patches: projecting chunk meshes into their selected keyframes.

JAX re-design of Patch/Chisel patch generation
(ref: Structure/Patch.cpp:40-108 CalculateTexCoords — project mesh
vertices into the chosen keyframe, texcoords + bbox; :88-96 wrong-mapping
detection (>30% of vertices with color Δ>0.6 or depth Δ>0.7);
Structure/Chisel.cpp:149-189 GeneratePatches).

The batched kernel processes U chunks at once with padded vertex arrays;
host code owns patch records and atlas placement (texture/atlas.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.config import TextureConfig
from texturefusion_tpu.core import camera as cam
from texturefusion_tpu.core import se3

_PREC = jax.lax.Precision.HIGHEST


class IncrementalCycleOut(NamedTuple):
    """Single-fetch outputs of the incremental texture-cycle program."""

    proj_rows: jnp.ndarray   # [M] int32 node index of projected chunks
    proj_kf: jnp.ndarray     # [M] int32 adopted keyframe per projected row
    n_changed: jnp.ndarray   # scalar int32 — total changed (may exceed M)
    uv16: jnp.ndarray        # [M, P, 2] uint16 pixel coords ×16 fixed point
    uv_valid: jnp.ndarray    # [M, P] bool
    bbox_min: jnp.ndarray    # [M, 2]
    bbox_max: jnp.ndarray    # [M, 2]
    wrong: jnp.ndarray       # [M] bool
    t_mats: jnp.ndarray      # [K, 3, 3] per-keyframe color transfer
    mean_t: jnp.ndarray      # [K, 3]
    mean_v: jnp.ndarray      # [K, 3]


def _bilinear_packed(rgbp: jnp.ndarray, depth: jnp.ndarray,
                     row: jnp.ndarray, uv: jnp.ndarray):
    """Bilinear rgb+depth from the packed keyframe stack: rgbp [K, H, W]
    uint32 (r|g<<8|b<<16), depth [K, H, W] f32, row [M] stack row per
    chunk, uv [M, P, 2]. ONE u32 gather + ONE f32 gather per tap (the
    unpacked-channel variant gathers 4× the words). Returns
    (rgb [M, P, 3] in 0..1, depth [M, P])."""
    k, h, w = rgbp.shape
    x = jnp.clip(uv[..., 0], 0.0, w - 1.001)
    y = jnp.clip(uv[..., 1], 0.0, h - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    base = row[:, None] * (h * w) + y0 * w + x0            # [M, P]
    pf = rgbp.reshape(-1)
    df = depth.reshape(-1)

    def unpack(p):
        return jnp.stack([p & 0xFF, (p >> 8) & 0xFF, (p >> 16) & 0xFF],
                         axis=-1).astype(jnp.float32)

    c00 = unpack(jnp.take(pf, base))
    c01 = unpack(jnp.take(pf, base + 1))
    c10 = unpack(jnp.take(pf, base + w))
    c11 = unpack(jnp.take(pf, base + w + 1))
    fxc = fx[..., None]
    top = c00 + (c01 - c00) * fxc
    bot = c10 + (c11 - c10) * fxc
    rgb = (top + (bot - top) * fy[..., None]) / 255.0
    d00 = jnp.take(df, base)
    d01 = jnp.take(df, base + 1)
    d10 = jnp.take(df, base + w)
    d11 = jnp.take(df, base + w + 1)
    dt = d00 + (d01 - d00) * fx
    db = d10 + (d11 - d10) * fx
    return rgb, dt + (db - dt) * fy


STATS_W = 25    # n, Σtex(3), Σvox(3), Σ tex·texᵀ(9), Σ vox·voxᵀ(9)


@functools.partial(
    jax.jit, static_argnames=("intr", "cfg", "sweeps", "m_budget"),
    donate_argnames=("labels_dev", "stats_dev"))
def texture_cycle_incremental(
    problem,                   # mrf.MRFProblem, node i ↔ chunk slot_idx[i]
    slot_idx: jnp.ndarray,     # [N] int32 chunk slot per node (trash pad)
    labels_dev: jnp.ndarray,   # [S+1] int32 current kf label per slot (DONATED)
    stats_dev: jnp.ndarray,    # [S+1, STATS_W] f32 color moments (DONATED)
    remeshed_mask: jnp.ndarray,  # [N] bool — chunk remeshed this cycle
    pool_verts: jnp.ndarray,   # [S+1, P, 3] device mesh pool
    pool_colpk: jnp.ndarray,   # [S+1, P] uint32 packed voxel colors
    pool_vcount: jnp.ndarray,  # [S+1] int32
    pool_tcount: jnp.ndarray,  # [S+1] int32
    kf_rgbp: jnp.ndarray,      # [K, H, W] uint32 packed keyframe rgb
    kf_depth: jnp.ndarray,     # [K, H, W] f32
    kf_poses: jnp.ndarray,     # [K, 4, 4]
    fallback_kf: jnp.ndarray,  # int32 — label for chunks w/o prior label
    intr: cam.Intrinsics,
    cfg: TextureConfig,
    sweeps: int,
    m_budget: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, IncrementalCycleOut]:
    """INCREMENTAL texture cycle: global MRF view-selection over all
    chunks, but projection/uv/wrong-mapping/color-stats only for CHANGED
    chunks (label flip ∪ remeshed) — the reference's incremental
    view_selection only touches changed chunks too (ref: TexMap.cpp:
    257-406). Unchanged chunks keep their device-resident color-moment
    rows, so the global per-keyframe color compensation (ref:
    Chisel.cpp:198-286) still sees EVERY patched vertex each cycle.
    One dispatch, one small fetch; labels/stats buffers donated."""
    from texturefusion_tpu.texture import mrf as mrf_ops

    n, _ = problem.unary.shape
    trash = labels_dev.shape[0] - 1
    k = kf_poses.shape[0]

    sol = mrf_ops.solve_icm(problem, cfg.mrf_potts_weight,
                            cfg.mrf_edge_weight, sweeps=sweeps)
    kf_sel = jnp.take_along_axis(problem.label_kf, sol[:, None],
                                 axis=1)[:, 0]                    # [N]
    old = labels_dev[slot_idx]
    kf_new = jnp.where(kf_sel >= 0, kf_sel,
                       jnp.where(old >= 0, old, fallback_kf))
    node_ok = (slot_idx != trash) & (pool_vcount[slot_idx] > 0)
    changed = node_ok & ((kf_new != old) | remeshed_mask)

    # compact the changed node list to the static projection budget
    ci = changed.astype(jnp.int32)
    cum = jnp.cumsum(ci)
    n_changed = cum[-1]
    rows = jnp.minimum(jnp.searchsorted(cum, jnp.arange(m_budget) + 1), n - 1)
    row_ok = jnp.arange(m_budget) < jnp.minimum(n_changed, m_budget)
    csl = jnp.where(row_ok, slot_idx[rows], trash)                # [M]

    # ---- projection of the changed chunks against their new keyframes
    verts = jnp.take(pool_verts, csl, axis=0)                     # [M, P, 3]
    cpk = jnp.take(pool_colpk, csl, axis=0)
    vert_color = jnp.stack([cpk & 0xFF, (cpk >> 8) & 0xFF,
                            (cpk >> 16) & 0xFF],
                           axis=-1).astype(jnp.float32) / 255.0
    p = cpk.shape[1]
    vert_valid = (jnp.arange(p)[None, :]
                  < jnp.take(pool_vcount, csl)[:, None])
    kfr = jnp.clip(kf_new[rows], 0, k - 1)                        # [M]
    w2c = se3.inverse(kf_poses)[kfr]
    # full f32: a TF32 product is ~2 mm off at 2 m, about half a pixel
    pts_cam = jnp.einsum("uij,upj->upi", w2c[:, :3, :3], verts,
                         precision=_PREC) + w2c[:, None, :3, 3]
    uv, z = cam.project(intr, pts_cam)
    ok = vert_valid & cam.in_image(intr, uv, margin=1.0) \
        & (z > intr.near) & row_ok[:, None]

    tex, d_kf = _bilinear_packed(kf_rgbp, kf_depth, kfr, uv)

    color_bad = jnp.max(jnp.abs(tex - vert_color), axis=-1) \
        > cfg.wrong_mapping_color
    depth_bad = jnp.abs(d_kf - z) > cfg.wrong_mapping_depth
    occluded = (d_kf > intr.near) & (z > d_kf + 0.05)
    bad = ok & (color_bad | depth_bad | occluded)
    n_ok = jnp.maximum(jnp.sum(ok, axis=1), 1)
    wrong = (jnp.sum(bad, axis=1) / n_ok) > cfg.wrong_mapping_frac
    wrong = wrong | (jnp.sum(ok, axis=1) == 0)

    big = 1e9
    uv_m = jnp.where(ok[..., None], uv, big)
    bbox_min = jnp.floor(jnp.min(uv_m, axis=1) - 1.0)
    uv_m = jnp.where(ok[..., None], uv, -big)
    bbox_max = jnp.ceil(jnp.max(uv_m, axis=1) + 1.0)
    lim = jnp.asarray([intr.width - 1, intr.height - 1])
    bbox_min = jnp.clip(bbox_min, 0, lim)
    bbox_max = jnp.clip(bbox_max, 0, lim)

    # ---- adopt labels + refresh per-chunk color moments (projected,
    # non-wrong rows only; wrong rows keep their old label so they stay
    # "changed" and re-select next cycle after the host poisons their
    # observation, ref: MobileFusion.cpp:330-343)
    adopt = row_ok & ~wrong
    lab_val = jnp.where(adopt, kf_new[rows], labels_dev[csl])
    labels_out = labels_dev.at[jnp.where(row_ok, csl, trash)].set(
        jnp.where(row_ok, lab_val, -1))

    wgt = (ok & ~wrong[:, None]).astype(jnp.float32)              # [M, P]
    s_n = jnp.sum(wgt, axis=1)
    s_t = jnp.einsum("mp,mpc->mc", wgt, tex, precision=_PREC)
    s_v = jnp.einsum("mp,mpc->mc", wgt, vert_color, precision=_PREC)
    s_tt = jnp.einsum("mp,mpc,mpd->mcd", wgt, tex, tex, precision=_PREC)
    s_vv = jnp.einsum("mp,mpc,mpd->mcd", wgt, vert_color, vert_color,
                      precision=_PREC)
    stat_rows = jnp.concatenate(
        [s_n[:, None], s_t, s_v, s_tt.reshape(-1, 9), s_vv.reshape(-1, 9)],
        axis=1)                                                   # [M, 25]
    stat_rows = jnp.where(adopt[:, None], stat_rows, 0.0)
    stats_out = stats_dev.at[jnp.where(adopt, csl, trash)].set(stat_rows)

    # ---- global per-keyframe color compensation from ALL chunks' moments
    lab_all = labels_out
    seg_ok = (lab_all >= 0) & (pool_tcount > 0)
    seg_ok = seg_ok.at[trash].set(False)
    seg = jnp.where(seg_ok, jnp.clip(lab_all, 0, k - 1), k)
    agg = jnp.zeros((k + 1, STATS_W)).at[seg].add(stats_out)[:k]  # [K, 25]
    cnt = jnp.maximum(agg[:, 0], 1e-6)[:, None]
    mean_t = agg[:, 1:4] / cnt
    mean_v = agg[:, 4:7] / cnt
    cov_t = (agg[:, 7:16].reshape(-1, 3, 3) / cnt[..., None]
             - mean_t[:, :, None] * mean_t[:, None, :])
    cov_v = (agg[:, 16:25].reshape(-1, 3, 3) / cnt[..., None]
             - mean_v[:, :, None] * mean_v[:, None, :])
    from texturefusion_tpu.texture import color as color_ops
    t_mats = color_ops.transfer_matrices(mean_t, cov_t, mean_v, cov_v)

    uv16 = jnp.clip(uv * 16.0, 0, 65535).astype(jnp.uint16)
    out = IncrementalCycleOut(
        proj_rows=rows.astype(jnp.int32), proj_kf=kf_new[rows],
        n_changed=n_changed, uv16=uv16, uv_valid=ok,
        bbox_min=bbox_min, bbox_max=bbox_max, wrong=wrong,
        t_mats=t_mats, mean_t=mean_t, mean_v=mean_v)
    return labels_out, stats_out, out
