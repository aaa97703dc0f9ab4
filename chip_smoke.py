"""Smoke check of the reconstruction pipeline on one NVIDIA GPU.

    python chip_smoke.py [--out DIR]      # phases a-d on one card
    python chip_smoke.py --four-cards     # sharded path on 4 cards vs 1

Phases (one process, one card):
  a. device: versions, device kind and count, XLA flags, compile cache,
     and the card's name and power limit from nvidia-smi;
  b. stage parity at full width (VGA, 2 cm voxels, 16384-chunk pool):
     every hot jitted stage runs on the GPU and on the CPU backend with
     the same inputs; each difference must stay within its tolerance;
  c. the CLI end to end over a generated 120-frame TUM-format dataset,
     with the trajectory's ATE under the regression gate;
  d. the bench-shaped textured pipeline once (bench.py's hardened
     120-frame loop, async fusion, pipeline depth 2) with ATE and map RMS
     gates.

The last line of standard output is one JSON object,
{"ok": true, "device": {...}}, printed only when every phase passed.
Without a GPU, or without the rest of the repository, it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ATE_GATE_MM = 25.0          # tests/test_bench_regression.py gates
MAP_RMS_GATE_MM = 32.0
N_FRAMES = 120

_CARD = ""


def say(*parts) -> None:
    """Print a line tagged with the card it was measured on."""
    print(f"[{_CARD}]" if _CARD else "", *parts, flush=True)


def require_gpu():
    """The first JAX device, which must be a GPU: no CPU fallback."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"chip_smoke needs a GPU; JAX's first device is "
                           f"{dev.platform} ({dev.device_kind})")
    return dev


def card_info() -> str:
    """`name, power.limit` of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------- phase a

def phase_device() -> None:
    global _CARD
    import jax
    import jaxlib

    from texturefusion_tpu.utils.cache import enable_compilation_cache

    dev = require_gpu()
    cache = enable_compilation_cache()
    _CARD = card_info()
    print(_CARD, flush=True)
    say(f"jax {jax.__version__} jaxlib {jaxlib.__version__}; device_kind "
        f"{dev.device_kind!r}; {len(jax.devices())} device(s)")
    say(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; compile cache "
        f"{cache}")


# ------------------------------------------------------------- phase b

class Parity:
    """Collects per-stage GPU-vs-CPU differences against tolerances."""

    def __init__(self):
        self.failed = []

    def check(self, stage: str, what: str, value: float, tol: float,
              why: str) -> None:
        ok = bool(value <= tol)
        say(f"parity {stage:26s} {what:34s} {value:.3e} <= {tol:.1e} "
            f"{'ok' if ok else 'FAIL'}  ({why})")
        if not ok:
            self.failed.append(f"{stage}: {what} {value:.3e} > {tol:.1e}")


def _run_both(fn, *args):
    """fn(*args) on the GPU and on the CPU backend, results on host."""
    import jax
    import numpy as np

    cpu = jax.devices("cpu")[0]
    gpu = jax.devices()[0]
    out = []
    for dev in (gpu, cpu):
        placed = jax.tree.map(lambda a: jax.device_put(np.asarray(a), dev),
                              args)
        with jax.default_device(dev):
            res = fn(*placed)
            out.append(jax.tree.map(np.asarray, jax.block_until_ready(res)))
    return out


def _rot_deg(a, b) -> float:
    import numpy as np

    c = (np.trace(a[:3, :3].T @ b[:3, :3]) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def _ba_graph(n_kf: int, seed: int = 0):
    """Keyframes on the bench loop, exact point-to-point edge sums for
    consecutive pairs and a few loop edges, noisy initial poses."""
    import jax.numpy as jnp
    import numpy as np

    from texturefusion_tpu.core import se3
    from texturefusion_tpu.io import synthetic
    from texturefusion_tpu.slam import fastba

    rng = np.random.default_rng(seed)
    gt = np.stack(synthetic.loop_trajectory(n_kf, radius=1.5))
    pts = rng.uniform(-2.5, 2.5, (160, 3)).astype(np.float32)
    pairs = ([(k, k + 1) for k in range(n_kf - 1)]
             + [(k, k + n_kf // 2) for k in range(0, n_kf // 2, 4)]
             + [(0, n_kf - 1)])
    sums = []
    for i, j in pairs:
        ti, tj = np.linalg.inv(gt[i]), np.linalg.inv(gt[j])
        p = pts @ ti[:3, :3].T + ti[:3, 3]
        q = pts @ tj[:3, :3].T + tj[:3, 3]
        sums.append([np.asarray(s) for s in fastba.preintegrate_edge(
            jnp.asarray(p), jnp.asarray(q), jnp.ones(len(pts)))])
    cap = 128
    pad = cap - len(pairs)

    def col(k):
        v = np.stack([s[k] for s in sums])
        return np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])

    ij = np.asarray(pairs + [(0, 0)] * pad, np.int32)
    edges = fastba.EdgeSums(kf_i=ij[:, 0], kf_j=ij[:, 1], s_w=col(0),
                            s_p=col(1), s_q=col(2), s_pp=col(3), s_qq=col(4),
                            s_pq=col(5), valid=np.arange(cap) < len(pairs))
    init = gt.copy()
    for k in range(1, n_kf):
        xi = np.concatenate([rng.normal(0, 0.02, 3), rng.normal(0, 0.01, 3)])
        init[k] = np.asarray(se3.compose(
            jnp.asarray(gt[k]), se3.se3_exp(jnp.asarray(xi, jnp.float32))))
    return init.astype(np.float32), edges, np.ones(n_kf, bool)


def bench_frames():
    """bench.py's configuration and its hardened 120-frame loop."""
    import bench
    from texturefusion_tpu.core import camera as cam

    config = bench.bench_config()
    intr = cam.Intrinsics.from_config(config.camera)
    packed, gt, scene = bench.make_frames(config, intr, N_FRAMES)
    return config, packed, gt, scene


def phase_stage_parity(config, packed, gt) -> None:
    """Each hot jitted stage on GPU and CPU with identical inputs: the
    first two frames of the bench loop."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from texturefusion_tpu.core import camera as cam
    from texturefusion_tpu.fusion.mesher import IncrementalMesher
    from texturefusion_tpu.models.reconstruction import frame_step_tracked2
    from texturefusion_tpu.ops import hamming
    from texturefusion_tpu.ops import marching_cubes as mc
    from texturefusion_tpu.ops import preprocess
    from texturefusion_tpu.ops import tsdf as tsdf_ops
    from texturefusion_tpu.slam import fastba
    from texturefusion_tpu.slam.features import extract_features
    from texturefusion_tpu.texture import color as color_ops
    from texturefusion_tpu.texture import mrf
    from texturefusion_tpu.texture import patch as patch_ops

    intr = cam.Intrinsics.from_config(config.camera)
    tcfg, vcfg = config.tracking, config.tsdf
    scale = config.camera.depth_scale
    say(f"phase b: {intr.width}x{intr.height}, voxel "
        f"{vcfg.voxel_resolution} m, capacity {vcfg.capacity}, "
        f"max_update_chunks {vcfg.max_update_chunks}, features "
        f"{tcfg.max_features}/{tcfg.max_features_pad}")
    par = Parity()
    f32 = "float32 exp/div/sqrt round differently on the two backends"

    # -- preprocess (clamp, 9x9 bilateral, normals, quality, blur score)
    def pre(p):
        return preprocess.preprocess_bundle(p, None, intr, depth_scale=scale)

    g, c = _run_both(pre, packed[1])
    both = (g[0] > 0) & (c[0] > 0)
    par.check("preprocess", "depth |d| (m), both valid",
              float(np.abs(g[0] - c[0])[both].max()), 1e-4, f32)
    par.check("preprocess", "validity flips / pixels",
              float(np.mean((g[0] > 0) != (c[0] > 0))), 1e-3,
              "grazing-angle and normal gates are thresholds on rounded "
              "normals")
    par.check("preprocess", "gray |d| (0-255)",
              float(np.abs(g[3] - c[3]).max()), 1e-3, f32)
    par.check("preprocess", "blur score rel |d|",
              float(abs(g[4] - c[4]) / abs(c[4])), 1e-4,
              "mean over 307k pixels in another reduction order")
    depth1, qual1, gray1, rgb1 = g[0], g[2], g[3], g[5]
    bundle0 = jax.device_get(pre(jnp.asarray(packed[0])))
    depth0, gray0 = bundle0[0], bundle0[3]

    # -- features + two registrations + keyframe depth fusion
    kp0 = jax.tree.map(np.asarray, extract_features(
        jnp.asarray(gray0), jnp.asarray(depth0), tcfg, intr))
    kf_w = (depth0 > 0).astype(np.float32)
    key = np.asarray(jax.random.PRNGKey(0))

    def track(p, k_ref, d0, w0, k):
        return frame_step_tracked2(p, None, k_ref, k_ref, d0, w0, k,
                                   np.int32(1), intr, tcfg, scale)

    g, c = _run_both(track, packed[1], kp0, depth0, kf_w, key)
    res_g, res_c = g[2], c[2]
    if not (bool(res_g.success) and bool(res_c.success)):
        par.failed.append("frame_step_tracked2: registration failed")
    rel_gt = np.linalg.inv(gt[0]) @ gt[1]
    say(f"frame_step_tracked2 inliers gpu {int(res_g.n_inliers)} cpu "
        f"{int(res_c.n_inliers)}; |t - t_gt| gpu "
        f"{np.linalg.norm(res_g.pose[:3, 3] - rel_gt[:3, 3]) * 1e3:.3f} mm")
    rng_why = ("keypoints at the FAST threshold and RANSAC inlier sets "
               "flip on last-bit differences")
    par.check("frame_step_tracked2", "pose |dt| (mm)",
              float(np.linalg.norm(res_g.pose[:3, 3] - res_c.pose[:3, 3])
                    * 1e3), 2.0, rng_why)
    par.check("frame_step_tracked2", "pose |dR| (deg)",
              _rot_deg(res_g.pose, res_c.pose), 0.1, rng_why)

    # -- chunk discovery (on-device candidate dedup)
    pose1 = gt[1].astype(np.float32)
    stride = max(1, intr.width // 320)
    max_out = vcfg.max_update_chunks * 4

    def disco(d, p):
        return tsdf_ops.candidate_chunks_unique(d, p, intr, vcfg,
                                                stride=stride,
                                                max_out=max_out)

    g, c = _run_both(disco, depth1, pose1)
    ids_g = {tuple(r) for r in g[0][:int(g[1])]}
    ids_c = {tuple(r) for r in c[0][:int(c[1])]}
    par.check("candidate_chunks_unique", "chunk set sym. diff / size",
              len(ids_g ^ ids_c) / max(len(ids_g), 1), 1e-2,
              "points within a rounding step of a chunk face")

    # -- voxel update, fused re-integration, meshing over the same rows
    ids = np.asarray(sorted(ids_g), np.int32)[:vcfg.max_update_chunks]
    n = len(ids)
    s1, u = vcfg.capacity + 1, vcfg.max_update_chunks
    extent = vcfg.voxel_resolution * vcfg.chunk_size
    origins = np.zeros((s1, 3), np.float32)
    origins[:n] = ids * extent
    idx = np.concatenate([np.arange(n), np.full(u - n, s1 - 1)]
                         ).astype(np.int32)
    active = np.arange(u) < n
    empty = jax.tree.map(np.asarray,
                         tsdf_ops.make_empty_batch(s1, vcfg.chunk_size ** 3))

    def integ(b, o, i, a, d, r, q, p):
        return tsdf_ops.integrate_frame_fused(
            b, o, i, a, d, r, q, p, jnp.float32(1.0), intr, vcfg,
            with_color=True)

    args = (empty, origins, idx, active, depth1, rgb1, qual1, pose1)
    mem = jax.jit(integ).lower(*args).compile().memory_analysis()
    say(f"integrate_frame_fused memory_analysis: {mem}")
    g, c = _run_both(integ, *args)
    vox_why = ("a voxel projecting within a rounding step of a pixel "
               "edge samples the neighbouring pixel")

    def check_rows(stage, bg, bc):
        w_g, w_c = bg.weight[:n], bc.weight[:n]
        d_sdf = np.abs(bg.sdf[:n] - bc.sdf[:n])[(w_g > 0) & (w_c > 0)]
        par.check(stage, "voxels |dsdf| > 1e-4 m, share",
                  float(np.mean(d_sdf > 1e-4)), 1e-3, vox_why)
        par.check(stage, "voxel weight flips, share",
                  float(np.mean((w_g > 0) != (w_c > 0))), 1e-3, vox_why)
        say(f"{stage}: {n} chunks, {int((w_g > 0).sum())} voxels observed,"
            f" max |dsdf| {d_sdf.max():.3e} m")

    check_rows("integrate_frame_fused", g[0], c[0])
    batch1 = g[0]
    pose2 = pose1.copy()
    pose2[:3, 3] += (0.004, -0.003, 0.002)

    def reint(b, o, i, a, d, r, q, p_old, p_new):
        return tsdf_ops.reintegrate_frame_fused(b, o, i, a, d, r, q, p_old,
                                                p_new, intr, vcfg)

    g, c = _run_both(reint, batch1, origins, idx, active, depth1, rgb1,
                     qual1, pose1, pose2)
    check_rows("reintegrate_frame_fused", g[0], c[0])
    batch2 = g[0]

    slot_of = {tuple(r): k for k, r in enumerate(ids)}
    bucket = 256
    while bucket < n:
        bucket *= 2
    nbr = np.full((bucket, 8), s1 - 1, np.int32)
    nbr[:n, 0] = np.arange(n)
    for k, r in enumerate(ids):
        for m, off in enumerate(IncrementalMesher._CORNER_OFFS):
            nbr[k, m + 1] = slot_of.get(tuple(r + off), s1 - 1)
    slots = np.concatenate([np.arange(n), np.full(bucket - n, s1 - 1)]
                           ).astype(np.int32)
    m_org = np.zeros((bucket, 3), np.float32)
    m_org[:n] = origins[:n]
    m_act = np.arange(bucket) < n
    pool = jax.tree.map(np.asarray, mc.make_mesh_pool(
        vcfg.capacity, config.mesh.pool_verts_per_chunk,
        config.mesh.pool_tris_per_chunk))

    def mesh(pl, sdf, w, col, cc, sl, nb, org, act):
        return mc.mesh_chunks_pooled(pl, sdf, w, col, cc, sl, nb, org, act,
                                     vcfg.chunk_size, vcfg.voxel_resolution)

    g, c = _run_both(mesh, pool, batch2.sdf, batch2.weight, batch2.color,
                     batch2.color_count, slots, nbr, m_org, m_act)
    v_g, v_c = int(g[1].sum()), int(c[1].sum())
    say(f"mesh_chunks_pooled: {v_g} vertices gpu, {v_c} cpu")
    par.check("mesh_chunks_pooled", "vertex count rel |d|",
              abs(v_g - v_c) / max(v_c, 1), 1e-3,
              "an sdf within a rounding step of 0 flips a cube's case")
    same = g[1] == c[1]
    vg = g[0].verts[:n][same[:n]]
    vc = c[0].verts[:n][same[:n]]
    mask = np.arange(vg.shape[1])[None, :] < g[1][:n][same[:n]][:, None]
    par.check("mesh_chunks_pooled", "vertex |d| (m), same-count chunks",
              float(np.abs(vg - vc)[mask].max()), 1e-5, f32)
    mesh_pool = g[0]

    # -- incremental texture cycle over that mesh with frames 0 and 1 as
    # keyframes: view selection, vertex -> keyframe projection, moments
    tex_cfg = config.texture
    n_lab = tex_cfg.max_labels
    label_kf = np.full((bucket, n_lab), -1, np.int32)
    label_kf[:n, :2] = (1, 0)
    unary = np.full((bucket, n_lab), 1e9, np.float32)
    pick = np.random.default_rng(3).integers(0, 2, n)
    unary[:n, 0], unary[:n, 1] = pick, 1 - pick
    problem = mrf.MRFProblem(
        unary=unary, label_kf=label_kf,
        neighbors=np.full((bucket, 6), bucket, np.int32),
        parity=np.zeros(bucket, np.int32),
        init_label=np.zeros(bucket, np.int32), n_valid=m_act)

    def pack_rgb(frame):
        c3 = frame[..., 2:5].astype(np.uint32)
        return c3[..., 0] | (c3[..., 1] << 8) | (c3[..., 2] << 16)

    def texcycle(pr, si, lab, st, rm, pl, kr, kd, kp):
        return patch_ops.texture_cycle_incremental(
            pr, si, lab, st, rm, pl.verts, pl.col_packed, pl.vcount,
            pl.tcount, kr, kd, kp, jnp.int32(0), intr, tex_cfg,
            tex_cfg.mrf_sweeps, tex_cfg.patch_project_budget)

    g, c = _run_both(
        texcycle, problem, slots, np.full(s1, -1, np.int32),
        np.zeros((s1, patch_ops.STATS_W), np.float32), m_act, mesh_pool,
        np.stack([pack_rgb(packed[0]), pack_rgb(packed[1])]),
        np.stack([depth0, depth1]), np.stack([gt[0], pose1]
                                             ).astype(np.float32))
    og, oc = g[2], c[2]
    m = min(int(oc.n_changed), tex_cfg.patch_project_budget)
    same = ((og.proj_rows == oc.proj_rows) & (og.proj_kf == oc.proj_kf))[:m]
    both = og.uv_valid[:m] & oc.uv_valid[:m] & same[:, None]
    st_g, st_c = g[1][:n], c[1][:n]
    adopted = (st_g[:, 0] > 0) & (st_g[:, 0] == st_c[:, 0])
    say(f"texture_cycle_incremental: {m} chunks projected "
        f"({int((oc.proj_kf[:m] == 1).sum())} into keyframe 1), "
        f"{int(both.sum())} vertices in view, {int(adopted.sum())} "
        f"moment rows compared")
    if not (both.any() and adopted.any()):
        par.failed.append("texture_cycle_incremental: nothing to compare")
        raise RuntimeError("stage parity failed: " + "; ".join(par.failed))
    par.check("texture_cycle_incremental", "row/keyframe mismatches",
              float(np.sum(~same)), 0.0,
              "unaries 1 apart and no neighbours: an exact argmin")
    par.check("texture_cycle_incremental", "uv in-view flips / vertices",
              float(np.mean(og.uv_valid[:m] != oc.uv_valid[:m])), 1e-3,
              "a vertex within a rounding step of the image margin")
    par.check("texture_cycle_incremental", "uv |d| (1/16 px steps)",
              float(np.abs(og.uv16[:m].astype(np.int32)
                           - oc.uv16[:m].astype(np.int32))[both].max()), 1.0,
              "uv x16 is floored, so f32 rounding can cross one step; a "
              "TF32 projection is ~0.5 px (8 steps) off at 2 m")
    par.check("texture_cycle_incremental", "moment/vertex |d| (0-1 colour)",
              float((np.abs(st_g[adopted, 1:] - st_c[adopted, 1:])
                     / st_c[adopted, :1]).max()), 1e-4,
              "f32 sums over <=256 vertices in another order; TF32 "
              "inputs (10-bit mantissa) would be ~1e-3 off")

    # -- Hamming matching of the two frames' descriptors
    kp1 = jax.tree.map(np.asarray, extract_features(
        jnp.asarray(gray1), jnp.asarray(depth1), tcfg, intr))
    g, c = _run_both(hamming.match_descriptors, kp0.desc, kp0.valid,
                     kp1.desc, kp1.valid, np.int32(tcfg.hamming_threshold))
    par.check("match_descriptors", "index/distance mismatches",
              float(np.sum(g[0] != c[0]) + np.sum(g[1] != c[1])), 0.0,
              "integer XOR/popcount: exact on every backend")

    # -- dense BA solve (3 robust GN rounds, 32 keyframes)
    n_kf = config.ba.kf_bucket_floor
    init, edges, act = _ba_graph(n_kf)

    def ba(p, e, a):
        return fastba.optimize(p, e, n_kf, a, config.ba)

    g, c = _run_both(ba, init, edges, act)
    par.check("fastba.optimize", "pose |dt| max (m)",
              float(np.abs(g[0][:, :3, 3] - c[0][:, :3, 3]).max()), 1e-4,
              "Hessian assembly scatters with float atomics on the GPU")

    # -- MRF view selection, checkerboard ICM
    rng = np.random.default_rng(7)
    side, n_lab = (16, 16, 8), config.texture.max_labels
    n_node = int(np.prod(side))
    grid = np.arange(n_node).reshape(side)
    nbrs = np.full((n_node, 6), n_node, np.int32)
    for a in range(3):
        for s, d in ((1, 0), (-1, 1)):
            shifted = np.roll(grid, -s, axis=a)
            edge = np.ones(side, bool)
            sl = [slice(None)] * 3
            sl[a] = -1 if s == 1 else 0
            edge[tuple(sl)] = False
            nbrs[grid.reshape(-1), 2 * a + d] = np.where(
                edge, shifted, n_node).reshape(-1)
    xyz = np.stack(np.meshgrid(*[np.arange(k) for k in side],
                               indexing="ij"), -1).reshape(-1, 3)
    problem = mrf.MRFProblem(
        unary=rng.uniform(0, 2, (n_node, n_lab)).astype(np.float32),
        label_kf=rng.integers(0, 32, (n_node, n_lab)).astype(np.int32),
        neighbors=nbrs, parity=(xyz.sum(-1) % 2).astype(np.int32),
        init_label=np.zeros(n_node, np.int32),
        n_valid=np.ones(n_node, bool))

    def icm(pr):
        return mrf.solve_icm(pr, config.texture.mrf_potts_weight,
                             config.texture.mrf_edge_weight,
                             sweeps=config.texture.mrf_sweeps)

    g, c = _run_both(icm, problem)
    par.check("mrf.solve_icm", "label mismatches / nodes",
              float(np.mean(g != c)), 1e-3,
              "argmin over float costs summed in another order")

    # -- global colour compensation (moments, eigh, transfer)
    vox = rng.uniform(0.1, 0.9, (20000, 3)).astype(np.float32)
    clus = rng.integers(0, 16, 20000).astype(np.int32)
    gain = 0.7 + 0.05 * clus[:, None]
    tex = np.clip(vox * gain + 0.05, 0, 1).astype(np.float32)

    def comp(t, v, w, cl):
        return color_ops.compensate(t, v, w, cl, 16)

    g, c = _run_both(comp, tex, vox, np.ones(20000, np.float32), clus)
    par.check("color.compensate", "delta |d| (0-1 colour)",
              float(np.abs(g - c).max()), 1e-4,
              "scatter-added moments and eigh differ in the last bits")

    if par.failed:
        raise RuntimeError("stage parity failed: " + "; ".join(par.failed))


# ------------------------------------------------------------- phase c

def phase_cli(out_dir: str) -> None:
    """Generate the fr1-proxy TUM dataset and run the CLI over it."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import make_tum_proxy

    from texturefusion_tpu.__main__ import main as cli_main
    from texturefusion_tpu.io import tum

    data = os.path.join(out_dir, "tum_proxy")
    t0 = time.perf_counter()
    make_tum_proxy.generate(data, N_FRAMES)
    say(f"phase c: dataset of {N_FRAMES} frames in "
        f"{time.perf_counter() - t0:.1f} s")
    out = os.path.join(data, "out")
    t0 = time.perf_counter()
    rc = cli_main([data, "", "0.02", "0", "--out", out])
    say(f"phase c: CLI returned {rc} after {time.perf_counter() - t0:.1f} s "
        f"(compilation included)")
    if rc != 0:
        raise RuntimeError(f"CLI exited with {rc}")
    est_ts, est = tum.read_trajectory(os.path.join(out, "trajectory.txt"))
    if len(est) != N_FRAMES:
        raise RuntimeError(f"trajectory.txt has {len(est)} poses, "
                           f"expected {N_FRAMES}")
    for name in ("fused.ply", "model.obj", "model.png"):
        path = os.path.join(out, name)
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            raise RuntimeError(f"CLI wrote no {name}")
    with open(os.path.join(out, "fused.ply"), "rb") as f:
        head = f.read(512).decode("ascii", "replace")
    n_vert = int(head.split("element vertex ")[1].split()[0])
    gt_ts, gt = tum.read_trajectory(os.path.join(data, "groundtruth.txt"))
    pairs = tum.associate_timestamps(est_ts, gt_ts, max_dt=0.05)
    ate = tum.ate_rmse(est[[i for i, _ in pairs]],
                       gt[[j for _, j in pairs]]) * 1e3
    say(f"phase c: {len(est)} poses, fused.ply {n_vert} vertices, "
        f"model.obj/.png written, ATE {ate:.2f} mm (gate "
        f"{ATE_GATE_MM} mm)")
    if n_vert == 0 or not np.isfinite(ate) or ate > ATE_GATE_MM:
        raise RuntimeError(f"CLI run out of gate: ATE {ate:.2f} mm, "
                           f"{n_vert} vertices")


# ------------------------------------------------------------- phase d

def phase_bench_pipeline(config, packed, gt, scene) -> None:
    """bench.py's textured loop, once, with the accuracy gates. Programs
    not compiled by the earlier phases compile inside this run."""
    import bench
    from texturefusion_tpu.fusion.pipeline import TexturedPipeline
    from texturefusion_tpu.io import tum

    t0 = time.perf_counter()
    pipe, fps = bench.run(TexturedPipeline, config, packed, 0,
                          range(N_FRAMES))
    pipe.finish()
    wall = time.perf_counter() - t0
    est = pipe.trajectory()
    ate = tum.ate_rmse(est, gt[:len(est)]) * 1e3
    merr = bench.map_error_mm(pipe, scene, est, gt)
    say(f"phase d: {fps:.2f} frames/s over {N_FRAMES} frames, compilation "
        f"included (bring-up reading, not a benchmark; {wall:.1f} s with "
        f"finish), ATE {ate:.2f} mm, map RMS {merr['map_rms_mm']} mm "
        f"(median {merr['map_median_mm']} mm), "
        f"{len(pipe.slam.keyframes)} keyframes, "
        f"{pipe.stats['reintegrations']} reintegrations")
    if not (ate <= ATE_GATE_MM and merr["map_rms_mm"] <= MAP_RMS_GATE_MM):
        raise RuntimeError(f"bench-shaped run out of gate: ATE {ate:.2f}"
                           f" mm, map RMS {merr['map_rms_mm']} mm")


# -------------------------------------------------------- four cards

def phase_four_cards(n_frames: int = 24) -> None:
    """ReconstructionPipeline with the chunk-sharded TSDF and edge-sharded
    BA over a 4-card mesh against the same frames on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from texturefusion_tpu.config import ParallelConfig
    from texturefusion_tpu.core import camera as cam
    from texturefusion_tpu.fusion.pipeline import ReconstructionPipeline

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found "
                           f"{len(jax.devices())}")
    base = bench.bench_config().replace(parallel=ParallelConfig())
    intr = cam.Intrinsics.from_config(base.camera)
    # the first frames of the 120-frame loop (its per-frame motion)
    packed, _, _ = bench.make_frames(base, intr, N_FRAMES)

    def run(cfg):
        t0 = time.perf_counter()
        pipe = ReconstructionPipeline(cfg)
        for i in range(n_frames):
            pipe.process_frame(jnp.asarray(packed[i]), timestamp=float(i))
        pipe.finish()
        verts, _, _, _ = pipe.mesher.full_mesh()
        out = {"weight_sum": float(jnp.sum(pipe.volume.batch.weight)),
               "active": pipe.volume.n_active(), "verts": len(verts),
               "traj": pipe.trajectory(),
               "keyframes": len(pipe.slam.keyframes),
               "edges": pipe.slam.n_edges,
               "s": time.perf_counter() - t0}
        say(f"{cfg.parallel.n_devices or 1} card(s): {n_frames} frames in "
            f"{out['s']:.1f} s (compilation included), "
            f"{out['keyframes']} keyframes, {out['edges']} edges, "
            f"{out['active']} chunks, weight sum {out['weight_sum']:.1f}, "
            f"{out['verts']} mesh vertices")
        return out, pipe

    one, _ = run(base)
    four, pipe4 = run(base.replace(parallel=ParallelConfig(
        tsdf_sharded=True, n_devices=4)))
    shards = pipe4.volume.batch.weight.sharding
    say(f"sharded TSDF over {len(shards.device_set)} devices: {shards}")
    par = Parity()
    why = "psum of Hessian blocks in another order; same frames, same chunks"
    par.check("4 cards vs 1", "weight sum rel |d|",
              abs(four["weight_sum"] - one["weight_sum"])
              / one["weight_sum"], 1e-3, why)
    par.check("4 cards vs 1", "active chunk count |d|",
              float(abs(four["active"] - one["active"])), 0.0,
              "allocation is host-side and identical")
    par.check("4 cards vs 1", "mesh vertex count rel |d|",
              abs(four["verts"] - one["verts"]) / max(one["verts"], 1),
              1e-3, why)
    par.check("4 cards vs 1", "trajectory |dt| max (mm)",
              float(np.abs(four["traj"][:, :3, 3]
                           - one["traj"][:, :3, 3]).max() * 1e3), 1.0, why)
    if len(shards.device_set) != 4:
        par.failed.append("TSDF not sharded over 4 devices")
    if par.failed:
        raise RuntimeError("four-card check failed: "
                           + "; ".join(par.failed))


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded path and its "
                         "one-card comparison")
    ap.add_argument("--out", default=os.path.join(ROOT, "smoke_out"),
                    help="directory for the generated dataset and the "
                         "CLI's outputs")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        import jax

        import texturefusion_tpu  # noqa: F401  (fails outside the repo)

        phase_device()
        if args.four_cards:
            phase_four_cards()
        else:
            t0 = time.perf_counter()
            config, packed, gt, scene = bench_frames()
            say(f"bench loop: {N_FRAMES} frames made in "
                f"{time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            phase_stage_parity(config, packed, gt)
            say(f"phase b passed in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            phase_cli(args.out)
            say(f"phase c passed in {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            phase_bench_pipeline(config, packed, gt, scene)
            say(f"phase d passed in {time.perf_counter() - t0:.1f} s")
    except Exception as e:  # every failure ends the run without a result
        import traceback
        traceback.print_exc()
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
