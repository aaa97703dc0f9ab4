"""Multi-device scaling benchmark: sharded TSDF + distributed BA.

Reports frames/s for the chunk-sharded integration step and BA GN
iterations/s at 1 device vs all available devices, plus scaling
efficiency — the BASELINE.md reporting points. On a single-chip box this
measures 1-chip numbers and the virtual-device path only validates
correctness (CPU virtual devices do not give meaningful speedups).

Usage: python examples/bench_multichip.py [--devices N] [--cap 4096]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def bench_sharded_tsdf(n_devices, cap, n_iters=20):
    from texturefusion_tpu.config import CameraConfig, TSDFConfig
    from texturefusion_tpu.core import camera as cam
    from texturefusion_tpu.parallel import sharded_tsdf
    from texturefusion_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_devices)
    intr = cam.Intrinsics.from_config(CameraConfig(far_plane=6.0))
    cfg = TSDFConfig(voxel_resolution=0.02, capacity=cap)
    n_vox = cfg.chunk_size ** 3
    batch, origins = sharded_tsdf.make_sharded_batch(cap, n_vox, mesh)
    rng = np.random.default_rng(0)
    sh = NamedSharding(mesh, P("shard"))
    origins = jax.device_put(
        jnp.asarray((rng.integers(-10, 10, (cap, 3)) * 0.16).astype(np.float32)), sh)
    active = jax.device_put(jnp.ones(cap, bool), sh)
    depth = jnp.asarray(rng.uniform(0.5, 3.0, (intr.height, intr.width)).astype(np.float32))
    rgb = jnp.asarray(rng.uniform(0, 1, (intr.height, intr.width, 3)).astype(np.float32))
    quality = jnp.zeros_like(depth)
    pose = jnp.eye(4)
    step = sharded_tsdf.sharded_integrate_step(mesh, intr, cfg)
    batch, _ = step(batch, origins, active, depth, rgb, quality, pose,
                    jnp.float32(1.0))
    jax.block_until_ready(batch.sdf)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        batch, _ = step(batch, origins, active, depth, rgb, quality, pose,
                        jnp.float32(1.0))
    jax.block_until_ready(batch.sdf)
    dt = time.perf_counter() - t0
    return n_iters / dt


def bench_distributed_ba(n_devices, n_kf=64, n_edges=512, n_iters=10):
    from texturefusion_tpu.config import BAConfig
    from texturefusion_tpu.parallel import ba as pba
    from texturefusion_tpu.parallel.mesh import make_mesh
    from texturefusion_tpu.slam import fastba

    mesh = make_mesh(n_devices)
    rng = np.random.default_rng(1)
    edges = fastba.make_edges(n_edges)
    ki = rng.integers(0, n_kf - 1, n_edges)
    kj = ki + 1
    p = rng.uniform(-1, 1, (n_edges, 64, 3)).astype(np.float32)
    sums = [fastba.preintegrate_edge(jnp.asarray(p[e]), jnp.asarray(p[e]),
                                     jnp.ones(64)) for e in range(8)]
    edges = edges._replace(
        kf_i=jnp.asarray(ki, jnp.int32), kf_j=jnp.asarray(kj, jnp.int32),
        s_w=jnp.full(n_edges, 64.0),
        s_p=jnp.tile(sums[0][1], (n_edges, 1)),
        s_q=jnp.tile(sums[0][2], (n_edges, 1)),
        s_pp=jnp.tile(sums[0][3], (n_edges, 1, 1)),
        s_qq=jnp.tile(sums[0][4], (n_edges, 1, 1)),
        s_pq=jnp.tile(sums[0][5], (n_edges, 1, 1)),
        valid=jnp.ones(n_edges, bool))
    edges = pba.shard_edges(pba.pad_edges_for_mesh(edges, mesh.size), mesh)
    poses = jnp.tile(jnp.eye(4), (n_kf, 1, 1))
    active = jnp.ones(n_kf, bool)
    cfg = BAConfig(gn_iterations_per_round=4)
    out = pba.distributed_gn(poses, edges, n_kf, active, cfg, mesh)
    jax.block_until_ready(out[0])
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out = pba.distributed_gn(poses, edges, n_kf, active, cfg, mesh)
    jax.block_until_ready(out[0])
    dt = time.perf_counter() - t0
    return n_iters * cfg.gn_iterations_per_round / dt


def _synthetic_pose_graph(n_kf, max_edges=4096, window=7, seed=2):
    """Loop-shaped pose graph: each keyframe links to its `window`
    predecessors (local co-visibility) plus n_kf/4 long-range loop
    closures — the structure the live pipeline produces, which is what
    makes contiguous keyframe blocks mostly interior for the Schur
    partition (ref graph shape: GCSLAM.cpp:52-185 edges per keyframe)."""
    from texturefusion_tpu.slam import fastba
    rng = np.random.default_rng(seed)
    ki, kj = [], []
    for d in range(1, window + 1):
        i = np.arange(d, n_kf)
        ki.append(i - d)
        kj.append(i)
    n_loops = n_kf // 4
    a = rng.integers(0, n_kf // 2, n_loops)
    b = rng.integers(n_kf // 2, n_kf, n_loops)
    ki.append(a)
    kj.append(b)
    ki = np.concatenate(ki)[:max_edges]
    kj = np.concatenate(kj)[:max_edges]
    n_e = len(ki)
    e_bucket = 16
    while e_bucket < n_e:
        e_bucket *= 2
    edges = fastba.make_edges(e_bucket)
    pts = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    pts[:, 2] += 2.0
    s = fastba.preintegrate_edge(jnp.asarray(pts), jnp.asarray(pts),
                                 jnp.ones(64))
    pad = e_bucket - n_e
    edges = edges._replace(
        kf_i=jnp.asarray(np.concatenate([ki, np.zeros(pad)]), jnp.int32),
        kf_j=jnp.asarray(np.concatenate([kj, np.zeros(pad)]), jnp.int32),
        s_w=jnp.full(e_bucket, 64.0),
        s_p=jnp.tile(s[1], (e_bucket, 1)),
        s_q=jnp.tile(s[2], (e_bucket, 1)),
        s_pp=jnp.tile(s[3], (e_bucket, 1, 1)),
        s_qq=jnp.tile(s[4], (e_bucket, 1, 1)),
        s_pq=jnp.tile(s[5], (e_bucket, 1, 1)),
        valid=jnp.asarray(np.arange(e_bucket) < n_e))
    return edges, n_e


def bench_ba_scale(n_devices, ks=(64, 128, 256, 512), n_iters=3,
                   sep_budget=128):
    """Dense vs Schur GN ms/iteration across keyframe counts at the
    configured capacity limits (BAConfig max_keyframes=512,
    max_edges=4096) — measures the Schur crossover K.
    Returns a list of row dicts."""
    from texturefusion_tpu.config import BAConfig
    from texturefusion_tpu.parallel import ba as pba
    from texturefusion_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_devices)
    cfg = BAConfig(gn_iterations_per_round=1)
    rows = []
    for k in ks:
        edges, n_e = _synthetic_pose_graph(k)
        edges = pba.shard_edges(pba.pad_edges_for_mesh(edges, mesh.size),
                                mesh)
        poses = jnp.tile(jnp.eye(4), (k, 1, 1))
        active = jnp.ones(k, bool)
        row = {"K": k, "E": n_e, "n_dev": n_devices}

        def run_dense():
            return pba.distributed_gn(poses, edges, k, active, cfg, mesh)

        def run_schur():
            return pba.schur_gn(poses, edges, k, active, cfg, mesh,
                                sep_budget=sep_budget)

        for name, fn in (("dense", run_dense), ("schur", run_schur)):
            try:
                out = fn()
                jax.block_until_ready(out[0])
                t0 = time.perf_counter()
                for _ in range(n_iters):
                    out = fn()
                jax.block_until_ready(out[0])
                row[f"{name}_ms_per_gn_iter"] = round(
                    (time.perf_counter() - t0) * 1e3
                    / (n_iters * cfg.gn_iterations_per_round), 2)
            except Exception as e:   # noqa: BLE001 — report, keep going
                row[f"{name}_error"] = repr(e)
        rows.append(row)
        print("ba_scale:", row)
    return rows


def bench_full_step(n_devices, cap=512, n_iters=10):
    """The complete multi-chip map cycle (discovery + sharded integrate +
    meshing + datacost + MRF + distributed BA) — steps/s."""
    import __graft_entry__  # noqa: F401  (repo-root path side effect)
    from texturefusion_tpu.config import CameraConfig, tiny_test_config
    from texturefusion_tpu.core import camera as cam
    from texturefusion_tpu.models.reconstruction import (
        MultichipFullState, make_multichip_full_step)
    from texturefusion_tpu.ops import tsdf as tsdf_ops
    from texturefusion_tpu.parallel import ba as pba
    from texturefusion_tpu.parallel.mesh import make_mesh
    from texturefusion_tpu.slam import fastba
    from texturefusion_tpu.texture import mrf as mrf_ops

    mesh = make_mesh(n_devices)
    sh = NamedSharding(mesh, P("shard"))
    rep = NamedSharding(mesh, P())
    cfg = tiny_test_config()
    intr = cam.Intrinsics.from_config(CameraConfig(far_plane=6.0))
    n_kf = 16
    cap = max(cap, n_devices)
    cap -= cap % n_devices
    n_vox = cfg.tsdf.chunk_size ** 3
    mesh_u = 64
    rng = np.random.default_rng(0)
    step = make_multichip_full_step(mesh, intr, cfg.tsdf, cfg.ba, n_kf,
                                    mesh_u)
    batch = tsdf_ops.ChunkBatch(
        sdf=jax.device_put(jnp.full((cap, n_vox), tsdf_ops.RESET_SDF), sh),
        weight=jax.device_put(jnp.zeros((cap, n_vox)), sh),
        color=jax.device_put(jnp.zeros((cap, n_vox, 3)), sh),
        color_count=jax.device_put(jnp.zeros((cap, n_vox)), sh))
    origins = jax.device_put(jnp.asarray(
        (rng.integers(-8, 8, (cap, 3)) * 0.16).astype(np.float32)), sh)
    edges = fastba.make_edges(max(64, n_devices))
    p = jnp.asarray(rng.uniform(-1, 1, (32, 3)).astype(np.float32))
    s = fastba.preintegrate_edge(p, p, jnp.ones(32))
    edges = edges._replace(
        kf_i=edges.kf_i.at[0].set(0), kf_j=edges.kf_j.at[0].set(1),
        s_w=edges.s_w.at[0].set(s[0]), s_p=edges.s_p.at[0].set(s[1]),
        s_q=edges.s_q.at[0].set(s[2]), s_pp=edges.s_pp.at[0].set(s[3]),
        s_qq=edges.s_qq.at[0].set(s[4]), s_pq=edges.s_pq.at[0].set(s[5]),
        valid=edges.valid.at[0].set(True))
    edges = jax.tree.map(lambda a: jax.device_put(a, sh),
                         pba.pad_edges_for_mesh(edges, n_devices))
    state = MultichipFullState(
        batch=batch, origins=origins,
        active=jax.device_put(jnp.ones(cap, bool), sh),
        datacost=jax.device_put(jnp.zeros((cap, n_kf)), sh),
        poses=jax.device_put(jnp.tile(jnp.eye(4), (n_kf, 1, 1)), rep),
        edges=edges)
    depth = jnp.asarray(rng.uniform(0.5, 3.0, (intr.height, intr.width))
                        .astype(np.float32))
    rgb = jnp.asarray(rng.uniform(0, 1, (intr.height, intr.width, 3))
                      .astype(np.float32))
    quality = jnp.abs(rgb[..., 0])
    active_kf = jnp.ones(n_kf, bool)
    mesh_slots = jax.device_put(jnp.arange(mesh_u, dtype=jnp.int32) % cap,
                                rep)
    nodes, ll = 256, 8
    problem = mrf_ops.MRFProblem(
        unary=jax.device_put(jnp.asarray(
            rng.uniform(0, 1, (nodes, ll)).astype(np.float32)), rep),
        label_kf=jax.device_put(jnp.asarray(
            rng.integers(0, n_kf, (nodes, ll)).astype(np.int32)), rep),
        neighbors=jax.device_put(jnp.asarray(
            rng.integers(0, nodes, (nodes, 6)).astype(np.int32)), rep),
        parity=jax.device_put(jnp.arange(nodes, dtype=jnp.int32) % 2, rep),
        init_label=jax.device_put(jnp.zeros(nodes, jnp.int32), rep),
        n_valid=jax.device_put(jnp.ones(nodes, bool), rep))

    args = (depth, rgb, quality, jnp.eye(4), jnp.int32(1), active_kf,
            mesh_slots, problem)
    state, *_ = step(state, *args)
    jax.block_until_ready(state.poses)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        state, n_found, vcount, labels = step(state, *args)
    _ = np.asarray(n_found)   # wait for the host copy, not only compute
    jax.block_until_ready(state.poses)
    return n_iters / (time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cap", type=int, default=4096)
    args = ap.parse_args()
    n_all = len(jax.devices())
    print(f"devices available: {n_all} ({jax.devices()[0].platform})")
    print(f"{'config':>34s} | {'1 device':>12s} | "
          f"{f'{n_all} devices':>12s} | efficiency")

    fps1 = bench_sharded_tsdf(1, args.cap)
    ba1 = bench_distributed_ba(1)
    full1 = bench_full_step(1)
    if n_all > 1:
        fpsN = bench_sharded_tsdf(n_all, args.cap)
        baN = bench_distributed_ba(n_all)
        fullN = bench_full_step(n_all)
        print(f"{'sharded TSDF integrate (steps/s)':>34s} | {fps1:12.2f} | "
              f"{fpsN:12.2f} | {fpsN / (fps1 * n_all):.0%} per-device")
        print(f"{'distributed BA (GN iters/s)':>34s} | {ba1:12.1f} | "
              f"{baN:12.1f} | {baN / ba1:.0%} vs 1-device")
        print(f"{'FULL map cycle (steps/s)':>34s} | {full1:12.2f} | "
              f"{fullN:12.2f} | {fullN / full1:.0%} vs 1-device")
        if jax.devices()[0].platform == "cpu":
            print("(virtual CPU devices validate sharding correctness; "
                  "speedups require real chips)")
    else:
        print(f"{'sharded TSDF integrate (steps/s)':>34s} | {fps1:12.2f} | "
              f"{'—':>12s} |")
        print(f"{'distributed BA (GN iters/s)':>34s} | {ba1:12.1f} | "
              f"{'—':>12s} |")
        print(f"{'FULL map cycle (steps/s)':>34s} | {full1:12.2f} | "
              f"{'—':>12s} |")
        print("single device only — multi-chip efficiency requires hardware")


if __name__ == "__main__":
    main()
