"""Distributed FastBA: pose-graph GN with edge-sharded psum reduction.

The BASELINE.json north-star configuration: keyframes' pose graph
optimized across devices/hosts by sharding EDGES over the mesh — each
device reduces its edges' closed-form 6×6 Hessian blocks into the dense
system, a single psum combines them over ICI, and the (small) solve runs
replicated. The pre-integrated edge representation (slam/fastba.py, after
ref: MultiViewGeometry.cpp:720-834) makes the per-edge payload O(1), so
the reduction is tiny — exactly the property SURVEY.md §5 calls out.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from texturefusion_tpu.config import BAConfig
from texturefusion_tpu.core import se3
from texturefusion_tpu.slam import fastba
from texturefusion_tpu.slam.fastba import EdgeSums

_PREC = jax.lax.Precision.HIGHEST


def _local_system(poses, edges, n_kf):
    blocks = fastba._edge_blocks(poses, edges)
    return fastba.assemble_dense(*blocks, edges.kf_i, edges.kf_j, n_kf)


def distributed_gn(poses: jnp.ndarray, edges: EdgeSums, n_kf: int,
                   active: jnp.ndarray, cfg: BAConfig, mesh: Mesh,
                   axis: str = "shard"
                   ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Edge-sharded Gauss-Newton: same semantics as
    fastba.gauss_newton_rounds but with edges partitioned over `axis`.

    Edge arrays must have leading dim divisible by the mesh size (pad with
    valid=False). Returns (poses, err_before, err_after) — replicated.
    JIT-compiled once per (mesh, n_kf, edge-bucket) — an eager shard_map
    re-traces and dispatches op-by-op on every call.
    """
    return _distributed_gn_jit(mesh, axis, n_kf, cfg)(poses, edges, active)


@functools.lru_cache(maxsize=None)
def _distributed_gn_jit(mesh: Mesh, axis: str, n_kf: int, cfg: BAConfig):
    n_dev = mesh.shape[axis]

    def call(poses, edges, active):
        assert edges.s_w.shape[0] % n_dev == 0, "pad edges to mesh multiple"
        return _distributed_gn_body(poses, edges, active, mesh, axis,
                                    n_kf, cfg)

    return jax.jit(call)


def _distributed_gn_body(poses, edges, active, mesh, axis, n_kf, cfg):
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), jax.tree.map(lambda _: P(axis), edges), P()),
        out_specs=(P(), P(), P()),
    )
    def run(poses, edge_shard, active):
        def total_err(p):
            local = jnp.sum(fastba.edge_errors(p, edge_shard))
            return jax.lax.psum(local, axis)

        err0 = total_err(poses)

        def gn_iter(_, poses):
            h_loc, b_loc = _local_system(poses, edge_shard, n_kf)
            h = jax.lax.psum(h_loc, axis)
            b = jax.lax.psum(b_loc, axis)
            diag = jnp.arange(n_kf * 6)
            first_active = jnp.argmax(active)
            pin = (jnp.arange(n_kf) == first_active) | (~active)
            pin6 = jnp.repeat(pin, 6)
            h = h.at[diag, diag].add(jnp.where(pin6, 1e12, 0.0))
            h = h.at[diag, diag].add(cfg.levenberg_lambda
                                     + 1e-6 * jnp.abs(h[diag, diag]))
            dx = -jnp.linalg.solve(h, b)
            dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros_like(dx))
            xi = jnp.where(active[:, None], dx.reshape(n_kf, 6), 0.0)
            upd = se3.compose(se3.se3_exp(xi), poses)
            return jnp.where(active[:, None, None], upd, poses)

        new_poses = jax.lax.fori_loop(0, cfg.gn_iterations_per_round,
                                      gn_iter, poses)
        err1 = total_err(new_poses)
        grew = err1 > err0 * cfg.rollback_error_growth
        out = jnp.where(grew, poses, new_poses)
        return out, err0, jnp.where(grew, err0, err1)

    return run(poses, edges, active)


def schur_gn(poses: jnp.ndarray, edges: EdgeSums, n_kf: int,
             active: jnp.ndarray, cfg: BAConfig, mesh: Mesh,
             axis: str = "shard", sep_budget: int = 128
             ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Keyframe-partitioned distributed GN with Schur-complement reduction
    (BASELINE.json config 5: "keyframe-partitioned distributed BA via
    Schur reduction").

    Keyframes are partitioned into contiguous blocks of B = n_kf/n_dev per
    device. A keyframe is a SEPARATOR iff some valid edge couples it
    across a block boundary; all other keyframes are INTERIOR — their
    Hessian rows couple only within their own device's block, so each
    device eliminates its interiors locally:

        S  =  H_ss − Σ_d H_sI_d · H_I_dI_d⁻¹ · H_I_ds     (psum over d)

    and only the small [6·n_sep] separator system is solved (replicated),
    followed by local interior back-substitution. Per-iteration solve cost
    drops from O((6K)³) to O((6B)³ + (6S)³); the per-block elimination is
    where the devices actually divide the work.  In the reference every GN
    solve is a single-threaded sparse LLT on one host
    (ref: MultiViewGeometry.cpp:1024-1143); this is the scale-out design
    SURVEY.md §5 prescribes.

    Requirements: n_kf divisible by mesh size (pad with inactive rows);
    edge arrays padded to a mesh multiple (pad_edges_for_mesh). When the
    separator set overflows `sep_budget`, the iteration falls back to the
    dense replicated solve (lax.cond) — correctness never depends on the
    partition being favorable.

    Returns (poses, err_before, err_after), replicated. JIT-compiled once
    per (mesh, n_kf, edge-bucket) like distributed_gn.
    """
    return _schur_gn_jit(mesh, axis, n_kf, cfg, sep_budget)(
        poses, edges, active)


@functools.lru_cache(maxsize=None)
def _schur_gn_jit(mesh: Mesh, axis: str, n_kf: int, cfg: BAConfig,
                  sep_budget: int):
    n_dev = mesh.shape[axis]
    assert n_kf % n_dev == 0, "pad n_kf to a mesh multiple"

    def call(poses, edges, active):
        assert edges.s_w.shape[0] % n_dev == 0, "pad edges to mesh multiple"
        return _schur_gn_body(poses, edges, active, mesh, axis, n_kf, cfg,
                              sep_budget)

    return jax.jit(call)


def _schur_gn_body(poses, edges, active, mesh, axis, n_kf, cfg, sep_budget):
    n_dev = mesh.shape[axis]
    blk = n_kf // n_dev           # keyframes per device block
    s_max = min(sep_budget, n_kf)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), jax.tree.map(lambda _: P(axis), edges), P()),
        out_specs=(P(), P(), P()),
    )
    def run(poses, edge_shard, active):
        d = jax.lax.axis_index(axis)

        def total_err(p):
            local = jnp.sum(fastba.edge_errors(p, edge_shard))
            return jax.lax.psum(local, axis)

        err0 = total_err(poses)

        # ---- separator classification (edge-sharded scatter + psum) ----
        dev_i = edge_shard.kf_i // blk
        dev_j = edge_shard.kf_j // blk
        cross = (dev_i != dev_j) & edge_shard.valid
        sep_loc = jnp.zeros((n_kf,), jnp.float32)
        sep_loc = sep_loc.at[edge_shard.kf_i].max(cross.astype(jnp.float32))
        sep_loc = sep_loc.at[edge_shard.kf_j].max(cross.astype(jnp.float32))
        sep = jax.lax.psum(sep_loc, axis) > 0                     # [K] bool
        interior = ~sep
        n_sep = jnp.sum(sep)
        # compacted separator slots (replicated, deterministic)
        sep_idx = jnp.nonzero(sep, size=s_max, fill_value=0)[0]   # [S]
        sep_ok = jnp.arange(s_max) < n_sep                        # [S]
        sep6 = (sep_idx[:, None] * 6
                + jnp.arange(6)[None, :]).reshape(-1)             # [6S]
        ok6 = jnp.repeat(sep_ok, 6)

        my = jnp.arange(blk) + d * blk                            # [B]
        my6 = (my[:, None] * 6 + jnp.arange(6)[None, :]).reshape(-1)
        int_mine6 = jnp.repeat(interior[my], 6)                   # [6B]

        def gn_iter(_, poses):
            h_loc, b_loc = _local_system(poses, edge_shard, n_kf)
            h = jax.lax.psum(h_loc, axis)
            b = jax.lax.psum(b_loc, axis)
            diag = jnp.arange(n_kf * 6)
            first_active = jnp.argmax(active)
            pin = (jnp.arange(n_kf) == first_active) | (~active)
            pin6 = jnp.repeat(pin, 6)
            h = h.at[diag, diag].add(jnp.where(pin6, 1e12, 0.0))
            h = h.at[diag, diag].add(cfg.levenberg_lambda
                                     + 1e-6 * jnp.abs(h[diag, diag]))

            def dense_solve(_):
                return -jnp.linalg.solve(h, b)

            def schur_solve(_):
                # A_d: my block's interior sub-system, identity on
                # non-interior rows/cols (elimination is a no-op there)
                hb = h[my6][:, my6]                               # [6B,6B]
                m2 = int_mine6[:, None] & int_mine6[None, :]
                a_d = jnp.where(m2, hb, 0.0) \
                    + jnp.diag(jnp.where(int_mine6, 0.0, 1.0))
                # coupling block: interior rows of my block × sep columns
                c_d = jnp.where(int_mine6[:, None] & ok6[None, :],
                                h[my6][:, sep6], 0.0)             # [6B,6S]
                b_i = jnp.where(int_mine6, b[my6], 0.0)           # [6B]
                # X = A⁻¹C and y = A⁻¹b in one solve
                xy = jnp.linalg.solve(
                    a_d, jnp.concatenate([c_d, b_i[:, None]], axis=1))
                x_d, y_d = xy[:, :-1], xy[:, -1]
                # Schur contributions, reduced over devices
                g = jax.lax.psum(
                    jnp.matmul(c_d.T, x_d, precision=_PREC), axis)
                g_b = jax.lax.psum(
                    jnp.matmul(c_d.T, y_d[:, None], precision=_PREC)[:, 0],
                    axis)
                s_mat = h[sep6][:, sep6] - g                      # [6S,6S]
                okm = ok6[:, None] & ok6[None, :]
                s_mat = jnp.where(okm, s_mat, 0.0) \
                    + jnp.diag(jnp.where(ok6, 0.0, 1.0))
                rhs = jnp.where(ok6, b[sep6] - g_b, 0.0)
                dx_s = -jnp.linalg.solve(s_mat, rhs)              # [6S]
                dx = jnp.zeros((n_kf * 6,))
                dx = dx.at[sep6].add(jnp.where(ok6, dx_s, 0.0))
                # interior back-substitution: dx_I = −A⁻¹(b_I + C dx_s)
                dx_i = -(y_d + jnp.matmul(x_d, jnp.where(ok6, dx_s, 0.0),
                                          precision=_PREC))
                dx_i = jnp.where(int_mine6, dx_i, 0.0)
                # each interior var owned by exactly one device
                dx_i_all = jax.lax.psum(
                    jnp.zeros((n_kf * 6,)).at[my6].add(dx_i), axis)
                return dx + dx_i_all

            dx = jax.lax.cond(n_sep <= s_max, schur_solve, dense_solve,
                              None)
            dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros_like(dx))
            xi = jnp.where(active[:, None], dx.reshape(n_kf, 6), 0.0)
            upd = se3.compose(se3.se3_exp(xi), poses)
            return jnp.where(active[:, None, None], upd, poses)

        new_poses = jax.lax.fori_loop(0, cfg.gn_iterations_per_round,
                                      gn_iter, poses)
        err1 = total_err(new_poses)
        grew = err1 > err0 * cfg.rollback_error_growth
        out = jnp.where(grew, poses, new_poses)
        return out, err0, jnp.where(grew, err0, err1)

    return run(poses, edges, active)


def ba_rounds(poses: jnp.ndarray, edges_full: EdgeSums, n_kf: int,
              active: jnp.ndarray, cfg: BAConfig, mesh: Mesh,
              e_bucket: int, use_schur: bool, sep_budget: int,
              axis: str = "shard"):
    """The COMPLETE per-keyframe BA as one compiled program: edge-bucket
    slice → mesh padding → gn_rounds× (distributed/Schur GN + outlier
    pruning between rounds) — one dispatch instead of ~40 eager ops per
    keyframe (slicing, padding and pruning dominated the tracking thread
    when dispatched eagerly).

    Returns (poses, edge_valid[e_bucket], errs[rounds, 2]) — device."""
    return _ba_rounds_jit(mesh, axis, n_kf, e_bucket, cfg, use_schur,
                          sep_budget)(poses, edges_full, active)


@functools.lru_cache(maxsize=None)
def _ba_rounds_jit(mesh: Mesh, axis: str, n_kf: int, e_bucket: int,
                   cfg: BAConfig, use_schur: bool, sep_budget: int):
    n_dev = mesh.shape[axis]
    e_pad = ((e_bucket + n_dev - 1) // n_dev) * n_dev

    def call(poses, edges_full, active):
        edges = jax.tree.map(lambda a: a[:e_bucket], edges_full)
        if e_pad != e_bucket:
            edges = EdgeSums(*(jnp.pad(
                a, [(0, e_pad - e_bucket)] + [(0, 0)] * (a.ndim - 1))
                for a in edges))
        errs = []
        for r in range(cfg.gn_rounds):
            if use_schur:
                poses_n, e0, e1 = _schur_gn_body(
                    poses, edges, active, mesh, axis, n_kf, cfg,
                    sep_budget)
            else:
                poses_n, e0, e1 = _distributed_gn_body(
                    poses, edges, active, mesh, axis, n_kf, cfg)
            poses = poses_n
            errs.append(jnp.stack([e0, e1]))
            if r < cfg.gn_rounds - 1:
                edges = fastba.prune_outlier_edges(poses, edges)
        return poses, edges.valid[:e_bucket], jnp.stack(errs)

    return jax.jit(call)


def pad_edges_for_mesh(edges: EdgeSums, n_dev: int) -> EdgeSums:
    """Pad edge arrays so the leading dim divides the mesh size."""
    e = edges.s_w.shape[0]
    target = ((e + n_dev - 1) // n_dev) * n_dev
    if target == e:
        return edges
    pad = target - e

    def pad_arr(a):
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, widths)

    return EdgeSums(*(pad_arr(a) for a in edges))


def shard_edges(edges: EdgeSums, mesh: Mesh, axis: str = "shard") -> EdgeSums:
    """Place edge arrays with their leading dim sharded over the mesh."""
    sh = NamedSharding(mesh, P(axis))
    return jax.tree.map(lambda a: jax.device_put(a, sh), edges)
