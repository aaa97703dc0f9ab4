"""FastBA: pose-graph Gauss-Newton over pre-integrated 3D-3D

JAX re-design of the reference's FastBA backend
(ref: GCSLAM/MultiViewGeometry.cpp — ComputeJacobianInfo :720-834,
optimizeKeyFrameMapRobust :915-1207, optimizeKeyFrameMap :1209-1217,
reprojection_error_3Dto3D :1219-1248; pre-integration
FrameCorrespondence::preIntegrate MultiViewGeometry.h:314-373 and
preIntegrateWithHuberNorm :245-311).

The key idea carried over: each keyframe-pair edge's correspondence set is
reduced once to fixed-size second-moment sums, making every GN iteration
O(edges) with closed-form 6×6 Jacobian blocks — no per-point work. This is
also what makes the reduction tiny for multi-device BA (SURVEY.md §5):
per-edge blocks are psum-reduced across an edge-sharded mesh
(see parallel/ba.py).

Cost: E(T) = Σ_edges Σ_k w_k ‖ T_i p_k − T_j q_k ‖²  over world poses T.
Left-multiplicative se3 updates; first keyframe (gauge) is pinned.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.config import BAConfig
from texturefusion_tpu.core import se3

_PREC = jax.lax.Precision.HIGHEST


class EdgeSums(NamedTuple):
    """Pre-integrated per-edge statistics (all Huber-weighted)."""

    kf_i: jnp.ndarray   # [E] int32 — reference keyframe index
    kf_j: jnp.ndarray   # [E] int32 — source keyframe index
    s_w: jnp.ndarray    # [E] Σw
    s_p: jnp.ndarray    # [E, 3] Σw·p      (points in frame i)
    s_q: jnp.ndarray    # [E, 3] Σw·q      (points in frame j)
    s_pp: jnp.ndarray   # [E, 3, 3] Σw·ppᵀ
    s_qq: jnp.ndarray   # [E, 3, 3] Σw·qqᵀ
    s_pq: jnp.ndarray   # [E, 3, 3] Σw·pqᵀ
    valid: jnp.ndarray  # [E] bool


def preintegrate_edge(p: jnp.ndarray, q: jnp.ndarray, w: jnp.ndarray
                      ) -> Tuple[jnp.ndarray, ...]:
    """Reduce correspondences to second-moment sums
    (ref: MultiViewGeometry.h:314-373 preIntegrate). p, q: [N, 3]; w: [N]
    (zero for non-inliers; Huber weights already folded in)."""
    s_w = jnp.sum(w)
    s_p = jnp.einsum("n,ni->i", w, p, precision=_PREC)
    s_q = jnp.einsum("n,ni->i", w, q, precision=_PREC)
    s_pp = jnp.einsum("n,ni,nj->ij", w, p, p, precision=_PREC)
    s_qq = jnp.einsum("n,ni,nj->ij", w, q, q, precision=_PREC)
    s_pq = jnp.einsum("n,ni,nj->ij", w, p, q, precision=_PREC)
    return s_w, s_p, s_q, s_pp, s_qq, s_pq


@jax.jit
def preintegrate_from_registration(p: jnp.ndarray, q: jnp.ndarray,
                                   inliers: jnp.ndarray, pose: jnp.ndarray,
                                   huber_delta: jnp.ndarray):
    """Huber-weighted pre-integration of a registration result — the
    residual weighting + moment sums as one compiled program
    (ref: preIntegrateWithHuberNorm MultiViewGeometry.h:245-311)."""
    x = se3.transform_points(pose, q)
    rn = jnp.linalg.norm(x - p, axis=-1)
    w = inliers * jnp.where(rn <= huber_delta, 1.0,
                            huber_delta / jnp.maximum(rn, 1e-12))
    return preintegrate_edge(p, q, w)


@functools.partial(jax.jit, donate_argnames=("edges",))
def append_edge(edges: EdgeSums, e: jnp.ndarray, kf_i: int, kf_j: int,
                s_w, s_p, s_q, s_pp, s_qq, s_pq) -> EdgeSums:
    """Write one edge's sums into slot `e` (single dispatch, donated)."""
    return EdgeSums(
        kf_i=edges.kf_i.at[e].set(kf_i),
        kf_j=edges.kf_j.at[e].set(kf_j),
        s_w=edges.s_w.at[e].set(s_w),
        s_p=edges.s_p.at[e].set(s_p),
        s_q=edges.s_q.at[e].set(s_q),
        s_pp=edges.s_pp.at[e].set(s_pp),
        s_qq=edges.s_qq.at[e].set(s_qq),
        s_pq=edges.s_pq.at[e].set(s_pq),
        valid=edges.valid.at[e].set(True),
    )


@functools.partial(jax.jit, donate_argnames=("edges", "midx_store",
                                             "minl_store"))
def append_probe_edges(edges: EdgeSums, midx_store: jnp.ndarray,
                       minl_store: jnp.ndarray, e0: jnp.ndarray,
                       cand_slots: jnp.ndarray, kf_j: jnp.ndarray,
                       s_w, s_p, s_q, s_pp, s_qq, s_pq,
                       midx: jnp.ndarray, minl: jnp.ndarray,
                       take: jnp.ndarray):
    """Append every taken promotion-probe candidate as an edge in ONE
    dispatch (the per-candidate eager-slice + append_edge loop cost
    ~10 ms of host dispatch per keyframe). Candidate c (take[c]) lands
    in edge slot e0 + (#taken before c); untaken rows scatter out of
    bounds and are dropped. Also stores the raw matches for finalBA's
    Huber re-weighting. Returns (edges, midx_store, minl_store)."""
    e_cap = edges.kf_i.shape[0]
    t = take.astype(jnp.int32)
    slot = e0 + jnp.cumsum(t) - t
    slot = jnp.where(take & (slot < e_cap), slot, e_cap)    # OOB → dropped
    new_edges = EdgeSums(
        kf_i=edges.kf_i.at[slot].set(cand_slots),
        kf_j=edges.kf_j.at[slot].set(kf_j),
        s_w=edges.s_w.at[slot].set(s_w),
        s_p=edges.s_p.at[slot].set(s_p),
        s_q=edges.s_q.at[slot].set(s_q),
        s_pp=edges.s_pp.at[slot].set(s_pp),
        s_qq=edges.s_qq.at[slot].set(s_qq),
        s_pq=edges.s_pq.at[slot].set(s_pq),
        valid=edges.valid.at[slot].set(True),
    )
    return (new_edges, midx_store.at[slot].set(midx),
            minl_store.at[slot].set(minl))


def make_edges(capacity: int) -> EdgeSums:
    # NOTE: every field gets its own buffer — append_edge donates the
    # whole structure, and aliased zero arrays would be donated twice
    return EdgeSums(
        kf_i=jnp.zeros(capacity, jnp.int32),
        kf_j=jnp.zeros(capacity, jnp.int32),
        s_w=jnp.zeros(capacity),
        s_p=jnp.zeros((capacity, 3)),
        s_q=jnp.zeros((capacity, 3)),
        s_pp=jnp.zeros((capacity, 3, 3)),
        s_qq=jnp.zeros((capacity, 3, 3)),
        s_pq=jnp.zeros((capacity, 3, 3)),
        valid=jnp.zeros(capacity, bool),
    )


def _edge_moments(edges: EdgeSums, rot_i, t_i, rot_j, t_j):
    """First/second moments of transformed points x = T_i p, y = T_j q:
    returns (m_x, m_y, s_xx, s_yy, s_xy, each Σw-weighted)."""
    m_x = jnp.einsum("eij,ej->ei", rot_i, edges.s_p, precision=_PREC) \
        + edges.s_w[:, None] * t_i
    m_y = jnp.einsum("eij,ej->ei", rot_j, edges.s_q, precision=_PREC) \
        + edges.s_w[:, None] * t_j

    def outer_term(rot_a, t_a, rot_b, t_b, s_ab, s_a, s_b):
        # Σw (R_a a + t_a)(R_b b + t_b)ᵀ
        return (jnp.einsum("eik,ekl,ejl->eij", rot_a, s_ab, rot_b, precision=_PREC)
                + jnp.einsum("eik,ek,ej->eij", rot_a, s_a, t_b, precision=_PREC)
                + jnp.einsum("ei,ejk,ek->eij", t_a, rot_b, s_b, precision=_PREC)
                + edges.s_w[:, None, None] * t_a[:, :, None] * t_b[:, None, :])

    s_xx = outer_term(rot_i, t_i, rot_i, t_i, edges.s_pp, edges.s_p, edges.s_p)
    s_yy = outer_term(rot_j, t_j, rot_j, t_j, edges.s_qq, edges.s_q, edges.s_q)
    s_xy = outer_term(rot_i, t_i, rot_j, t_j, edges.s_pq, edges.s_p, edges.s_q)
    return m_x, m_y, s_xx, s_yy, s_xy


def edge_errors(poses: jnp.ndarray, edges: EdgeSums) -> jnp.ndarray:
    """Closed-form per-edge total squared error Σw‖x−y‖²
    (ref: reprojection_error_3Dto3D MultiViewGeometry.cpp:1219-1248)."""
    rot_i = poses[edges.kf_i][:, :3, :3]
    t_i = poses[edges.kf_i][:, :3, 3]
    rot_j = poses[edges.kf_j][:, :3, :3]
    t_j = poses[edges.kf_j][:, :3, 3]
    _, _, s_xx, s_yy, s_xy = _edge_moments(edges, rot_i, t_i, rot_j, t_j)
    tr = lambda m: m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    e = tr(s_xx) + tr(s_yy) - 2.0 * tr(s_xy)
    return jnp.where(edges.valid, e, 0.0)


def _skew_from_vec(v):
    return se3.hat(v)


def _edge_blocks(poses: jnp.ndarray, edges: EdgeSums):
    """Closed-form per-edge JᵀJ blocks and JᵀR
    (ref: ComputeJacobianInfo MultiViewGeometry.cpp:720-834).

    For residual r_k = x_k − y_k with x = T_i p, y = T_j q and left
    perturbations: J_i,k = [I  −x̂_k], J_j,k = −[I  −ŷ_k]. All the Σ over k
    reduce to the stored moments:
      H_ii = [[ΣwI, −Σwx̂], [Σwx̂ᵀ... ]] with Σwx̂ = hat(m_x),
      Σw x̂ᵀx̂ = tr(s_xx)I − s_xx, etc.
    """
    rot_i = poses[edges.kf_i][:, :3, :3]
    t_i = poses[edges.kf_i][:, :3, 3]
    rot_j = poses[edges.kf_j][:, :3, :3]
    t_j = poses[edges.kf_j][:, :3, 3]
    m_x, m_y, s_xx, s_yy, s_xy = _edge_moments(edges, rot_i, t_i, rot_j, t_j)

    e3 = jnp.eye(3)
    sw = edges.s_w[:, None, None]
    tr = lambda m: (m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2])[:, None, None]

    hx = _skew_from_vec(m_x)      # Σw x̂
    hy = _skew_from_vec(m_y)

    def cross_sum(s):
        # Σw x̂ ŷᵀ-like terms from second moments: for vectors a, b:
        # â b̂ᵀ = (a·b)I − b aᵀ  ⇒  Σw x̂ ŷᵀ = tr(s_xy)I − s_xy ᵀ-carefully:
        # Σw x̂_k ŷ_kᵀ = Σw[(x·y)I − y xᵀ] = tr(s_xy)·I − s_xyᵀ
        return tr(s) * e3 - jnp.swapaxes(s, 1, 2)

    # H_ii (6x6): [[Σw I, −Σw x̂], [Σw x̂, Σw x̂ᵀx̂]]  (x̂ᵀ = −x̂)
    def self_block(m, s):
        h = _skew_from_vec(m)
        a = sw * e3
        b = -h
        c = h
        d = cross_sum(s)  # Σw x̂ x̂ᵀ = tr(s_xx)I − s_xxᵀ (s_xx symmetric)
        return jnp.concatenate([
            jnp.concatenate([a, b], axis=2),
            jnp.concatenate([c, d], axis=2)], axis=1)

    h_ii = self_block(m_x, s_xx)
    h_jj = self_block(m_y, s_yy)

    # H_ij = Σw J_iᵀ J_j = −[[Σw I, −Σw ŷ], [Σw x̂, Σw x̂ ŷᵀ]]
    h_ij = -jnp.concatenate([
        jnp.concatenate([sw * e3, -hy], axis=2),
        jnp.concatenate([hx, cross_sum(s_xy)], axis=2)], axis=1)

    # b_i = Σw J_iᵀ r = [Σw(x−y); Σw x̂(x−y)] = [m_x−m_y; Σw x̂x − Σw x̂y]
    # Σw x̂_k x_k = 0;  Σw x̂_k y_k = vee-style: from s_xy: (Σ x×y)_a
    def cross_vec(s):
        # Σw x_k × y_k from s_xy = Σw x yᵀ
        return jnp.stack([s[:, 1, 2] - s[:, 2, 1],
                          s[:, 2, 0] - s[:, 0, 2],
                          s[:, 0, 1] - s[:, 1, 0]], axis=-1)

    b_i = jnp.concatenate([m_x - m_y, -cross_vec(s_xy)], axis=-1)
    b_j = -jnp.concatenate([m_x - m_y, cross_vec(jnp.swapaxes(s_xy, 1, 2))], axis=-1)

    vz = edges.valid[:, None, None]
    vb = edges.valid[:, None]
    return (jnp.where(vz, h_ii, 0.0), jnp.where(vz, h_jj, 0.0),
            jnp.where(vz, h_ij, 0.0), jnp.where(vb, b_i, 0.0),
            jnp.where(vb, b_j, 0.0))


def assemble_dense(h_ii, h_jj, h_ij, b_i, b_j, kf_i, kf_j, n_kf: int):
    """Scatter per-edge blocks into the dense [6K, 6K] system."""
    k6 = n_kf * 6
    h = jnp.zeros((k6, k6))
    b = jnp.zeros((k6,))
    r = jnp.arange(6)

    def put(h, blocks, rows_kf, cols_kf):
        rows = rows_kf[:, None, None] * 6 + r[None, :, None]
        cols = cols_kf[:, None, None] * 6 + r[None, None, :]
        return h.at[rows, cols].add(blocks)

    h = put(h, h_ii, kf_i, kf_i)
    h = put(h, h_jj, kf_j, kf_j)
    h = put(h, h_ij, kf_i, kf_j)
    h = put(h, jnp.swapaxes(h_ij, 1, 2), kf_j, kf_i)
    rows = kf_i[:, None] * 6 + r[None, :]
    b = b.at[rows].add(b_i)
    rows = kf_j[:, None] * 6 + r[None, :]
    b = b.at[rows].add(b_j)
    return h, b


@functools.partial(jax.jit, static_argnames=("n_kf", "cfg"))
def gauss_newton_rounds(poses: jnp.ndarray, edges: EdgeSums, n_kf: int,
                        active: jnp.ndarray, cfg: BAConfig
                        ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One robust GN round: iterate solve+update, with rollback when the
    total error grows beyond the reference's 5% gate
    (ref: optimizeKeyFrameMapRobust GN loop :1024-1143, rollback :1165-1205).

    `active`: [K] bool — keyframes being optimized (padded rows inert).
    First active keyframe is the gauge anchor (pinned via large diagonal).
    Returns (new poses, total error before, total error after).
    """
    err0 = jnp.sum(edge_errors(poses, edges))

    def gn_iter(_, poses):
        blocks = _edge_blocks(poses, edges)
        h, b = assemble_dense(*blocks, edges.kf_i, edges.kf_j, n_kf)
        diag = jnp.arange(n_kf * 6)
        # pin gauge: first active keyframe + all inactive rows
        first_active = jnp.argmax(active)
        pin = (jnp.arange(n_kf) == first_active) | (~active)
        pin6 = jnp.repeat(pin, 6)
        h = h.at[diag, diag].add(jnp.where(pin6, 1e12, 0.0))
        h = h.at[diag, diag].add(cfg.levenberg_lambda
                                 + 1e-6 * jnp.abs(h[diag, diag]))
        dx = -jnp.linalg.solve(h, b)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros_like(dx))
        xi = dx.reshape(n_kf, 6)
        # NaN guard per keyframe (ref: MultiViewGeometry.cpp:1104-1108)
        xi = jnp.where(active[:, None], xi, 0.0)
        upd = se3.compose(se3.se3_exp(xi), poses)
        return jnp.where(active[:, None, None], upd, poses)

    new_poses = jax.lax.fori_loop(0, cfg.gn_iterations_per_round, gn_iter, poses)
    err1 = jnp.sum(edge_errors(new_poses, edges))
    # rollback if error grew by >5%
    grew = err1 > err0 * cfg.rollback_error_growth
    out = jnp.where(grew, poses, new_poses)
    return out, err0, jnp.where(grew, err0, err1)


@functools.partial(jax.jit, static_argnames=("factor",))
def prune_outlier_edges(poses: jnp.ndarray, edges: EdgeSums,
                        factor: float = 3.0) -> EdgeSums:
    """Disable edges whose mean residual exceeds factor × the median
    (ref: outlier-edge pruning, MultiViewGeometry.cpp:1165-1205).
    JIT-compiled: called between distributed GN rounds at keyframe rate —
    an eager evaluation dispatches ~1000 tiny ops."""
    e = edge_errors(poses, edges)
    mean_per_pt = e / jnp.maximum(edges.s_w, 1e-9)
    # masked median over VALID edges only: sort invalid rows to +inf and
    # index the middle of the valid prefix (jnp.median over NaN-padded
    # data would take the median index over the FULL padded bucket —
    # NaN with >50% padding, biased high otherwise)
    n_valid = jnp.sum(edges.valid)
    srt = jnp.sort(jnp.where(edges.valid, mean_per_pt, jnp.inf))
    hi = jnp.clip((n_valid - 1) // 2 + (n_valid - 1) % 2, 0, srt.size - 1)
    lo = jnp.clip((n_valid - 1) // 2, 0, srt.size - 1)
    med = 0.5 * (srt[lo] + srt[hi])
    med = jnp.where(n_valid > 0, med, 1e9)
    keep = edges.valid & (mean_per_pt <= factor * jnp.maximum(med, 1e-12))
    # never prune odometry edges (consecutive keyframes)
    odo = jnp.abs(edges.kf_i - edges.kf_j) == 1
    return edges._replace(valid=jnp.where(odo, edges.valid, keep))


@jax.jit
def reweight_edges(poses: jnp.ndarray, edges: EdgeSums,
                   kp_pts: jnp.ndarray,      # [K, P, 3] keypoint DB points
                   match_idx: jnp.ndarray,   # [E, P] ref row per src slot
                   match_w: jnp.ndarray,     # [E, P] inlier weight (0 off)
                   has_matches: jnp.ndarray,  # [E] bool — raw matches kept
                   huber_delta: jnp.ndarray) -> EdgeSums:
    """Re-pre-integrate every edge with Huber weights evaluated at the
    CURRENT poses — the reference's finalBA re-initializes the graph with
    Huber norms at final poses before the last optimization
    (ref: GCSLAM/GCSLAM.h:32-39 initGraphHuberNorm; weight recipe
    preIntegrateWithHuberNorm MultiViewGeometry.h:245-311). Edges without
    stored matches (virtual odometry priors) keep their old sums."""
    t_i = poses[edges.kf_i]
    t_j = poses[edges.kf_j]
    rel = se3.compose(se3.inverse(t_i), t_j)            # i ← j
    p = kp_pts[edges.kf_i[:, None], match_idx]          # [E, P, 3]
    q = kp_pts[edges.kf_j]                              # [E, P, 3]
    x = jnp.einsum("eij,epj->epi", rel[:, :3, :3], q,
                   precision=_PREC) + rel[:, None, :3, 3]
    rn = jnp.linalg.norm(x - p, axis=-1)
    w = match_w * jnp.where(rn <= huber_delta, 1.0,
                            huber_delta / jnp.maximum(rn, 1e-12))
    s_w = jnp.sum(w, axis=1)
    s_p = jnp.einsum("ep,epi->ei", w, p, precision=_PREC)
    s_q = jnp.einsum("ep,epi->ei", w, q, precision=_PREC)
    s_pp = jnp.einsum("ep,epi,epj->eij", w, p, p, precision=_PREC)
    s_qq = jnp.einsum("ep,epi,epj->eij", w, q, q, precision=_PREC)
    s_pq = jnp.einsum("ep,epi,epj->eij", w, p, q, precision=_PREC)
    use = has_matches & edges.valid
    uz = use[:, None]
    um = use[:, None, None]
    return edges._replace(
        s_w=jnp.where(use, s_w, edges.s_w),
        s_p=jnp.where(uz, s_p, edges.s_p),
        s_q=jnp.where(uz, s_q, edges.s_q),
        s_pp=jnp.where(um, s_pp, edges.s_pp),
        s_qq=jnp.where(um, s_qq, edges.s_qq),
        s_pq=jnp.where(um, s_pq, edges.s_pq))


@functools.partial(jax.jit, static_argnames=("n_kf", "cfg"))
def optimize(poses: jnp.ndarray, edges: EdgeSums, n_kf: int,
             active: jnp.ndarray, cfg: BAConfig):
    """Full robust optimization: rounds of GN with pruning in between,
    ONE compiled program and zero host syncs
    (ref: optimizeKeyFrameMap :1209-1217 — 3 robust rounds).
    Returns (poses, edges, errs [rounds, 2] device array)."""
    errs = []
    for r in range(cfg.gn_rounds):
        poses, e0, e1 = gauss_newton_rounds(poses, edges, n_kf, active, cfg)
        errs.append(jnp.stack([e0, e1]))
        if r < cfg.gn_rounds - 1:
            edges = prune_outlier_edges(poses, edges)
    return poses, edges, jnp.stack(errs)
