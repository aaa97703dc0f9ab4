"""Two-view RGB-D registration: matching, filtering, RANSAC, Huber GN.

JAX re-design of FrameMatchingTwoViewRGB and its helpers
(ref: GCSLAM/MultiViewGeometry.cpp:517-718 FrameMatchingTwoViewRGB;
estimateRigid3DTransformation :154-250; ransac3D3D :252-481;
optimize_3d_to_3d_huber_filter :31-152; outlierFiltering :483-515;
RefineByRotation MultiViewGeometry.h:554-594).

Everything is one jitted program over padded [K]-shaped keypoint arrays:
  * Hamming matching (exact, replaces MILD SparseMatcher hashing)
  * rotation-consistency histogram filter
  * pairwise-distance consistency filter (all-pairs instead of the
    reference's 8 random probes — stronger, same threshold semantics)
  * 4-point Kabsch-SVD RANSAC, all hypotheses evaluated in parallel
  * Huber-weighted Gauss-Newton refinement on the inlier set
  * guided fine re-match with projected priors + second RANSAC round

Convention: the estimated pose maps source-frame points into the
reference frame: p_ref ≈ T · p_src.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from texturefusion_tpu.config import TrackingConfig
from texturefusion_tpu.core import camera as cam
from texturefusion_tpu.core import se3
from texturefusion_tpu.ops import hamming
from texturefusion_tpu.slam.features import Keypoints

_PREC = jax.lax.Precision.HIGHEST


class TwoViewResult(NamedTuple):
    pose: jnp.ndarray          # [4, 4] T: p_ref = T · p_src
    success: jnp.ndarray      # bool
    inliers: jnp.ndarray      # [K] bool over source keypoint slots
    match_idx: jnp.ndarray    # [K] int32: ref keypoint index per src slot
    n_inliers: jnp.ndarray    # int32
    mean_error: jnp.ndarray   # mean 3D residual over inliers
    disparity: jnp.ndarray    # mean 2D keypoint motion (pixels / width)
    scale_change: jnp.ndarray  # relative mean-depth change
    stats: jnp.ndarray         # [5] f32 [success, n_inl, err, disp, scale]
    # `stats` packs the host-decision scalars so control flow costs ONE
    # device→host fetch instead of five


def kabsch(p: jnp.ndarray, q: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Weighted rigid fit: returns T with p ≈ R q + t. p, q: [N, 3]; w: [N]."""
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    pc = jnp.sum(p * w[:, None], axis=0) / wsum
    qc = jnp.sum(q * w[:, None], axis=0) / wsum
    pp = (p - pc) * w[:, None]
    qq = q - qc
    h = jnp.matmul(qq.T, pp, precision=_PREC)  # 3x3
    u, s, vt = jnp.linalg.svd(h)
    d = jnp.linalg.det(jnp.matmul(vt.T, u.T, precision=_PREC))
    sign = jnp.diag(jnp.asarray([1.0, 1.0, 1.0])).at[2, 2].set(jnp.sign(d))
    r = jnp.matmul(jnp.matmul(vt.T, sign, precision=_PREC), u.T, precision=_PREC)
    t = pc - r @ qc
    return se3.make_pose(r, t)


def huber_weights(residual_norm: jnp.ndarray, delta: float) -> jnp.ndarray:
    """IRLS weights for the Huber norm (ref: preIntegrateWithHuberNorm
    MultiViewGeometry.h:245-311)."""
    return jnp.where(residual_norm <= delta, 1.0,
                     delta / jnp.maximum(residual_norm, 1e-12))


def refine_pose_gn(pose: jnp.ndarray, p: jnp.ndarray, q: jnp.ndarray,
                   w: jnp.ndarray, iters: int, huber_delta: float) -> jnp.ndarray:
    """Huber-IRLS Gauss-Newton on 3D-3D alignment
    (ref: optimize_3d_to_3d_huber_filter MultiViewGeometry.cpp:31-152).
    Left-multiplicative update T ← exp(ξ)·T."""

    def body(_, pose):
        x = se3.transform_points(pose, q)            # [N, 3]
        r = x - p
        rn = jnp.linalg.norm(r, axis=-1)
        wr = w * huber_weights(rn, huber_delta)
        # J_i = [I | -hat(x_i)]  (left perturbation)
        # Assemble normal equations in closed form
        hat_x = se3.hat(x)                            # [N, 3, 3]
        jtj_tt = jnp.sum(wr) * jnp.eye(3)
        jtj_tw = -jnp.einsum("n,nij->ij", wr, hat_x, precision=_PREC)
        jtj_ww = jnp.einsum("n,nki,nkj->ij", wr, hat_x, hat_x, precision=_PREC)
        jtr_t = jnp.einsum("n,ni->i", wr, r, precision=_PREC)
        # (∂r/∂ω)ᵀ r = (−x̂)ᵀ r = +x̂ r
        jtr_w = jnp.einsum("n,nij,nj->i", wr, hat_x, r, precision=_PREC)
        h6 = jnp.block([[jtj_tt, jtj_tw], [jtj_tw.T, jtj_ww]])
        b6 = jnp.concatenate([jtr_t, jtr_w])
        h6 = h6 + jnp.eye(6) * 1e-9
        xi = -jnp.linalg.solve(h6, b6)
        xi = jnp.where(jnp.all(jnp.isfinite(xi)), xi, jnp.zeros(6))
        return se3.compose(se3.se3_exp(xi), pose)

    return jax.lax.fori_loop(0, iters, body, pose)


def _rotation_histogram_filter(ok: jnp.ndarray, ang_src: jnp.ndarray,
                               ang_ref: jnp.ndarray, n_bins: int = 12,
                               n_keep: int = 3) -> jnp.ndarray:
    """Keep matches whose orientation difference falls in the top-k
    histogram bins (ref: RefineByRotation MultiViewGeometry.h:554-594)."""
    delta = jnp.mod(ang_ref - ang_src + jnp.pi, 2 * jnp.pi)
    bins = jnp.clip((delta / (2 * jnp.pi) * n_bins).astype(jnp.int32), 0, n_bins - 1)
    hist = jnp.zeros(n_bins, jnp.int32).at[bins].add(ok.astype(jnp.int32))
    top = jax.lax.top_k(hist, n_keep)[0][-1]
    good_bin = hist >= jnp.maximum(top, 1)
    return ok & good_bin[bins]


def _distance_consistency_filter(ok: jnp.ndarray, p: jnp.ndarray,
                                 q: jnp.ndarray, threshold: float = 0.015,
                                 min_frac: float = 0.2) -> jnp.ndarray:
    """All-pairs geometric consistency (ref: outlierFiltering
    MultiViewGeometry.cpp:483-515, threshold 0.015·z). A match survives if
    ≥ min_frac of the other tentative matches preserve pairwise distance."""
    dp = jnp.linalg.norm(p[:, None, :] - p[None, :, :], axis=-1)
    dq = jnp.linalg.norm(q[:, None, :] - q[None, :, :], axis=-1)
    zref = jnp.maximum(p[:, 2], 1e-3)
    consistent = (jnp.abs(dp - dq) / zref[:, None]) < threshold
    consistent = consistent & ok[None, :] & ok[:, None]
    frac = jnp.sum(consistent, axis=1) / jnp.maximum(jnp.sum(ok), 1)
    return ok & (frac >= min_frac)


def _ransac(key: jax.Array, p: jnp.ndarray, q: jnp.ndarray, ok: jnp.ndarray,
            uv_ref: jnp.ndarray, intr: cam.Intrinsics,
            cfg: TrackingConfig) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Parallel 4-point Kabsch RANSAC (ref: estimateRigid3DTransformation
    MultiViewGeometry.cpp:154-250, ransac3D3D :252-481).
    Returns (best pose, inlier mask)."""
    n = p.shape[0]
    n_hyp = cfg.ransac_iterations
    # sample 4 match indices per hypothesis, biased to valid ones by
    # resampling via categorical over the mask
    logits = jnp.where(ok, 0.0, -1e9)
    samples = jax.random.categorical(key, logits, shape=(n_hyp, 4))

    def fit(idx):
        return kabsch(p[idx], q[idx], jnp.ones(4))

    poses = jax.vmap(fit)(samples)                       # [H, 4, 4]

    x = jnp.einsum("hij,nj->hni", poses[:, :3, :3], q, precision=_PREC) \
        + poses[:, None, :3, 3]
    err3d = jnp.linalg.norm(x - p[None], axis=-1)        # [H, N]
    uv_proj, _ = cam.project(intr, x)
    err2d = jnp.linalg.norm(uv_proj - uv_ref[None], axis=-1)
    inl = ok[None] & (err3d < cfg.reproj_3d_threshold * 3.0) \
        & (err2d < cfg.reproj_2d_threshold)
    scores = jnp.sum(inl, axis=1)
    best = jnp.argmax(scores)
    return poses[best], inl[best]


@functools.partial(jax.jit, static_argnames=("cfg", "intr"))
def register_frames(kp_ref: Keypoints, kp_src: Keypoints, key: jax.Array,
                    cfg: TrackingConfig, intr: cam.Intrinsics) -> TwoViewResult:
    """Full two-view registration pipeline
    (ref: FrameMatchingTwoViewRGB MultiViewGeometry.cpp:517-718)."""
    k = kp_src.uv.shape[0]

    def run_round(key, match_idx, ok):
        p = kp_ref.points3d[match_idx]                  # ref 3D per src slot
        q = kp_src.points3d
        uvr = kp_ref.uv[match_idx]
        ok = _rotation_histogram_filter(ok, kp_src.angle,
                                        kp_ref.angle[match_idx])
        for _ in range(2):
            ok = _distance_consistency_filter(ok, p, q)
        key, sub = jax.random.split(key)
        pose, inl = _ransac(sub, p, q, ok, uvr, intr, cfg)
        pose = refine_pose_gn(pose, p, q, inl.astype(jnp.float32),
                              cfg.gn_iterations, cfg.huber_delta)
        # re-select inliers with the refined pose (tighter threshold)
        x = se3.transform_points(pose, q)
        err = jnp.linalg.norm(x - p, axis=-1)
        uv_proj, _ = cam.project(intr, x)
        err2d = jnp.linalg.norm(uv_proj - uvr, axis=-1)
        inl = ok & (err < cfg.reproj_3d_threshold * 3.0) \
            & (err2d < cfg.reproj_2d_threshold)
        pose = refine_pose_gn(pose, p, q, inl.astype(jnp.float32),
                              cfg.gn_iterations, cfg.huber_delta)
        return key, pose, inl

    # ---- round 1: appearance-only matching
    both3d = kp_src.has_depth
    idx, dist, ok = hamming.match_descriptors(
        kp_src.desc, kp_src.valid & both3d, kp_ref.desc,
        kp_ref.valid & kp_ref.has_depth, cfg.hamming_threshold)
    ok = ok & kp_ref.has_depth[idx]
    key, pose, inl = run_round(key, idx, ok)

    # ---- round 2: guided fine search with projected priors
    # (ref: MultiViewGeometry.cpp:608-648; sparse_match search_8_with_range)
    if cfg.use_fine_search:
        pred = se3.transform_points(se3.inverse(pose),
                                    kp_ref.points3d)     # ref pts in src frame
        pred_uv, _ = cam.project(intr, pred)
        idx2, dist2, ok2 = hamming.match_descriptors_ranged(
            kp_src.desc, kp_src.valid & both3d, kp_src.uv,
            kp_ref.desc, kp_ref.valid & kp_ref.has_depth, pred_uv,
            cfg.hamming_threshold, radius=24.0)
        # note: pred_uv indexed by *ref* slots; match_descriptors_ranged
        # compares src uv to the predicted location of each ref keypoint
        ok2 = ok2 & kp_ref.has_depth[idx2]
        use2 = jnp.sum(ok2) >= jnp.sum(ok)
        idx = jnp.where(use2, idx2, idx)
        ok = jnp.where(use2, ok2, ok)
        key, pose, inl = run_round(key, idx, ok)

    p = kp_ref.points3d[idx]
    q = kp_src.points3d
    x = se3.transform_points(pose, q)
    err = jnp.linalg.norm(x - p, axis=-1)
    n_inl = jnp.sum(inl)
    mean_err = jnp.sum(jnp.where(inl, err, 0.0)) / jnp.maximum(n_inl, 1)

    # keyframe-decision statistics (ref: GCSLAM.cpp:315-327)
    flow = jnp.linalg.norm(kp_ref.uv[idx] - kp_src.uv, axis=-1)
    disparity = jnp.sum(jnp.where(inl, flow, 0.0)) / jnp.maximum(n_inl, 1) / intr.width
    z_ref = jnp.sum(jnp.where(inl, p[:, 2], 0.0)) / jnp.maximum(n_inl, 1)
    z_src = jnp.sum(jnp.where(inl, q[:, 2], 0.0)) / jnp.maximum(n_inl, 1)
    scale_change = jnp.abs(z_ref - z_src) / jnp.maximum(z_src, 1e-6)

    success = ((n_inl >= cfg.min_matches) & (mean_err < cfg.reproj_3d_threshold * 5)
               & jnp.all(jnp.isfinite(pose)))
    # pose rides along flattened: the host reads ONE 1D buffer per frame
    stats = jnp.concatenate([
        jnp.stack([success.astype(jnp.float32),
                   n_inl.astype(jnp.float32), mean_err, disparity,
                   scale_change]),
        pose.reshape(-1)])
    return TwoViewResult(pose=pose, success=success, inliers=inl,
                         match_idx=idx, n_inliers=n_inl.astype(jnp.int32),
                         mean_error=mean_err, disparity=disparity,
                         scale_change=scale_change, stats=stats)


@functools.partial(jax.jit, static_argnames=("cfg", "intr"))
def register_frames_batch(kp_refs: Keypoints, kp_src: Keypoints,
                          keys: jax.Array, cfg: TrackingConfig,
                          intr: cam.Intrinsics) -> TwoViewResult:
    """Register one source frame against N stacked reference keyframes in
    a single compiled program (vmap over the reference axis).

    The reference registers loop-closure candidates one at a time on the
    tracking thread (ref: GCSLAM.cpp:104 per-candidate
    FrameMatchingTwoViewRGB); here each dispatch+fetch costs host
    latency, so the keyframe-promotion path batches all candidates into
    one dispatch and ONE [N, 21] stats fetch.

    kp_refs: Keypoints with a leading [N] axis on every leaf.
    keys: [N] PRNG keys. Returns a TwoViewResult with leading [N] axes.
    """
    return jax.vmap(
        lambda kr, k: register_frames(kr, kp_src, k, cfg, intr)
    )(kp_refs, keys)


def stack_keypoints(kps) -> Keypoints:
    """Tree-stack a list of Keypoints along a new leading axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *kps)
