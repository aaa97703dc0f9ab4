"""Single-dispatch keyframe-promotion probe.

The reference's update_keyframe (ref: GCSLAM/GCSLAM.cpp:52-185) runs
candidate selection (MILD query + salient score, :6-50) and then a
per-candidate FrameMatchingTwoViewRGB loop (:104). Every dispatch→sync
roundtrip costs host latency, so here the WHOLE promotion probe is one
compiled program:

  similarity over the keyframe descriptor DB → salient-score top-k
  candidate rows → gather candidate keypoints from a device-resident
  stacked keypoint DB → vmapped two-view registration → Huber edge
  pre-integration (ref: preIntegrateWithHuberNorm
  MultiViewGeometry.h:245-311) — and ONE small fetch returns every
  host decision scalar.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.config import TrackingConfig
from texturefusion_tpu.core import camera as cam
from texturefusion_tpu.ops import hamming
from texturefusion_tpu.slam import fastba
from texturefusion_tpu.slam.features import Keypoints
from texturefusion_tpu.slam.loopclosure import _similarity_kernel
from texturefusion_tpu.slam.matching import register_frames


class KeypointDB:
    """Device-resident stacked keypoints of every keyframe, indexed by
    keyframe SLOT (the reference keeps per-keyframe feature vectors on
    the heap, frame.h:29-161; here they live in [max_kf, pad, ...]
    device arrays so the promotion probe can gather candidates without
    host participation)."""

    def __init__(self, max_kf: int, pad: int):
        self.max_kf = max_kf
        self.kp = Keypoints(
            uv=jnp.zeros((max_kf, pad, 2), jnp.float32),
            response=jnp.zeros((max_kf, pad), jnp.float32),
            angle=jnp.zeros((max_kf, pad), jnp.float32),
            level=jnp.zeros((max_kf, pad), jnp.int32),
            desc=jnp.zeros((max_kf, pad, hamming.WORDS), jnp.uint32),
            valid=jnp.zeros((max_kf, pad), bool),
            points3d=jnp.zeros((max_kf, pad, 3), jnp.float32),
            has_depth=jnp.zeros((max_kf, pad), bool),
        )

    def add(self, slot: int, kp: Keypoints) -> None:
        self.kp = _db_insert(self.kp, jnp.int32(slot), kp)


@jax.jit
def _db_insert(db: Keypoints, slot: jnp.ndarray, kp: Keypoints) -> Keypoints:
    return jax.tree.map(lambda d, x: d.at[slot].set(x), db, kp)


def salient_scores(sims: jnp.ndarray, in_use: jnp.ndarray,
                   n_rows: jnp.ndarray) -> jnp.ndarray:
    """EXACT reference salient score (ref: BayesianFilter.hpp:31-91
    calculateSalientScore): the trailing run of RECENT keyframes whose
    similarity is ≥ the global average is excluded before computing the
    historical mean/σ — temporally adjacent views are always similar and
    would otherwise inflate the normalizer so true loop closures never
    clear the threshold. salient = (sim − σ_hist)/μ_hist; all-significant
    degenerates to 3, too-short history to 1."""
    r_max = sims.shape[0]
    idxs = jnp.arange(r_max)
    nr = jnp.maximum(n_rows, 1).astype(jnp.float32)
    avg = jnp.sum(sims) / nr
    below = in_use & (sims < avg)
    # history_loop: last DB row (scanning backward) below the average
    history_loop = jnp.max(jnp.where(below, idxs, -1))
    hist = in_use & (idxs < history_loop)
    n_hist = jnp.sum(hist).astype(jnp.float32)
    mean_hist = jnp.sum(jnp.where(hist, sims, 0.0)) / jnp.maximum(n_hist, 1.0)
    var = jnp.sum(jnp.where(hist, (sims - mean_hist) ** 2, 0.0))
    delta = jnp.sqrt(var) / jnp.maximum(jnp.sqrt(n_hist - 1.0), 1.0)
    scores = (sims - delta) / jnp.maximum(mean_hist, 1e-8)
    scores = jnp.where((mean_hist < 1e-8) | (n_hist < 3),
                       jnp.ones_like(scores), scores)
    return jnp.where(history_loop <= 0, jnp.full_like(scores, 3.0), scores)


class PromoteProbe(NamedTuple):
    cand_slots: jnp.ndarray   # [C] int32 keyframe slots probed
    cand_ok: jnp.ndarray      # [C] bool: candidate admissible & success
    stats: jnp.ndarray        # [C, 21] per-candidate TwoViewResult.stats
    s_w: jnp.ndarray          # [C] edge pre-integration sums...
    s_p: jnp.ndarray          # [C, 3]
    s_q: jnp.ndarray          # [C, 3]
    s_pp: jnp.ndarray         # [C, 3, 3]
    s_qq: jnp.ndarray         # [C, 3, 3]
    s_pq: jnp.ndarray         # [C, 3, 3]
    midx: jnp.ndarray         # [C, P] per-candidate match indices (device)
    minl: jnp.ndarray         # [C, P] per-candidate inlier weights (device)
    fetch: jnp.ndarray        # [C, 23] flat (slot, ok, stats) host fetch


@functools.partial(jax.jit,
                   static_argnames=("cfg", "intr", "n_cand"))
def promote_probe(db_kp: Keypoints,            # stacked by keyframe slot
                  db_desc: jnp.ndarray,        # [R, S, W] descriptor DB
                  db_desc_valid: jnp.ndarray,  # [R, S]
                  row_to_slot: jnp.ndarray,    # [R] int32 DB row → kf slot
                  n_rows: jnp.ndarray,         # int32 rows in use
                  last_slot: jnp.ndarray,      # int32 newest keyframe slot
                  kp_new: Keypoints,
                  tracked_stats: jnp.ndarray,  # [21] vs last keyframe (or zeros)
                  have_tracked: jnp.ndarray,   # bool: tracked_stats usable
                  key: jax.Array,
                  salient_threshold: float,
                  huber_delta: float,
                  cfg: TrackingConfig,
                  intr: cam.Intrinsics,
                  n_cand: int) -> PromoteProbe:
    """Candidate selection + registration + edge pre-integration in one
    program. Candidate 0 is always the last keyframe; rows whose salient
    score (sim − σ)/μ ≤ threshold are masked off (ref: GCSLAM.cpp:6-50,
    BayesianFilter.hpp:31-91)."""
    r_max = db_desc.shape[0]
    sims = _similarity_kernel(kp_new.desc, kp_new.valid, db_desc,
                              db_desc_valid)                  # [R]
    in_use = jnp.arange(r_max) < n_rows
    sims = jnp.where(in_use, sims, 0.0)
    salient = salient_scores(sims, in_use, n_rows)
    # exclude the last keyframe's own row and unused rows from ranking
    rank_sims = jnp.where(in_use & (row_to_slot != last_slot), sims, -1.0)
    top_sims, top_rows = jax.lax.top_k(rank_sims, n_cand - 1)
    exists = top_sims > 0.0
    salient_ok = salient[top_rows] > salient_threshold
    cand_slots = jnp.concatenate([last_slot[None],
                                  row_to_slot[top_rows]])    # [C]

    kp_c = jax.tree.map(lambda a: a[cand_slots], db_kp)      # [C, ...]
    keys = jax.random.split(key, n_cand)

    def reg_one(kp_ref, k):
        return register_frames(kp_ref, kp_new, k, cfg, intr)

    res = jax.vmap(reg_one)(kp_c, keys)                      # stacked [C]
    # candidate 0: reuse the per-frame tracked result when available
    # (the frame step already registered vs the last keyframe)
    stats = res.stats
    stats = stats.at[0].set(jnp.where(have_tracked, tracked_stats, stats[0]))
    # admission: the salient gate (ref semantics) OR overwhelming
    # geometric verification. The reference prunes by salience because
    # per-candidate registration is expensive on its CPU thread
    # (GCSLAM.cpp:27-29); here all candidates registered in this same
    # fixed-shape dispatch anyway, so a registration with a 3× inlier
    # margin is accepted even when the similarity statistics are flat
    # (small overlapping scenes).
    strong = stats[:, 1] >= 3.0 * cfg.min_matches
    admissible = jnp.concatenate([jnp.asarray([True]),
                                  exists & (salient_ok | strong[1:])])
    ok = admissible & (stats[:, 0] > 0.5)

    # Huber edge pre-integration per candidate from the (possibly
    # overridden) candidate pose
    def edge_one(kp_ref, r, st):
        pose = st[5:21].reshape(4, 4)
        p = kp_ref.points3d[r.match_idx]
        q = kp_new.points3d
        inl = r.inliers.astype(jnp.float32)
        return fastba.preintegrate_from_registration(
            p, q, inl, pose, jnp.float32(huber_delta))

    s_w, s_p, s_q, s_pp, s_qq, s_pq = jax.vmap(edge_one)(kp_c, res, stats)
    cand_sim = jnp.concatenate([jnp.zeros(1), top_sims])
    cand_sal = jnp.concatenate([jnp.zeros(1), salient[top_rows]])
    fetch = jnp.concatenate([cand_slots[:, None].astype(jnp.float32),
                             ok[:, None].astype(jnp.float32),
                             stats,
                             cand_sim[:, None], cand_sal[:, None]],
                            axis=1)                           # [C, 25]
    return PromoteProbe(cand_slots=cand_slots, cand_ok=ok, stats=stats,
                        s_w=s_w, s_p=s_p, s_q=s_q,
                        s_pp=s_pp, s_qq=s_qq, s_pq=s_pq,
                        midx=res.match_idx.astype(jnp.int32),
                        minl=res.inliers.astype(jnp.float32),
                        fetch=fetch.reshape(-1))
