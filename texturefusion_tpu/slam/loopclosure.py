"""Loop-closure candidate scoring: batched Hamming similarity + salience.

JAX equivalent of MILD's LoopClosureDetector + BayesianFilter
(ref: GCSLAM/MILD/loop_closure_detector.hpp:56-231 — 16-table multi-index
hashing with Gaussian-of-Hamming similarity LUT exp(−d²/900) :100-109 and
IDF weighting :214-228; BayesianFilter.hpp:31-91 calculateSalientScore;
driven from GCSLAM.cpp:6-50 select_closure_candidates).

On the device the hash tables are unnecessary: each keyframe keeps a fixed
random subsample of its descriptors, and a query frame scores against ALL
keyframes with one [Q, K·S] XOR+popcount broadcast — exact where MILD is
approximate. The similarity and salience formulas keep the reference's
semantics: sim(query, kf) = Σ_q exp(−d_min²/900), candidates are keyframes
whose salient score (sim − σ)/μ exceeds the threshold (1.5), top-5.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from texturefusion_tpu.ops import hamming


class KeyframeDescriptorDB:
    """Per-keyframe descriptor subsamples, stacked device-side."""

    def __init__(self, sub_per_kf: int = 256, max_keyframes: int = 512):
        self.sub = sub_per_kf
        self.max_kf = max_keyframes
        self.desc = jnp.zeros((max_keyframes, sub_per_kf, hamming.WORDS), jnp.uint32)
        self.valid = jnp.zeros((max_keyframes, sub_per_kf), bool)
        self.kf_ids: List[int] = []

    def add(self, kf_id: int, desc: jnp.ndarray, valid: jnp.ndarray,
            seed: int = 0) -> None:
        """Insert a keyframe's descriptors (subsampled deterministically,
        valid-first). The reference gates insertion on reg_success_cnt < 4
        (ref: GCSLAM.cpp:171-177) — callers enforce that. The valid-first
        partition runs ON DEVICE: fetching the valid mask here cost one
        blocking readback per keyframe on the tracking thread."""
        k = len(self.kf_ids)
        if k >= self.max_kf:
            return
        n = desc.shape[0]
        if n == 0:      # degenerate keyframe with zero descriptor rows
            return
        rng = np.random.default_rng(seed + kf_id)
        order = rng.permutation(max(n, self.sub)) % n   # host perm, no fetch
        self.desc, self.valid = _db_insert_row(
            self.desc, self.valid, jnp.int32(k), desc, valid,
            jnp.asarray(order, jnp.int32), self.sub)
        self.kf_ids.append(kf_id)

    def __len__(self) -> int:
        return len(self.kf_ids)

    def similarity(self, query_desc: jnp.ndarray,
                   query_valid: jnp.ndarray) -> np.ndarray:
        """Similarity of the query frame to every stored keyframe: [K]."""
        if not self.kf_ids:
            return np.zeros(0, np.float32)
        k = len(self.kf_ids)
        sims = _similarity_kernel(query_desc, query_valid,
                                  self.desc, self.valid)
        return np.asarray(sims)[:k]


import functools


@functools.partial(jax.jit, static_argnames=("sub",),
                   donate_argnames=("db_desc", "db_valid"))
def _db_insert_row(db_desc, db_valid, row, desc, valid, order, sub):
    """Subsample `sub` descriptors valid-first along a host-chosen random
    order (stable partition on device) and write row `row` in place."""
    v_perm = valid[order]
    part = jnp.argsort(~v_perm, stable=True)
    sel = order[part][:sub]
    return (db_desc.at[row].set(desc[sel]),
            db_valid.at[row].set(v_perm[part][:sub]))


@jax.jit
def _similarity_kernel(qdesc, qvalid, db_desc, db_valid):
    k, s, w = db_desc.shape
    flat = db_desc.reshape(k * s, w)
    fvalid = db_valid.reshape(k * s)
    d = hamming.hamming_matrix(qdesc, flat)             # [Q, K*S]
    d = jnp.where(fvalid[None, :] & qvalid[:, None], d, 1 << 14)
    d = d.reshape(-1, k, s)
    dmin = jnp.min(d, axis=2).astype(jnp.float32)       # [Q, K]
    sim = jnp.exp(-(dmin * dmin) / 900.0)               # ref LUT exp(−d²/900)
    sim = jnp.where(dmin < 256.0, sim, 0.0)
    # IDF weighting (ref: loop_closure_detector.hpp:214-228): a feature
    # matching MANY keyframes is common texture and carries no place
    # information — without this, repetitive scenes score uniformly and
    # true revisits never clear the salient gate
    n_kf = jnp.maximum(jnp.sum(jnp.any(db_valid, axis=1)), 1)
    df = jnp.sum(dmin < 50.0, axis=1).astype(jnp.float32)   # [Q]
    idf = jnp.log(n_kf.astype(jnp.float32) / (1.0 + df) + 1.0)
    return jnp.sum(sim * idf[:, None], axis=0)               # [K]


def select_candidates(sims: np.ndarray,
                      salient_threshold: float = 1.5,
                      max_candidates: int = 5) -> List[int]:
    """Salient-score candidate selection over database rows
    (ref: GCSLAM.cpp:6-50 + BayesianFilter.hpp:31-91 EXACTLY): the
    trailing run of recent above-average rows is excluded from the
    historical mean/σ (adjacent views are always similar); score =
    (sim − σ_hist)/μ_hist; keep top-N rows above threshold.
    Returned indices are DB rows; callers map rows → keyframes."""
    n = len(sims)
    if n == 0:
        return []
    avg = float(sims.mean())
    history_loop = -1
    for i in range(n - 1, -1, -1):
        if sims[i] < avg:
            history_loop = i
            break
    if history_loop <= 0:
        salient = np.full(n, 3.0)
    else:
        hist = np.asarray(sims[:history_loop], np.float64)
        mean_hist = hist.mean()
        if mean_hist < 1e-8 or history_loop < 3:
            salient = np.ones(n)
        else:
            delta = np.linalg.norm(hist - mean_hist) \
                / max(np.sqrt(len(hist) - 1.0), 1.0)
            salient = (sims - delta) / mean_hist
    cands = [int(i) for i in np.argsort(-sims)
             if salient[i] > salient_threshold]
    return cands[:max_candidates]
