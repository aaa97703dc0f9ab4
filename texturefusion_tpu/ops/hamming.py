"""Binary-descriptor Hamming matching as batched XLA integer ops.

Batched replacement for MILD's multi-index hashing machinery
(ref: GCSLAM/MILD/mild.hpp:33-104 multi_index_hashing,
sparse_match.hpp:160-276 SparseMatcher, loop_closure_detector.hpp:314-324
256-bit popcount Hamming): at ≤1024 descriptors per frame, exact all-pairs
Hamming distance is a single XOR+popcount broadcast — the
hash-table candidate pruning the reference needs on CPU is unnecessary
(SURVEY.md §7 phase 2). The *behavior* is preserved: best-match with
distance threshold, optional location-constrained search
(ref: sparse_match.hpp:224-276 search_8_with_range).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

WORDS = 8  # 256-bit descriptors as 8 × uint32


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """(..., 256) bool -> (..., 8) uint32 descriptor words."""
    b = bits.astype(jnp.uint32).reshape(bits.shape[:-1] + (WORDS, 32))
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts, axis=-1, dtype=jnp.uint32)


def hamming_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """[N, 8] × [M, 8] uint32 -> [N, M] int32 Hamming distances."""
    x = jnp.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=())
def match_descriptors(
    desc_a: jnp.ndarray, valid_a: jnp.ndarray,
    desc_b: jnp.ndarray, valid_b: jnp.ndarray,
    max_distance: jnp.ndarray | int = 50,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Best match in B for each descriptor of A.

    Returns (index [N] int32, distance [N] int32, matched [N] bool).
    Matches the reference's hamming_distance_threshold=50 gate
    (ref: settings.yaml:28; MultiViewGeometry.cpp:553-554).
    """
    d = hamming_matrix(desc_a, desc_b)
    d = jnp.where(valid_b[None, :], d, 1 << 14)
    idx = jnp.argmin(d, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(d, idx[:, None], axis=1)[:, 0]
    ok = valid_a & (best <= max_distance)
    return idx, best, ok


@functools.partial(jax.jit, static_argnames=())
def match_descriptors_ranged(
    desc_a: jnp.ndarray, valid_a: jnp.ndarray, pred_uv: jnp.ndarray,
    desc_b: jnp.ndarray, valid_b: jnp.ndarray, kp_uv_b: jnp.ndarray,
    max_distance: jnp.ndarray | int = 50,
    radius: jnp.ndarray | float = 32.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Location-constrained best match: only candidates within `radius`
    pixels of the predicted location are considered — the guided fine
    search (ref: sparse_match.hpp:224-276 search_8_with_range;
    MultiViewGeometry.cpp:608-648 fine search with projected priors)."""
    d = hamming_matrix(desc_a, desc_b)
    dist2 = jnp.sum((pred_uv[:, None, :] - kp_uv_b[None, :, :]) ** 2, axis=-1)
    near = dist2 <= radius * radius
    d = jnp.where(valid_b[None, :] & near, d, 1 << 14)
    idx = jnp.argmin(d, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(d, idx[:, None], axis=1)[:, 0]
    ok = valid_a & (best <= max_distance)
    return idx, best, ok


def mutual_filter(idx_ab: jnp.ndarray, ok_ab: jnp.ndarray,
                  idx_ba: jnp.ndarray) -> jnp.ndarray:
    """Keep only mutual best matches (cross-check)."""
    back = idx_ba[idx_ab]
    return ok_ab & (back == jnp.arange(idx_ab.shape[0]))
