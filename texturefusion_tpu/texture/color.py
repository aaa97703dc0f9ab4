"""Global color compensation: covariance-matched linear color transfer.

Batched re-design of Chisel::CompensateColor
(ref: Structure/Chisel.cpp:198-286 — cluster patches by keyframe id,
compute mean/covariance of sampled texture colors vs fused voxel colors,
build the eigendecomposition-based transfer T :250-268, and emit
per-vertex corrected colors :270-284; color/mean/cov helpers
Structure/Patch.cpp:240-348).

For each keyframe cluster, the linear map T aligns the texture-color
distribution to the (globally consistent) voxel-color distribution:
  T = U_v Λ_v^{1/2} Λ_t^{-1/2} U_tᵀ,   corrected = T (c − μ_t) + μ_v
computed batched over keyframes with 3×3 eigendecompositions on device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("n_clusters",))
def cluster_stats(colors: jnp.ndarray, weights: jnp.ndarray,
                  cluster: jnp.ndarray, n_clusters: int
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Weighted per-cluster mean [C, 3] and covariance [C, 3, 3] of colors
    [N, 3]; `cluster` [N] int32 ids; weight 0 drops a sample."""
    w = weights
    wsum = jnp.zeros(n_clusters).at[cluster].add(w) + 1e-9
    mean = jnp.zeros((n_clusters, 3)).at[cluster].add(w[:, None] * colors)
    mean = mean / wsum[:, None]
    diff = colors - mean[cluster]
    outer = diff[:, :, None] * diff[:, None, :] * w[:, None, None]
    cov = jnp.zeros((n_clusters, 3, 3)).at[cluster].add(outer)
    cov = cov / wsum[:, None, None]
    return mean, cov


@jax.jit
def transfer_matrices(mean_tex: jnp.ndarray, cov_tex: jnp.ndarray,
                      mean_vox: jnp.ndarray, cov_vox: jnp.ndarray
                      ) -> jnp.ndarray:
    """Per-cluster 3×3 transfer T matching tex distribution to vox
    distribution (ref: Chisel.cpp:250-268)."""
    eps = 1e-6

    def one(ct, cv):
        lt, ut = jnp.linalg.eigh(ct + eps * jnp.eye(3))
        lv, uv = jnp.linalg.eigh(cv + eps * jnp.eye(3))
        sqrt_v = jnp.matmul(uv * jnp.sqrt(jnp.maximum(lv, eps))[None, :],
                            uv.T, precision=_PREC)
        inv_sqrt_t = jnp.matmul(
            ut * (1.0 / jnp.sqrt(jnp.maximum(lt, eps)))[None, :], ut.T,
            precision=_PREC)
        return jnp.matmul(sqrt_v, inv_sqrt_t, precision=_PREC)

    return jax.vmap(one)(cov_tex, cov_vox)


@jax.jit
def apply_transfer(colors_tex: jnp.ndarray, cluster: jnp.ndarray,
                   t: jnp.ndarray, mean_tex: jnp.ndarray,
                   mean_vox: jnp.ndarray) -> jnp.ndarray:
    """Corrected colors [N, 3]: T_c (c − μ_tex,c) + μ_vox,c."""
    tc = t[cluster]
    corrected = jnp.einsum("nij,nj->ni", tc,
                           colors_tex - mean_tex[cluster], precision=_PREC) \
        + mean_vox[cluster]
    return jnp.clip(corrected, 0.0, 1.0)


def compensate(colors_tex: jnp.ndarray, colors_vox: jnp.ndarray,
               weights: jnp.ndarray, cluster: jnp.ndarray,
               n_clusters: int) -> jnp.ndarray:
    """Full compensation: per-cluster stats → transfer → corrected colors.
    Returns per-sample color-adjust deltas (corrected − tex), the quantity
    the reference packs per vertex for the shader
    (ref: Chisel.cpp:270-284 packed color-adjust; draw_mesh.vert:29-70)."""
    mean_t, cov_t = cluster_stats(colors_tex, weights, cluster, n_clusters)
    mean_v, cov_v = cluster_stats(colors_vox, weights, cluster, n_clusters)
    t = transfer_matrices(mean_t, cov_t, mean_v, cov_v)
    corrected = apply_transfer(colors_tex, cluster, t, mean_t, mean_v)
    return corrected - colors_tex
