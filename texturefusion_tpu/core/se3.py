"""Batched SO(3)/SE(3) Lie-group operations in pure jnp.

Replaces the reference's Sophus::SE3d usage (ref: GCSLAM/frame.h:14,
MultiViewGeometry.cpp:1101-1112 SE3 exp update). All functions are
shape-polymorphic over leading batch dimensions and jit-safe.

Representation: a pose is a (..., 4, 4) homogeneous matrix (float32 by
default; BA may run in float64 on host, see slam/fastba.py). Twists are
(..., 6) with convention [rho (translation), omega (rotation)] matching
Sophus' SE3::exp ordering used by the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# 3x3/4x4 pose algebra must not run at a reduced default matmul precision
# (TF32 on the GPU keeps ~3 decimal digits).
_PREC = jax.lax.Precision.HIGHEST

_EPS = 1e-8


def hat(omega: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    ox, oy, oz = omega[..., 0], omega[..., 1], omega[..., 2]
    zero = jnp.zeros_like(ox)
    return jnp.stack(
        [
            jnp.stack([zero, -oz, oy], axis=-1),
            jnp.stack([oz, zero, -ox], axis=-1),
            jnp.stack([-oy, ox, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(m: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) skew -> (..., 3)."""
    return jnp.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], axis=-1)


def so3_exp(omega: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula, (..., 3) -> (..., 3, 3). Taylor-safe at 0."""
    theta2 = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    k = hat(omega)
    k2 = jnp.matmul(k, k, precision=_PREC)
    # sin(t)/t and (1-cos(t))/t² with small-angle Taylor fallback
    a = jnp.where(theta2 > _EPS, jnp.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = jnp.where(theta2 > _EPS, (1.0 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), k.shape)
    return eye + a[..., None, None] * k + b[..., None, None] * k2


def so3_log(rot: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) -> (..., 3) principal rotation vector.

    Goes through the quaternion, which is uniformly stable including near
    theta = pi (where the antisymmetric-part formula degenerates)."""
    q = quaternion_from_matrix(rot)
    xyz, w = q[..., :3], q[..., 3]
    # enforce w >= 0 for the principal branch
    sign = jnp.where(w < 0, -1.0, 1.0)
    xyz = xyz * sign[..., None]
    w = w * sign
    s = jnp.linalg.norm(xyz, axis=-1)
    theta = 2.0 * jnp.arctan2(s, w)
    # omega = theta * xyz / s, with Taylor fallback theta/s -> 2/w for s→0
    scale = jnp.where(s > _EPS, theta / jnp.maximum(s, _EPS), 2.0 / jnp.maximum(w, _EPS))
    return xyz * scale[..., None]


def _left_jacobian(omega: jnp.ndarray) -> jnp.ndarray:
    """SO(3) left Jacobian V used in SE(3) exp: t = V·rho."""
    theta2 = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    k = hat(omega)
    k2 = jnp.matmul(k, k, precision=_PREC)
    b = jnp.where(theta2 > _EPS, (1.0 - jnp.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    c = jnp.where(
        theta2 > _EPS, (theta - jnp.sin(theta)) / (theta2 * theta), 1.0 / 6.0 - theta2 / 120.0
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), k.shape)
    return eye + b[..., None, None] * k + c[..., None, None] * k2


def _left_jacobian_inv(omega: jnp.ndarray) -> jnp.ndarray:
    theta2 = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    k = hat(omega)
    k2 = jnp.matmul(k, k, precision=_PREC)
    half = 0.5
    cot_term = jnp.where(
        theta2 > _EPS,
        (1.0 - theta * jnp.cos(theta * 0.5) / (2.0 * jnp.sin(theta * 0.5) + _EPS)) / theta2,
        1.0 / 12.0 + theta2 / 720.0,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), k.shape)
    return eye - half * k + cot_term[..., None, None] * k2


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """(..., 6) twist [rho, omega] -> (..., 4, 4) homogeneous matrix."""
    rho, omega = xi[..., :3], xi[..., 3:]
    rot = so3_exp(omega)
    t = jnp.einsum("...ij,...j->...i", _left_jacobian(omega), rho, precision=_PREC)
    return make_pose(rot, t)


def se3_log(pose: jnp.ndarray) -> jnp.ndarray:
    """(..., 4, 4) -> (..., 6) twist [rho, omega]."""
    rot = pose[..., :3, :3]
    t = pose[..., :3, 3]
    omega = so3_log(rot)
    rho = jnp.einsum("...ij,...j->...i", _left_jacobian_inv(omega), t, precision=_PREC)
    return jnp.concatenate([rho, omega], axis=-1)


def make_pose(rot: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = jnp.broadcast_shapes(rot.shape[:-2], t.shape[:-1])
    rot = jnp.broadcast_to(rot, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([rot, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=rot.dtype), batch + (4,)
    )
    return jnp.concatenate([top, bottom[..., None, :]], axis=-2)


def identity(batch_shape=(), dtype=jnp.float32) -> jnp.ndarray:
    return jnp.broadcast_to(jnp.eye(4, dtype=dtype), tuple(batch_shape) + (4, 4))


def inverse(pose: jnp.ndarray) -> jnp.ndarray:
    rot_t = jnp.swapaxes(pose[..., :3, :3], -1, -2)
    t = pose[..., :3, 3]
    return make_pose(rot_t, -jnp.einsum("...ij,...j->...i", rot_t, t, precision=_PREC))


def compose(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.matmul(a, b, precision=_PREC)


def transform_points(pose: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply (..., 4, 4) to (..., N, 3) points."""
    rot = pose[..., :3, :3]
    t = pose[..., :3, 3]
    return jnp.einsum("...ij,...nj->...ni", rot, pts, precision=_PREC) + t[..., None, :]


def rotate_points(pose: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    return jnp.einsum("...ij,...nj->...ni", pose[..., :3, :3], pts, precision=_PREC)


def pose_distance(a: jnp.ndarray, b: jnp.ndarray,
                  rot_weight: float = 1.0, trans_weight: float = 1.0) -> jnp.ndarray:
    """Weighted SE3 delta cost between two poses (ref: MapMaintain.hpp:239-258
    GetPoseDifference — drives re-integration scheduling)."""
    delta = compose(inverse(a), b)
    xi = se3_log(delta)
    return (trans_weight * jnp.sum(xi[..., :3] ** 2, axis=-1)
            + rot_weight * jnp.sum(xi[..., 3:] ** 2, axis=-1))


def quaternion_from_matrix(rot: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) -> (..., 4) quaternion (x, y, z, w) — TUM trajectory order
    (ref: BasicAPI.cpp:74-91 saveTrajectoryFrameList)."""
    m = rot
    trace = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]

    def _case_w(m, trace):
        s = jnp.sqrt(jnp.maximum(trace + 1.0, _EPS)) * 2.0
        return jnp.stack([
            (m[..., 2, 1] - m[..., 1, 2]) / s,
            (m[..., 0, 2] - m[..., 2, 0]) / s,
            (m[..., 1, 0] - m[..., 0, 1]) / s,
            0.25 * s,
        ], axis=-1)

    def _case_x(m, trace):
        s = jnp.sqrt(jnp.maximum(1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2], _EPS)) * 2.0
        return jnp.stack([
            0.25 * s,
            (m[..., 0, 1] + m[..., 1, 0]) / s,
            (m[..., 0, 2] + m[..., 2, 0]) / s,
            (m[..., 2, 1] - m[..., 1, 2]) / s,
        ], axis=-1)

    def _case_y(m, trace):
        s = jnp.sqrt(jnp.maximum(1.0 + m[..., 1, 1] - m[..., 0, 0] - m[..., 2, 2], _EPS)) * 2.0
        return jnp.stack([
            (m[..., 0, 1] + m[..., 1, 0]) / s,
            0.25 * s,
            (m[..., 1, 2] + m[..., 2, 1]) / s,
            (m[..., 0, 2] - m[..., 2, 0]) / s,
        ], axis=-1)

    def _case_z(m, trace):
        s = jnp.sqrt(jnp.maximum(1.0 + m[..., 2, 2] - m[..., 0, 0] - m[..., 1, 1], _EPS)) * 2.0
        return jnp.stack([
            (m[..., 0, 2] + m[..., 2, 0]) / s,
            (m[..., 1, 2] + m[..., 2, 1]) / s,
            0.25 * s,
            (m[..., 1, 0] - m[..., 0, 1]) / s,
        ], axis=-1)

    qw = _case_w(m, trace)
    qx = _case_x(m, trace)
    qy = _case_y(m, trace)
    qz = _case_z(m, trace)
    use_w = trace > 0
    x_big = (m[..., 0, 0] >= m[..., 1, 1]) & (m[..., 0, 0] >= m[..., 2, 2])
    y_big = m[..., 1, 1] >= m[..., 2, 2]
    out = jnp.where(use_w[..., None], qw,
                    jnp.where(x_big[..., None], qx,
                              jnp.where(y_big[..., None], qy, qz)))
    return out / jnp.linalg.norm(out, axis=-1, keepdims=True)


def matrix_from_quaternion(q: jnp.ndarray) -> jnp.ndarray:
    """(..., 4) quaternion (x, y, z, w) -> (..., 3, 3)."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], axis=-1),
        jnp.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], axis=-1),
        jnp.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], axis=-1),
    ], axis=-2)
