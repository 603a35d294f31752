"""SO(3)/SE(3) utilities as pure, batchable JAX functions.

The reference leans on iDynTree spatial types (``iDynTree::Rotation``,
``Transform``, ``Twist``); here rotations are plain ``(…, 3, 3)`` arrays,
positions ``(…, 3)`` arrays, and twists ``(…, 6)`` arrays in **mixed
representation** (linear part expressed in the world frame at the frame
origin, angular in the world frame) — the same convention the reference
assumes throughout (``FloatingBaseSystemKinematics.cpp:62-68``,
``ContinousContactModelTest.cpp:151-171``).

Everything broadcasts over leading batch axes and is ``vmap``/``jit`` safe.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "skew",
    "unskew",
    "so3_exp",
    "so3_log",
    "so3_baumgarte_rate",
    "rotation_rate_mixed",
    "quat_to_rot",
    "rot_to_quat",
    "se3_compose",
    "se3_apply",
    "se3_inverse",
    "rpy_to_rot",
]


def skew(v: jnp.ndarray) -> jnp.ndarray:
    """``(…, 3) → (…, 3, 3)`` skew-symmetric map, ``skew(v) @ u = v × u``
    (equivalent of ``iDynTree::skew``, used throughout
    ``ContinuousContactModel.cpp:79-254``)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def unskew(m: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`skew` (antisymmetric part is used)."""
    return jnp.stack(
        [
            0.5 * (m[..., 2, 1] - m[..., 1, 2]),
            0.5 * (m[..., 0, 2] - m[..., 2, 0]),
            0.5 * (m[..., 1, 0] - m[..., 0, 1]),
        ],
        axis=-1,
    )


def so3_exp(omega: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula: ``(…, 3)`` rotation vector → ``(…, 3, 3)`` rotation.

    Matches the closed forms the reference tests integrate against
    (``IntegratorTest.cpp:97-104`` uses ``Eigen::AngleAxisd``;
    ``ContinousContactModelTest.cpp:151-166`` uses
    ``AngularMotionVector3::exp``). Taylor-guarded at ``θ → 0`` so it is
    differentiable and stable in f32.
    """
    theta2 = jnp.sum(omega * omega, axis=-1)
    # sin θ / θ and (1 − cos θ)/θ² with series fallbacks near zero. The
    # untaken branch must stay NaN-free under differentiation (double-where).
    small = theta2 < 1e-12
    safe_t2 = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(safe_t2)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / safe_t2)
    k = skew(omega)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), k.shape)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def so3_log(rot: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix → rotation vector (principal branch, θ ∈ [0, π))."""
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    w = unskew(rot)
    sin_theta = jnp.sin(theta)
    small = theta < 1e-6
    scale = jnp.where(
        small, 1.0 + theta * theta / 6.0, theta / jnp.where(small, 1.0, sin_theta)
    )
    return scale[..., None] * w


def rotation_rate_mixed(rot: jnp.ndarray, omega: jnp.ndarray) -> jnp.ndarray:
    """``Ṙ = ω̂ R`` for a world-frame (mixed-representation) angular velocity.

    Eigen's ``-R.colwise().cross(ω)`` in the reference
    (``FloatingBaseSystemKinematics.cpp:64-65``) is column-wise ``−(rᵢ × ω)
    = ω × rᵢ``, i.e. exactly ``skew(ω) @ R``.
    """
    return skew(omega) @ rot


def so3_baumgarte_rate(rot: jnp.ndarray, omega: jnp.ndarray, rho) -> jnp.ndarray:
    """Rotation-matrix rate with Baumgarte orthonormality stabilisation.

    ``Ṙ = ω̂ R + ρ/2 ((R Rᵀ)⁻¹ − I) R`` — the exact correction term of
    ``FloatingBaseSystemKinematics.cpp:64-68`` (and
    ``FloatingBaseSystemDynamics.cpp:136-140``), which drives ``R Rᵀ → I``
    under numerical drift of a matrix-valued integrator.
    """
    rrt = rot @ jnp.swapaxes(rot, -1, -2)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=rot.dtype), rrt.shape)
    correction = (jnp.linalg.inv(rrt) - eye) @ rot
    rho = jnp.asarray(rho, dtype=rot.dtype)
    return rotation_rate_mixed(rot, omega) + 0.5 * rho * correction


def quat_to_rot(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion ``(…, 4)`` (w, x, y, z) → rotation matrix."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


def rot_to_quat(rot: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix → unit quaternion (w, x, y, z), w ≥ 0.

    Branchless Shepperd-style construction (max-component select) so it is
    ``vmap``/accelerator friendly.
    """
    m = rot
    t0 = 1.0 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    t1 = 1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2]
    t2 = 1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2]
    t3 = 1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]

    def _cand0():
        s = jnp.sqrt(jnp.maximum(t0, 1e-12)) * 2.0
        return jnp.stack(
            [0.25 * s,
             (m[..., 2, 1] - m[..., 1, 2]) / s,
             (m[..., 0, 2] - m[..., 2, 0]) / s,
             (m[..., 1, 0] - m[..., 0, 1]) / s], -1)

    def _cand1():
        s = jnp.sqrt(jnp.maximum(t1, 1e-12)) * 2.0
        return jnp.stack(
            [(m[..., 2, 1] - m[..., 1, 2]) / s,
             0.25 * s,
             (m[..., 0, 1] + m[..., 1, 0]) / s,
             (m[..., 0, 2] + m[..., 2, 0]) / s], -1)

    def _cand2():
        s = jnp.sqrt(jnp.maximum(t2, 1e-12)) * 2.0
        return jnp.stack(
            [(m[..., 0, 2] - m[..., 2, 0]) / s,
             (m[..., 0, 1] + m[..., 1, 0]) / s,
             0.25 * s,
             (m[..., 1, 2] + m[..., 2, 1]) / s], -1)

    def _cand3():
        s = jnp.sqrt(jnp.maximum(t3, 1e-12)) * 2.0
        return jnp.stack(
            [(m[..., 1, 0] - m[..., 0, 1]) / s,
             (m[..., 0, 2] + m[..., 2, 0]) / s,
             (m[..., 1, 2] + m[..., 2, 1]) / s,
             0.25 * s], -1)

    cands = jnp.stack([_cand0(), _cand1(), _cand2(), _cand3()], axis=-2)
    traces = jnp.stack([t0, t1, t2, t3], axis=-1)
    idx = jnp.argmax(traces, axis=-1)
    q = jnp.take_along_axis(cands, idx[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    sign = jnp.where(q[..., :1] < 0, -1.0, 1.0)
    q = q * sign
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def rpy_to_rot(roll, pitch, yaw) -> jnp.ndarray:
    """ZYX roll-pitch-yaw → rotation, matching ``iDynTree::Rotation::RPY``
    (``R = Rz(yaw) Ry(pitch) Rx(roll)``), used by the reference tests
    (``ContinousContactModelTest.cpp:36``)."""
    roll, pitch, yaw = (jnp.asarray(a) for a in (roll, pitch, yaw))
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    return jnp.stack(
        [
            jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
            jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
            jnp.stack([-sp, cp * sr, cp * cr], -1),
        ],
        axis=-2,
    )


# -- SE(3) as (rotation, position) pairs ------------------------------------

def se3_compose(rot_ab, pos_ab, rot_bc, pos_bc):
    """``T_ac = T_ab ∘ T_bc`` for (R, p) pairs."""
    return rot_ab @ rot_bc, pos_ab + jnp.einsum("...ij,...j->...i", rot_ab, pos_bc)


def se3_apply(rot, pos, point):
    """Apply transform to a ``(…, 3)`` point."""
    return jnp.einsum("...ij,...j->...i", rot, point) + pos


def se3_inverse(rot, pos):
    rt = jnp.swapaxes(rot, -1, -2)
    return rt, -jnp.einsum("...ij,...j->...i", rt, pos)
