"""Continuous spring–damper contact model over a rectangular patch.

Accelerator-native re-design of the reference's ``ContactModels`` component
(``src/ContactModels/.../ContinuousContactModel.{h,cpp}``; SURVEY.md §2 row 6).
The reference caches wrench/f/g/regressor in member buffers behind dirty flags
(``ContactModel.cpp:12-92``); here each product is a **pure function** of

- static parameters :class:`ContactParams` — patch ``length``/``width`` and
  ``spring_coeff``/``damper_coeff`` (the four ``initialize`` parameters,
  ``ContinuousContactModel.cpp:24-65``), and
- the kinematic :class:`ContactState` — world frame pose, mixed-representation
  twist, and the *null-force* pose at which the patch exerts zero wrench
  (``setState``/``setNullForceTransform``, ``ContinuousContactModel.cpp:67-83``).

All functions broadcast over leading batch axes; XLA fuses the shared
subexpressions that the reference's lazy caching existed to avoid recomputing.

Physical model: a continuum of springs (stiffness density ``k``) and dampers
(density ``b``) over the rectangle ``[-L/2, L/2] × [-W/2, W/2]``; all products
below are the closed-form surface integrals of the pointwise law
:func:`force_at_point`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from blf_tpu.ops.lie import rotation_rate_mixed, skew

__all__ = [
    "ContactParams",
    "ContactState",
    "contact_wrench",
    "autonomous_dynamics",
    "control_matrix",
    "regressor",
    "wrench_rate",
    "force_at_point",
    "torque_at_point",
    "params_from_handler",
]


class ContactParams(NamedTuple):
    """Static patch parameters (``ContinuousContactModel.cpp:24-65``)."""

    length: jnp.ndarray       # patch size along the frame x axis [m]
    width: jnp.ndarray        # patch size along the frame y axis [m]
    spring_coeff: jnp.ndarray  # spring density k [N/m³]
    damper_coeff: jnp.ndarray  # damper density b [N·s/m³]


def params_from_handler(handler) -> ContactParams:
    """Initialize-protocol parity: read the four named parameters the
    reference requires (missing key ⇒ error), ``ContinuousContactModel.cpp:35-63``."""
    return ContactParams(
        length=jnp.asarray(handler.get_parameter("length", float)),
        width=jnp.asarray(handler.get_parameter("width", float)),
        spring_coeff=jnp.asarray(handler.get_parameter("spring_coeff", float)),
        damper_coeff=jnp.asarray(handler.get_parameter("damper_coeff", float)),
    )


class ContactState(NamedTuple):
    """Kinematic state of the contact frame and its zero-force reference.

    ``position``/``rotation`` are ``world_T_frame``; ``linear/angular_velocity``
    the mixed-representation frame twist; ``null_position``/``null_rotation``
    the pose at which the deformation field (and hence the wrench) vanishes.
    """

    position: jnp.ndarray        # (…, 3)
    rotation: jnp.ndarray        # (…, 3, 3)
    linear_velocity: jnp.ndarray  # (…, 3)
    angular_velocity: jnp.ndarray  # (…, 3)
    null_position: jnp.ndarray   # (…, 3)
    null_rotation: jnp.ndarray   # (…, 3, 3)


def _mv(m, v):
    return jnp.einsum("...ij,...j->...i", m, v)


def contact_wrench(params: ContactParams, state: ContactState) -> jnp.ndarray:
    """Closed-form contact wrench ``(…, 6)`` = [force; torque].

    Analytic surface integral of :func:`force_at_point`
    (``ContinuousContactModel::computeContactWrench``,
    ``ContinuousContactModel.cpp:85-108``):

    ``f = |R₃₃| A (k (p₀ − p) − b v)``
    ``τ = |R₃₃| A/12 [L² (b ê₁² ω + k ê₁ r₀₁) + W² (b ê₂² ω + k ê₂ r₀₂)]``

    with ``êᵢ = skew(R eᵢ)`` and ``r₀ᵢ`` the null-rotation columns.
    """
    L, W, k, b = params
    area = L * W
    R, R0 = state.rotation, state.null_rotation
    r33 = jnp.abs(R[..., 2, 2])[..., None]

    force = r33 * area * (
        k * (state.null_position - state.position) - b * state.linear_velocity
    )

    e1_hat = skew(R[..., :, 0])
    e2_hat = skew(R[..., :, 1])
    torque = r33 * (area / 12.0) * (
        L * L * (b * _mv(e1_hat @ e1_hat, state.angular_velocity)
                 + k * _mv(e1_hat, R0[..., :, 0]))
        + W * W * (b * _mv(e2_hat @ e2_hat, state.angular_velocity)
                   + k * _mv(e2_hat, R0[..., :, 1]))
    )
    return jnp.concatenate([force, torque], axis=-1)


def autonomous_dynamics(params: ContactParams, state: ContactState) -> jnp.ndarray:
    """Autonomous part ``f`` of the wrench rate ``ẇ = f + G a`` (``(…, 6)``).

    ``ContinuousContactModel::computeAutonomousDynamics``
    (``ContinuousContactModel.cpp:110-146``). Note the reference uses the
    *signed* ``R₃₃`` here (unlike the wrench's ``|R₃₃|``) — preserved exactly.
    """
    L, W, k, b = params
    area = L * W
    R, R0 = state.rotation, state.null_rotation
    v, omega = state.linear_velocity, state.angular_velocity

    R_dot = rotation_rate_mixed(R, omega)
    r33 = R[..., 2, 2][..., None]
    r33_dot = R_dot[..., 2, 2][..., None]

    lin = area * (
        r33_dot * (k * (state.null_position - state.position) - b * v)
        - r33 * k * v
    )

    e1_hat, e2_hat = skew(R[..., :, 0]), skew(R[..., :, 1])
    e1d_hat, e2d_hat = skew(R_dot[..., :, 0]), skew(R_dot[..., :, 1])

    ang = (area / 12.0) * (
        r33_dot * (
            L * L * (b * _mv(e1_hat @ e1_hat, omega) + k * _mv(e1_hat, R0[..., :, 0]))
            + W * W * (b * _mv(e2_hat @ e2_hat, omega) + k * _mv(e2_hat, R0[..., :, 1]))
        )
        + r33 * (
            L * L * (k * _mv(e1d_hat, R0[..., :, 0])
                     + b * _mv(e1d_hat @ e1_hat + e1_hat @ e1d_hat, omega))
            + W * W * (k * _mv(e2d_hat, R0[..., :, 1])
                       + b * _mv(e2d_hat @ e2_hat + e2_hat @ e2d_hat, omega))
        )
    )
    return jnp.concatenate([lin, ang], axis=-1)


def control_matrix(params: ContactParams, state: ContactState) -> jnp.ndarray:
    """Control matrix ``G`` of ``ẇ = f + G a`` w.r.t. frame acceleration (``(…, 6, 6)``).

    ``ContinuousContactModel::computeControlMatrix``
    (``ContinuousContactModel.cpp:148-171``): block-diagonal,
    ``G₁₁ = −A b R₃₃ I₃``, ``G₂₂ = A/12 R₃₃ b (L² ê₁² + W² ê₂²)``.
    """
    L, W, _, b = params
    area = L * W
    R = state.rotation
    r33 = R[..., 2, 2][..., None, None]

    eye3 = jnp.eye(3, dtype=R.dtype)
    top_left = -area * b * r33 * eye3

    e1_hat, e2_hat = skew(R[..., :, 0]), skew(R[..., :, 1])
    bottom_right = (area / 12.0) * r33 * b * (
        L * L * (e1_hat @ e1_hat) + W * W * (e2_hat @ e2_hat)
    )

    zeros = jnp.zeros_like(top_left)
    top = jnp.concatenate([top_left, zeros], axis=-1)
    bottom = jnp.concatenate([zeros, bottom_right], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def wrench_rate(params: ContactParams, state: ContactState, acceleration) -> jnp.ndarray:
    """``ẇ = f(x) + G(x) a`` — the split the linearization consumes
    (verified against finite differences, ``ContinousContactModelTest.cpp:126-213``)."""
    return autonomous_dynamics(params, state) + _mv(
        control_matrix(params, state), jnp.asarray(acceleration)
    )


def regressor(params: ContactParams, state: ContactState) -> jnp.ndarray:
    """Regressor ``A`` with ``w = A [k; b]`` (``(…, 6, 2)``).

    ``ContinuousContactModel::computeRegressor``
    (``ContinuousContactModel.cpp:223-254``); consumed by the RLS estimator
    for online spring/damper identification (SURVEY.md §3.2).
    """
    L, W, _, _ = params
    area = L * W
    R, R0 = state.rotation, state.null_rotation
    r33 = jnp.abs(R[..., 2, 2])[..., None]

    e1_hat, e2_hat = skew(R[..., :, 0]), skew(R[..., :, 1])

    top_k = r33 * area * (state.null_position - state.position)
    top_b = -r33 * area * state.linear_velocity
    bot_k = (area / 12.0) * r33 * (
        L * L * _mv(e1_hat, R0[..., :, 0]) + W * W * _mv(e2_hat, R0[..., :, 1])
    )
    bot_b = (area / 12.0) * r33 * _mv(
        L * L * (e1_hat @ e1_hat) + W * W * (e2_hat @ e2_hat),
        state.angular_velocity,
    )
    col_k = jnp.concatenate([top_k, bot_k], axis=-1)
    col_b = jnp.concatenate([top_b, bot_b], axis=-1)
    return jnp.stack([col_k, col_b], axis=-1)


def force_at_point(params: ContactParams, state: ContactState, x, y) -> jnp.ndarray:
    """Pointwise force density law at patch coordinates ``(x, y)`` (``(…, 3)``).

    ``ContinuousContactModel::getForceAtPoint``
    (``ContinuousContactModel.cpp:173-203``):
    ``f(x,y) = k[(p₀ − p) + (R₀ − R) ρ] − b[v + ω̂ R ρ]``, ``ρ = (x, y, 0)``;
    zero outside the patch.
    """
    L, W, k, b = params
    x, y = jnp.asarray(x), jnp.asarray(y)
    R, R0 = state.rotation, state.null_rotation
    rho = jnp.stack([x, y, jnp.zeros_like(x)], axis=-1)
    f = (
        k * ((state.null_position - state.position) + _mv(R0 - R, rho))
        - b * (state.linear_velocity + _mv(skew(state.angular_velocity) @ R, rho))
    )
    inside = (jnp.abs(x) <= L / 2) & (jnp.abs(y) <= W / 2)
    return jnp.where(inside[..., None], f, jnp.zeros_like(f))


def torque_at_point(params: ContactParams, state: ContactState, x, y) -> jnp.ndarray:
    """Pointwise torque ``(Rρ) × f(x,y)`` (``ContinuousContactModel.cpp:205-221``)."""
    x, y = jnp.asarray(x), jnp.asarray(y)
    rho = jnp.stack([x, y, jnp.zeros_like(x)], axis=-1)
    arm = _mv(state.rotation, rho)
    return jnp.cross(arm, force_at_point(params, state, x, y))
