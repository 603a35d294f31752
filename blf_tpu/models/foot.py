"""Rigid-foot spring–damper rollout — the reference's hot simulation loop.

BASELINE config 2 ("ContinuousContactModel spring-damper foot rollout + RLS
contact-parameter estimation") distilled to its compute core: a single rigid
body (the foot) falling/settling on the continuous spring–damper patch of
:mod:`blf_tpu.models.contact`, integrated with forward Euler exactly like the
reference's hot loop (``FixedStepIntegrator.tpp:48-61`` over
``FloatingBaseSystemDynamics.cpp:102-251`` with one ``ContactWrench``) — but
batched over thousands of scenarios.

Dynamics (mixed representation, foot frame at the CoM):

    ṗ = v
    Ṙ = ω̂ R + ρ/2 ((R Rᵀ)⁻¹ − I) R      (Baumgarte, ``FloatingBaseSystem
                                           Kinematics.cpp:64-68``)
    v̇ = w_f / m + g
    ω̇ = R I⁻¹ Rᵀ (w_τ − ω × (R I Rᵀ ω))  (diagonal body inertia ⇒ the world
                                           inertia inverse is closed-form)

with ``w = contact_wrench(params, state)`` — the closed-form patch wrench
(``ContinuousContactModel.cpp:79-108``).

:func:`foot_rollout` runs ``lax.scan`` over :func:`foot_dynamics` (it
composes with the generic integrators and the full articulated engine).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from blf_tpu.models.contact import ContactParams, ContactState, contact_wrench
from blf_tpu.ops.lie import rotation_rate_mixed, skew, so3_baumgarte_rate

__all__ = ["FootParams", "FootState", "foot_dynamics", "foot_euler_step",
           "foot_rollout"]

GRAVITY_Z = -9.81


class FootParams(NamedTuple):
    """Rigid-foot body parameters (contact patch params ride separately)."""

    mass: jnp.ndarray           # scalar [kg]
    inertia: jnp.ndarray        # (3,) diagonal body inertia at the CoM
    baumgarte_rho: jnp.ndarray  # SO(3) stabilisation gain (reference ρ)


class FootState(NamedTuple):
    """Batched foot state; every leaf broadcasts over leading axes."""

    position: jnp.ndarray         # (…, 3)
    rotation: jnp.ndarray         # (…, 3, 3)
    linear_velocity: jnp.ndarray  # (…, 3)
    angular_velocity: jnp.ndarray  # (…, 3)


def _mv(m, v):
    return jnp.einsum("...ij,...j->...i", m, v)


def foot_dynamics(
    cparams: ContactParams,
    fparams: FootParams,
    state: FootState,
    null_position: jnp.ndarray,
    null_rotation: jnp.ndarray,
) -> FootState:
    """State derivative of the contact-closed rigid foot (see module doc)."""
    w = contact_wrench(
        cparams,
        ContactState(
            position=state.position, rotation=state.rotation,
            linear_velocity=state.linear_velocity,
            angular_velocity=state.angular_velocity,
            null_position=null_position, null_rotation=null_rotation,
        ),
    )
    g = jnp.zeros_like(state.linear_velocity).at[..., 2].set(GRAVITY_Z)
    v_dot = w[..., :3] / fparams.mass + g

    R = state.rotation
    Rt = jnp.swapaxes(R, -1, -2)
    omega = state.angular_velocity
    I_diag = jnp.asarray(fparams.inertia, dtype=R.dtype)
    Iw_omega = _mv(R, I_diag * _mv(Rt, omega))
    torque = w[..., 3:] - jnp.cross(omega, Iw_omega)
    omega_dot = _mv(R, _mv(Rt, torque) / I_diag)

    return FootState(
        position=state.linear_velocity,
        rotation=so3_baumgarte_rate(R, omega, fparams.baumgarte_rho),
        linear_velocity=v_dot,
        angular_velocity=omega_dot,
    )


def foot_euler_step(cparams, fparams, state: FootState, null_position,
                    null_rotation, dt) -> FootState:
    """One forward-Euler step (``ForwardEuler.tpp:19-41`` shape: x += dT·f)."""
    d = foot_dynamics(cparams, fparams, state, null_position, null_rotation)
    return jax.tree_util.tree_map(lambda x, dx: x + dt * dx, state, d)


def foot_rollout(
    cparams: ContactParams,
    fparams: FootParams,
    state: FootState,
    null_position: jnp.ndarray,
    null_rotation: jnp.ndarray,
    dt: float,
    steps: int,
) -> FootState:
    """Integrate ``steps`` Euler steps; returns the final state.

    Every argument broadcasts over leading batch axes (per-lane
    ``spring_coeff``/``damper_coeff`` included).
    """

    def body(s, _):
        return foot_euler_step(
            cparams, fparams, s, null_position, null_rotation, dt
        ), None

    # force full-f32 3×3 products: a reduced-precision (TF32 / bf16) product
    # injects ~1e-3 rotation error over a 50-step stiff-contact rollout
    with jax.default_matmul_precision("float32"):
        out, _ = jax.lax.scan(body, state, None, length=steps)
    return out
