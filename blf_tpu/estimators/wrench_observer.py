"""Momentum-based external contact-wrench observer (batched filter).

The second half of the Estimators stack the north star names ("recursive
least squares, **contact wrench observers** ... as batched filters feeding
the controller", BASELINE.json). The reference snapshot carries only the RLS
half (``src/Estimators/include/.../RecursiveLeastSquare.h:28-111``); this
module adds the generalized-momentum residual observer that later upstream
versions build for contact/external-wrench estimation, re-designed as a pure
JAX filter in the same ``step(params, state, ...) -> (state, out)`` /
``vmap``-fleet idiom as :mod:`blf_tpu.estimators.rls`.

Theory. With the floating-base dynamics exactly as the engine integrates
them (``blf_tpu.models.rigid_body.floating_base_dynamics``, the reference's
``FloatingBaseSystemDynamics.cpp:102-251``):

    M(q) ν̇ + h(q, ν) = B τ + τ_ext ,      p ≜ M(q) ν

the generalized momentum evolves as ``ṗ = Ṁν − h + Bτ + τ_ext`` (no
Christoffel/Coriolis-factorization identity needed — ``Ṁν`` is computed
EXACTLY by ``jax.jvp`` of the mass-matrix map along the state flow, the same
autodiff trick the engine uses for ``J̇ν`` in ``bias_forces``). The observer
integrates the *modeled* part and feeds back the gap:

    r = K (p − ∫ (Ṁν − h + Bτ + r) dt − p(0))     ⇒     ṙ = K (τ_ext − r)

so the residual ``r`` is a first-order filter of the true external
generalized force ``τ_ext = Σ J_cᵀ w_c`` with per-coordinate bandwidth ``K``
[rad/s]: zero when nothing touches the robot, and converging to ``Jᵀ w``
with time constant ``1/K`` on contact. Contact wrenches are then recovered
per frame by the least-squares inverse of the stacked contact Jacobians.

All functions are single-sample and pure; ``vmap`` provides the fleet axis
(see ``tests/test_wrench_observer.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from blf_tpu.models.kinematics import KinematicTree, forward_kinematics, frame_jacobian
from blf_tpu.models.rigid_body import (
    GRAVITY,
    FloatingBaseState,
    bias_forces,
    mass_matrix,
)
from blf_tpu.ops.lie import skew

__all__ = [
    "MomentumObserverParams",
    "MomentumObserverState",
    "init_momentum_observer",
    "momentum_observer_step",
    "wrench_normal_equations",
    "momentum_observer_scan",
    "wrenches_from_residual",
]


class MomentumObserverParams(NamedTuple):
    """Observer configuration.

    ``gain``: per-coordinate residual bandwidth K (scalar or (6+n,)) in
    rad/s — the only tuning knob of the classical observer.
    """

    gain: jnp.ndarray
    dt: jnp.ndarray


class MomentumObserverState(NamedTuple):
    """Filter carry: the integral term, seeded with p(0) so r(0) = 0."""

    integral: jnp.ndarray   # (6+n,) ∫(Ṁν − h + Bτ + r)dt + p(0)
    residual: jnp.ndarray   # (6+n,) latest r (diagnostic / warm output)


def _momentum_and_rate(tree: KinematicTree, state: FloatingBaseState,
                       gravity) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(p, Ṁν − h): generalized momentum and its input-free rate."""
    nu = jnp.concatenate([state.base_twist, state.joint_velocities])
    omega = state.base_twist[3:]

    def p_map(bp, bR, qq):
        return mass_matrix(tree, bp, bR, qq) @ nu

    # Ṁν exactly: differentiate q ↦ M(q)ν along the state flow
    # (ṗ = v, Ṙ = ω̂R, q̇ = s_dot); nu is held constant inside p_map.
    p, mdot_nu = jax.jvp(
        p_map,
        (state.base_position, state.base_rotation, state.joint_positions),
        (state.base_twist[:3], skew(omega) @ state.base_rotation,
         state.joint_velocities),
    )
    h = bias_forces(
        tree, state.base_position, state.base_rotation, state.joint_positions,
        state.base_twist, state.joint_velocities, gravity,
    )
    return p, mdot_nu - h


def init_momentum_observer(
    tree: KinematicTree,
    state: FloatingBaseState,
    gain,
    dt,
    gravity=GRAVITY,
) -> Tuple[MomentumObserverParams, MomentumObserverState]:
    """Params + state with the integral seeded at p(0) (residual starts 0)."""
    nu = jnp.concatenate([state.base_twist, state.joint_velocities])
    p0 = mass_matrix(
        tree, state.base_position, state.base_rotation, state.joint_positions
    ) @ nu
    params = MomentumObserverParams(
        gain=jnp.asarray(gain, p0.dtype), dt=jnp.asarray(dt, p0.dtype)
    )
    return params, MomentumObserverState(integral=p0, residual=jnp.zeros_like(p0))


def momentum_observer_step(
    tree: KinematicTree,
    params: MomentumObserverParams,
    obs: MomentumObserverState,
    state: FloatingBaseState,
    joint_torques: jnp.ndarray,
    gravity=GRAVITY,
) -> Tuple[MomentumObserverState, jnp.ndarray]:
    """One observer tick at the robot's sampled state; returns (state, r).

    ``state`` is the sample at the END of the tick's interval and
    ``joint_torques`` the *commanded/measured* actuation over it (the
    observer must know Bτ to attribute the rest of the momentum gap to
    contact). Backward-Euler discretization — solve the implicit pair

        I⁺ = I + dt (Ṁν − h + Bτ + r⁺),   r⁺ = K (p − I⁺)

    in closed form: ``r⁺ = K (p − I − dt·(modeled rate)) / (1 + K dt)``.
    This keeps ``r = K·(p − I)`` exact at every sample, gives the exact
    discrete first-order pole ``gap⁺ = (gap + dt·τ_ext)/(1 + K dt)`` (stable
    for any gain), and makes the residual at rest exactly zero.
    """
    p, rate = _momentum_and_rate(tree, state, gravity)
    tau_gen = jnp.concatenate([jnp.zeros(6, p.dtype), joint_torques])
    predicted = obs.integral + params.dt * (rate + tau_gen)
    r = params.gain * (p - predicted) / (1.0 + params.gain * params.dt)
    integral = predicted + params.dt * r
    return MomentumObserverState(integral=integral, residual=r), r


def momentum_observer_scan(
    tree: KinematicTree,
    params: MomentumObserverParams,
    obs: MomentumObserverState,
    states: FloatingBaseState,
    joint_torques: jnp.ndarray,
    gravity=GRAVITY,
) -> Tuple[MomentumObserverState, jnp.ndarray]:
    """Run the observer along a sampled trajectory (leading time axis on
    ``states``/``joint_torques``); returns the final state and the residual
    history (T, 6+n) — streaming equivalent of :func:`rls_scan`."""

    def body(carry, inp):
        st, tau = inp
        carry, r = momentum_observer_step(tree, params, carry, st, tau, gravity)
        return carry, r

    return jax.lax.scan(body, obs, (states, joint_torques))


def wrenches_from_residual(
    tree: KinematicTree,
    state: FloatingBaseState,
    frames: Sequence[str],
    residual: jnp.ndarray,
    *,
    reg: float = 1e-9,
) -> jnp.ndarray:
    """Recover per-frame contact wrenches from the residual: least-squares
    solve of ``Jᵀ f = r`` over the stacked contact Jacobians.

    Returns (len(frames), 6) mixed wrenches. With k active frames the normal
    equations are ``(J Jᵀ + reg·I) f = J r`` (6k × 6k — tiny, batched
    Cholesky); exact when ``r`` lies in the column space of ``Jᵀ`` (it does,
    up to the observer's filter lag). For 6k > nv the Tikhonov term picks the
    minimum-norm wrench distribution (the usual multi-contact ambiguity).
    """
    G, Jr = wrench_normal_equations(tree, state, frames, residual, reg=reg)
    f = jnp.linalg.solve(G, Jr)
    return f.reshape(len(frames), 6)


def wrench_normal_equations(
    tree: KinematicTree,
    state: FloatingBaseState,
    frames: Sequence[str],
    residual: jnp.ndarray,
    *,
    reg: float = 1e-9,
):
    """The (G, J·r) normal-equation pair of :func:`wrenches_from_residual`
    WITHOUT the solve — so a fleet caller can vmap the Jacobian assembly
    and run the tiny batched SPD solve once for the whole fleet as the
    unrolled :func:`blf_tpu.ops.linalg.solve_psd_small` instead of a
    per-lane ``linalg.solve``."""
    poses = forward_kinematics(
        tree, state.base_position, state.base_rotation, state.joint_positions
    )
    J = jnp.concatenate(
        [frame_jacobian(tree, poses, f) for f in frames], axis=0
    )  # (6k, 6+n)
    k6 = J.shape[0]
    G = J @ J.T + reg * jnp.eye(k6, dtype=J.dtype)
    return G, J @ residual
