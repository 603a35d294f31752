"""Rigid-foot contact rollout: physics ground truths and batching.

Mirrors the reference's verification style (SURVEY.md §4): the integrated
spring-damper foot must settle to the analytic static equilibrium, and
every lane of a batched rollout must integrate as if alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blf_tpu.models.contact import ContactParams, ContactState, contact_wrench
from blf_tpu.models.foot import (FootParams, FootState, foot_dynamics,
                                 foot_rollout)

DTYPE = jnp.float32


def make_problem(B=256, seed=0, dtype=DTYPE):
    cparams = ContactParams(
        length=jnp.asarray(0.2, dtype), width=jnp.asarray(0.1, dtype),
        spring_coeff=jnp.asarray(2e5, dtype),
        damper_coeff=jnp.asarray(2e3, dtype),
    )
    fparams = FootParams(
        mass=jnp.asarray(0.75, dtype),
        inertia=jnp.asarray([2e-3, 4e-3, 5e-3], dtype),
        baumgarte_rho=jnp.asarray(10.0, dtype),
    )
    rng = np.random.default_rng(seed)
    from blf_tpu.ops.lie import so3_exp

    rotvec = jnp.asarray(rng.normal(0, 0.02, (B, 3)), dtype)
    state = FootState(
        position=jnp.asarray(rng.normal(0, 1e-3, (B, 3)), dtype),
        rotation=so3_exp(rotvec),
        linear_velocity=jnp.asarray(rng.normal(0, 0.05, (B, 3)), dtype),
        angular_velocity=jnp.asarray(rng.normal(0, 0.05, (B, 3)), dtype),
    )
    null_position = jnp.zeros((B, 3), dtype)
    null_rotation = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (B, 3, 3))
    return cparams, fparams, state, null_position, null_rotation


class TestFootRollout:
    def test_settles_to_static_equilibrium(self):
        """Damped settling: p_z → p0_z − m g /(k A), velocities → 0, R → I
        (the closed-loop analogue of the reference's integrator ground-truth
        checks, IntegratorTest.cpp:54-125)."""
        cp, fp, state, p0, R0 = make_problem(B=64)
        final = jax.jit(
            lambda s: foot_rollout(cp, fp, s, p0, R0, dt=1e-3, steps=4000)
        )(state)
        area = float(cp.length * cp.width)
        sink = float(fp.mass) * 9.81 / (float(cp.spring_coeff) * area)
        np.testing.assert_allclose(
            np.asarray(final.position[:, 2]), -sink, atol=1e-4)
        assert float(jnp.abs(final.linear_velocity).max()) < 1e-4
        assert float(jnp.abs(final.angular_velocity).max()) < 1e-3
        eye = jnp.broadcast_to(jnp.eye(3, dtype=DTYPE), final.rotation.shape)
        assert float(jnp.abs(final.rotation - eye).max()) < 1e-3

    def test_equilibrium_wrench_balances_gravity(self):
        """At the settled state the patch wrench equals the foot's weight."""
        cp, fp, state, p0, R0 = make_problem(B=8)
        final = foot_rollout(cp, fp, state, p0, R0, dt=1e-3, steps=4000)
        w = contact_wrench(cp, ContactState(
            position=final.position, rotation=final.rotation,
            linear_velocity=final.linear_velocity,
            angular_velocity=final.angular_velocity,
            null_position=p0, null_rotation=R0,
        ))
        np.testing.assert_allclose(
            np.asarray(w[:, 2]), float(fp.mass) * 9.81, rtol=1e-3)
        assert float(jnp.abs(w[:, :2]).max()) < 1e-2

    def test_dynamics_matches_contact_model(self):
        """foot_dynamics' wrench term is exactly models.contact.contact_wrench
        (regression guard on the hand-inlined kernel formulas)."""
        cp, fp, state, p0, R0 = make_problem(B=8)
        d = foot_dynamics(cp, fp, state, p0, R0)
        w = contact_wrench(cp, ContactState(
            position=state.position, rotation=state.rotation,
            linear_velocity=state.linear_velocity,
            angular_velocity=state.angular_velocity,
            null_position=p0, null_rotation=R0,
        ))
        g = jnp.asarray([0.0, 0.0, -9.81], DTYPE)
        np.testing.assert_allclose(
            np.asarray(d.linear_velocity),
            np.asarray(w[:, :3] / fp.mass + g), rtol=1e-6, atol=1e-6)

    def test_odd_batch_matches_per_lane_rollout(self):
        """A batch of 13 lanes (no alignment) integrates every lane exactly
        as a rollout of that lane alone."""
        cp, fp, state, p0, R0 = make_problem(B=13)
        args = dict(dt=1e-3, steps=50)
        fleet = foot_rollout(cp, fp, state, p0, R0, **args)
        for i in (0, 6, 12):
            one = foot_rollout(
                cp, fp, jax.tree_util.tree_map(lambda a: a[i:i + 1], state),
                p0[i:i + 1], R0[i:i + 1], **args)
            for name in FootState._fields:
                np.testing.assert_allclose(
                    np.asarray(getattr(fleet, name))[i],
                    np.asarray(getattr(one, name))[0],
                    rtol=1e-6, atol=1e-7, err_msg=name)

    def test_per_lane_stiffness(self):
        """Per-lane (B, 1) spring/damper coefficients (identification
        sweeps): each lane settles to its own static sink m·g/(k·A)."""
        cp, fp, state, p0, R0 = make_problem(B=16)
        rng = np.random.default_rng(3)
        k = rng.uniform(1e5, 3e5, (16, 1))
        b = rng.uniform(1e3, 3e3, (16, 1))
        cpl = cp._replace(spring_coeff=jnp.asarray(k, DTYPE),
                          damper_coeff=jnp.asarray(b, DTYPE))
        final = jax.jit(lambda s: foot_rollout(
            cpl, fp, s, p0, R0, dt=1e-3, steps=4000))(state)
        area = float(cp.length * cp.width)
        sink = float(fp.mass) * 9.81 / (k[:, 0] * area)
        np.testing.assert_allclose(np.asarray(final.position[:, 2]), -sink,
                                   atol=1e-4)
        assert len(np.unique(np.round(sink, 8))) == 16

    def test_traced_under_jit_and_grad(self):
        """The XLA path composes with jit+grad (policy-learning readiness)."""
        cp, fp, state, p0, R0 = make_problem(B=4)

        def loss(k):
            cpl = cp._replace(spring_coeff=k)
            out = foot_rollout(cpl, fp, state, p0, R0, dt=1e-3, steps=50)
            return jnp.sum(out.position[:, 2] ** 2)

        g = jax.jit(jax.grad(loss))(cp.spring_coeff)
        assert np.isfinite(float(g))
