"""Advanceable protocol contract tests.

The reference's ``Advanceable<T>`` (`Advanceable.h:24-46`) maps to the
``step(carry, *inputs) -> (carry', out)`` convention; these tests make the
convention enforceable and pin that the framework's
stateful components actually satisfy it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blf_tpu.ops.advanceable import advance_scan, check_advanceable


class TestContract:
    def test_good_step_passes(self):
        def step(c, x):
            return c + x, c * 2.0

        check_advanceable(step, jnp.zeros(3), jnp.ones(3))

    def test_non_tuple_return_rejected(self):
        with pytest.raises(TypeError, match="must return"):
            check_advanceable(lambda c: c, jnp.zeros(3))

    def test_carry_shape_change_rejected(self):
        def bad(c):
            return jnp.concatenate([c, c]), c

        with pytest.raises(TypeError, match="stable carry"):
            check_advanceable(bad, jnp.zeros(3))

    def test_carry_dtype_change_rejected(self):
        def bad(c):
            return c.astype(jnp.float16), c

        with pytest.raises(TypeError, match="stable carry"):
            check_advanceable(bad, jnp.zeros(3))

    def test_carry_treedef_change_rejected(self):
        def bad(c):
            return {"a": c}, c

        with pytest.raises(TypeError, match="treedef"):
            check_advanceable(bad, jnp.zeros(3))


class TestAdvanceScan:
    def test_drives_sequence(self):
        def step(c, x):
            c = c + x
            return c, c

        final, outs = advance_scan(step, jnp.asarray(0.0),
                                   jnp.asarray([1.0, 2.0, 3.0]))
        assert float(final) == 6.0
        np.testing.assert_allclose(np.asarray(outs), [1.0, 3.0, 6.0])

    def test_autonomous_with_length(self):
        final, outs = advance_scan(lambda c: (c * 2.0, c), jnp.asarray(1.0),
                                   length=4)
        assert float(final) == 16.0
        np.testing.assert_allclose(np.asarray(outs), [1.0, 2.0, 4.0, 8.0])

    def test_pytree_inputs_pass_as_one(self):
        def step(c, ab):
            a, b = ab
            return c + a * b, c

        final, _ = advance_scan(step, jnp.asarray(0.0),
                                (jnp.ones(3), 2.0 * jnp.ones(3)))
        assert float(final) == 6.0


class TestFrameworkComponentsConform:
    """The components the reference implemented as Advanceable subclasses
    (or would have) satisfy the step contract."""

    def test_rls_step(self):
        from blf_tpu.estimators.rls import RLSParams, RLSState, rls_step

        params = RLSParams(lam=jnp.asarray(0.98),
                           measurement_covariance=1e-2 * jnp.eye(2))
        state = RLSState(jnp.zeros(2), jnp.eye(2))

        def step(carry, Ay):
            A, y = Ay
            nxt = rls_step(params, carry, A, y)
            return nxt, nxt.theta

        check_advanceable(step, state, (jnp.eye(2), jnp.ones(2)))
        # and it scans: recover a constant parameter from clean data
        T = 50
        A_seq = jnp.broadcast_to(jnp.eye(2), (T, 2, 2))
        y_seq = jnp.broadcast_to(jnp.asarray([0.3, -0.7]), (T, 2))
        final, thetas = advance_scan(step, state, (A_seq, y_seq))
        np.testing.assert_allclose(np.asarray(final.theta), [0.3, -0.7],
                                   atol=1e-3)

    def test_integrator_step(self):
        from blf_tpu.ops.integrators import rk4_step

        def f(x, u, t):
            return -x + u

        def step(carry, u):
            x, t = carry
            x2 = rk4_step(f, x, u, t, 0.01)
            return (x2, t + 0.01), x2

        check_advanceable(step, (jnp.ones(3), jnp.asarray(0.0)), jnp.zeros(3))

    def test_momentum_observer_step(self):
        from blf_tpu.estimators.wrench_observer import (
            MomentumObserverParams,
            init_momentum_observer,
            momentum_observer_step,
        )
        from blf_tpu.models import rigid_body as rb
        from blf_tpu.models.robots import make_humanoid_23dof

        tree = make_humanoid_23dof()
        n = tree.num_dofs
        plant = rb.FloatingBaseState(
            base_twist=jnp.zeros(6),
            joint_velocities=jnp.zeros(n),
            base_position=jnp.asarray([0.0, 0.0, 0.8]),
            base_rotation=jnp.eye(3),
            joint_positions=jnp.zeros(n),
        )
        params = MomentumObserverParams(gain=jnp.asarray(30.0),
                                        dt=jnp.asarray(0.01))
        _, obs = init_momentum_observer(tree, plant, 30.0, 0.01)

        def step(carry, tau):
            nxt, residual = momentum_observer_step(tree, params, carry,
                                                   plant, tau)
            return nxt, residual

        check_advanceable(step, obs, jnp.zeros(n))

    def test_fleet_tick(self):
        from jax.sharding import Mesh

        from blf_tpu.models.lipm import LIPMParams
        from blf_tpu.parallel.mesh import make_mesh
        from blf_tpu.parallel.sweep import init_fleet, make_fleet_step

        if len(jax.devices()) < 2:
            pytest.skip("needs multi-device mesh")
        mesh = make_mesh(2, model_axis=1)
        params = LIPMParams(jnp.asarray(0.9), jnp.asarray(9.81))
        N = 8
        B = 4
        state = init_fleet(B, N, 2 * N + 4 * N, jnp.zeros(2), jnp.zeros(2),
                           dtype=jnp.float32)
        dt32 = jnp.float32
        refs = (
            jnp.zeros((B, 1, 2), dt32),
            jnp.zeros((N + 1, 2), dt32),
            jnp.zeros((N, 2), dt32),
            jnp.tile(jnp.asarray([[1.0, 0], [-1, 0], [0, 1], [0, -1]], dt32),
                     (N, 1, 1)),
            jnp.broadcast_to(jnp.asarray([0.1, 0.1, 0.1, 0.1], dt32), (N, 4)),
        )
        step = make_fleet_step(mesh, params, 0.1, iterations=10)

        def tick(carry, _):
            return step.sharded_fn(carry, *refs)

        check_advanceable(tick, state, None)
