"""SQP trajectory optimizer + time-varying DCM planner tests.

Ground truths, in the reference's own test style (SURVEY.md §4): exact
agreement with the linear-quadratic Riccati solver on LQ problems, an
independent scipy SLSQP solve on a constrained problem, and the analytic DCM
backward recursion (`models/lipm.py`) for the planner's constant-ω reduction.
"""

import numpy as np
import pytest

from conftest import tol
import scipy.optimize

import jax
import jax.numpy as jnp

from blf_tpu.models.lipm import (
    LIPMParams, dcm_backward_recursion, dcm_discrete_step, lipm_omega,
)
from blf_tpu.mpc.dcm_planner import (
    DCMPlannerLimits, DCMPlannerWeights, com_from_dcm_omega,
    plan_time_varying_dcm, plan_time_varying_dcm_batch,
)
from blf_tpu.mpc.riccati import solve_lqr
from blf_tpu.mpc.sqp import SQPConfig, solve_trajopt


class TestSQPCore:
    def test_lq_problem_matches_riccati(self):
        """On a linear-quadratic problem the GN-SQP is exact in one pass."""
        rng = np.random.default_rng(0)
        T, nx, nu = 15, 4, 2
        F = jnp.asarray(np.eye(nx) + 0.05 * rng.normal(size=(nx, nx)))
        L = jnp.asarray(0.1 * rng.normal(size=(nx, nu)))
        c = jnp.asarray(0.01 * rng.normal(size=(nx,)))
        sqQ = jnp.asarray(rng.normal(size=(nx, nx)) * 0.3)
        sqR = jnp.asarray(np.diag(rng.uniform(0.5, 1.0, nu)))
        sqQT = jnp.asarray(rng.normal(size=(nx, nx)))
        x0 = jnp.asarray(rng.normal(size=(nx,)))

        lqr = solve_lqr(
            jnp.tile(F, (T, 1, 1)), jnp.tile(c, (T, 1)),
            jnp.tile(L, (T, 1, 1)), jnp.tile(sqQ.T @ sqQ, (T, 1, 1)),
            jnp.tile(sqR.T @ sqR, (T, 1, 1)), sqQT.T @ sqQT, x0,
        )

        sol = solve_trajopt(
            lambda x, u, k: F @ x + L @ u + c,
            lambda x, u, k: jnp.concatenate([sqQ @ x, sqR @ u]),
            lambda x: sqQT @ x,
            x0, jnp.zeros((T, nu)),
            config=SQPConfig(iterations=3, al_iterations=1,
                             regularization=0.0),
        )
        np.testing.assert_allclose(sol.states, lqr.states, atol=tol(1e-9, 2e-4))
        np.testing.assert_allclose(sol.controls, lqr.controls, atol=tol(1e-9, 2e-4))

    def test_constrained_double_integrator_vs_scipy(self):
        """Box-constrained minimum-effort transfer vs an independent SLSQP."""
        T, dt, u_max = 12, 0.2, 0.35
        target = np.array([1.0, 0.0])
        A = np.array([[1.0, dt], [0.0, 1.0]])
        B = np.array([[0.5 * dt * dt], [dt]])
        wT = 30.0

        def rollout_np(us):
            x = np.zeros(2)
            for u in us:
                x = A @ x + B[:, 0] * u
            return x

        def cost_np(us):
            xT = rollout_np(us)
            return 0.5 * np.sum(us**2) + 0.5 * wT**2 * np.sum(
                (xT - target) ** 2
            )

        ref = scipy.optimize.minimize(
            cost_np, np.zeros(T), method="SLSQP",
            bounds=[(-u_max, u_max)] * T,
            options={"maxiter": 400, "ftol": 1e-14},
        )
        assert ref.success

        sol = solve_trajopt(
            lambda x, u, k: jnp.asarray(A) @ x + jnp.asarray(B[:, 0]) * u[0],
            lambda x, u, k: u,
            lambda x: wT * (x - jnp.asarray(target)),
            jnp.zeros(2), jnp.zeros((T, 1)),
            inequality=lambda x, u, k: jnp.stack(
                [u[0] - u_max, -u_max - u[0]]
            ),
            config=SQPConfig(iterations=10, al_iterations=6,
                             penalty_init=10.0),
        )
        assert float(sol.max_violation) <= tol(1e-6, 2e-4)
        # same optimum as the independent solver
        np.testing.assert_allclose(float(sol.cost), ref.fun, rtol=1e-5)
        np.testing.assert_allclose(
            np.asarray(sol.controls)[:, 0], ref.x, atol=2e-3
        )
        # the box constraint is genuinely active on this problem
        assert np.max(np.abs(ref.x)) > u_max - 1e-6

    def test_unconstrained_converges_flag(self):
        sol = solve_trajopt(
            lambda x, u, k: 0.9 * x + 0.1 * u,
            lambda x, u, k: jnp.concatenate([x, u]),
            lambda x: x,
            jnp.ones(2), jnp.zeros((8, 2)),
            config=SQPConfig(iterations=6, al_iterations=2),
        )
        assert bool(sol.converged)
        assert float(sol.max_violation) == 0.0


def _planner_problem(T=30, dt=0.1, z_nom=0.9, margin=0.12):
    params = LIPMParams(jnp.asarray(z_nom), jnp.asarray(9.81))
    steps = np.array([[0.0, 0.0], [0.15, 0.1], [0.3, -0.1], [0.45, 0.0]])
    reps = T // len(steps)
    zmp_ref = jnp.asarray(np.repeat(steps, reps, axis=0))
    T = zmp_ref.shape[0]
    # square polygons of half-width `margin` around each reference point
    poly_A = jnp.tile(
        jnp.asarray([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]]),
        (T, 1, 1),
    )
    poly_b = jnp.stack(
        [zmp_ref[:, 0] + margin, -(zmp_ref[:, 0] - margin),
         zmp_ref[:, 1] + margin, -(zmp_ref[:, 1] - margin)], -1,
    )
    return params, zmp_ref, poly_A, poly_b


class TestDCMPlanner:
    def test_consistent_problem_reproduces_analytic_recursion(self):
        """Seeded on the analytic DCM recursion, the optimum is exactly the
        constant-ω flow — trajectory parity with models/lipm.py."""
        params, zmp_ref, poly_A, poly_b = _planner_problem()
        T = zmp_ref.shape[0]
        dt, z_nom = 0.1, float(params.com_height)
        omega = lipm_omega(params)
        xy_ref = dcm_backward_recursion(
            params, zmp_ref, zmp_ref[-1], dt
        )                                            # (T+1, 2)
        dcm0 = jnp.concatenate([xy_ref[0], jnp.asarray([z_nom])])
        goal = jnp.concatenate([xy_ref[-1], jnp.asarray([z_nom])])

        sol = plan_time_varying_dcm(
            params, dt, dcm0, omega, zmp_ref, poly_A, poly_b, goal,
        )
        assert bool(sol.converged)
        assert float(sol.cost) < tol(1e-10, 1e-6)
        np.testing.assert_allclose(sol.dcm[:, :2], xy_ref, atol=tol(1e-8, 2e-4))
        np.testing.assert_allclose(sol.dcm[:, 2], z_nom, atol=tol(1e-8, 2e-4))
        np.testing.assert_allclose(sol.omega, float(omega), atol=tol(1e-9, 2e-4))
        np.testing.assert_allclose(sol.omega_dot, 0.0, atol=tol(1e-9, 2e-4))
        # vrp_z = g/ω² = z_nom exactly in the constant-ω reduction
        np.testing.assert_allclose(sol.vrp[:, 2], z_nom, atol=tol(1e-8, 2e-4))

    def test_push_recovery_respects_polygons_and_terminal(self):
        """Perturbed initial DCM: the planner must deviate the ZMP (within
        the support polygons) to recover and still hit the capture goal."""
        params, zmp_ref, poly_A, poly_b = _planner_problem(margin=0.08)
        dt, z_nom = 0.1, float(params.com_height)
        omega = lipm_omega(params)
        xy_ref = dcm_backward_recursion(params, zmp_ref, zmp_ref[-1], dt)
        dcm0 = jnp.concatenate(
            [xy_ref[0] + jnp.asarray([0.06, -0.05]), jnp.asarray([z_nom])]
        )
        goal = jnp.concatenate([xy_ref[-1], jnp.asarray([z_nom])])

        sol = plan_time_varying_dcm(
            params, dt, dcm0, omega, zmp_ref, poly_A, poly_b, goal,
        )
        assert float(sol.max_violation) <= tol(1e-6, 2e-4)
        # every ZMP inside its polygon
        margins = (
            jnp.einsum("tmi,ti->tm", poly_A, sol.zmp) - poly_b
        )
        assert float(margins.max()) <= tol(1e-6, 2e-4)
        # recovery actually used the polygon (ZMP ≠ reference)
        assert float(jnp.abs(sol.zmp - zmp_ref).max()) > 1e-3
        # terminal capture: DCM at goal, ω settled
        np.testing.assert_allclose(np.asarray(sol.dcm[-1]), np.asarray(goal),
                                   atol=2e-3)
        assert abs(float(sol.omega[-1]) - float(omega)) < 5e-2
        # ω within limits everywhere
        lim = DCMPlannerLimits()
        assert float(sol.omega.min()) >= lim.omega_min - 1e-9
        assert float(sol.omega.max()) <= lim.omega_max + 1e-9

    def test_time_varying_omega_engages_under_height_mismatch(self):
        """Start with ω far from nominal: the planner must actively steer ω
        back via ω̇ — the capability the constant-ω DCM-MPC lacks."""
        params, zmp_ref, poly_A, poly_b = _planner_problem()
        dt, z_nom = 0.1, float(params.com_height)
        omega_nom = lipm_omega(params)
        xy_ref = dcm_backward_recursion(params, zmp_ref, zmp_ref[-1], dt)
        dcm0 = jnp.concatenate([xy_ref[0], jnp.asarray([z_nom + 0.1])])
        goal = jnp.concatenate([xy_ref[-1], jnp.asarray([z_nom])])
        omega0 = omega_nom * 1.25

        sol = plan_time_varying_dcm(
            params, dt, dcm0, omega0, zmp_ref, poly_A, poly_b, goal,
            weights=DCMPlannerWeights(omega_tracking=0.3, omega_dot=0.1),
        )
        assert float(sol.max_violation) <= tol(1e-6, 2e-4)
        assert float(jnp.abs(sol.omega_dot).max()) > 1e-2   # ω̇ engaged
        # ω driven back toward nominal by the end
        assert abs(float(sol.omega[-1]) - float(omega_nom)) < 0.05
        np.testing.assert_allclose(np.asarray(sol.dcm[-1]),
                                   np.asarray(goal), atol=5e-3)

    def test_batched_matches_single(self):
        params, zmp_ref, poly_A, poly_b = _planner_problem(T=20)
        dt, z_nom = 0.1, float(params.com_height)
        omega = lipm_omega(params)
        rng = np.random.default_rng(3)
        B = 6
        xy_ref = dcm_backward_recursion(params, zmp_ref, zmp_ref[-1], dt)
        dcm0 = jnp.concatenate(
            [jnp.broadcast_to(xy_ref[0], (B, 2))
             + jnp.asarray(rng.uniform(-0.03, 0.03, (B, 2))),
             jnp.full((B, 1), z_nom)], axis=-1,
        )
        omega0 = jnp.full((B,), float(omega))
        goal = jnp.concatenate([xy_ref[-1], jnp.asarray([z_nom])])

        batch = plan_time_varying_dcm_batch(
            params, dt, dcm0, omega0, zmp_ref, poly_A, poly_b, goal
        )
        assert batch.dcm.shape == (B, 21, 3)
        assert np.isfinite(np.asarray(batch.dcm)).all()
        single = plan_time_varying_dcm(
            params, dt, dcm0[2], omega0[2], zmp_ref, poly_A, poly_b, goal
        )
        np.testing.assert_allclose(batch.dcm[2], single.dcm, atol=tol(1e-10, 1e-4))
        np.testing.assert_allclose(batch.zmp[2], single.zmp, atol=tol(1e-10, 1e-4))

    def test_exact_step_reduces_to_lipm_discrete_step(self):
        """ω̇ = 0 ⇒ the planner's flow is bit-for-bit dcm_discrete_step."""
        from blf_tpu.mpc.dcm_planner import _dcm_step

        params = LIPMParams(jnp.asarray(0.85), jnp.asarray(9.81))
        omega = lipm_omega(params)
        xi = jnp.asarray([0.1, -0.05, 0.85])
        zmp = jnp.asarray([0.02, 0.01])
        dt = 0.07
        x = jnp.concatenate([xi, jnp.atleast_1d(omega)])
        u = jnp.concatenate([zmp, jnp.zeros(1)])
        stepped = _dcm_step(x, u, dt, params.gravity, 0.0)
        vrp = jnp.concatenate([zmp, jnp.atleast_1d(9.81 / omega**2)])
        expected = dcm_discrete_step(params, xi, vrp, dt)
        np.testing.assert_allclose(stepped[:3], expected, atol=tol(1e-14, 1e-6))
        np.testing.assert_allclose(stepped[3], omega, atol=0)

    def test_com_integration_exactness(self):
        """Constant (ξ, ω): ċ = ω(ξ−c) has closed form; ours is exact."""
        dt, T = 0.05, 40
        omega = 3.2
        xi = jnp.asarray([0.3, -0.1, 0.9])
        dcm = jnp.broadcast_to(xi, (T + 1, 3))
        om = jnp.full((T + 1,), omega)
        com0 = jnp.asarray([0.0, 0.0, 0.8])
        com = com_from_dcm_omega(com0, dcm, om, dt)
        ts = np.arange(T + 1) * dt
        expected = (
            np.asarray(xi)[None]
            + np.exp(-omega * ts)[:, None]
            * (np.asarray(com0) - np.asarray(xi))[None]
        )
        np.testing.assert_allclose(com, expected, atol=tol(1e-12, 1e-6))


class TestParallelBackward:
    """SQP with the O(log T) associative-scan backward: identical solutions
    to the sequential pass (the SP machinery connected to the nonlinear
    stack)."""

    @pytest.mark.parametrize("T", [16, 64])
    def test_matches_sequential_on_planner_problem(self, T):
        from conftest import F32_LANE

        if F32_LANE and T > 24:
            pytest.skip(
                "unstable DCM dynamics: composed interval maps grow like "
                "rho(A)^T ~ 1.4^T, so the f32 associative scan overflows "
                "its precision beyond T~24 (documented constraint of "
                "parallel_value_general; sequential backward is exact)")
        params, zmp_ref, poly_A, poly_b = _planner_problem(T=T)
        dt, z_nom = 0.1, float(params.com_height)
        omega = lipm_omega(params)
        xy_ref = dcm_backward_recursion(params, zmp_ref, zmp_ref[-1], dt)
        dcm0 = jnp.concatenate(
            [xy_ref[0] + jnp.asarray([0.04, -0.03]), jnp.asarray([z_nom])])
        goal = jnp.concatenate([xy_ref[-1], jnp.asarray([z_nom])])
        kw = dict(iterations=8, al_iterations=3, penalty_init=10.0)
        seq = plan_time_varying_dcm(
            params, dt, dcm0, omega, zmp_ref, poly_A, poly_b, goal,
            sqp=SQPConfig(**kw))
        par = plan_time_varying_dcm(
            params, dt, dcm0, omega, zmp_ref, poly_A, poly_b, goal,
            sqp=SQPConfig(parallel_backward=True, **kw))
        np.testing.assert_allclose(np.asarray(par.dcm), np.asarray(seq.dcm),
                                   atol=tol(1e-6, 5e-3))
        np.testing.assert_allclose(np.asarray(par.zmp), np.asarray(seq.zmp),
                                   atol=tol(1e-6, 5e-3))
        assert abs(float(par.max_violation) - float(seq.max_violation)) \
            <= tol(1e-6, 5e-4)
