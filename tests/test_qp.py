"""Batched ADMM QP solver tests: against closed forms and scipy (SLSQP)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import tol

from blf_tpu.mpc.qp import solve_qp, solve_qp_lanes

RNG = np.random.default_rng(0)


def random_spd(n, rng=RNG):
    B = rng.normal(size=(n, n))
    return B @ B.T + n * np.eye(n)


class TestUnconstrained:
    def test_matches_closed_form(self):
        n = 8
        P = jnp.asarray(random_spd(n))
        q = jnp.asarray(RNG.normal(size=n))
        A = jnp.zeros((1, n))
        sol = solve_qp(P, q, A, jnp.array([-jnp.inf]), jnp.array([jnp.inf]),
                       iterations=300)
        np.testing.assert_allclose(
            np.asarray(sol.x), np.linalg.solve(np.asarray(P), -np.asarray(q)),
            atol=1e-6,
        )
        assert bool(sol.converged)


class TestConstrained:
    def make_problem(self, n=6, m=4, rng=None):
        rng = rng or np.random.default_rng(7)
        P = random_spd(n, rng)
        q = rng.normal(size=n)
        A = rng.normal(size=(m, n))
        # bounds around a feasible point so the problem is well-posed
        x_feas = rng.normal(size=n) * 0.1
        c = A @ x_feas
        l = c - rng.uniform(0.05, 0.5, size=m)
        u = c + rng.uniform(0.05, 0.5, size=m)
        return P, q, A, l, u

    def scipy_solve(self, P, q, A, l, u):
        from scipy.optimize import minimize

        cons = [
            {"type": "ineq", "fun": lambda x, A=A, u=u: u - A @ x},
            {"type": "ineq", "fun": lambda x, A=A, l=l: A @ x - l},
        ]
        res = minimize(
            lambda x: 0.5 * x @ P @ x + q @ x,
            np.zeros_like(q),
            jac=lambda x: P @ x + q,
            constraints=cons,
            method="SLSQP",
            options={"maxiter": 500, "ftol": 1e-12},
        )
        assert res.success
        return res.x

    def test_matches_scipy_active_constraints(self):
        for seed in range(5):
            rng = np.random.default_rng(seed)
            P, q, A, l, u = self.make_problem(rng=rng)
            ref = self.scipy_solve(P, q, A, l, u)
            sol = solve_qp(jnp.asarray(P), jnp.asarray(q), jnp.asarray(A),
                           jnp.asarray(l), jnp.asarray(u), iterations=2000)
            np.testing.assert_allclose(np.asarray(sol.x), ref, atol=1e-4)
            assert bool(sol.converged), seed

    def test_equality_constraints(self):
        n = 5
        P = jnp.asarray(random_spd(n))
        q = jnp.asarray(RNG.normal(size=n))
        A = jnp.asarray(RNG.normal(size=(2, n)))
        b = jnp.asarray(RNG.normal(size=2) * 0.1)
        sol = solve_qp(P, q, A, b, b, iterations=500)
        np.testing.assert_allclose(np.asarray(A @ sol.x), np.asarray(b), atol=1e-6)
        # KKT: Px + q + Aᵀy = 0
        kkt = np.asarray(P @ sol.x + q + A.T @ sol.y)
        np.testing.assert_allclose(kkt, 0, atol=1e-4)

    def test_active_box_clips(self):
        # min ½‖x − c‖² s.t. −1 ≤ x ≤ 1, c outside the box → x* = clip(c)
        n = 4
        c = jnp.array([2.0, -3.0, 0.5, 1.5])
        P = jnp.eye(n)
        sol = solve_qp(P, -c, jnp.eye(n), -jnp.ones(n), jnp.ones(n),
                       iterations=300)
        np.testing.assert_allclose(
            np.asarray(sol.x), np.clip(np.asarray(c), -1, 1), atol=1e-6
        )


class TestBatched:
    def test_vmap_equals_per_lane(self):
        probs = [TestConstrained().make_problem(rng=np.random.default_rng(s))
                 for s in range(8)]
        Ps = jnp.stack([jnp.asarray(p[0]) for p in probs])
        qs = jnp.stack([jnp.asarray(p[1]) for p in probs])
        As = jnp.stack([jnp.asarray(p[2]) for p in probs])
        ls = jnp.stack([jnp.asarray(p[3]) for p in probs])
        us = jnp.stack([jnp.asarray(p[4]) for p in probs])
        batched = jax.jit(
            lambda: solve_qp(Ps, qs, As, ls, us, iterations=500)
        )()
        for k in range(8):
            solo = solve_qp(Ps[k], qs[k], As[k], ls[k], us[k], iterations=500)
            np.testing.assert_allclose(
                np.asarray(batched.x[k]), np.asarray(solo.x), atol=tol(1e-8, 1e-4)
            )
        assert batched.converged.shape == (8,)

    def test_broadcast_without_vmap(self):
        """solve_qp broadcasts natively over leading axes (no vmap)."""
        P, q, A, l, u = TestConstrained().make_problem()
        qs = jnp.stack([jnp.asarray(q), jnp.asarray(q) * 2.0])
        sol = solve_qp(
            jnp.asarray(P), qs, jnp.asarray(A), jnp.asarray(l), jnp.asarray(u),
            iterations=800,
        )
        assert sol.x.shape == (2, 6)
        solo = solve_qp(jnp.asarray(P), jnp.asarray(q) * 2.0, jnp.asarray(A),
                        jnp.asarray(l), jnp.asarray(u), iterations=800)
        np.testing.assert_allclose(np.asarray(sol.x[1]), np.asarray(solo.x), atol=1e-8)


class TestDiagnostics:
    def test_unconverged_flag_on_tight_budget(self):
        P, q, A, l, u = TestConstrained().make_problem()
        sol = solve_qp(jnp.asarray(P), jnp.asarray(q), jnp.asarray(A),
                       jnp.asarray(l), jnp.asarray(u), iterations=3)
        assert not bool(sol.converged)

    def test_warm_start_speeds_convergence(self):
        P, q, A, l, u = TestConstrained().make_problem()
        args = (jnp.asarray(P), jnp.asarray(q), jnp.asarray(A),
                jnp.asarray(l), jnp.asarray(u))
        cold = solve_qp(*args, iterations=2000)
        warm = solve_qp(*args, iterations=30, x0=cold.x, y0=cold.y)
        assert float(warm.primal_residual) < 1e-6
        np.testing.assert_allclose(np.asarray(warm.x), np.asarray(cold.x), atol=1e-5)


class TestDualPolish:
    """ρ-continuation dual polish (round 2): the f32 dual-iterate granularity
    is ∝ the adapted ρ, so a short low-ρ tail must lower the dual residual
    without losing primal feasibility (the dryrun-config failure mode)."""

    def _dryrun_problem(self):
        from __graft_entry__ import _example_problem
        from blf_tpu.mpc.dcm import solve_dcm_mpc

        batch, horizon = 16, 8
        dtype = jnp.float32
        params, dt, _, dcm_ref, zmp_ref, poly_A, poly_b = _example_problem(
            batch, horizon, dtype
        )
        dcm0 = jnp.broadcast_to(jnp.array([0.05, -0.08], dtype), (batch, 2))
        nc = 2 * horizon + horizon * poly_A.shape[-2]
        kwargs = dict(
            warm_start=jnp.zeros((batch, horizon, 2), dtype),
            warm_start_dual=jnp.zeros((batch, nc), dtype),
            s0=jnp.ones((batch, 1), dtype),
            shared=True, iterations=300,
        )
        return lambda **kw: solve_dcm_mpc(
            params, dt, dcm0, dcm0, dcm_ref, zmp_ref, poly_A, poly_b,
            **kwargs, **kw,
        ), batch

    def test_polish_lowers_dual_floor_and_converges(self):
        solve, batch = self._dryrun_problem()
        base = solve()
        polished = solve(polish_iters=50)
        # same f32 pipeline: the polish must beat the unpolished dual floor
        assert (float(polished.qp.dual_residual.max())
                < 0.75 * float(base.qp.dual_residual.max()))
        # ... while keeping every lane primal-feasible and flag-converged
        assert int(polished.qp.converged.sum()) == batch

    def test_polish_is_per_lane_guarded(self):
        """r4: the polish stage is accepted PER LANE only where it improves
        the tolerance-normalized residual score, so it can never degrade a
        lane (the unguarded version pushed unconverged closed-loop lanes off
        their fixed point and the error compounded across warm-started
        ticks). Whatever polish setting, no lane's residuals may exceed the
        unpolished ones beyond noise, and convergence may not drop."""
        solve, batch = self._dryrun_problem()
        base = solve()
        for ps in (0.01, 0.1):
            pol = solve(polish_iters=25, polish_scale=ps)
            assert int(pol.qp.converged.sum()) >= int(base.qp.converged.sum())
            # a lane's rp may trade up WITHIN tolerance when its score
            # improves; what may never happen is a blow-up past tolerance
            # (the unguarded failure pushed rp to ~10)
            assert float(pol.qp.primal_residual.max()) < 1e-4
            assert (float(pol.qp.dual_residual.max())
                    <= 1.05 * float(base.qp.dual_residual.max()) + 1e-7)

    def test_polish_preserves_solution(self):
        solve, _ = self._dryrun_problem()
        base = solve()
        polished = solve(polish_iters=25)
        np.testing.assert_allclose(
            np.asarray(polished.zmp), np.asarray(base.zmp), atol=1e-4
        )


class TestPerLaneFused:
    """solve_qp_lanes — the fused per-lane-operator path (the WBC shape of
    the control stack). Interpret mode on CPU runs the same kernel source
    that is compiled for the GPU."""

    def make_fleet(self, B=5, n=12, m=18, seed=0):
        rng = np.random.default_rng(seed)
        P = rng.normal(size=(B, n, n)) * 0.5
        P = P @ np.swapaxes(P, -1, -2) + np.eye(n)
        q = rng.normal(size=(B, n))
        A = rng.normal(size=(B, m, n))
        xs = rng.normal(size=(B, n))
        Ax = np.einsum("bmn,bn->bm", A, xs)
        l = Ax - np.abs(rng.normal(size=(B, m))) * 0.5
        u = Ax + np.abs(rng.normal(size=(B, m))) * 0.5
        l[:, :4] = u[:, :4] = Ax[:, :4]      # feasible equality rows
        l[:, 5] = -np.inf                    # one-sided row
        return tuple(map(jnp.asarray, (P, q, A, l, u)))

    def test_matches_xla_path(self):
        P, q, A, l, u = self.make_fleet()
        kw = dict(iterations=400, eps_abs=1e-4, eps_rel=1e-4)
        ref = solve_qp(P, q, A, l, u, **kw)
        lane = solve_qp_lanes(P, q, A, l, u, **kw)
        np.testing.assert_allclose(
            np.asarray(lane.x), np.asarray(ref.x), atol=tol(1e-4, 5e-3))
        assert not bool(lane.refined)

    def test_backend_dispatch(self):
        P, q, A, l, u = self.make_fleet(seed=1)
        via_backend = solve_qp(P, q, A, l, u, iterations=120,
                               backend="pallas")
        direct = solve_qp_lanes(P, q, A, l, u, iterations=120)
        np.testing.assert_allclose(np.asarray(via_backend.x),
                                   np.asarray(direct.x), atol=1e-6)
        with pytest.raises(ValueError, match="unknown solve_qp backend"):
            solve_qp(P, q, A, l, u, backend="cuda")

    def test_warm_start_converges_and_polish(self):
        P, q, A, l, u = self.make_fleet(seed=2)
        cold = solve_qp_lanes(P, q, A, l, u, iterations=400,
                              eps_abs=1e-4, eps_rel=1e-4)
        warm = solve_qp_lanes(P, q, A, l, u, iterations=50,
                              x0=cold.x, y0=cold.y, s0=cold.rho_scale,
                              polish_iters=10, eps_abs=1e-4, eps_rel=1e-4)
        assert bool(jnp.all(warm.converged)), (
            np.asarray(warm.primal_residual), np.asarray(warm.dual_residual))

    def test_requires_single_batch_axis(self):
        P, q, A, l, u = self.make_fleet()
        with pytest.raises(ValueError, match="exactly one batch axis"):
            solve_qp_lanes(P[None], q[None], A[None], l[None], u[None],
                           iterations=10)

    def test_equality_and_kkt(self):
        """Per-lane KKT conditions hold in the ORIGINAL scaling."""
        P, q, A, l, u = self.make_fleet(seed=3)
        sol = solve_qp_lanes(P, q, A, l, u, iterations=600,
                             eps_abs=1e-4, eps_rel=1e-4)
        Ax = np.einsum("bmn,bn->bm", np.asarray(A), np.asarray(sol.x))
        np.testing.assert_allclose(Ax[:, :4], np.asarray(u)[:, :4],
                                   atol=5e-3)
        kkt = (np.einsum("bnm,bm->bn", np.asarray(P), np.asarray(sol.x))
               + np.asarray(q)
               + np.einsum("bmn,bm->bn", np.asarray(A), np.asarray(sol.y)))
        assert np.max(np.abs(kkt)) < 5e-3
