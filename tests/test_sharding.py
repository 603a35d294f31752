"""Mesh/shard_map tests on the 8-virtual-device CPU backend (SURVEY.md §4:
the multi-device coverage the reference never had)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import tol

from blf_tpu.models.lipm import LIPMParams, dcm_backward_recursion
from blf_tpu.mpc.dcm import solve_dcm_mpc
from blf_tpu.parallel.mesh import make_mesh, shard_batch, replicate
from blf_tpu.parallel.sweep import init_fleet, make_fleet_step

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

PARAMS = LIPMParams(jnp.asarray(0.9), jnp.asarray(9.81))
DT = 0.1
N = 16


def problem_refs(dtype=jnp.float64):
    steps = np.array([[0.0, -0.1], [0.2, 0.1], [0.4, -0.1], [0.6, 0.1]])
    zmp_ref = jnp.asarray(np.repeat(steps, 4, axis=0), dtype)
    dcm_ref = dcm_backward_recursion(PARAMS, zmp_ref, jnp.asarray(steps[-1], dtype), DT)
    poly_A = jnp.tile(
        jnp.asarray([[1.0, 0], [-1.0, 0], [0, 1.0], [0, -1.0]], dtype), (N, 1, 1)
    )
    poly_b = jnp.stack(
        [zmp_ref[:, 0] + 0.07, -(zmp_ref[:, 0] - 0.07),
         zmp_ref[:, 1] + 0.04, -(zmp_ref[:, 1] - 0.04)], -1,
    )
    return dcm_ref, zmp_ref, poly_A, poly_b


class TestMesh:
    def test_mesh_shapes(self):
        mesh = make_mesh(8, model_axis=2)
        assert mesh.devices.shape == (4, 2)
        assert mesh.axis_names == ("data", "model")
        with pytest.raises(ValueError):
            make_mesh(8, model_axis=3)
        with pytest.raises(ValueError):
            make_mesh(1024)

    def test_shard_batch_placement(self):
        mesh = make_mesh(8, model_axis=1)
        x = shard_batch(jnp.arange(64.0).reshape(16, 4), mesh)
        assert len(x.sharding.device_set) == 8
        r = replicate(jnp.ones(3), mesh)
        assert r.sharding.is_fully_replicated


class TestShardedFleet:
    def _run(self, model_axis):
        mesh = make_mesh(8, model_axis=model_axis)
        dcm_ref, zmp_ref, poly_A, poly_b = problem_refs()
        B, K = 32, model_axis
        num_constraints = 2 * N + N * 4
        dcm0 = jnp.array([0.05, -0.08])
        state = init_fleet(B, N, num_constraints, dcm0, dcm0, dtype=zmp_ref.dtype)
        state = shard_batch(state, mesh)
        rng = np.random.default_rng(0)
        disturbance = jnp.asarray(rng.normal(0, 0.01, (B, K, 2)), zmp_ref.dtype)
        step = make_fleet_step(mesh, PARAMS, DT, iterations=150)
        new_state, result = step(state, disturbance, dcm_ref, zmp_ref,
                                 poly_A, poly_b)
        return state, new_state, result

    def test_pure_data_parallel_tick(self):
        state, new_state, result = self._run(model_axis=1)
        assert float(result.stats.num_scenarios) == 32
        assert float(result.stats.num_converged) >= 0
        assert float(result.worst_margin) <= 1e-3
        assert new_state.dcm.shape == state.dcm.shape
        assert not np.allclose(np.asarray(new_state.dcm), np.asarray(state.dcm))

    def test_ensemble_axis_tick(self):
        _, new_state, result = self._run(model_axis=2)
        assert float(result.stats.num_scenarios) == 32  # not double-counted
        assert np.all(np.isfinite(np.asarray(new_state.warm_zmp)))

    def test_matches_unsharded_reference(self):
        """The sharded DP tick must reproduce a plain vmap solve bit-for-bit
        modulo reduction order (same plans, same advance)."""
        mesh = make_mesh(8, model_axis=1)
        dcm_ref, zmp_ref, poly_A, poly_b = problem_refs()
        B = 16
        num_constraints = 2 * N + N * 4
        dcm0 = jnp.array([0.05, -0.08])
        state = init_fleet(B, N, num_constraints, dcm0, dcm0, dtype=zmp_ref.dtype)
        disturbance = jnp.zeros((B, 1, 2), zmp_ref.dtype)

        step = make_fleet_step(mesh, PARAMS, DT, iterations=150)
        _, result = step(shard_batch(state, mesh), disturbance, dcm_ref,
                         zmp_ref, poly_A, poly_b)

        plans = solve_dcm_mpc(
            PARAMS, DT, state.dcm, state.com, dcm_ref, zmp_ref, poly_A,
            poly_b, iterations=150, warm_start=state.warm_zmp,
            warm_start_dual=state.warm_y, shared=True,
        )
        np.testing.assert_allclose(
            np.asarray(result.consensus_zmp0), np.asarray(plans.zmp[:, 0, :]),
            atol=tol(1e-10, 2e-6),
        )
        # and the general per-lane solver agrees to solver tolerance
        general = jax.vmap(
            lambda d0, c0, wz, wy: solve_dcm_mpc(
                PARAMS, DT, d0, c0, dcm_ref, zmp_ref, poly_A, poly_b,
                iterations=400, warm_start=wz, warm_start_dual=wy,
            )
        )(state.dcm, state.com, state.warm_zmp, state.warm_y)
        np.testing.assert_allclose(
            np.asarray(result.consensus_zmp0), np.asarray(general.zmp[:, 0, :]),
            atol=1e-3,
        )

    def test_multi_tick_balance_stability(self):
        """10 push-recovery ticks on a *stationary* balance task (the
        time-invariant receding horizon): warm starts + estimator must keep
        the fleet converged and the DCM bounded near the stance point."""
        mesh = make_mesh(8, model_axis=2)
        dtype = jnp.float64
        stance = jnp.asarray([0.0, 0.0], dtype)
        zmp_ref = jnp.broadcast_to(stance, (N, 2))
        dcm_ref = jnp.broadcast_to(stance, (N + 1, 2))
        poly_A = jnp.tile(
            jnp.asarray([[1.0, 0], [-1.0, 0], [0, 1.0], [0, -1.0]], dtype),
            (N, 1, 1),
        )
        poly_b = jnp.broadcast_to(
            jnp.asarray([0.1, 0.1, 0.06, 0.06], dtype), (N, 4)
        )
        B, K = 16, 2
        num_constraints = 2 * N + N * 4
        state = init_fleet(B, N, num_constraints, stance, stance, dtype=dtype)
        state = shard_batch(state, mesh)
        step = make_fleet_step(mesh, PARAMS, DT, iterations=200)
        rng = np.random.default_rng(1)
        for tick in range(10):
            dist = jnp.asarray(rng.normal(0, 0.004, (B, K, 2)), dtype)
            state, result = step(state, dist, dcm_ref, zmp_ref, poly_A, poly_b)
        assert np.all(np.isfinite(np.asarray(state.dcm)))
        assert np.all(np.isfinite(np.asarray(state.offset_theta)))
        # pushes get rejected: DCM stays well inside the support region
        assert np.abs(np.asarray(state.dcm)).max() < 0.1
        assert float(result.worst_margin) <= 1e-3
        assert float(result.stats.num_converged) >= 12


class TestStatusAndQuarantine:
    """Failure detection wired into the production tick (SURVEY.md §5:
    status 'carried in the batch', NaN quarantine per lane)."""

    def _setup(self, B=16):
        mesh = make_mesh(8, model_axis=1)
        dcm_ref, zmp_ref, poly_A, poly_b = problem_refs()
        num_constraints = 2 * N + N * 4
        dcm0 = jnp.array([0.05, -0.08])
        state = init_fleet(B, N, num_constraints, dcm0, dcm0,
                           dtype=zmp_ref.dtype)
        dist = jnp.zeros((B, 1, 2), zmp_ref.dtype)
        step = make_fleet_step(mesh, PARAMS, DT, iterations=150)
        return mesh, state, dist, (dcm_ref, zmp_ref, poly_A, poly_b), step

    def test_healthy_fleet_reports_converged_status(self):
        from blf_tpu.utils.status import SolverStatus, status_counts

        mesh, state, dist, refs, step = self._setup()
        _, result = step(shard_batch(state, mesh), dist, *refs)
        status = np.asarray(result.status)
        assert status.shape == (16,)
        counts = status_counts(result.status)
        assert counts["numerical_error"] == 0
        assert counts["converged"] == int(result.stats.num_converged)
        assert float(result.num_quarantined) == 0.0

    def test_nan_lane_is_quarantined_not_propagated(self):
        """Poison one lane's state with NaN: its solve goes non-finite, the
        tick flags NUMERICAL_ERROR for that lane only, and the new state is
        reset (finite) for it — warm starts cleared — while every other
        lane advances normally."""
        from blf_tpu.utils.status import SolverStatus

        mesh, state, dist, refs, step = self._setup()
        poisoned = state._replace(
            dcm=state.dcm.at[3].set(jnp.nan),
        )
        new_state, result = step(shard_batch(poisoned, mesh), dist, *refs)
        status = np.asarray(result.status)
        assert status[3] == int(SolverStatus.NUMERICAL_ERROR)
        assert np.all(status[np.arange(16) != 3]
                      != int(SolverStatus.NUMERICAL_ERROR))
        assert float(result.num_quarantined) == 1.0
        # quarantined lane: finite state, cleared warm start, fresh prior
        assert not np.all(np.isfinite(np.asarray(poisoned.dcm)))
        np.testing.assert_array_equal(
            np.asarray(new_state.warm_zmp[3]), 0.0)
        np.testing.assert_array_equal(np.asarray(new_state.warm_s[3]), 1.0)
        # the reset is sanitized, so even though the pre-tick dcm was the
        # poison itself the quarantined lane comes back fully finite
        assert all(
            np.all(np.isfinite(np.asarray(leaf)))
            for leaf in new_state
        )


class TestRowShardedQP:
    """Intra-solve tensor/model parallelism (SURVEY.md §2.3 TP row): one
    shared-factor ADMM solve's constraint rows split across the mesh."""

    def _problem(self, B=8):
        dcm_ref, zmp_ref, poly_A, poly_b = problem_refs()
        from blf_tpu.mpc.dcm import build_dcm_qp
        rng = np.random.default_rng(0)
        dcm0s = jnp.asarray(rng.normal(0.05, 0.02, (B, 2)))
        P, q, A, l, u = build_dcm_qp(PARAMS, DT, dcm0s, dcm_ref, zmp_ref,
                                     poly_A, poly_b)
        is_eq = jnp.arange(A.shape[-2]) < 2 * N
        from blf_tpu.mpc.qp import factor_shared_qp
        return factor_shared_qp(P, A, is_eq), q, l, u

    @pytest.mark.parametrize("shards", [2, 4, 8])
    def test_matches_unsharded(self, shards):
        from jax.sharding import Mesh, PartitionSpec as P_
        from jax import shard_map

        from blf_tpu.mpc.qp import (
            shard_factors_rows,
            solve_qp_factored,
            solve_qp_factored_rowsharded,
        )

        f, q, l, u = self._problem()
        m = f.A_s.shape[-2]
        ref = solve_qp_factored(f, q, l, u, iterations=150, refine=False)

        mesh = Mesh(np.array(jax.devices()[:shards]).reshape(shards),
                    ("model",))

        def solve(lT, uT):
            idx = jax.lax.axis_index("model")
            f_loc = shard_factors_rows(f, idx, shards)
            return solve_qp_factored_rowsharded(
                f_loc, q, lT, uT, axis_name="model", iterations=150)

        sol = shard_map(
            solve, mesh=mesh,
            in_specs=(P_(None, "model"), P_(None, "model")),
            out_specs=type(ref)(
                x=P_(), y=P_(None, "model"), z=P_(None, "model"),
                primal_residual=P_(), dual_residual=P_(), converged=P_(),
                objective=P_(), rho_scale=P_(), refined=P_(),
            ),
            check_vma=False,
        )(l, u)

        assert sol.y.shape == (8, m)
        # both solvers run the SAME iteration: in f64 the 150-iteration
        # iterates match to collective-reduction rounding even before full
        # convergence; in f32 rounding makes the paths diverge on the slow
        # lanes, so the bound is the coarser one both converge within
        np.testing.assert_allclose(np.asarray(sol.x), np.asarray(ref.x),
                                   atol=tol(2e-5, 8e-3))
        # duals on still-unconverged stiff equality rows are path-sensitive;
        # they only identify a comparable point once the iterates coincide,
        # which f32 rounding breaks on cold lanes — f64-lane check only
        from conftest import F32_LANE
        if not F32_LANE:
            np.testing.assert_allclose(np.asarray(sol.y), np.asarray(ref.y),
                                       atol=1e-3)
        assert int(sol.converged.sum()) >= int(ref.converged.sum()) - 1
