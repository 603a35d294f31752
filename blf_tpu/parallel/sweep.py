"""Sharded MPC fleet step — the framework's "training step" equivalent.

One control tick for a fleet of push-recovery scenarios (BASELINE config 5),
expressed as a single ``shard_map`` program over a ``(data, model)`` mesh:

- ``data`` axis: scenario data-parallelism — each device group owns a slice
  of the fleet; lanes never migrate, so the only cross-device traffic is the
  collective reduction of solver statistics.
- ``model`` axis: **disturbance-ensemble parallelism** — each model-lane
  solves its scenario slice under a different push realization; ensemble
  consensus (``pmean`` of plans) and worst-case constraint margins
  (``pmax``) are reduced across the axis. With ``model = 1`` this degenerates
  to pure DP.

The tick = warm-started batched DCM-MPC solve → fleet-stat reduction →
state advance under the consensus plan + disturbance → per-lane RLS update
of a ZMP-offset disturbance estimate (the Estimators stack riding along with
the controller, SURVEY.md §3.2's pairing).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from blf_tpu.estimators.rls import RLSParams, RLSState, rls_step
from blf_tpu.models.lipm import LIPMParams, com_discrete_step, lipm_omega
from blf_tpu.mpc.dcm import DCMWeights, solve_dcm_mpc
from blf_tpu.ops.precision import f32_matmuls
from blf_tpu.parallel.collectives import FleetStats, reduce_fleet_stats
from blf_tpu.utils.status import SolverStatus, classify_qp, nan_quarantine

__all__ = ["FleetState", "TickResult", "make_fleet_step", "init_fleet"]


class FleetState(NamedTuple):
    """Per-scenario persistent state, leading axis = fleet batch."""

    dcm: jnp.ndarray        # (B, 2)
    com: jnp.ndarray        # (B, 2)
    warm_zmp: jnp.ndarray   # (B, N, 2) previous plan (primal warm start)
    warm_y: jnp.ndarray     # (B, M) previous duals
    offset_theta: jnp.ndarray  # (B, 2) RLS estimate of the ZMP disturbance offset
    offset_cov: jnp.ndarray    # (B, 2, 2)
    warm_s: jnp.ndarray        # (B, 1) adapted per-lane ADMM ρ multiplier


class TickResult(NamedTuple):
    stats: FleetStats
    worst_margin: jnp.ndarray   # scalar: worst ensemble constraint margin
    consensus_zmp0: jnp.ndarray  # (B, 2) first-knot consensus plan
    status: jnp.ndarray          # (B,) int32 per-lane SolverStatus
    num_quarantined: jnp.ndarray  # scalar: NUMERICAL_ERROR lanes this tick


def init_fleet(batch: int, horizon: int, num_constraints: int, dcm0, com0,
               dtype=jnp.float32) -> FleetState:
    """Fleet state with zeroed warm starts and a fresh offset estimator."""
    dcm0 = jnp.broadcast_to(jnp.asarray(dcm0, dtype), (batch, 2))
    com0 = jnp.broadcast_to(jnp.asarray(com0, dtype), (batch, 2))
    return FleetState(
        dcm=dcm0,
        com=com0,
        warm_zmp=jnp.zeros((batch, horizon, 2), dtype),
        warm_y=jnp.zeros((batch, num_constraints), dtype),
        offset_theta=jnp.zeros((batch, 2), dtype),
        offset_cov=jnp.broadcast_to(jnp.eye(2, dtype=dtype), (batch, 2, 2)) * 10.0,
        warm_s=jnp.ones((batch, 1), dtype),
    )


def make_fleet_step(
    mesh: Mesh,
    params: LIPMParams,
    dt: float,
    weights: Optional[DCMWeights] = None,
    iterations: int = 200,
    rls_lambda: float = 0.98,
    meas_noise: float = 1e-4,
    **qp_kwargs,
):
    """Build the jitted sharded tick function.

    Returns ``step(state, disturbance, dcm_ref, zmp_ref, poly_A, poly_b)
    -> (FleetState, TickResult)`` where ``disturbance`` is ``(B, K, 2)`` with
    ``K`` = mesh model-axis size (one push realization per ensemble lane).
    Extra ``qp_kwargs`` (e.g. ``refine``, ``check_every``) pass through to
    :func:`blf_tpu.mpc.qp.solve_qp_factored`.
    """
    data_axis, model_axis = mesh.axis_names

    rls_params = RLSParams(
        lam=jnp.asarray(rls_lambda),
        measurement_covariance=meas_noise * jnp.eye(2),
    )

    @f32_matmuls
    def tick(state: FleetState, disturbance, dcm_ref, zmp_ref, poly_A, poly_b):
        # local shapes: state (B', …); disturbance (B', 1, 2) — this lane's draw
        dist = disturbance[:, 0, :]
        # the carry's dtype is authoritative: cast every closed-over
        # parameter before mixing, or x64-mode params silently promote the
        # f32 fleet state to f64 across the tick (caught by the Advanceable
        # carry-stability contract test)
        dtype = state.dcm.dtype
        omega_dt = (jnp.asarray(lipm_omega(params), dtype)
                    * jnp.asarray(dt, dtype))
        a = jnp.exp(omega_dt)

        # ensemble-perturbed initial DCM: each model-lane solves its own draw
        dcm0 = state.dcm + dist + state.offset_theta

        # fleet fast path: shared (P, A), batch rides on dcm0/warm starts —
        # one KKT factorization, GEMM-shaped ADMM iterations (solve_qp_shared)
        plans = solve_dcm_mpc(
            params, dt, dcm0, state.com, dcm_ref, zmp_ref, poly_A, poly_b,
            weights, iterations=iterations,
            warm_start=state.warm_zmp, warm_start_dual=state.warm_y,
            s0=state.warm_s, shared=True, **qp_kwargs,
        )

        # collective QP reduce over the whole fleet: sum/max over the data
        # axis, then combine the ensemble copies (mean counts, worst residuals)
        stats = reduce_fleet_stats(plans.qp, data_axis)
        stats = FleetStats(
            num_scenarios=jax.lax.pmean(stats.num_scenarios, model_axis),
            num_converged=jax.lax.pmean(stats.num_converged, model_axis),
            max_primal_residual=jax.lax.pmax(stats.max_primal_residual, model_axis),
            max_dual_residual=jax.lax.pmax(stats.max_dual_residual, model_axis),
            mean_objective=jax.lax.pmean(stats.mean_objective, model_axis),
        )

        # worst-case constraint margin across the disturbance ensemble
        margins = jnp.einsum("kfa,...ka->...kf", poly_A, plans.zmp) - poly_b
        worst = jax.lax.pmax(
            jax.lax.pmax(jnp.max(margins), model_axis), data_axis
        )

        # consensus plan: certainty-equivalent average over the ensemble
        zmp_consensus = jax.lax.pmean(plans.zmp, model_axis)
        y_consensus = jax.lax.pmean(plans.qp.y, model_axis)
        s_consensus = jax.lax.pmean(plans.qp.rho_scale, model_axis)

        # advance the TRUE scenario state one knot under the consensus plan
        # and the fleet's actual push realization
        z0 = zmp_consensus[:, 0, :]
        true_dist = jax.lax.pmean(dist, model_axis)  # shared push realization
        dcm_next = a * state.dcm + (1 - a) * z0 + true_dist
        com_next = com_discrete_step(params, state.com, state.dcm, z0, dt)

        # RLS: identify the UNMODELED additive DCM disturbance — the observed
        # transition residual minus the push the ensemble already anticipated
        # (otherwise the planner would double-compensate a modeled push).
        regressor = jnp.broadcast_to(
            jnp.eye(2, dtype=z0.dtype), (z0.shape[0], 2, 2)
        )
        measurement = dcm_next - (a * state.dcm + (1 - a) * z0) - true_dist
        rls_p = RLSParams(
            lam=jnp.asarray(rls_params.lam, dtype),
            measurement_covariance=jnp.asarray(
                rls_params.measurement_covariance, dtype),
        )
        est = jax.vmap(lambda th, cv, A_, y_: rls_step(
            rls_p, RLSState(th, cv), A_, y_
        ))(state.offset_theta, state.offset_cov, regressor, measurement)

        new_state = FleetState(
            dcm=dcm_next,
            com=com_next,
            warm_zmp=zmp_consensus,
            warm_y=y_consensus,
            offset_theta=est.theta,
            offset_cov=est.covariance,
            warm_s=s_consensus,
        )

        # failure detection as data (SURVEY.md §5): per-lane status codes
        # carried in the batch, and NaN quarantine — a lane whose solve went
        # non-finite restarts from its last-good (pre-tick) scenario state
        # with cleared warm starts and a fresh estimator prior, instead of
        # poisoning every subsequent warm-started tick.
        # worst status across the disturbance ensemble (severity-ordered
        # enum, so pmax = "any member failed ⇒ the scenario failed"), making
        # the status model-invariant like the consensus state it guards
        status = jax.lax.pmax(classify_qp(plans.qp), model_axis)
        dtype = state.dcm.dtype
        reset = FleetState(
            dcm=state.dcm,
            com=state.com,
            warm_zmp=jnp.zeros_like(state.warm_zmp),
            warm_y=jnp.zeros_like(state.warm_y),
            offset_theta=jnp.zeros_like(state.offset_theta),
            offset_cov=jnp.broadcast_to(
                10.0 * jnp.eye(2, dtype=dtype), state.offset_cov.shape
            ),
            warm_s=jnp.ones_like(state.warm_s),
        )
        new_state = nan_quarantine(new_state, status, reset)
        bad = (status == SolverStatus.NUMERICAL_ERROR)
        num_bad = jax.lax.psum(jnp.sum(bad.astype(jnp.float32)), data_axis)
        return new_state, TickResult(stats, worst, z0, status, num_bad)

    state_spec = FleetState(
        dcm=P(data_axis), com=P(data_axis), warm_zmp=P(data_axis),
        warm_y=P(data_axis), offset_theta=P(data_axis), offset_cov=P(data_axis),
        warm_s=P(data_axis),
    )
    result_spec = TickResult(
        stats=FleetStats(P(), P(), P(), P(), P()),
        worst_margin=P(),
        consensus_zmp0=P(data_axis),
        status=P(data_axis),
        num_quarantined=P(),
    )
    sharded = shard_map(
        tick,
        mesh=mesh,
        in_specs=(state_spec, P(data_axis, model_axis), P(), P(), P(), P()),
        out_specs=(state_spec, result_spec),
    )
    stepped = jax.jit(sharded)
    # expose the un-jitted sharded tick so callers can lax.scan many ticks
    # inside ONE jit (single dispatch — the production/bench loop shape)
    stepped.sharded_fn = sharded
    return stepped
