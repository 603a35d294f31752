"""Parallel-in-time RLS: the exponentially-weighted information filter as an
associative scan.

The reference's ``RecursiveLeastSquare::advance`` is an inherently sequential
recursion (``RecursiveLeastSquare.cpp:96-133``; SURVEY.md §5 calls it out as
such). On an accelerator, long identification streams don't have to pay that serial
depth: the filter has an exact **information-form** restatement in which the
whole trajectory of estimates is an exponentially-weighted prefix reduction —
an associative operation — so the T-step recursion collapses to O(log T)
depth via ``jax.lax.associative_scan`` (and to one cross-device
``all_gather`` when the stream is sharded over a mesh axis, mirroring
:func:`blf_tpu.mpc.riccati.solve_lqr_sharded`).

Math. With forgetting factor λ, prior (θ₀, P₀), regressors A_t and
measurements y_t, the sequential RLS estimate after t steps is exactly

    Λ_t = λᵗ P₀⁻¹ + Σ_{s≤t} λ^{t-s} A_sᵀ R⁻¹ A_s        (information matrix)
    b_t = λᵗ P₀⁻¹ θ₀ + Σ_{s≤t} λ^{t-s} A_sᵀ R⁻¹ y_s     (information vector)
    θ_t = Λ_t⁻¹ b_t,   P_t = Λ_t⁻¹

(the standard covariance↔information duality of the Kalman filter; the
reference's gain-form update is the Sherman–Morrison–Woodbury rewrite of this
recursion). The weighted prefix sums compose associatively:

    (Λ_l, b_l, w_l) ⊕ (Λ_r, b_r, w_r) = (w_r Λ_l + Λ_r, w_r b_l + b_r, w_l w_r)

with leaf elements (A_tᵀR⁻¹A_t, A_tᵀR⁻¹y_t, λ). This module exposes:

- :func:`rls_parallel` — full trajectory of (θ_t, P_t) for all t in O(log T)
  depth, numerically equal to :func:`blf_tpu.estimators.rls.rls_scan`;
- :func:`rls_fit` — final state only (one reduction, no trajectory);
- :func:`rls_parallel_sharded` — the stream sharded over a mesh axis via
  ``shard_map``: local associative scans + one ``all_gather`` of per-shard
  aggregates (p×p floats each), the same two-level prefix used by the
  horizon-sharded LQR.

All functions broadcast over leading batch axes of ``regressors`` /
``measurements`` after the time axis, so a fleet of estimators
(``vmap``-free, shape-driven) runs as one fused program.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from blf_tpu.estimators.rls import RLSParams, RLSState
from blf_tpu.ops.linalg import solve_psd

__all__ = ["rls_leaf_elements", "rls_combine", "rls_parallel", "rls_fit",
           "rls_parallel_sharded"]

# Full-f32 products: the p×p/m×p products are tiny and latency-bound, and
# reduced (TF32/bf16) precision visibly degrades the information aggregates.
_HI = jax.lax.Precision.HIGHEST


def rls_leaf_elements(
    params: RLSParams, regressors: jnp.ndarray, measurements: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-step information increments ``(AᵀR⁻¹A, AᵀR⁻¹y, λ)``.

    ``regressors``: ``(T, …, m, p)``; ``measurements``: ``(T, …, m)``.
    R⁻¹ is applied through a PSD solve so only the m×m covariance (not its
    inverse) is ever supplied, matching the reference's config keys.
    """
    R = params.measurement_covariance
    # R⁻¹ A : solve the tiny m×m system once per step (batched elementwise).
    RinvA = solve_psd(jnp.broadcast_to(R, regressors.shape[:-2] + R.shape),
                      regressors)                       # (T, …, m, p)
    At = jnp.swapaxes(regressors, -1, -2)               # (T, …, p, m)
    Lam = jnp.matmul(At, RinvA, precision=_HI)          # (T, …, p, p)
    b = jnp.einsum("...pm,...m->...p", jnp.swapaxes(RinvA, -1, -2),
                   measurements, precision=_HI)         # (T, …, p)
    w = jnp.broadcast_to(params.lam, Lam.shape[:-2])    # (T, …)
    return Lam, b, w


def rls_combine(left, right):
    """Associative combine of weighted information aggregates."""
    Lam_l, b_l, w_l = left
    Lam_r, b_r, w_r = right
    return (w_r[..., None, None] * Lam_l + Lam_r,
            w_r[..., None] * b_l + b_r,
            w_l * w_r)


def _states_from_aggregates(state0: RLSState, Lam, b, w) -> RLSState:
    """Fold the prior through the aggregates and invert to covariance form."""
    P0, theta0 = state0.covariance, state0.theta
    prior_info = solve_psd(
        P0, jnp.broadcast_to(jnp.eye(P0.shape[-1], dtype=P0.dtype), P0.shape))
    Lam_t = w[..., None, None] * prior_info + Lam
    b_t = w[..., None] * jnp.einsum(
        "...ij,...j->...i", prior_info, theta0, precision=_HI) + b
    eye = jnp.broadcast_to(jnp.eye(Lam_t.shape[-1], dtype=Lam_t.dtype),
                           Lam_t.shape)
    P_t = solve_psd(Lam_t, eye)
    P_t = 0.5 * (P_t + jnp.swapaxes(P_t, -1, -2))
    theta_t = jnp.einsum("...ij,...j->...i", P_t, b_t, precision=_HI)
    return RLSState(theta_t, P_t)


def rls_parallel(
    params: RLSParams,
    state0: RLSState,
    regressors: jnp.ndarray,
    measurements: jnp.ndarray,
) -> Tuple[RLSState, jnp.ndarray]:
    """All T posterior states in O(log T) depth.

    Returns ``(final_state, thetas)`` with ``thetas[t] == rls_scan``'s
    trajectory entry t (numerically identical filters;
    ``tests/test_rls_parallel.py`` asserts ≤1e-7 in the f64 lane and ≤2e-4
    in the f32 lane — both lanes run in CI).
    """
    leaves = rls_leaf_elements(params, regressors, measurements)
    Lam, b, w = jax.lax.associative_scan(rls_combine, leaves)
    states = _states_from_aggregates(state0, Lam, b, w)
    final = jax.tree_util.tree_map(lambda x: x[-1], states)
    return final, states.theta


def rls_fit(
    params: RLSParams,
    state0: RLSState,
    regressors: jnp.ndarray,
    measurements: jnp.ndarray,
) -> RLSState:
    """Final posterior only: one weighted information *reduction* (no
    trajectory materialized) — the cheapest way to batch-identify parameters
    from a recorded stream."""
    Lam, b, w = rls_leaf_elements(params, regressors, measurements)

    def red(acc, leaf):
        return rls_combine(acc, leaf), None

    p = regressors.shape[-1]
    batch = Lam.shape[1:-2]
    acc0 = (jnp.zeros(batch + (p, p), Lam.dtype),
            jnp.zeros(batch + (p,), b.dtype),
            jnp.ones(batch, w.dtype))
    (Lam_T, b_T, w_T), _ = jax.lax.scan(red, acc0, (Lam, b, w))
    # scan keeps it O(T) work / O(T) depth but fused; for long T prefer
    # rls_parallel's associative_scan (log depth, identical result).
    return _states_from_aggregates(state0, Lam_T, b_T, w_T)


def rls_parallel_sharded(
    params: RLSParams,
    state0: RLSState,
    regressors: jnp.ndarray,   # (T, …): T divisible by the axis size
    measurements: jnp.ndarray,
    mesh,
    axis_name: str,
) -> Tuple[RLSState, jnp.ndarray]:
    """Stream-sharded parallel RLS over a mesh axis.

    Two-level exclusive prefix: each device scans its local block with
    ``associative_scan``, then one ``all_gather`` of the per-device aggregate
    (p² + p + 1 floats) lets every device fold the exclusive prefix of all
    earlier blocks into its local results. Communication volume is
    independent of the local block length — the same structure as
    :func:`blf_tpu.mpc.riccati.solve_lqr_sharded`.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    T = regressors.shape[0]
    n_shards = mesh.shape[axis_name]
    if T % n_shards:
        raise ValueError(f"stream length {T} not divisible by {n_shards}")

    def local(regs, ys):
        leaves = rls_leaf_elements(params, regs, ys)
        Lam, b, w = jax.lax.associative_scan(rls_combine, leaves)
        agg = jax.tree_util.tree_map(lambda x: x[-1], (Lam, b, w))
        # every device sees every block aggregate (tiny), computes the
        # exclusive prefix of the blocks before it, folds it in.
        gathered = jax.lax.all_gather(agg, axis_name)        # (P, …)
        idx = jax.lax.axis_index(axis_name)

        def fold(acc, blk):
            return rls_combine(acc, blk), None

        p = regs.shape[-1]
        batch = Lam.shape[1:-2]
        ident = jax.tree_util.tree_map(
            lambda x: jax.lax.pcast(x, (axis_name,), to="varying"),
            (jnp.zeros(batch + (p, p), Lam.dtype),
             jnp.zeros(batch + (p,), b.dtype),
             jnp.ones(batch, w.dtype)))
        mask = (jnp.arange(n_shards) < idx)

        def masked_fold(acc, inp):
            blk, use = inp
            out = rls_combine(acc, blk)
            out = jax.tree_util.tree_map(
                lambda new, old: jnp.where(use, new, old), out, acc)
            return out, None

        prefix, _ = jax.lax.scan(masked_fold, ident, (gathered, mask))
        Lam_g, b_g, w_g = rls_combine(
            prefix, (Lam, b, w))  # broadcast prefix over local time axis
        return Lam_g, b_g, w_g

    spec = P(axis_name)
    Lam, b, w = shard_map(
        local, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec, spec)
    )(regressors, measurements)
    states = _states_from_aggregates(state0, Lam, b, w)
    final = jax.tree_util.tree_map(lambda x: x[-1], states)
    return final, states.theta
