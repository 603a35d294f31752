"""Recursive least squares with forgetting factor, as a batched filter.

Accelerator-native re-design of the reference's ``Estimators`` component
(``src/Estimators/src/RecursiveLeastSquare.cpp``; SURVEY.md §2 row 5, §3.2).
The reference is a stateful object advanced once per control tick with a
regressor callback; here the update is a **pure step function**

    ``state' = rls_step(params, state, regressor, measurement)``

suited to ``lax.scan`` (streaming) and ``vmap`` (a fleet of estimators, one
per MPC scenario — the batch-width win called out in SURVEY.md §3.2). The
``m×m`` innovation system is solved with an unrolled small-PSD Cholesky
(:func:`blf_tpu.ops.linalg.solve_psd`) instead of the reference's explicit
``.inverse()`` (``RecursiveLeastSquare.cpp:120-123``) — same math, better
conditioning, and pure elementwise XLA ops so wide scenario batches never
touch per-matrix linalg library calls.

Config parity: :func:`params_from_handler` reads the same four keys the
reference's ``initialize`` does — ``lambda``, ``measurement_covariance``
(diagonal), ``state``, ``state_covariance`` (diagonal)
(``RecursiveLeastSquare.cpp:17-89``, fixture ``src/Estimators/tests/config.ini``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from blf_tpu.ops.linalg import solve_psd

__all__ = ["RLSParams", "RLSState", "init_from_handler", "rls_step", "rls_scan"]


class RLSParams(NamedTuple):
    """Static filter parameters."""

    lam: jnp.ndarray                  # forgetting factor λ ∈ (0, 1]
    measurement_covariance: jnp.ndarray  # (m, m) noise covariance R


class RLSState(NamedTuple):
    """Filter state: parameter estimate θ and its covariance P
    (``RecursiveLeastSquare.h:30-42``)."""

    theta: jnp.ndarray  # (…, p)
    covariance: jnp.ndarray  # (…, p, p)


def init_from_handler(handler) -> Tuple[RLSParams, RLSState]:
    """Build (params, state) from a ParametersHandler with the reference's
    exact key names and diagonal-covariance convention
    (``RecursiveLeastSquare.cpp:36-89``)."""
    lam = jnp.asarray(handler.get_parameter("lambda", float))
    meas_cov = jnp.diag(jnp.asarray(handler.get_array("measurement_covariance")))
    theta = jnp.asarray(handler.get_array("state"))
    cov = jnp.diag(jnp.asarray(handler.get_array("state_covariance")))
    return RLSParams(lam, meas_cov), RLSState(theta, cov)


def rls_step(
    params: RLSParams, state: RLSState, regressor: jnp.ndarray, measurement: jnp.ndarray
) -> RLSState:
    """One RLS/Kalman update (``RecursiveLeastSquare::advance``,
    ``RecursiveLeastSquare.cpp:96-133``):

    ``K = P Aᵀ (λR + A P Aᵀ)⁻¹``; ``θ ← θ + K (y − A θ)``;
    ``P ← (P − K A P)/λ``.

    Shapes: ``regressor`` ``(…, m, p)``, ``measurement`` ``(…, m)``;
    broadcasts over leading batch axes.
    """
    lam, R = params.lam, params.measurement_covariance
    theta, P = state.theta, state.covariance
    hi = jax.lax.Precision.HIGHEST  # TF32/bf16 products break P's PSD-ness
    #   (S goes indefinite → Cholesky NaN); these m×p products are tiny and
    #   latency-bound, so full-f32 passes are free.

    AP = jnp.matmul(regressor, P, precision=hi)                   # (…, m, p)
    S = lam * R + jnp.matmul(
        AP, jnp.swapaxes(regressor, -1, -2), precision=hi)        # (…, m, m)
    # K = P Aᵀ S⁻¹  ⇔  Kᵀ = S⁻¹ A P (S symmetric PSD). solve_psd unrolls the
    # tiny m×m Cholesky into elementwise ops instead of a per-matrix linalg
    # library call on wide scenario batches.
    K = jnp.swapaxes(solve_psd(S, AP), -1, -2)                    # (…, p, m)

    innovation = measurement - jnp.einsum(
        "...mp,...p->...m", regressor, theta, precision=hi)
    theta_next = theta + jnp.einsum(
        "...pm,...m->...p", K, innovation, precision=hi)
    P_next = (P - jnp.matmul(K, AP, precision=hi)) / lam
    # Re-symmetrize: the reference's exact update (doubles, λ=1) tolerates the
    # drift, but λ<1 and/or f32 batches need P to stay symmetric PSD.
    P_next = 0.5 * (P_next + jnp.swapaxes(P_next, -1, -2))
    return RLSState(theta_next, P_next)


def rls_scan(
    params: RLSParams,
    state0: RLSState,
    regressors: jnp.ndarray,
    measurements: jnp.ndarray,
    save_trajectory: bool = False,
):
    """Run the filter over a whole measurement stream with ``lax.scan``
    (the reference's per-tick loop, ``RecursiveLeastSquareTest.cpp:125-141``,
    as one fused program). ``regressors``: ``(T, …, m, p)``;
    ``measurements``: ``(T, …, m)``."""

    def body(carry, inputs):
        A, y = inputs
        nxt = rls_step(params, carry, A, y)
        return nxt, (nxt.theta if save_trajectory else None)

    final, thetas = jax.lax.scan(body, state0, (regressors, measurements))
    if save_trajectory:
        return final, thetas
    return final
