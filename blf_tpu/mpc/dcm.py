"""DCM-based walking MPC: condensed transcription + batched solve.

The end-to-end slice of the BASELINE.json north star ("the reference's
TimeVaryingDCMPlanner transcription becomes a batched SQP/QP solver in JAX"):
plan the ZMP over a horizon so the Divergent Component of Motion tracks a
footstep-derived reference while the ZMP stays inside the support polygon
(half-spaces from :mod:`blf_tpu.planners.convex_hull`, the reference's
``ConvexHullHelper`` role).

Transcription (sparse / non-condensed): decision vector

    x = [ξ₁ˣ…ξ_Nˣ, ξ₁ʸ…ξ_Nʸ, z₀ˣ…z_{N−1}ˣ, z₀ʸ…z_{N−1}ʸ]

with the exact-ZOH dynamics ``ξ_{k+1} = a ξ_k + (1 − a) z_k`` (a = e^{ω dt})
imposed as *equality rows* of the QP rather than eliminated. Condensing an
**unstable** flow (a > 1) stuffs powers aᴺ into the Hessian and wrecks its
conditioning (ADMM crawls); the sparse form keeps the Hessian diagonal and
the constraint matrix O(1), which is exactly the regime the fixed-iteration
batched ADMM of :mod:`blf_tpu.mpc.qp` is fast in. All matrices are built
with ``jnp`` ops from array inputs, so the whole build+solve jits, vmaps
over scenarios, and shards over a mesh.

x/y decouple in the LIPM, so blocks are built per-axis on the scalar knot
grid (arrays carry a trailing ``(2,)`` until stacking).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from blf_tpu.models.lipm import LIPMParams, com_trajectory_from_dcm, lipm_omega
from blf_tpu.ops.precision import f32_matmuls
from blf_tpu.mpc.qp import (QPSolution, factor_shared_qp, solve_qp,
                            solve_qp_factored, solve_qp_shared)

__all__ = ["DCMWeights", "DCMPlan", "build_dcm_qp", "solve_dcm_mpc"]


class DCMWeights(NamedTuple):
    """Cost weights (all scalars)."""

    dcm_tracking: jnp.ndarray       # Q: per-knot ‖ξ_k − ξ_ref‖²
    dcm_terminal: jnp.ndarray       # Q_N: terminal DCM
    zmp_tracking: jnp.ndarray       # R: ‖z_k − z_ref‖²
    zmp_rate: jnp.ndarray           # R_Δ: ‖z_{k+1} − z_k‖²

    @classmethod
    def default(cls):
        return cls(
            dcm_tracking=jnp.asarray(10.0),
            dcm_terminal=jnp.asarray(100.0),
            zmp_tracking=jnp.asarray(0.1),
            zmp_rate=jnp.asarray(1.0),
        )


class DCMPlan(NamedTuple):
    """Solved plan + per-lane diagnostics."""

    zmp: jnp.ndarray        # (…, N, 2)
    dcm: jnp.ndarray        # (…, N+1, 2) — ξ₀ prepended
    com: jnp.ndarray        # (…, N+1, 2)
    qp: QPSolution


def _difference_matrix(N: int, dtype):
    """(N−1, N) forward-difference operator."""
    eye = jnp.eye(N, dtype=dtype)
    return eye[1:] - eye[:-1]


@f32_matmuls
def build_dcm_qp(
    params: LIPMParams,
    dt,
    dcm0: jnp.ndarray,        # (…, 2)
    dcm_ref: jnp.ndarray,     # (…, N+1, 2) reference (index 0 unused)
    zmp_ref: jnp.ndarray,     # (…, N, 2)
    poly_A: jnp.ndarray,      # (…, N, F, 2) per-knot support half-spaces
    poly_b: jnp.ndarray,      # (…, N, F)
    weights: Optional[DCMWeights] = None,
):
    """Assemble (P, q, A, l, u) for the sparse DCM QP (see module docstring).

    Variable layout (size 4N): ``[ξˣ(N), ξʸ(N), zˣ(N), zʸ(N)]``.
    Constraint rows (size 2N + N·F): dynamics equalities then polygon rows.
    """
    if weights is None:
        weights = DCMWeights.default()
    N = zmp_ref.shape[-2]
    F = poly_A.shape[-2]
    dtype = zmp_ref.dtype
    a = jnp.exp(lipm_omega(params) * jnp.asarray(dt, dtype))

    qw = weights.dcm_tracking
    qn = weights.dcm_terminal - weights.dcm_tracking     # extra terminal weight
    rz = weights.zmp_tracking
    rd = weights.zmp_rate

    # Hessian: diag(Q) on ξ blocks; (R + Dᵀ R_Δ D) on z blocks.
    Qdiag = qw * jnp.ones((N,), dtype=dtype)
    Qdiag = Qdiag.at[-1].add(qn)
    D = _difference_matrix(N, dtype)
    Hz = rz * jnp.eye(N, dtype=dtype) + rd * (D.T @ D)
    P = jax.scipy.linalg.block_diag(jnp.diag(Qdiag), jnp.diag(Qdiag), Hz, Hz)

    # Linear term: −Q ξ_ref on ξ, −R z_ref on z.
    q_xi = -Qdiag[:, None] * dcm_ref[..., 1:, :]          # (…, N, 2)
    q_z = -rz * zmp_ref                                   # (…, N, 2)
    qvec = jnp.concatenate(
        [q_xi[..., 0], q_xi[..., 1], q_z[..., 0], q_z[..., 1]], axis=-1
    )
    # P stays unbatched (batch rides on q/l/u); both solver paths handle it.

    # Dynamics equalities, per axis: ξ_{k} − a ξ_{k−1} − (1−a) z_{k−1} = r_k
    # (ξ₀ fixed: row 0 rhs = a ξ₀; later rows rhs = 0).
    eyeN = jnp.eye(N, dtype=dtype)
    sub = jnp.diag(jnp.ones((N - 1,), dtype=dtype), k=-1)
    Adyn_xi = eyeN - a * sub                              # (N, N) on ξ block
    Adyn_z = -(1 - a) * eyeN                              # (N, N) on z block
    zero = jnp.zeros((N, N), dtype=dtype)
    Adyn_x = jnp.concatenate([Adyn_xi, zero, Adyn_z, zero], axis=-1)
    Adyn_y = jnp.concatenate([zero, Adyn_xi, zero, Adyn_z], axis=-1)
    rhs0 = jnp.zeros((N,), dtype=dtype).at[0].set(1.0)
    bdyn_x = a * dcm0[..., 0, None] * rhs0                # (…, N)
    bdyn_y = a * dcm0[..., 1, None] * rhs0

    # Polygon rows: A_poly[k, f] · z_k ≤ b[k, f] — one row per (k, f).
    batch = poly_A.shape[:-3]
    Az_x = jnp.einsum("...kf,kn->...kfn", poly_A[..., 0], eyeN).reshape(
        batch + (N * F, N)
    )
    Az_y = jnp.einsum("...kf,kn->...kfn", poly_A[..., 1], eyeN).reshape(
        batch + (N * F, N)
    )
    zeros_poly = jnp.zeros(batch + (N * F, N), dtype=dtype)
    Apoly = jnp.concatenate([zeros_poly, zeros_poly, Az_x, Az_y], axis=-1)
    bpoly = poly_b.reshape(poly_b.shape[:-2] + (N * F,))

    Adyn = jnp.broadcast_to(
        jnp.concatenate([Adyn_x, Adyn_y], axis=-2),
        batch + (2 * N, 4 * N),
    )
    A = jnp.concatenate([Adyn, Apoly], axis=-2)
    bdyn = jnp.concatenate([bdyn_x, bdyn_y], axis=-1)      # (…, 2N), dcm0 batch
    bpoly = jnp.broadcast_to(bpoly, bdyn.shape[:-1] + bpoly.shape[-1:])
    u = jnp.concatenate([bdyn, bpoly], axis=-1)
    l = jnp.concatenate([bdyn, jnp.full_like(bpoly, -jnp.inf)], axis=-1)
    return P, qvec, A, l, u


@f32_matmuls
def solve_dcm_mpc(
    params: LIPMParams,
    dt,
    dcm0: jnp.ndarray,
    com0: jnp.ndarray,
    dcm_ref: jnp.ndarray,
    zmp_ref: jnp.ndarray,
    poly_A: jnp.ndarray,
    poly_b: jnp.ndarray,
    weights: Optional[DCMWeights] = None,
    *,
    iterations: int = 200,
    warm_start: Optional[jnp.ndarray] = None,
    warm_start_dual: Optional[jnp.ndarray] = None,
    shared: bool = False,
    **qp_kwargs,
) -> DCMPlan:
    """Build and solve the DCM-MPC; roll out DCM and CoM trajectories.

    Single-scenario shapes documented on :func:`build_dcm_qp`; every input may
    carry leading batch axes (or use ``vmap``/``shard_map`` outside).

    ``shared=True`` selects :func:`blf_tpu.mpc.qp.solve_qp_shared` — the
    fleet fast path when all lanes share references and polygons (batch on
    ``dcm0``/warm starts only): one KKT factorization, GEMM-shaped
    iterations. Requires unbatched ``dcm_ref``/``zmp_ref``/``poly_*``.
    """
    N = zmp_ref.shape[-2]
    P, q, A, l, u = build_dcm_qp(
        params, dt, dcm0, dcm_ref, zmp_ref, poly_A, poly_b, weights
    )
    x0 = None
    if warm_start is not None:
        # warm_start: previous (…, N, 2) ZMP plan; seed ξ by exact rollout.
        a_ws = jnp.exp(lipm_omega(params) * jnp.asarray(dt, warm_start.dtype))

        def xi_roll(xi, z):
            xi_next = a_ws * xi + (1 - a_ws) * z
            return xi_next, xi_next

        _, xi_seq = jax.lax.scan(
            xi_roll, dcm0, jnp.moveaxis(warm_start, -2, 0)
        )
        xi_seq = jnp.moveaxis(xi_seq, 0, -2)
        x0 = jnp.concatenate(
            [xi_seq[..., 0], xi_seq[..., 1],
             warm_start[..., 0], warm_start[..., 1]], axis=-1
        )
    if shared:
        # structural equality mask (first 2N rows are dynamics equalities) —
        # constant by construction, so the factorization depends only on
        # tick-invariant data and XLA hoists it out of receding-horizon
        # scan loops (the per-tick solve then starts at the ADMM iterations).
        # (P, A) depend only on the shared refs/polygons — with those
        # unbatched (the shared-path contract above), any batch axes on
        # (P, A) are pure broadcasts of dcm0's batch (build_dcm_qp), so for
        # the fleet-native path collapse them back to one copy: the batch
        # rides (q, l, u) through solve_qp_factored.
        if jnp.asarray(poly_A).ndim != 3 or jnp.asarray(poly_b).ndim != 2:
            raise ValueError(
                "solve_dcm_mpc(shared=True) requires unbatched poly_A/poly_b"
                " (lanes share one transcription); use shared=False or vmap"
                " for per-lane polygons")
        P_s = P[(0,) * (P.ndim - 2)] if P.ndim > 2 else P
        A_s = A[(0,) * (A.ndim - 2)] if A.ndim > 2 else A
        is_eq = jnp.arange(A_s.shape[-2]) < 2 * N
        factors = factor_shared_qp(
            P_s, A_s, is_eq,
            **{k: qp_kwargs.pop(k) for k in
               ("rho", "sigma", "rho_eq_scale", "scaling_iters")
               if k in qp_kwargs},
        )
        sol = solve_qp_factored(factors, q, l, u, iterations=iterations,
                                x0=x0, y0=warm_start_dual, **qp_kwargs)
    else:
        sol = solve_qp(P, q, A, l, u, iterations=iterations, x0=x0,
                       y0=warm_start_dual, **qp_kwargs)
    zmp = jnp.stack(
        [sol.x[..., 2 * N : 3 * N], sol.x[..., 3 * N :]], axis=-1
    )  # (…, N, 2)

    # DCM trajectory from the QP's own ξ decision variables: the dynamics
    # equality rows pin them to the rollout within the solver residual. Do
    # NOT re-roll ξ⁺ = a·ξ + (1−a)z forward — the DCM flow is unstable
    # (a = e^{ω·dt} > 1), so over a long gait horizon that recursion
    # amplifies dtype rounding by a^T (≈1e13 at T = 96, ω·dt ≈ 0.33; f32
    # trajectories exploded to ±5e4 while the QP itself was converged —
    # caught by the f32 test lane). Consequence: plan.dcm/com
    # satisfy the DCM dynamics only up to the QP residual — on
    # iteration-capped unconverged lanes, gate on plan.qp.converged before
    # consuming them as dynamically consistent trajectories.
    dcm_knots = jnp.stack(
        [sol.x[..., 0:N], sol.x[..., N:2 * N]], axis=-1
    )  # (…, N, 2) = ξ_{1..N}
    dcm_traj = jnp.concatenate(
        [jnp.broadcast_to(dcm0[..., None, :], dcm_knots[..., :1, :].shape),
         dcm_knots],
        axis=-2,
    )
    com_traj = com_trajectory_from_dcm(params, com0, dcm_traj, zmp, dt)
    return DCMPlan(zmp=zmp, dcm=dcm_traj, com=com_traj, qp=sol)
