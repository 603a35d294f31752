"""Batched SQP trajectory optimizer (Gauss-Newton / iLQR-structured).

The north-star workload (BASELINE.json) is the upstream
``TimeVaryingDCMPlanner`` class of problems: *nonlinear* optimal-control
transcriptions that the reference solves with CasADi/Ipopt on CPU. This module
is the accelerator-native replacement: a shooting SQP whose every stage is a fixed
-shape, fixed-iteration JAX program —

- **Gauss-Newton quadraticization** of nonlinear least-squares running and
  terminal costs (residual Jacobians via ``jax.jacfwd``; the GN Hessian
  ``JᵀJ`` is PSD by construction, so the Riccati pass needs no eigenvalue
  surgery, only a static Levenberg regularizer);
- **augmented-Lagrangian** outer loop for inequality constraints
  ``g(x, u, k) ≤ 0`` (per-constraint multipliers, monotone penalty ladder) —
  the standard way to keep a *batched* solver single-program: active sets
  differ per lane but the AL update is the same dense computation everywhere;
- an **iLQR backward pass** (time-varying Riccati with cross terms) as a
  ``lax.scan``, and a **vectorized backtracking line search** that evaluates
  every candidate step size in one batched rollout and selects the best by
  merit — no data-dependent control flow anywhere, so one ``jit`` serves
  every lane of a ``vmap``/``shard_map`` fleet.

Reference parity: the reference snapshot has no NLP solver (SURVEY.md §7 —
"QP solver (batched ADMM/OSQP-style + Riccati-structured SQP for the MPC
transcription)" is a required new component with no counterpart); the linear
-quadratic backbone it composes with lives in :mod:`blf_tpu.mpc.riccati` and
the ADMM QP in :mod:`blf_tpu.mpc.qp`.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = ["SQPConfig", "SQPSolution", "solve_trajopt"]

_PREC = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC)


def _mv(a, v):
    return jnp.matmul(a, v[..., None], precision=_PREC)[..., 0]


class SQPConfig(NamedTuple):
    """Fixed-budget solver knobs (all static under jit)."""

    iterations: int = 12            # GN/iLQR iterations per AL round
    al_iterations: int = 4          # augmented-Lagrangian rounds
    penalty_init: float = 10.0      # initial AL penalty ρ
    penalty_scale: float = 10.0     # ρ multiplier per AL round
    penalty_max: float = 1e8
    regularization: float = 1e-8    # Levenberg term on Quu
    line_search_alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.03, 0.0)
    constraint_tol: float = 1e-6    # feasibility for `converged`
    step_tol: float = 1e-8          # |merit decrease| for `converged`
    parallel_backward: bool = False  # O(log T) associative-scan value pass
    #   (blf_tpu.mpc.riccati.parallel_value_general) instead of the O(T)
    #   sequential Riccati scan — same gains to fp; wins at long horizons


class SQPSolution(NamedTuple):
    states: jnp.ndarray             # (T+1, nx)
    controls: jnp.ndarray           # (T, nu)
    cost: jnp.ndarray               # scalar Σ ½‖r‖² (+ terminal), no AL terms
    max_violation: jnp.ndarray      # scalar max(0, g) over all knots
    multipliers: jnp.ndarray        # (T, ng) final AL multipliers
    terminal_multipliers: jnp.ndarray  # (ngT,)
    converged: jnp.ndarray          # bool: feasible & stalled step
    merit_decrease: jnp.ndarray     # last accepted merit improvement
    gain_norm: jnp.ndarray          # ‖feedforward‖∞ at the last iterate


def _no_ineq(x, u, k):
    return jnp.zeros((0,), x.dtype)


def _no_term_ineq(x):
    return jnp.zeros((0,), x.dtype)


def solve_trajopt(
    dynamics: Callable,             # f(x, u, k) -> x_next
    running_residuals: Callable,    # r(x, u, k) -> (nr,)   cost ½‖r‖²
    terminal_residuals: Callable,   # rT(x) -> (nrT,)
    x0: jnp.ndarray,                # (nx,)
    us_init: jnp.ndarray,           # (T, nu)
    *,
    inequality: Optional[Callable] = None,          # g(x, u, k) ≤ 0, (ng,)
    terminal_inequality: Optional[Callable] = None,  # gT(x) ≤ 0, (ngT,)
    config: SQPConfig = SQPConfig(),
) -> SQPSolution:
    """Solve ``min Σ½‖r(x,u,k)‖² + ½‖rT(x_T)‖²  s.t. x⁺=f(x,u,k), g ≤ 0``.

    Single-scenario and pure: batch with ``jax.vmap``, shard with
    ``shard_map`` — every iteration count is static, so one compilation
    serves the whole fleet. Time-varying references enter through the ``k``
    argument (gather from closed-over arrays).
    """
    ineq = inequality or _no_ineq
    term_ineq = terminal_inequality or _no_term_ineq
    T, nu = us_init.shape
    nx = x0.shape[0]
    dtype = us_init.dtype
    ks = jnp.arange(T)
    alphas = jnp.asarray(config.line_search_alphas, dtype)

    def rollout(us):
        def step(x, inp):
            u, k = inp
            x_next = dynamics(x, u, k)
            return x_next, x_next

        _, xs_tail = jax.lax.scan(step, x0, (us, ks))
        return jnp.concatenate([x0[None], xs_tail], axis=0)

    ng = jax.eval_shape(ineq, x0, us_init[0], 0).shape[0]
    ngT = jax.eval_shape(term_ineq, x0).shape[0]

    def merit(xs, us, mu, muT, rho):
        """AL merit: true cost + Σ ψ(g, μ, ρ), ψ = (max(0, μ+ρg)² − μ²)/2ρ."""
        r = jax.vmap(running_residuals)(xs[:-1], us, ks)
        rT = terminal_residuals(xs[-1])
        cost = 0.5 * (jnp.sum(r * r) + jnp.sum(rT * rT))
        g = jax.vmap(ineq)(xs[:-1], us, ks)
        gT = term_ineq(xs[-1])
        w = jnp.maximum(0.0, mu + rho * g)
        wT = jnp.maximum(0.0, muT + rho * gT)
        al = (jnp.sum(w * w - mu * mu) + jnp.sum(wT * wT - muT * muT)) / (
            2.0 * rho
        )
        viol = jnp.maximum(
            jnp.max(jnp.maximum(g, 0.0), initial=0.0),
            jnp.max(jnp.maximum(gT, 0.0), initial=0.0),
        )
        return cost + al, cost, viol

    def stage_derivs(x, u, k, mu_k, rho):
        """Gradient + GN Hessian of the AL running cost at one knot."""
        r = running_residuals(x, u, k)
        Jx = jax.jacfwd(running_residuals, argnums=0)(x, u, k)
        Ju = jax.jacfwd(running_residuals, argnums=1)(x, u, k)
        lx = _mv(Jx.T, r)
        lu = _mv(Ju.T, r)
        lxx = _mm(Jx.T, Jx)
        luu = _mm(Ju.T, Ju)
        lux = _mm(Ju.T, Jx)
        if ng:
            g = ineq(x, u, k)
            Gx = jax.jacfwd(ineq, argnums=0)(x, u, k)
            Gu = jax.jacfwd(ineq, argnums=1)(x, u, k)
            w = jnp.maximum(0.0, mu_k + rho * g)
            act = (w > 0.0).astype(x.dtype)
            lx = lx + _mv(Gx.T, w)
            lu = lu + _mv(Gu.T, w)
            lxx = lxx + rho * _mm(Gx.T, act[:, None] * Gx)
            luu = luu + rho * _mm(Gu.T, act[:, None] * Gu)
            lux = lux + rho * _mm(Gu.T, act[:, None] * Gx)
        A = jax.jacfwd(dynamics, argnums=0)(x, u, k)
        B = jax.jacfwd(dynamics, argnums=1)(x, u, k)
        return lx, lu, lxx, luu, lux, A, B

    def terminal_derivs(xT, muT, rho):
        rT = terminal_residuals(xT)
        JT = jax.jacfwd(terminal_residuals)(xT)
        Vx = _mv(JT.T, rT)
        Vxx = _mm(JT.T, JT)
        if ngT:
            gT = term_ineq(xT)
            GT = jax.jacfwd(term_ineq)(xT)
            w = jnp.maximum(0.0, muT + rho * gT)
            act = (w > 0.0).astype(xT.dtype)
            Vx = Vx + _mv(GT.T, w)
            Vxx = Vxx + rho * _mm(GT.T, act[:, None] * GT)
        return Vx, Vxx

    def backward(xs, us, mu, muT, rho):
        lx, lu, lxx, luu, lux, A, B = jax.vmap(
            stage_derivs, in_axes=(0, 0, 0, 0, None)
        )(xs[:-1], us, ks, mu, rho)
        VxT, VxxT = terminal_derivs(xs[-1], muT, rho)
        # Levenberg term scaled with the AL penalty: the active-constraint
        # block of Quu grows ∝ ρ, so an absolute regularizer vanishes
        # relative to it on late AL rounds — in f32 that let cond(Quu) reach
        # 1/eps and the gains blow up (seen as ω diverging on the DCM
        # planner's stiff-start tests). A ρ-relative floor keeps the solve
        # conditioned in both dtypes without biasing early rounds.
        reg = (config.regularization * jnp.maximum(1.0, rho)
               * jnp.eye(nu, dtype=dtype))

        def gains(Vx, Vxx, lx_k, lu_k, lxx_k, luu_k, lux_k, A_k, B_k):
            Qx = lx_k + _mv(A_k.T, Vx)
            Qu = lu_k + _mv(B_k.T, Vx)
            Qxx = lxx_k + _mm(A_k.T, _mm(Vxx, A_k))
            Quu = luu_k + _mm(B_k.T, _mm(Vxx, B_k)) + reg
            Qux = lux_k + _mm(B_k.T, _mm(Vxx, A_k))
            K = jnp.linalg.solve(Quu, Qux)
            kff = jnp.linalg.solve(Quu, Qu[:, None])[:, 0]
            Vx_new = (
                Qx + _mv(K.T, _mv(Quu, kff)) - _mv(K.T, Qu) - _mv(Qux.T, kff)
            )
            Vxx_new = Qxx + _mm(K.T, _mm(Quu, K)) - _mm(K.T, Qux) - _mm(
                Qux.T, K
            )
            Vxx_new = 0.5 * (Vxx_new + Vxx_new.T)
            return Vx_new, Vxx_new, K, kff

        if config.parallel_backward:
            # O(log T) value pass (associative scan), then every knot's
            # gains in one vmap — the SP machinery driving the SQP
            from blf_tpu.mpc.riccati import parallel_value_general

            Vxs, Vxxs = parallel_value_general(
                A, B, lx, lu, lxx, luu + reg, lux, VxT, VxxT)
            _, _, Ks, kffs = jax.vmap(gains)(
                Vxs[1:], Vxxs[1:], lx, lu, lxx, luu, lux, A, B)
            return Ks, kffs

        def step(carry, inp):
            Vx, Vxx = carry
            Vx_new, Vxx_new, K, kff = gains(Vx, Vxx, *inp)
            return (Vx_new, Vxx_new), (K, kff)

        _, (Ks, kffs) = jax.lax.scan(
            step, (VxT, VxxT), (lx, lu, lxx, luu, lux, A, B), reverse=True
        )
        return Ks, kffs

    def forward(xs_nom, us_nom, Ks, kffs, alpha):
        def step(x, inp):
            x_nom, u_nom, K, kff, k = inp
            u = u_nom - alpha * kff - _mv(K, x - x_nom)
            x_next = dynamics(x, u, k)
            return x_next, (x_next, u)

        _, (xs_tail, us) = jax.lax.scan(
            step, x0, (xs_nom[:-1], us_nom, Ks, kffs, ks)
        )
        return jnp.concatenate([x0[None], xs_tail], axis=0), us

    def inner_iteration(carry, _):
        xs, us, mu, muT, rho, m_prev = carry
        Ks, kffs = backward(xs, us, mu, muT, rho)
        xs_cand, us_cand = jax.vmap(
            lambda a: forward(xs, us, Ks, kffs, a)
        )(alphas)
        m_cand = jax.vmap(lambda x, u: merit(x, u, mu, muT, rho)[0])(
            xs_cand, us_cand
        )
        m_cand = jnp.where(jnp.isfinite(m_cand), m_cand, jnp.inf)
        best = jnp.argmin(m_cand)
        xs_new = xs_cand[best]
        us_new = us_cand[best]
        m_new = m_cand[best]
        # never accept an increase over the incumbent (α=0 is in the set, so
        # this only triggers on numerically tied candidates)
        take = m_new <= m_prev
        xs_new = jnp.where(take, xs_new, xs)
        us_new = jnp.where(take, us_new, us)
        m_new = jnp.where(take, m_new, m_prev)
        gain = jnp.max(jnp.abs(kffs))
        return (xs_new, us_new, mu, muT, rho, m_new), (m_prev - m_new, gain)

    def al_round(carry, _):
        xs, us, mu, muT, rho = carry
        m0, _, _ = merit(xs, us, mu, muT, rho)
        (xs, us, mu, muT, rho, _), (decreases, gains) = jax.lax.scan(
            inner_iteration, (xs, us, mu, muT, rho, m0), None,
            length=config.iterations,
        )
        g = jax.vmap(ineq)(xs[:-1], us, ks)
        gT = term_ineq(xs[-1])
        mu = jnp.maximum(0.0, mu + rho * g)
        muT = jnp.maximum(0.0, muT + rho * gT)
        rho = jnp.minimum(rho * config.penalty_scale, config.penalty_max)
        return (xs, us, mu, muT, rho), (decreases[-1], gains[-1])

    us0 = us_init
    xs0 = rollout(us0)
    mu0 = jnp.zeros((T, ng), dtype)
    muT0 = jnp.zeros((ngT,), dtype)
    rho0 = jnp.asarray(config.penalty_init, dtype)

    (xs, us, mu, muT, rho), (last_dec, last_gain) = jax.lax.scan(
        al_round, (xs0, us0, mu0, muT0, rho0), None,
        length=config.al_iterations,
    )

    _, cost, viol = merit(xs, us, mu, muT, rho)
    converged = (viol <= config.constraint_tol) & (
        jnp.abs(last_dec[-1]) <= config.step_tol
    )
    return SQPSolution(
        states=xs, controls=us, cost=cost, max_violation=viol,
        multipliers=mu, terminal_multipliers=muT, converged=converged,
        merit_decrease=last_dec[-1], gain_norm=last_gain[-1],
    )
