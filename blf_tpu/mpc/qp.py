"""Batched fixed-iteration ADMM quadratic-program solver (OSQP-style).

The new-component solver SURVEY.md §7 mandates ("QP solver (batched
ADMM/OSQP-style)"; BASELINE.json north star): one ``jit``ted solver handling
thousands of heterogeneous scenarios with **no data-dependent control flow** —
fixed iteration count, per-lane convergence *flags* instead of early exit
(SURVEY.md §5 "failure detection": status codes carried in the batch).

Problem form (OSQP):  ``min ½ xᵀPx + qᵀx  s.t.  l ≤ Ax ≤ u``.

Iteration (α-relaxed ADMM, per-constraint penalty ρ):

    (P + σI + AᵀρA) x̃ = σx − q + Aᵀ(ρz − y)
    x⁺ = αx̃ + (1−α)x
    z⁺ = clip(α A x̃ + (1−α) z + y/ρ, l, u)
    y⁺ = y + ρ (α A x̃ + (1−α) z − z⁺)

The KKT matrix is factored **once** per stage (batched Cholesky) and reused
across iterations; equality rows (l == u) get a stiffer ρ as in
OSQP. Everything broadcasts over leading batch axes and is ``vmap``-free by
construction (but composes with ``vmap``/``shard_map`` for sharded sweeps).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["QPSolution", "SharedQPFactors", "solve_qp", "solve_qp_lanes",
           "solve_qp_shared", "factor_shared_qp", "solve_qp_factored",
           "shard_factors_rows", "solve_qp_factored_rowsharded"]

# Reduced-precision (TF32 / bf16) products bias the ADMM fixed point and
# floor residuals around 1e-3; every solver contraction asks for full f32.
_PRECISION = jax.lax.Precision.HIGHEST


def _einsum(spec, *ops):
    return jnp.einsum(spec, *ops, precision=_PRECISION)


# Shared f32-matmul context (see blf_tpu.ops.precision) for the products
# not written through _einsum.
from blf_tpu.ops.precision import f32_matmuls as _f32_matmuls



class QPSolution(NamedTuple):
    """Per-lane solution + diagnostics (no exceptions on device — SURVEY.md §5)."""

    x: jnp.ndarray               # (…, n) primal solution
    y: jnp.ndarray               # (…, m) dual solution
    z: jnp.ndarray               # (…, m) constraint-space iterate
    primal_residual: jnp.ndarray  # (…,) ‖Ax − z‖∞
    dual_residual: jnp.ndarray    # (…,) ‖Px + q + Aᵀy‖∞
    converged: jnp.ndarray        # (…,) bool
    objective: jnp.ndarray        # (…,) ½xᵀPx + qᵀx
    rho_scale: jnp.ndarray = None  # (…, 1) adapted per-lane ρ multiplier s
    refined: jnp.ndarray = None   # () bool: iterative refinement ran


@_f32_matmuls
def solve_qp(
    P: jnp.ndarray,
    q: jnp.ndarray,
    A: jnp.ndarray,
    l: jnp.ndarray,
    u: jnp.ndarray,
    *,
    iterations: int = 200,
    rho: float = 1.0,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    eps_abs: float = 1e-5,
    eps_rel: float = 1e-5,
    rho_eq_scale: Optional[float] = None,
    scaling_iters: int = 10,
    check_every: int = 25,
    x0: Optional[jnp.ndarray] = None,
    y0: Optional[jnp.ndarray] = None,
    s0: Optional[jnp.ndarray] = None,
    unroll: int = 1,
    kkt_inverse: bool = True,
    kkt_refine: int = 3,
    polish_iters: int = 0,
    polish_scale: float = 0.1,
    backend: str = "xla",
) -> QPSolution:
    """Solve ``min ½xᵀPx + qᵀx s.t. l ≤ Ax ≤ u`` with fixed-iteration ADMM.

    Shapes: ``P`` (…, n, n) SPSD, ``q`` (…, n), ``A`` (…, m, n), ``l``/``u``
    (…, m) (use ∓∞ for one-sided rows, ``l == u`` for equalities). ``x0``/``y0``
    warm-start the iteration — the key latency lever in receding-horizon MPC —
    and ``s0`` (…,) or (…, 1) warm-starts the per-lane adaptive ρ multiplier
    (returned as ``QPSolution.rho_scale``).

    ``kkt_inverse=True`` (default) applies the per-stage KKT factor as an
    explicit inverse: one extra batched triangular solve per *stage* buys
    per-*iteration* x-steps that are plain batched matvecs instead of
    sequential triangular substitutions. ``kkt_refine`` iterative-
    refinement passes against the exact KKT keep the x-step error at the
    cho_solve level (see the in-code measurement note for the default).

    ``polish_iters > 0`` appends a ρ-continuation dual polish stage at
    ``rho_scale·polish_scale`` — same rationale as
    :func:`solve_qp_factored`: in f32 the dual update granularity is
    ``ρ·eps(|z|)``, so a short low-ρ tail settles y below the main loop's
    floor while the converged primal holds.

    ``scaling_iters`` rounds of Ruiz equilibration precondition the problem
    (OSQP's scaling): essential for one jitted solve to handle thousands of
    heterogeneously-conditioned scenarios (SURVEY.md §7 "batched QP
    robustness"). Residuals/solution are reported in the ORIGINAL scaling.

    ``rho_eq_scale=None`` picks the equality-row stiffening by dtype: OSQP's
    1e3 in f64, 30 in f32 — the KKT solve error grows with
    ``cond(K) ∝ rho_eq_scale``, and at 1e3 the f32 dual residual floors
    ~1e-1 absolute on reference-tracking problems (caught by the f32 test
    lane; same reasoning as :func:`factor_shared_qp`). The per-stage
    adaptive ρ recovers the equality enforcement a stiffer ρ would give.

    ``backend="pallas"`` dispatches to :func:`solve_qp_lanes` — the fused
    per-lane-operator kernel path (one batch axis required; ``kkt_inverse``/
    ``kkt_refine``/``unroll`` are XLA-path knobs and are ignored there).
    ``backend="xla"`` is its plain reference.
    """
    if backend == "pallas":
        return solve_qp_lanes(
            P, q, A, l, u, iterations=iterations, rho=rho, sigma=sigma,
            alpha=alpha, eps_abs=eps_abs, eps_rel=eps_rel,
            rho_eq_scale=rho_eq_scale, scaling_iters=scaling_iters,
            check_every=check_every, x0=x0, y0=y0, s0=s0,
            polish_iters=polish_iters, polish_scale=polish_scale,
        )
    if backend != "xla":
        raise ValueError(f"unknown solve_qp backend {backend!r}")
    P, q, A = jnp.asarray(P), jnp.asarray(q), jnp.asarray(A)
    l, u = jnp.asarray(l), jnp.asarray(u)
    n, m = P.shape[-1], A.shape[-2]
    dtype = P.dtype
    if rho_eq_scale is None:
        rho_eq_scale = 1e3 if jnp.finfo(dtype).bits >= 64 else 30.0

    # -- Ruiz equilibration: P̄ = c·D P D, Ā = E A D, q̄ = c·D q, l̄/ū = E l/u --
    P_orig, q_orig, A_orig = P, q, A
    D = jnp.ones(P.shape[:-2] + (n,), dtype=dtype)
    E = jnp.ones(A.shape[:-2] + (m,), dtype=dtype)
    c = jnp.ones(jnp.broadcast_shapes(P.shape[:-2], q.shape[:-1]), dtype=dtype)
    for _ in range(scaling_iters):
        col_norm = jnp.maximum(
            jnp.max(jnp.abs(P), axis=-2), jnp.max(jnp.abs(A), axis=-2)
        )
        dx = 1.0 / jnp.sqrt(jnp.where(col_norm > 1e-12, col_norm, 1.0))
        row_norm = jnp.max(jnp.abs(A), axis=-1)
        de = 1.0 / jnp.sqrt(jnp.where(row_norm > 1e-12, row_norm, 1.0))
        P = dx[..., :, None] * P * dx[..., None, :]
        A = de[..., :, None] * A * dx[..., None, :]
        q = q * dx
        D = D * dx
        E = E * de
        # cost normalisation
        p_cols = jnp.mean(jnp.max(jnp.abs(P), axis=-2), axis=-1)
        gamma = 1.0 / jnp.maximum(
            jnp.maximum(p_cols, jnp.max(jnp.abs(q), axis=-1)), 1e-12
        )
        P = gamma[..., None, None] * P
        q = gamma[..., None] * q
        c = c * gamma
    l = E * l
    u = E * u
    if x0 is not None:
        x0 = x0 / D                      # x̄ = D⁻¹ x
    if y0 is not None:
        y0 = c[..., None] * y0 / E       # ȳ = c E⁻¹ y  (y = E ȳ / c)

    is_eq = (u - l) < 1e-12
    base_rho = jnp.where(is_eq, rho * rho_eq_scale, rho).astype(dtype)

    At = jnp.swapaxes(A, -1, -2)

    batch = jnp.broadcast_shapes(
        P.shape[:-2], q.shape[:-1], A.shape[:-2], l.shape[:-1], u.shape[:-1],
        () if x0 is None else x0.shape[:-1],
        () if y0 is None else y0.shape[:-1],
    )
    # Initial iterates are derived from (or merged with) the inputs rather
    # than fresh constants, so that under shard_map the scan carries inherit
    # the union of the inputs' varying mesh axes.
    x = jnp.broadcast_to(q * 0 if x0 is None else x0 + q * 0, batch + (n,))
    z = jnp.broadcast_to(_einsum("...mn,...n->...m", A, x), batch + (m,))
    zero_m = z * 0 + (l * 0 + u * 0) * 0 if jnp.issubdtype(dtype, jnp.floating) else z * 0
    zero_m = jnp.where(jnp.isnan(zero_m), 0.0, zero_m)  # ±inf bounds → 0·inf = nan
    y = jnp.broadcast_to(zero_m if y0 is None else y0 + zero_m, batch + (m,))

    def run_stage(x, z, y, rho_scale, iters):
        """`iters` ADMM iterations at a fixed per-lane ρ (refactored)."""
        rho_vec = base_rho * rho_scale[..., None]           # (batch, m)
        kkt = jnp.broadcast_to(
            P
            + sigma * jnp.eye(n, dtype=dtype)
            + _einsum("...nm,...m,...mk->...nk", At, rho_vec, A),
            batch + (n, n),
        )
        chol = jnp.linalg.cholesky(kkt)
        if kkt_inverse:
            Kinv = jax.scipy.linalg.cho_solve(
                (chol, True), jnp.broadcast_to(jnp.eye(n, dtype=dtype),
                                               batch + (n, n)))

            def kkt_solve(rhs):
                # inverse-apply + refinement passes against the exact KKT:
                # matvec-only per iteration (see docstring). Three passes measured necessary to match
                # cho_solve convergence counts on the ill-conditioned
                # walking-gait transcription in f32 (1 pass lost 5/64
                # marginal lanes at 1e-4 tolerances, 2 passes 2/64; 3
                # passes converged 64/64 vs cho_solve's 63).
                x1 = _einsum("...ij,...j->...i", Kinv, rhs)
                for _ in range(kkt_refine):
                    r = rhs - _einsum("...ij,...j->...i", kkt, x1)
                    x1 = x1 + _einsum("...ij,...j->...i", Kinv, r)
                return x1
        else:
            def kkt_solve(rhs):
                return jax.scipy.linalg.cho_solve(
                    (chol, True), rhs[..., None])[..., 0]

        def body(carry, _):
            x, z, y = carry
            rhs = sigma * x - q + _einsum(
                "...nm,...m->...n", At, rho_vec * z - y
            )
            x_tilde = kkt_solve(rhs)
            x_next = alpha * x_tilde + (1 - alpha) * x
            Ax_tilde = _einsum("...mn,...n->...m", A, x_tilde)
            z_relaxed = alpha * Ax_tilde + (1 - alpha) * z
            z_next = jnp.clip(z_relaxed + y / rho_vec, l, u)
            y_next = y + rho_vec * (z_relaxed - z_next)
            return (x_next, z_next, y_next), None

        (x, z, y), _ = jax.lax.scan(
            body, (x, z, y), None, length=iters, unroll=unroll
        )
        return x, z, y

    check_every = max(1, min(check_every, iterations))
    n_stages = max(1, -(-iterations // check_every))

    def stage(carry, _):
        x, z, y, rho_scale = carry
        x, z, y = run_stage(x, z, y, rho_scale, check_every)
        # OSQP adaptive ρ: balance relative primal vs dual residuals per lane.
        Ax = _einsum("...mn,...n->...m", A, x)
        Px_ = _einsum("...nm,...m->...n", P, x)
        Aty_ = _einsum("...nm,...m->...n", At, y)
        rp = jnp.max(jnp.abs(Ax - z), axis=-1) / jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(Ax), -1), jnp.max(jnp.abs(z), -1)), 1e-12
        )
        rd = jnp.max(jnp.abs(Px_ + q + Aty_), axis=-1) / jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(Px_), -1),
                        jnp.maximum(jnp.max(jnp.abs(Aty_), -1),
                                    jnp.max(jnp.abs(q), -1))), 1e-12
        )
        scale = jnp.sqrt(rp / jnp.maximum(rd, 1e-12))
        rho_scale = jnp.clip(
            rho_scale * jnp.clip(scale, 0.2, 5.0), 1e-6, 1e6
        )
        return (x, z, y, rho_scale), None

    if s0 is None:
        rho_scale = jnp.broadcast_to(x[..., 0] * 0 + 1, batch)
    else:
        s0 = jnp.asarray(s0, dtype)
        if s0.ndim and s0.shape[-1] == 1 and s0.ndim > len(batch):
            s0 = s0[..., 0]
        rho_scale = jnp.broadcast_to(s0 + x[..., 0] * 0, batch)
    (x, z, y, rho_scale), _ = jax.lax.scan(
        stage, (x, z, y, rho_scale), None, length=n_stages
    )

    def _finish(x, z, y):
        """Unscale an iterate and diagnose it in the ORIGINAL problem."""
        x = D * x
        y = E * y / c[..., None]
        z = z / E
        Ax = _einsum("...mn,...n->...m", A_orig, x)
        r_prim = jnp.max(jnp.abs(Ax - z), axis=-1)
        Px = _einsum("...nm,...m->...n", P_orig, x)
        Aty = _einsum("...nm,...m->...n", jnp.swapaxes(A_orig, -1, -2), y)
        r_dual = jnp.max(jnp.abs(Px + q_orig + Aty), axis=-1)
        # OSQP-style relative tolerances (scale-free convergence check)
        prim_tol = eps_abs + eps_rel * jnp.maximum(
            jnp.max(jnp.abs(Ax), axis=-1), jnp.max(jnp.abs(z), axis=-1)
        )
        dual_tol = eps_abs + eps_rel * jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(Px), axis=-1),
                        jnp.max(jnp.abs(Aty), axis=-1)),
            jnp.max(jnp.abs(q_orig), axis=-1),
        )
        return x, z, y, r_prim, r_dual, prim_tol, dual_tol

    cand = _finish(x, z, y)
    if polish_iters > 0:
        # ρ-continuation dual polish (see docstring): the KKT point is a
        # fixed point for EVERY ρ, so on converged lanes a short low-ρ stage
        # only refines the duals' settling granularity. On lanes that are
        # NOT yet converged, low-ρ iterations weaken primal enforcement and
        # can blow the residual up (seen closed-loop: a lane pushed off its
        # fixed point re-enters the next warm-started tick worse — the
        # degradation compounds), so the polish is accepted PER LANE only
        # where it lowered the tolerance-normalized residual score — the
        # same original-frame metric the convergence flag uses.
        pol = _finish(*run_stage(
            x, z, y,
            jnp.clip(rho_scale * jnp.asarray(polish_scale, dtype), 1e-6, 1e6),
            polish_iters,
        ))
        score = lambda d: jnp.maximum(d[3] / d[5], d[4] / d[6])
        better = score(pol) < score(cand)
        pick = lambda a, b: jnp.where(
            better.reshape(better.shape + (1,) * (a.ndim - better.ndim)),
            b, a)
        cand = tuple(pick(a, b) for a, b in zip(cand, pol))

    x, z, y, r_prim, r_dual, prim_tol, dual_tol = cand
    converged = (r_prim < prim_tol) & (r_dual < dual_tol)
    objective = 0.5 * _einsum("...n,...nm,...m->...", x, P_orig, x) + _einsum(
        "...n,...n->...", q_orig, x
    )
    return QPSolution(x, y, z, r_prim, r_dual, converged, objective,
                      rho_scale=rho_scale[..., None])


@_f32_matmuls
def solve_qp_lanes(
    P: jnp.ndarray,
    q: jnp.ndarray,
    A: jnp.ndarray,
    l: jnp.ndarray,
    u: jnp.ndarray,
    *,
    iterations: int = 200,
    rho: float = 1.0,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    eps_abs: float = 1e-5,
    eps_rel: float = 1e-5,
    rho_eq_scale: Optional[float] = None,
    scaling_iters: int = 10,
    check_every: int = 25,
    x0: Optional[jnp.ndarray] = None,
    y0: Optional[jnp.ndarray] = None,
    s0: Optional[jnp.ndarray] = None,
    polish_iters: int = 0,
    polish_scale: float = 0.1,
    s_min: float = 1e-4,
    s_max: float = 1e4,
) -> QPSolution:
    """Fused-kernel ADMM for a batch of QPs with PER-LANE (P, A).

    The whole-body-QP shape of the control stack: every lane carries its own
    cost and constraint matrices (its own mass matrix / Jacobians), so the
    shared-factor spectral path is unavailable, and the XLA batched path
    runs every iteration as several launches of small batched matvecs.
    This path instead:

    - Ruiz-equilibrates per lane (same as :func:`solve_qp`);
    - per stage, builds ``K(s) = P̄ + σI + s·ĀᵀρĀ`` (batched GEMM) and
      inverts it (:func:`blf_tpu.ops.linalg.spd_inverse`);
    - runs the stage's iterations in one kernel launch with each lane's
      operators held on chip
      (:func:`blf_tpu.ops.pallas.admm_lane.admm_lane_stage`,
      v-space recursion — the σ·x proximal term is dropped exactly as in
      :func:`solve_qp_factored`, shifting the fixed point by ~σ‖x‖ ≈ 1e-7);
    - adapts the per-lane ρ multiplier ``s`` at stage boundaries with the
      same OSQP hysteresis rule, and accepts an optional ρ-continuation
      dual polish per lane only where it improves the tolerance-normalized
      residual score.

    Semantics, warm starts, and diagnostics mirror :func:`solve_qp`;
    ``converged``/residuals are computed in the ORIGINAL scaling. Exactly
    one leading batch axis is required (one kernel program per lane).
    """
    from blf_tpu.ops.linalg import spd_inverse
    from blf_tpu.ops.pallas.admm_lane import admm_lane_stage

    P, q, A = jnp.asarray(P), jnp.asarray(q), jnp.asarray(A)
    l, u = jnp.asarray(l), jnp.asarray(u)
    n, m = P.shape[-1], A.shape[-2]
    dtype = P.dtype
    if rho_eq_scale is None:
        rho_eq_scale = 1e3 if jnp.finfo(dtype).bits >= 64 else 30.0
    batch = jnp.broadcast_shapes(
        P.shape[:-2], q.shape[:-1], A.shape[:-2], l.shape[:-1], u.shape[:-1],
        () if x0 is None else x0.shape[:-1],
        () if y0 is None else y0.shape[:-1],
    )
    if len(batch) != 1:
        raise ValueError(
            f"solve_qp_lanes requires exactly one batch axis, got {batch}")
    B = batch[0]
    P = jnp.broadcast_to(P, (B, n, n))
    A = jnp.broadcast_to(A, (B, m, n))
    q = jnp.broadcast_to(q, (B, n))
    l = jnp.broadcast_to(l, (B, m))
    u = jnp.broadcast_to(u, (B, m))

    # -- per-lane Ruiz equilibration (identical math to solve_qp) ------------
    P_orig, q_orig, A_orig = P, q, A
    D = jnp.ones((B, n), dtype=dtype)
    E = jnp.ones((B, m), dtype=dtype)
    c = jnp.ones((B,), dtype=dtype)
    for _ in range(scaling_iters):
        col_norm = jnp.maximum(
            jnp.max(jnp.abs(P), axis=-2), jnp.max(jnp.abs(A), axis=-2)
        )
        dx = 1.0 / jnp.sqrt(jnp.where(col_norm > 1e-12, col_norm, 1.0))
        row_norm = jnp.max(jnp.abs(A), axis=-1)
        de = 1.0 / jnp.sqrt(jnp.where(row_norm > 1e-12, row_norm, 1.0))
        P = dx[..., :, None] * P * dx[..., None, :]
        A = de[..., :, None] * A * dx[..., None, :]
        q = q * dx
        D = D * dx
        E = E * de
        p_cols = jnp.mean(jnp.max(jnp.abs(P), axis=-2), axis=-1)
        gamma = 1.0 / jnp.maximum(
            jnp.maximum(p_cols, jnp.max(jnp.abs(q), axis=-1)), 1e-12
        )
        P = gamma[..., None, None] * P
        q = gamma[..., None] * q
        c = c * gamma
    l = E * l
    u = E * u
    if x0 is not None:
        x0 = x0 / D
    if y0 is not None:
        y0 = c[..., None] * y0 / E

    is_eq = (u - l) < 1e-12
    base_rho = jnp.where(is_eq, rho * rho_eq_scale, rho).astype(dtype)

    # -- v-space init --------------------------------------------------------
    x_init = q * 0 if x0 is None else x0 + q * 0
    z = _einsum("bmn,bn->bm", A, x_init)
    zero_m = jnp.where(jnp.isnan((l * 0 + u * 0)), 0.0, (l * 0 + u * 0))
    y = zero_m if y0 is None else y0 + zero_m
    if s0 is None:
        s = jnp.ones((B, 1), dtype)
    else:
        s = jnp.asarray(s0, dtype)
        s = s.reshape(B, -1)[:, :1] if s.ndim else jnp.full((B, 1), s)
    v = z + y / (s * base_rho)

    At = jnp.swapaxes(A, -1, -2)
    eye_n = jnp.eye(n, dtype=dtype)

    def run_stage(v, s, iters):
        rho_lane = s * base_rho                              # (B, m)
        K = P + sigma * eye_n + _einsum(
            "bnm,bm,bmk->bnk", At, rho_lane, A)
        return admm_lane_stage(v, rho_lane, A, spd_inverse(K), q, l, u,
                               iters=iters, alpha=alpha)     # (B, m), (B, n)

    check_every = max(1, min(check_every, iterations))
    n_stages = max(1, -(-iterations // check_every))
    if n_stages > 64:
        # stages are python-unrolled here (each embeds a K build + kernel
        # launch); a tiny check_every would explode compile time. The
        # intended operating point is 1-8 stages per solve (warm-started
        # control loops); use the XLA backend for fine-grained adaptation.
        raise ValueError(
            f"solve_qp_lanes unrolls stages: {n_stages} stages "
            f"(iterations={iterations}, check_every={check_every}) would "
            "blow up compilation; raise check_every or use backend='xla'")

    x = x_init
    for _ in range(n_stages):
        v, x = run_stage(v, s, check_every)
        z = jnp.clip(v, l, u)
        y = (s * base_rho) * (v - z)
        Ax = _einsum("bmn,bn->bm", A, x)
        Px_ = _einsum("bnm,bm->bn", P, x)
        Aty_ = _einsum("bnm,bm->bn", At, y)
        rp = jnp.max(jnp.abs(Ax - z), axis=-1) / jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(Ax), -1), jnp.max(jnp.abs(z), -1)),
            1e-12,
        )
        rd = jnp.max(jnp.abs(Px_ + q + Aty_), axis=-1) / jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(Px_), -1),
                        jnp.maximum(jnp.max(jnp.abs(Aty_), -1),
                                    jnp.max(jnp.abs(q), -1))), 1e-12
        )
        ratio = jnp.sqrt(rp / jnp.maximum(rd, 1e-12))[..., None]
        move = (ratio > 5.0) | (ratio < 0.2)
        s_new = jnp.where(move, jnp.clip(s * ratio, s_min, s_max), s)
        v = z + (s / s_new) * (v - z)
        s = s_new

    def _finish(v, x, rho_lane):
        xs = D * x
        z = jnp.clip(v, l, u)
        ys = E * (rho_lane * (v - z)) / c[..., None]
        zs = z / E
        Ax = _einsum("bmn,bn->bm", A_orig, xs)
        r_prim = jnp.max(jnp.abs(Ax - zs), axis=-1)
        Px = _einsum("bnm,bm->bn", P_orig, xs)
        Aty = _einsum("bnm,bm->bn", jnp.swapaxes(A_orig, -1, -2), ys)
        r_dual = jnp.max(jnp.abs(Px + q_orig + Aty), axis=-1)
        prim_tol = eps_abs + eps_rel * jnp.maximum(
            jnp.max(jnp.abs(Ax), axis=-1), jnp.max(jnp.abs(zs), axis=-1)
        )
        dual_tol = eps_abs + eps_rel * jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(Px), axis=-1),
                        jnp.max(jnp.abs(Aty), axis=-1)),
            jnp.max(jnp.abs(q_orig), axis=-1),
        )
        return xs, zs, ys, r_prim, r_dual, prim_tol, dual_tol

    cand = _finish(v, x, s * base_rho)
    if polish_iters > 0:
        # ρ-continuation dual polish, per-lane acceptance (see solve_qp)
        s_pol = jnp.clip(s * jnp.asarray(polish_scale, dtype), s_min, s_max)
        z = jnp.clip(v, l, u)
        v_p = z + (s / s_pol) * (v - z)
        v_p, x_p = run_stage(v_p, s_pol, polish_iters)
        pol = _finish(v_p, x_p, s_pol * base_rho)
        score = lambda d: jnp.maximum(d[3] / d[5], d[4] / d[6])
        better = score(pol) < score(cand)
        pick = lambda a, b: jnp.where(
            better.reshape(better.shape + (1,) * (a.ndim - better.ndim)),
            b, a)
        cand = tuple(pick(a, b) for a, b in zip(cand, pol))

    xs, zs, ys, r_prim, r_dual, prim_tol, dual_tol = cand
    converged = (r_prim < prim_tol) & (r_dual < dual_tol)
    objective = 0.5 * _einsum("bn,bnm,bm->b", xs, P_orig, xs) + _einsum(
        "bn,bn->b", q_orig, xs
    )
    return QPSolution(xs, ys, zs, r_prim, r_dual, converged, objective,
                      rho_scale=s, refined=jnp.asarray(False))


@_f32_matmuls
def solve_qp_shared(
    P: jnp.ndarray,
    q: jnp.ndarray,
    A: jnp.ndarray,
    l: jnp.ndarray,
    u: jnp.ndarray,
    *,
    iterations: int = 200,
    rho: float = 1.0,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    eps_abs: float = 1e-5,
    eps_rel: float = 1e-5,
    rho_eq_scale: float = 30.0,
    scaling_iters: int = 10,
    check_every: int = 25,
    x0: Optional[jnp.ndarray] = None,
    y0: Optional[jnp.ndarray] = None,
    s0: Optional[jnp.ndarray] = None,
    unroll: int = 1,
    refine: bool = True,
    polish_iters: int = 0,
    polish_scale: float = 0.1,
) -> QPSolution:
    """ADMM for a scenario fleet sharing ONE (P, A) with per-lane (q, l, u).

    The throughput path of the framework (SURVEY.md §2.3 "scenario
    batching"): when every lane solves the same transcription (same horizon,
    same polygons) with different initial states/references, the KKT system
    is factored ONCE and every per-iteration product becomes a dense
    ``(B, ·) × (·, ·)`` GEMM. Convenience wrapper around
    :func:`factor_shared_qp` + :func:`solve_qp_factored` — hoist the
    factorization yourself when (P, A) survive across control ticks.

    Shapes: ``P`` (n, n), ``A`` (m, n) — strictly unbatched; ``q`` (…, n),
    ``l``/``u`` (…, m) carry the batch.
    """
    l = jnp.asarray(l)
    u = jnp.asarray(u)
    m = jnp.asarray(A).shape[-2]
    # equality pattern must be lane-independent for a shared factorization: a
    # row is stiff iff it is an equality in EVERY lane (true for MPC
    # transcriptions, where the equality/inequality split is structural).
    is_eq = jnp.all(((u - l) < 1e-12).reshape((-1, m)), axis=0)
    factors = factor_shared_qp(
        P, A, is_eq, rho=rho, sigma=sigma, rho_eq_scale=rho_eq_scale,
        scaling_iters=scaling_iters,
    )
    return solve_qp_factored(
        factors, q, l, u, iterations=iterations, alpha=alpha,
        eps_abs=eps_abs, eps_rel=eps_rel, check_every=check_every,
        x0=x0, y0=y0, s0=s0, unroll=unroll, refine=refine,
        polish_iters=polish_iters, polish_scale=polish_scale,
    )


class SharedQPFactors(NamedTuple):
    """One-time spectral factorization of a fleet-shared QP (P, A).

    The per-lane adaptive penalty is a *scalar multiplier* ``s`` on the
    structural ρ vector: ``K(s) = P̄ + σI + s·ĀᵀρĀ``. Writing
    ``P̄ + σI = LLᵀ`` and eigendecomposing the pencil
    ``L⁻¹(ĀᵀρĀ)L⁻ᵀ = U diag(d) Uᵀ`` gives, with ``W = L⁻ᵀU``,

        ``K(s)⁻¹ = W diag(1/(1 + s·d)) Wᵀ``  for EVERY ``s`` at once —

    continuous per-lane ρ adaptation at shared-factorization cost: the
    per-iteration solve is two ``(B, n) × (n, n)`` GEMMs and an elementwise
    scale (the replacement for per-lane refactorization, which no batched
    solver can afford, and for the discrete ρ-ladder this design supersedes).
    All members are in the Ruiz-equilibrated frame.
    """

    P_s: jnp.ndarray        # (n, n) scaled cost matrix (γ·DPD)
    A_s: jnp.ndarray        # (m, n) scaled constraints (EAD)
    R2: jnp.ndarray         # (n, n) Ā ᵀ diag(ρ) Ā
    W: jnp.ndarray          # (n, n) spectral basis L⁻ᵀU
    d: jnp.ndarray          # (n,) pencil eigenvalues (≥ 0)
    base_rho: jnp.ndarray   # (m,) structural ρ (stiff on equality rows)
    D: jnp.ndarray          # (n,) Ruiz column scaling
    E: jnp.ndarray          # (m,) Ruiz row scaling
    c: jnp.ndarray          # scalar cost normalization γ
    sigma: jnp.ndarray      # scalar ADMM σ
    P_orig: jnp.ndarray     # (n, n) unscaled, for diagnostics
    A_orig: jnp.ndarray     # (m, n) unscaled
    G2: jnp.ndarray = None  # (m, n) Ā·W — the v-space iteration operator
    #   (t = w·G2 − q·W and Ax̃ = τ·G2ᵀ: the two per-iteration GEMMs)


@_f32_matmuls
def factor_shared_qp(
    P: jnp.ndarray,
    A: jnp.ndarray,
    is_eq: jnp.ndarray,
    *,
    rho: float = 1.0,
    sigma: float = 1e-6,
    rho_eq_scale: float = 30.0,
    scaling_iters: int = 10,
) -> SharedQPFactors:
    """Ruiz-equilibrate and spectrally factor a shared (P, A) pair.

    Depends ONLY on (P, A, is_eq) — deliberately not on q/l/u — so inside a
    ``lax.scan`` over control ticks XLA hoists the whole factorization
    (Cholesky + eigh included) out of the loop.

    ``rho_eq_scale`` defaults to 30 here (vs OSQP's — and :func:`solve_qp`'s
    — 1e3): the spectral form applies ``K(s)⁻¹`` through an f32 eigenbasis
    whose solve error grows with ``cond(K) ∝ rho_eq_scale``, and at 1e3 the
    dual-residual floor (≈ cond·eps ≈ 1e-4 relative) sits above the default
    tolerances on reference-tracking problems with large ``q``. At 30, one
    refinement pass (``refine=True`` in :func:`solve_qp_factored`) puts the
    f32 path at measured parity with an f64 ADMM on the same problems, while
    per-lane ρ adaptation recovers the equality enforcement a stiffer ρ
    would have provided.
    """
    P, A = jnp.asarray(P), jnp.asarray(A)
    if P.ndim != 2 or A.ndim != 2:
        raise ValueError("factor_shared_qp requires unbatched P and A")
    n, m = P.shape[-1], A.shape[-2]
    dtype = P.dtype
    P_orig, A_orig = P, A

    D = jnp.ones((n,), dtype=dtype)
    E = jnp.ones((m,), dtype=dtype)
    for _ in range(scaling_iters):
        col_norm = jnp.maximum(jnp.max(jnp.abs(P), axis=0),
                               jnp.max(jnp.abs(A), axis=0))
        dx = 1.0 / jnp.sqrt(jnp.where(col_norm > 1e-12, col_norm, 1.0))
        row_norm = jnp.max(jnp.abs(A), axis=1)
        de = 1.0 / jnp.sqrt(jnp.where(row_norm > 1e-12, row_norm, 1.0))
        P = dx[:, None] * P * dx[None, :]
        A = de[:, None] * A * dx[None, :]
        D, E = D * dx, E * de
    # cost normalization from P alone (NOT q: keeps the factorization
    # tick-invariant; the per-lane adaptive s absorbs the difference)
    p_cols = jnp.mean(jnp.max(jnp.abs(P), axis=0))
    c = 1.0 / jnp.maximum(p_cols, 1e-12)
    P = c * P

    base_rho = jnp.where(is_eq, rho * rho_eq_scale, rho).astype(dtype)
    R2 = _einsum("mi,m,mj->ij", A, base_rho, A)
    P_sig = P + sigma * jnp.eye(n, dtype=dtype)
    L = jnp.linalg.cholesky(P_sig)
    Linv = jax.scipy.linalg.solve_triangular(
        L, jnp.eye(n, dtype=dtype), lower=True
    )
    M = Linv @ R2 @ Linv.T
    M = 0.5 * (M + M.T)
    d, U = jnp.linalg.eigh(M)
    d = jnp.maximum(d, 0.0)
    W = Linv.T @ U
    return SharedQPFactors(
        P_s=P, A_s=A, R2=R2, W=W, d=d, base_rho=base_rho, D=D, E=E,
        c=jnp.asarray(c, dtype), sigma=jnp.asarray(sigma, dtype),
        P_orig=P_orig, A_orig=A_orig, G2=A @ W,
    )


@_f32_matmuls
def solve_qp_factored(
    factors: SharedQPFactors,
    q: jnp.ndarray,
    l: jnp.ndarray,
    u: jnp.ndarray,
    *,
    iterations: int = 200,
    alpha: float = 1.6,
    eps_abs: float = 1e-5,
    eps_rel: float = 1e-5,
    check_every: int = 25,
    x0: Optional[jnp.ndarray] = None,
    y0: Optional[jnp.ndarray] = None,
    s0: Optional[jnp.ndarray] = None,
    unroll: int = 1,
    refine: bool = True,
    s_min: float = 1e-4,
    s_max: float = 1e4,
    polish_iters: int = 0,
    polish_scale: float = 0.1,
) -> QPSolution:
    """Solve a fleet of QPs against a prebuilt :class:`SharedQPFactors`.

    **v-space iteration.** The σ·x proximal term is dropped from the x-step
    rhs (exact ADMM for the σ-regularized cost P̄+σI; the fixed point shifts
    by ``σ·‖x‖`` ≈ 1e-7·‖x‖ at the default σ, below the solver's residual
    floor). The primal iterate then never feeds back, and the whole OSQP
    iteration collapses onto the pre-clip constraint-space point
    ``v = z_relaxed + y/ρ`` (``z = clip(v, l, u)``, ``y = ρ(v − z)`` are
    recovered views): two GEMMs per iteration (contractions of size m and n
    against ``G2 = Ā·W``) instead of four — the (n, n) spectral-basis
    products appear only at stage boundaries and in the final unscale.

    Per-lane continuous adaptive ρ: each lane carries a scalar ``s`` moved
    every ``check_every`` iterations by its own primal/dual residual ratio
    (OSQP rule with ×5 hysteresis); the spectral form evaluates every lane's
    ``K(s)⁻¹`` with two shared GEMMs. ``refine=True`` (default) adds one
    iterative-refinement pass per x-solve, which the f32 eigenbasis needs to
    reach default tolerances on ill-conditioned lanes (see
    :func:`factor_shared_qp`). ``refine=False`` is the throughput path: two
    GEMMs per iteration instead of six (residuals floor ~1e-6 relative;
    warm-started fleets converge fully).

    ``polish_iters > 0`` appends a ρ-continuation dual polish: a final stage
    of that many iterations at ``s·polish_scale``. In f32 the dual iterate's
    update granularity is ``ρ·eps(|z|)`` — at the large adapted ``s`` the
    main loop settles on, y oscillates at ~1e-4 absolute and the dual
    residual floors there even though x/z are fully converged. A short
    low-ρ tail (x already optimal, so primal holds) lets y settle with
    ~100× finer granularity; measured on the horizon-8 DCM transcription it
    moves the dual floor 7e-4 → 5e-5 for 25 extra iterations.
    """
    f = factors
    n, m = f.P_s.shape[-1], f.A_s.shape[-2]
    dtype = f.P_s.dtype
    q = jnp.asarray(q)
    l, u = jnp.asarray(l), jnp.asarray(u)
    q_orig = q
    batch = jnp.broadcast_shapes(q.shape[:-1], l.shape[:-1], u.shape[:-1])

    A, P = f.A_s, f.P_s
    sigma = f.sigma
    q = f.c * (q * f.D)
    l, u = f.E * l, f.E * u
    if x0 is not None:
        x0 = x0 / f.D
    if y0 is not None:
        y0 = f.c * y0 / f.E

    # per-lane warm ρ state first: the v-space init depends on ρ(s)
    s = jnp.broadcast_to(
        jnp.ones((1,), dtype) if s0 is None else jnp.asarray(s0, dtype),
        batch + (1,),
    )
    x_init = jnp.broadcast_to(q * 0 if x0 is None else x0 + q * 0, batch + (n,))
    z = _einsum("mn,...n->...m", A, x_init)
    z = jnp.broadcast_to(z, batch + (m,))
    y = jnp.broadcast_to(z * 0 if y0 is None else y0 + z * 0, batch + (m,))
    # merge the batch operands' varying mesh axes into the carry init so the
    # stage scan type-checks under shard_map (vma typing)
    s = s + 0.0 * (x_init[..., :1] + z[..., :1] + y[..., :1])

    lb = jnp.broadcast_to(l, batch + (m,))
    ub = jnp.broadcast_to(u, batch + (m,))
    qb = jnp.broadcast_to(q, batch + (n,))

    G2 = f.G2 if f.G2 is not None else A @ f.W
    gq = _einsum("...n,nk->...k", qb, f.W)   # q·W — constant across stages

    # v-space iterate: v = z + y/ρ, so z = clip(v, l, u) and y = ρ(v − z)
    # are recovered views. Warm starts from a previous solve satisfy the
    # complementarity this encodes; otherwise iteration 1 re-projects.
    v = z + y / (s * f.base_rho)
    # aux primal carry: spectral τ (x̃ = τ·Wᵀ) on the fast path, materialized
    # x̃ when refining. Neither feeds back into the v recursion, so 0 is an
    # exact init (overwritten on the first iteration).
    tau = jnp.zeros_like(x_init)

    def _x_of(tau):
        return tau if refine else _einsum("...k,nk->...n", tau, f.W)

    def _Ax_of(tau):
        return (_einsum("...n,mn->...m", tau, A) if refine
                else _einsum("...n,nm->...m", tau, G2.T))

    def run_stage(v, tau, s, iters):
        rho_lane = s * f.base_rho                          # (batch, m)
        dinv = 1.0 / (1.0 + s * f.d)                       # (batch, n)

        def body(carry, _):
            v, tau = carry
            z = jnp.clip(v, lb, ub)
            w = rho_lane * (2.0 * z - v)
            t = _einsum("...m,mn->...n", w, G2) - gq       # = rhs·W
            if refine:
                # accuracy path: materialize x̃, one iterative-refinement
                # pass against K(s) = P̄ + σI + s·R2 through the eigenbasis
                x1 = _einsum("...k,nk->...n", t * dinv, f.W)
                Kx1 = (_einsum("...n,nk->...k", x1, P) + sigma * x1
                       + s * _einsum("...n,nk->...k", x1, f.R2))
                rhs = _einsum("...m,mn->...n", w, A) - qb
                t2 = _einsum("...n,nk->...k", rhs - Kx1, f.W) * dinv
                x_t = x1 + _einsum("...k,nk->...n", t2, f.W)
                v_next = v + alpha * (_einsum("...n,mn->...m", x_t, A) - z)
                return (v_next, x_t), None
            tau_next = t * dinv                            # x̃ = τ·Wᵀ
            v_next = v + alpha * (
                _einsum("...n,nm->...m", tau_next, G2.T) - z
            )
            return (v_next, tau_next), None

        (v, tau), _ = jax.lax.scan(
            body, (v, tau), None, length=iters, unroll=unroll
        )
        return v, tau

    check_every = max(1, min(check_every, iterations))
    n_stages = max(1, -(-iterations // check_every))

    def stage(carry, _):
        v, tau, s = carry
        v, tau = run_stage(v, tau, s, check_every)
        z = jnp.clip(v, lb, ub)
        y = (s * f.base_rho) * (v - z)
        x = _x_of(tau)
        Ax = _Ax_of(tau)
        Px_ = _einsum("...m,nm->...n", x, P)
        Aty_ = _einsum("...m,nm->...n", y, A.T)
        rp = jnp.max(jnp.abs(Ax - z), axis=-1) / jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(Ax), -1), jnp.max(jnp.abs(z), -1)),
            1e-12,
        )
        rd = jnp.max(jnp.abs(Px_ + qb + Aty_), axis=-1) / jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(Px_), -1),
                        jnp.maximum(jnp.max(jnp.abs(Aty_), -1),
                                    jnp.max(jnp.abs(qb), -1))), 1e-12
        )
        # OSQP per-lane ρ rule with hysteresis: move by the residual ratio
        # only when it leaves [1/5, 5] (continuous s — no ladder quantization)
        ratio = jnp.sqrt(rp / jnp.maximum(rd, 1e-12))[..., None]
        move = (ratio > 5.0) | (ratio < 0.2)
        s_new = jnp.where(move, jnp.clip(s * ratio, s_min, s_max), s)
        # ρ changed ⇒ re-express v so the recovered (z, y) views are
        # invariant: ρ_old(v_old − z) = y = ρ_new(v_new − z)
        v = z + (s / s_new) * (v - z)
        return (v, tau, s_new), None

    (v, tau, s), _ = jax.lax.scan(
        stage, (v, tau, s), None, length=n_stages
    )

    def _finish(v, tau, rho_lane):
        """Recover (x, z, y), unscale, diagnose in the ORIGINAL problem."""
        x = _x_of(tau)
        z = jnp.clip(v, lb, ub)
        y = rho_lane * (v - z)
        x = f.D * x
        y = f.E * y / f.c
        z = z / f.E
        Ax = _einsum("...n,mn->...m", x, f.A_orig)
        r_prim = jnp.max(jnp.abs(Ax - z), axis=-1)
        Px = _einsum("...m,nm->...n", x, f.P_orig)
        Aty = _einsum("...m,mn->...n", y, f.A_orig)
        r_dual = jnp.max(jnp.abs(Px + q_orig + Aty), axis=-1)
        prim_tol = eps_abs + eps_rel * jnp.maximum(
            jnp.max(jnp.abs(Ax), axis=-1), jnp.max(jnp.abs(z), axis=-1)
        )
        dual_tol = eps_abs + eps_rel * jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(Px), axis=-1),
                        jnp.max(jnp.abs(Aty), axis=-1)),
            jnp.max(jnp.abs(q_orig), axis=-1),
        )
        return x, z, y, r_prim, r_dual, prim_tol, dual_tol, Px

    cand = _finish(v, tau, s * f.base_rho)
    if polish_iters > 0:
        # ρ-continuation dual polish (see docstring): y's granularity ∝ s, so
        # a short low-s tail lets the duals settle on converged lanes; lanes
        # still far from their fixed point can be pushed AWAY by low-ρ
        # iterations, so the polish is accepted per lane only where it
        # lowered the tolerance-normalized residual score (the original-frame
        # metric of the convergence flag). s itself is NOT polished — the
        # warm-start s for the next receding-horizon tick stays at the
        # adapted operating point.
        s_pol = jnp.clip(s * jnp.asarray(polish_scale, dtype), s_min, s_max)
        z = jnp.clip(v, lb, ub)
        v_p = z + (s / s_pol) * (v - z)
        v_p, tau_p = run_stage(v_p, tau, s_pol, polish_iters)
        pol = _finish(v_p, tau_p, s_pol * f.base_rho)
        score = lambda d: jnp.maximum(d[3] / d[5], d[4] / d[6])
        better = score(pol) < score(cand)
        pick = lambda a, b: jnp.where(
            better.reshape(better.shape + (1,) * (a.ndim - better.ndim)),
            b, a)
        cand = tuple(pick(a, b) for a, b in zip(cand, pol))

    x, z, y, r_prim, r_dual, prim_tol, dual_tol, Px = cand
    converged = (r_prim < prim_tol) & (r_dual < dual_tol)
    objective = 0.5 * jnp.sum(x * Px, axis=-1) + jnp.sum(q_orig * x, axis=-1)
    return QPSolution(x, y, z, r_prim, r_dual, converged, objective,
                      rho_scale=s, refined=jnp.asarray(refine))


def shard_factors_rows(f: SharedQPFactors, index, num_shards: int):
    """Row-block ``index`` of ``num_shards`` of a :class:`SharedQPFactors`.

    Slices every m-indexed member (constraint rows); n-indexed members are
    replicated. ``m`` must divide evenly — pad the transcription with
    vacuous rows (``±inf`` bounds, zero A row) if it doesn't.
    """
    m = f.A_s.shape[-2]
    if m % num_shards:
        raise ValueError(f"m={m} not divisible by {num_shards} row shards")
    blk = m // num_shards
    sl = lambda a: jax.lax.dynamic_slice_in_dim(a, index * blk, blk, axis=0)
    return f._replace(
        A_s=sl(f.A_s), A_orig=sl(f.A_orig), E=sl(f.E),
        base_rho=sl(f.base_rho), G2=sl(f.G2 if f.G2 is not None
                                       else f.A_s @ f.W),
    )


@_f32_matmuls
def solve_qp_factored_rowsharded(
    factors: SharedQPFactors,
    q: jnp.ndarray,
    l: jnp.ndarray,
    u: jnp.ndarray,
    *,
    axis_name: str,
    iterations: int = 200,
    alpha: float = 1.6,
    eps_abs: float = 1e-5,
    eps_rel: float = 1e-5,
    check_every: int = 25,
    s0: Optional[jnp.ndarray] = None,
    unroll: int = 1,
) -> QPSolution:
    """Tensor/model-parallel shared-factor ADMM: ONE solve's constraint
    rows sharded over a mesh axis (SURVEY.md §2.3 TP row).

    Call **inside** ``shard_map``: ``factors`` must be the LOCAL row block
    (:func:`shard_factors_rows`), ``l``/``u`` the matching ``(…, m_local)``
    slices; ``q`` is replicated. Per v-space iteration the only cross-device
    traffic is ONE ``psum`` of the ``(…, n)`` partial contraction
    ``w·G₂_local`` — the constraint-space iterates (z, y, v) never leave
    their shard, so a transcription wider than one device's memory runs
    across the axis at one (B, n)-collective per iteration of latency cost.
    Use when ``m`` (contact/constraint count × horizon) outgrows a single
    device; the single-device path is faster below that.

    Returns a :class:`QPSolution` whose ``x``/residuals/``converged`` are
    replicated across the axis and whose ``y``/``z`` are the local rows.
    """
    f = factors
    n = f.P_s.shape[-1]
    dtype = f.P_s.dtype
    q = jnp.asarray(q)
    l, u = jnp.asarray(l), jnp.asarray(u)
    q_orig = q
    m_loc = f.A_s.shape[-2]
    batch = jnp.broadcast_shapes(q.shape[:-1], l.shape[:-1], u.shape[:-1])

    A, P = f.A_s, f.P_s
    q = f.c * (q * f.D)
    l, u = f.E * l, f.E * u

    s = jnp.broadcast_to(
        jnp.ones((1,), dtype) if s0 is None else jnp.asarray(s0, dtype),
        batch + (1,),
    )
    lb = jnp.broadcast_to(l, batch + (m_loc,))
    ub = jnp.broadcast_to(u, batch + (m_loc,))
    qb = jnp.broadcast_to(q, batch + (n,))
    G2 = f.G2
    gq = _einsum("...n,nk->...k", qb, f.W)

    # cold start in v-space (x=0 ⇒ z=0, y=0 ⇒ v=0); warm starts would need
    # row-sharded y/z plumbing — out of scope for the TP path
    v = jnp.zeros(batch + (m_loc,), dtype) + 0.0 * (lb + ub) * 0.0
    v = jnp.where(jnp.isnan(v), 0.0, v)   # ±inf bounds → 0·inf
    tau = jnp.zeros(batch + (n,), dtype) + 0.0 * qb
    s = s + 0.0 * (v[..., :1] + tau[..., :1])

    def run_stage(v, tau, s, iters):
        rho_lane = s * f.base_rho                           # (…, m_local)
        dinv = 1.0 / (1.0 + s * f.d)                        # (…, n)

        def body(carry, _):
            v, tau = carry
            z = jnp.clip(v, lb, ub)
            w = rho_lane * (2.0 * z - v)
            t_part = _einsum("...m,mn->...n", w, G2)
            t = jax.lax.psum(t_part, axis_name) - gq        # the ONE collective
            tau_next = t * dinv
            v_next = v + alpha * (
                _einsum("...n,nm->...m", tau_next, G2.T) - z
            )
            return (v_next, tau_next), None

        (v, tau), _ = jax.lax.scan(body, (v, tau), None, length=iters,
                                   unroll=unroll)
        return v, tau

    check_every = max(1, min(check_every, iterations))
    n_stages = max(1, -(-iterations // check_every))

    def stage(carry, _):
        v, tau, s = carry
        v, tau = run_stage(v, tau, s, check_every)
        z = jnp.clip(v, lb, ub)
        y = (s * f.base_rho) * (v - z)
        x = _einsum("...k,nk->...n", tau, f.W)
        Ax = _einsum("...n,nm->...m", tau, G2.T)
        Px_ = _einsum("...m,nm->...n", x, P)
        Aty_ = jax.lax.psum(_einsum("...m,nm->...n", y, A.T), axis_name)
        pmax = lambda a: jax.lax.pmax(a, axis_name)
        rp = pmax(jnp.max(jnp.abs(Ax - z), axis=-1)) / jnp.maximum(
            pmax(jnp.maximum(jnp.max(jnp.abs(Ax), -1),
                             jnp.max(jnp.abs(z), -1))), 1e-12)
        rd = jnp.max(jnp.abs(Px_ + qb + Aty_), axis=-1) / jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(Px_), -1),
                        jnp.maximum(jnp.max(jnp.abs(Aty_), -1),
                                    jnp.max(jnp.abs(qb), -1))), 1e-12)
        ratio = jnp.sqrt(rp / jnp.maximum(rd, 1e-12))[..., None]
        move = (ratio > 5.0) | (ratio < 0.2)
        s_new = jnp.where(move, jnp.clip(ratio * s, 1e-4, 1e4), s)
        v = z + (s / s_new) * (v - z)
        return (v, tau, s_new), None

    (v, tau, s), _ = jax.lax.scan(stage, (v, tau, s), None, length=n_stages)

    x = _einsum("...k,nk->...n", tau, f.W)
    z = jnp.clip(v, lb, ub)
    y = (s * f.base_rho) * (v - z)

    x = f.D * x
    y = f.E * y / f.c
    z = z / f.E
    Ax = _einsum("...n,mn->...m", x, f.A_orig)
    pmax = lambda a: jax.lax.pmax(a, axis_name)
    r_prim = pmax(jnp.max(jnp.abs(Ax - z), axis=-1))
    Px = _einsum("...m,nm->...n", x, f.P_orig)
    Aty = jax.lax.psum(_einsum("...m,mn->...n", y, f.A_orig), axis_name)
    r_dual = jnp.max(jnp.abs(Px + q_orig + Aty), axis=-1)
    prim_tol = eps_abs + eps_rel * pmax(jnp.maximum(
        jnp.max(jnp.abs(Ax), axis=-1), jnp.max(jnp.abs(z), axis=-1)))
    dual_tol = eps_abs + eps_rel * jnp.maximum(
        jnp.maximum(jnp.max(jnp.abs(Px), axis=-1),
                    jnp.max(jnp.abs(Aty), axis=-1)),
        jnp.max(jnp.abs(q_orig), axis=-1),
    )
    converged = (r_prim < prim_tol) & (r_dual < dual_tol)
    objective = 0.5 * jnp.sum(x * Px, axis=-1) + jnp.sum(q_orig * x, axis=-1)
    return QPSolution(x, y, z, r_prim, r_dual, converged, objective,
                      rho_scale=s, refined=jnp.asarray(False))
