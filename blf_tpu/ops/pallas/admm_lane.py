"""Fused per-lane ADMM stage — Pallas kernel on the Triton route.

The whole-body QP of the control stack (BASELINE config 4) gives every lane
its OWN cost and constraint matrices (its own mass matrix and contact
Jacobians — reference dynamics ``FloatingBaseSystemDynamics.cpp:102-251``),
so there is no shared GEMM to batch. XLA runs each ADMM iteration of that
shape as several launches of small batched matvecs, re-reading every lane's
operators from device memory each time.

This kernel runs all iterations of one stage of the v-space ADMM recursion

    z  = clip(v, l, u)
    w  = ρ ⊙ (2z − v)                      ( = ρz − y )
    x̃  = K⁻¹ (Aᵀw − q)                     (K = P + σI + AᵀρA, prefactored)
    v += α (A x̃ − z)

in ONE launch, one program per lane: the lane's ``A`` (rows padded to a
power of two, 128 for the WBC's m≈86 × n=64) and ``K⁻¹`` (64×64) — about
48 KB in f32 — are loaded once and stay on the SM (registers / shared
memory) for every iteration. The matvecs are f32 broadcast-multiplies plus
reductions, never ``dot``: no tensor-core (TF32) products, so the fixed
point matches the XLA v-space recursion to f32 rounding.

Platforms: the kernel is compiled for the GPU (``backend="triton"``) and
runs in Pallas interpret mode on the CPU, where the test suite checks it;
lowering for any other platform raises.

The consuming solver (``blf_tpu.mpc.qp.solve_qp`` with
``backend="pallas"``) inverts K once per stage with
:func:`blf_tpu.ops.linalg.spd_inverse` and runs stage-boundary ρ adaptation
and diagnostics in XLA.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

__all__ = ["admm_lane_stage", "admm_lane_stage_reference"]

#: warps per lane program (one lane's operators spread over 4 × 32 threads)
NUM_WARPS = 4


def _lane_kernel(v_ref, rho_ref, A_ref, Kinv_ref, q_ref, l_ref, u_ref,
                 v_out, x_out, *, iters: int, alpha: float):
    """One ADMM stage for one lane; A_ref (m, n), Kinv_ref (n, n)."""
    A = A_ref[...]
    Kinv = Kinv_ref[...]
    rho, q, l, u = rho_ref[...], q_ref[...], l_ref[...], u_ref[...]

    def body(_, carry):
        v, _ = carry
        z = jnp.minimum(jnp.maximum(v, l), u)
        w = rho * (2.0 * z - v)
        rhs = jnp.sum(A * w[:, None], axis=0) - q            # Aᵀw − q
        x = jnp.sum(Kinv * rhs[None, :], axis=1)             # K⁻¹ rhs
        ax = jnp.sum(A * x[None, :], axis=1)                 # A x̃
        return v + alpha * (ax - z), x

    v, x = jax.lax.fori_loop(0, iters, body, (v_ref[...], jnp.zeros_like(q)))
    v_out[...] = v
    x_out[...] = x


def _pow2(k: int) -> int:
    return 1 << max(0, (k - 1).bit_length())


def _stage_call(v, rho, A, Kinv, q, l, u, *, iters, alpha, interpret):
    B, m = v.shape
    n = q.shape[-1]
    vec = lambda r: pl.BlockSpec((None, r), lambda b: (b, 0))
    mat = lambda r, c: pl.BlockSpec((None, r, c), lambda b: (b, 0, 0))
    return pl.pallas_call(
        functools.partial(_lane_kernel, iters=iters, alpha=alpha),
        grid=(B,),
        in_specs=[vec(m), vec(m), mat(m, n), mat(n, n), vec(n), vec(m),
                  vec(m)],
        out_specs=[vec(m), vec(n)],
        out_shape=[jax.ShapeDtypeStruct((B, m), v.dtype),
                   jax.ShapeDtypeStruct((B, n), v.dtype)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="admm_lane_stage",
    )(v, rho, A, Kinv, q, l, u)


@functools.partial(jax.jit, static_argnames=("iters", "alpha"))
def admm_lane_stage(
    v: jnp.ndarray,         # (B, m) pre-clip constraint-space iterate
    rho: jnp.ndarray,       # (B, m) per-lane penalty vector (s ⊙ base_rho)
    A: jnp.ndarray,         # (B, m, n) per-lane constraints (scaled frame)
    Kinv: jnp.ndarray,      # (B, n, n) per-lane KKT inverse at this ρ
    q: jnp.ndarray,         # (B, n) per-lane linear cost (scaled frame)
    l: jnp.ndarray,         # (B, m)
    u: jnp.ndarray,         # (B, m)
    *,
    iters: int,
    alpha: float = 1.6,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run ``iters`` fused per-lane v-space ADMM iterations; returns (v, x̃).

    ``m`` and ``n`` are padded to powers of two internally (padded rows have
    ``A = 0``, ``l = u = 0``, so their iterate stays 0; padded columns have
    ``K⁻¹ = 0``, so their primal stays 0). ±inf bounds are fine. The
    returned x̃ is the last iteration's primal in the scaled frame (z, y are
    recoverable views: ``z = clip(v, l, u)``, ``y = ρ(v − z)``).
    """
    B, m = v.shape
    n = q.shape[-1]
    mp, np_ = _pow2(m), _pow2(n)
    if (mp, np_) != (m, n):
        rows = lambda a, c=0.0: jnp.pad(a, ((0, 0), (0, mp - m)),
                                        constant_values=c)
        cols = lambda a: jnp.pad(a, ((0, 0), (0, np_ - n)))
        v, l, u = rows(v), rows(l), rows(u)
        rho = rows(rho, 1.0)
        q = cols(q)
        A = jnp.pad(A, ((0, 0), (0, mp - m), (0, np_ - n)))
        Kinv = jnp.pad(Kinv, ((0, 0), (0, np_ - n), (0, np_ - n)))
    call = functools.partial(_stage_call, iters=iters, alpha=float(alpha))
    v_out, x_out = jax.lax.platform_dependent(
        v, rho, A, Kinv, q, l, u,
        cpu=functools.partial(call, interpret=True),
        cuda=functools.partial(call, interpret=False),
    )
    return v_out[:, :m], x_out[:, :n]


def admm_lane_stage_reference(v, rho, A, Kinv, q, l, u, *, iters: int,
                              alpha: float = 1.6):
    """Plain XLA version of :func:`admm_lane_stage` (same recursion, batched
    f32 matvecs at ``Precision.HIGHEST``) — the kernel's test reference."""
    mv = lambda spec, a, b: jnp.einsum(spec, a, b,
                                       precision=jax.lax.Precision.HIGHEST)

    def body(_, carry):
        v, _ = carry
        z = jnp.clip(v, l, u)
        w = rho * (2.0 * z - v)
        x = mv("bij,bj->bi", Kinv, mv("bmn,bm->bn", A, w) - q)
        return v + alpha * (mv("bmn,bn->bm", A, x) - z), x

    return jax.lax.fori_loop(0, iters, body, (v, jnp.zeros_like(q)))
