"""Shared-factor fleet solve (solve_qp_factored) — the config-5 hot path.

The fleet tick runs the two-GEMM v-space iteration (``refine=False``); the
refined path is the accuracy default. Both run the same spectral per-lane-ρ
stage in XLA at ``Precision.HIGHEST``.
"""

import jax.numpy as jnp
import numpy as np

from blf_tpu.models.lipm import LIPMParams
from blf_tpu.mpc.dcm import build_dcm_qp
from blf_tpu.mpc.qp import factor_shared_qp, solve_qp_factored, solve_qp_shared

N = 16
DTYPE = jnp.float32


def fleet_problem(B=256):
    params = LIPMParams(jnp.asarray(0.9, DTYPE), jnp.asarray(9.81, DTYPE))
    stance = jnp.zeros(2, DTYPE)
    zr = jnp.broadcast_to(stance, (N, 2))
    dr = jnp.broadcast_to(stance, (N + 1, 2))
    pA = jnp.tile(
        jnp.asarray([[1.0, 0], [-1.0, 0], [0, 1.0], [0, -1.0]], DTYPE),
        (N, 1, 1),
    )
    pb = jnp.broadcast_to(jnp.asarray([0.1, 0.1, 0.06, 0.06], DTYPE), (N, 4))
    rng = np.random.default_rng(0)
    dcm0s = jnp.asarray(rng.normal(0, 0.02, (B, 2)), DTYPE)
    return build_dcm_qp(params, 0.1, dcm0s, dr, zr, pA, pb)


def test_unrefined_solution_quality():
    """The fleet tick's two-GEMM iteration (no refinement pass) holds the
    1e-4 contract against the refined default on the same lanes."""
    P, q, A, l, u = fleet_problem()
    eps = dict(eps_abs=1e-4, eps_rel=1e-4)
    ref = solve_qp_shared(P, q, A, l, u, iterations=150, **eps)
    fast = solve_qp_shared(P, q, A, l, u, iterations=150, refine=False,
                           **eps)
    assert bool(ref.refined) and not bool(fast.refined)
    assert int(fast.converged.sum()) >= int(ref.converged.sum()) - 25
    both = np.asarray(fast.converged & ref.converged)
    np.testing.assert_allclose(np.asarray(fast.x)[both],
                               np.asarray(ref.x)[both], atol=5e-4)


def test_warm_start_floor():
    """The production pattern (warm-started receding-horizon resolve):
    starting from a solved fixed point, 50 unrefined iterations stay there."""
    P, q, A, l, u = fleet_problem()
    ref = solve_qp_shared(P, q, A, l, u, iterations=200, refine=False)
    warm = solve_qp_shared(P, q, A, l, u, iterations=50, refine=False,
                           x0=ref.x, y0=ref.y, s0=ref.rho_scale)
    conv = np.asarray(ref.converged)
    assert conv.sum() >= 250
    np.testing.assert_allclose(np.asarray(warm.x)[conv],
                               np.asarray(ref.x)[conv], atol=2e-5)
    assert int(warm.converged[conv].sum()) >= int(conv.sum()) - 2


def test_unaligned_batch():
    """Any batch size runs: no lane-block alignment on the XLA path."""
    P, q, A, l, u = fleet_problem(B=100)
    s = solve_qp_shared(P, q, A, l, u, iterations=50, refine=False)
    assert s.x.shape == (100, 4 * N)
    assert s.rho_scale.shape == (100, 1)
    assert np.all(np.isfinite(np.asarray(s.x)))


def test_factored_api_reuses_factors():
    """factor once, solve many — the tick-loop shape."""
    P, q, A, l, u = fleet_problem(B=256)
    is_eq = jnp.all((u - l) < 1e-12, axis=0)
    f = factor_shared_qp(P, A, is_eq)
    s1 = solve_qp_factored(f, q, l, u, iterations=100)
    s2 = solve_qp_shared(P, q, A, l, u, iterations=100)
    np.testing.assert_allclose(np.asarray(s1.x), np.asarray(s2.x),
                               atol=1e-12)
    # warm start (primal, dual, AND adapted ρ) from the previous solve
    # converges at least as well in half the iterations
    s3 = solve_qp_factored(f, q, l, u, iterations=50,
                           x0=s1.x, y0=s1.y, s0=s1.rho_scale)
    assert int(s3.converged.sum()) >= int(s1.converged.sum())
