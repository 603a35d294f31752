"""Unrolled small-PSD linear algebra (blf_tpu.ops.linalg).

Pins the unrolled batched Cholesky/solve paths to jnp.linalg ground truth —
the estimator stack (and any future small-system consumer) relies on these
being bit-close while emitting zero linalg custom calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import tol
from blf_tpu.ops.linalg import cholesky_small, solve_psd, solve_psd_small


def _random_psd(rng, batch, m, jitter=0.1):
    A = rng.normal(size=batch + (m, m))
    S = A @ np.swapaxes(A, -1, -2) + jitter * np.eye(m)
    return jnp.asarray(S)


class TestCholeskySmall:
    @pytest.mark.parametrize("m", [1, 2, 3, 5, 8])
    def test_matches_jnp_cholesky(self, m):
        rng = np.random.default_rng(m)
        S = _random_psd(rng, (7,), m)
        L = cholesky_small(S)
        np.testing.assert_allclose(L, jnp.linalg.cholesky(S),
                                   rtol=tol(1e-10, 1e-4), atol=tol(1e-12, 1e-5))

    def test_strict_upper_triangle_zero(self):
        rng = np.random.default_rng(0)
        S = _random_psd(rng, (4,), 4)
        L = np.asarray(cholesky_small(S))
        assert np.all(L[..., np.triu_indices(4, k=1)[0],
                        np.triu_indices(4, k=1)[1]] == 0.0)

    def test_eps_floors_degenerate_pivot(self):
        S = jnp.zeros((2, 2))
        L = cholesky_small(S, eps=1e-12)
        assert bool(jnp.all(jnp.isfinite(L)))


class TestSolvePsd:
    @pytest.mark.parametrize("m,k", [(2, 3), (3, 1), (6, 6)])
    def test_matches_jnp_solve_matrix_rhs(self, m, k):
        rng = np.random.default_rng(m * 10 + k)
        S = _random_psd(rng, (5, 4), m)
        B = jnp.asarray(rng.normal(size=(5, 4, m, k)))
        np.testing.assert_allclose(solve_psd_small(S, B),
                                   jnp.linalg.solve(S, B),
                                   rtol=tol(1e-8, 1e-4), atol=tol(1e-10, 1e-5))

    def test_vector_rhs_shape(self):
        rng = np.random.default_rng(1)
        S = _random_psd(rng, (9,), 3)
        b = jnp.asarray(rng.normal(size=(9, 3)))
        x = solve_psd_small(S, b)
        assert x.shape == (9, 3)
        np.testing.assert_allclose(
            jnp.einsum("bij,bj->bi", S, x), b, rtol=tol(1e-8, 1e-4), atol=tol(1e-10, 1e-5))

    def test_dispatch_large_m_falls_back(self):
        rng = np.random.default_rng(2)
        S = _random_psd(rng, (), 16)
        B = jnp.asarray(rng.normal(size=(16, 2)))
        np.testing.assert_allclose(solve_psd(S, B), jnp.linalg.solve(S, B),
                                   rtol=tol(1e-8, 1e-4), atol=tol(1e-10, 1e-5))

    def test_jit_and_vmap_compose(self):
        rng = np.random.default_rng(3)
        S = _random_psd(rng, (64,), 2)
        b = jnp.asarray(rng.normal(size=(64, 2)))
        x = jax.jit(jax.vmap(solve_psd))(S, b)
        np.testing.assert_allclose(
            jnp.einsum("bij,bj->bi", S, x), b, rtol=tol(1e-6, 1e-4), atol=tol(1e-8, 1e-5))

    def test_grad_flows(self):
        rng = np.random.default_rng(4)
        S = _random_psd(rng, (), 2)
        b = jnp.asarray(rng.normal(size=(2,)))

        g = jax.grad(lambda bb: solve_psd_small(S, bb).sum())(b)
        g_ref = jax.grad(lambda bb: jnp.linalg.solve(S, bb[:, None]).sum())(b)
        np.testing.assert_allclose(g, g_ref, rtol=tol(1e-8, 1e-4), atol=tol(1e-10, 1e-5))


class TestRLSUsesFastPath:
    def test_rls_step_unchanged_numerics(self):
        """rls_step numerics must be identical (to fp) after the swap."""
        from blf_tpu.estimators.rls import RLSParams, RLSState, rls_step

        rng = np.random.default_rng(5)
        p, m, B = 3, 2, 17
        params = RLSParams(jnp.asarray(0.97),
                           jnp.asarray(0.1 * np.eye(m)))
        theta = jnp.asarray(rng.normal(size=(B, p)))
        cov = _random_psd(rng, (B,), p)
        A = jnp.asarray(rng.normal(size=(B, m, p)))
        y = jnp.asarray(rng.normal(size=(B, m)))
        out = rls_step(params, RLSState(theta, cov), A, y)

        # ground truth with explicit dense inverse (the reference's form)
        S = 0.97 * np.asarray(params.measurement_covariance) + \
            np.asarray(A) @ np.asarray(cov) @ np.swapaxes(np.asarray(A), -1, -2)
        K = np.asarray(cov) @ np.swapaxes(np.asarray(A), -1, -2) @ np.linalg.inv(S)
        innov = np.asarray(y) - np.einsum("bmp,bp->bm", np.asarray(A),
                                          np.asarray(theta))
        theta_ref = np.asarray(theta) + np.einsum("bpm,bm->bp", K, innov)
        np.testing.assert_allclose(out.theta, theta_ref, rtol=tol(1e-8, 1e-4), atol=tol(1e-10, 1e-5))
