"""Batched SPD inverse/solve of the fleet paths (blf_tpu.ops.linalg) vs
NumPy.

The stack inverts its per-tick mass matrices and per-stage WBC KKT matrices
with :func:`spd_inverse` and solves the (B, 6, 6) estimator normal
equations with the unrolled :func:`solve_psd_small`. The reference's
analogue is the dense LLT of the dynamics
(``FloatingBaseSystemDynamics.cpp:237-244``); these are the fleet version of
that solve.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from blf_tpu.ops.linalg import solve_psd, solve_psd_small, spd_inverse

from conftest import tol


def _spd(rng, B, n, dtype):
    K = rng.normal(size=(B, n, n)).astype(dtype) * 0.3
    return K @ np.swapaxes(K, -1, -2) + np.eye(n, dtype=dtype) * 2


@pytest.mark.parametrize("B,n", [(3, 5), (16, 35), (7, 64), (2, 1)])
def test_inverse_matches_numpy(B, n):
    rng = np.random.default_rng(0)
    K = _spd(rng, B, n, np.float32)
    Ki = np.asarray(spd_inverse(jnp.asarray(K)))
    ref = np.linalg.inv(K.astype(np.float64))
    assert np.max(np.abs(Ki - ref)) / np.max(np.abs(ref)) < 1e-5


@pytest.mark.parametrize("B,n", [(3, 5), (16, 6), (5, 8)])
def test_solve_matches_numpy(B, n):
    rng = np.random.default_rng(1)
    K = _spd(rng, B, n, np.float32)
    b = rng.normal(size=(B, n)).astype(np.float32)
    x = np.asarray(solve_psd_small(jnp.asarray(K), jnp.asarray(b)))
    ref = np.linalg.solve(K.astype(np.float64), b[..., None])[..., 0]
    assert np.max(np.abs(x - ref)) / np.max(np.abs(ref)) < 1e-5


def test_nan_lane_stays_local():
    """A poisoned lane must not contaminate its neighbours (per-lane status
    semantics, SURVEY.md §5)."""
    rng = np.random.default_rng(2)
    K = _spd(rng, 4, 8, np.float32)
    K[2] = np.nan
    Ki = np.asarray(spd_inverse(jnp.asarray(K)))
    assert np.all(np.isnan(Ki[2]))
    ref = np.linalg.inv(K[[0, 1, 3]])
    assert np.max(np.abs(Ki[[0, 1, 3]] - ref)) < 1e-4


def test_dispatch_helper_fallback():
    """solve_psd must give the unrolled and the library path the same
    answer, batched or unbatched."""
    rng = np.random.default_rng(3)
    K = _spd(rng, 6, 12, np.float32)
    b = rng.normal(size=(6, 12)).astype(np.float32)
    lib = np.asarray(solve_psd(jnp.asarray(K), jnp.asarray(b)))
    unrolled = np.asarray(solve_psd(jnp.asarray(K), jnp.asarray(b),
                                    max_unrolled=12))
    one = np.asarray(solve_psd(jnp.asarray(K[0]), jnp.asarray(b[0])))
    np.testing.assert_allclose(lib, unrolled, atol=1e-4)
    np.testing.assert_allclose(lib[0], one, atol=1e-4)


def test_f64_lane():
    """The solves run in the suite's default dtype lane too."""
    rng = np.random.default_rng(4)
    dtype = jnp.zeros(()).dtype  # honours jax_enable_x64
    K = _spd(rng, 3, 9, np.float32).astype(dtype)
    b = rng.normal(size=(3, 9)).astype(dtype)
    x = np.asarray(jnp.einsum("bij,bj->bi", spd_inverse(jnp.asarray(K)),
                              jnp.asarray(b), precision="highest"))
    ref = np.linalg.solve(np.asarray(K, np.float64),
                          np.asarray(b, np.float64)[..., None])[..., 0]
    assert np.max(np.abs(x - ref)) < tol(1e-9, 1e-4)
