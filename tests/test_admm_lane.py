"""Fused per-lane ADMM stage kernel (blf_tpu.ops.pallas.admm_lane).

Pallas interpret mode on CPU runs the kernel source that is compiled for the
GPU through Triton; the plain reference is the same recursion as batched
XLA matvecs. Row/column padding to powers of two, per-lane isolation and the
platform rule are checked here; the compiled kernel is checked on the card
by the ``gpu``-marked test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blf_tpu.ops.pallas.admm_lane import (
    admm_lane_stage,
    admm_lane_stage_reference,
)


def lane_problem(B=3, m=18, n=12, seed=0, dtype=np.float32):
    """A stage's inputs: per-lane A, a contractive K⁻¹, bounds with an
    equality row and a one-sided (±inf) row."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, n)) * 0.3
    rho = np.abs(rng.normal(size=(B, m))) + 0.5
    K = (np.eye(n) + np.einsum("bmi,bm,bmj->bij", A, rho, A))
    Kinv = np.linalg.inv(K)
    q = rng.normal(size=(B, n))
    v = rng.normal(size=(B, m)) * 0.1
    l = -np.abs(rng.normal(size=(B, m)))
    u = np.abs(rng.normal(size=(B, m)))
    l[:, 0] = u[:, 0] = 0.2
    l[:, 1] = -np.inf
    return tuple(jnp.asarray(a, dtype)
                 for a in (v, rho, A, Kinv, q, l, u))


@pytest.mark.parametrize("m,n", [(16, 8), (18, 12), (86, 64)])
def test_kernel_matches_reference(m, n):
    """Aligned (16, 8), padded rows and columns (18, 12) and the WBC shape
    (86 → 128 rows, 64 columns)."""
    args = lane_problem(B=3, m=m, n=n)
    v, x = admm_lane_stage(*args, iters=20)
    v_ref, x_ref = admm_lane_stage_reference(*args, iters=20)
    assert v.shape == (3, m) and x.shape == (3, n)
    np.testing.assert_allclose(np.asarray(v), np.asarray(v_ref),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref),
                               rtol=1e-4, atol=1e-5)


def test_nan_lane_stays_local():
    """One program per lane: a poisoned lane leaves its neighbours exact."""
    v, rho, A, Kinv, q, l, u = lane_problem(B=4)
    A = A.at[2].set(jnp.nan)
    out, _ = admm_lane_stage(v, rho, A, Kinv, q, l, u, iters=10)
    ref, _ = admm_lane_stage_reference(v, rho, A, Kinv, q, l, u, iters=10)
    assert np.all(np.isnan(np.asarray(out[2])))
    keep = np.array([0, 1, 3])
    np.testing.assert_allclose(np.asarray(out)[keep], np.asarray(ref)[keep],
                               rtol=1e-4, atol=1e-5)


def test_unsupported_platform_raises():
    """Compiled for the GPU, interpreted on the CPU, refused elsewhere."""
    args = lane_problem(B=2)
    lowered = jax.jit(lambda *a: admm_lane_stage(*a, iters=3)).trace(*args)
    assert lowered.lower(lowering_platforms=("cuda",)) is not None
    with pytest.raises(NotImplementedError):
        lowered.lower(lowering_platforms=("rocm",))


@pytest.mark.gpu
def test_compiled_kernel_matches_reference_on_gpu(gpu):
    """The kernel as compiled for the card, at the WBC shape and batch."""
    with jax.default_device(gpu):
        args = lane_problem(B=512, m=86, n=64)
        v, x = admm_lane_stage(*args, iters=150)
        v_ref, x_ref = admm_lane_stage_reference(*args, iters=150)
        np.testing.assert_allclose(np.asarray(v), np.asarray(v_ref),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(x), np.asarray(x_ref),
                                   rtol=1e-4, atol=1e-5)
