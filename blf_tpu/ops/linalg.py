"""Batched small-matrix linear algebra.

- :func:`cholesky_small` / :func:`solve_psd_small` unroll Cholesky and the
  two triangular solves over a static small ``m`` (the innovation /
  measurement dimension — 2–8 in every framework use), vectorizing over
  arbitrary leading batch axes: a handful of fused elementwise ops per
  solve, no linalg library call and no data-dependent control flow, so safe
  inside ``jit``/``scan``/``shard_map`` on any backend.
- :func:`spd_inverse` inverts a batch of larger SPD matrices (the plant's
  per-tick mass matrix, 29×29; the whole-body QP's per-stage KKT matrix,
  64×64) through the batched factorization routines XLA calls on the
  device.

The reference solves the same systems with dense ``Eigen`` factorizations
on one matrix at a time (``RecursiveLeastSquare.cpp:120-123``,
``FloatingBaseSystemDynamics.cpp:237-244``); batching over scenarios is this
framework's redesign.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["cholesky_small", "solve_psd_small", "solve_psd", "spd_inverse"]

# Above this size the O(m³) unrolled op count stops paying for itself and
# XLA's custom call wins; every in-framework consumer is far below it.
MAX_UNROLLED = 8


def _chol_entries(S, eps: float):
    """Unrolled lower-Cholesky entries of PSD ``S`` (…, m, m) as a list of
    lists of (…,) arrays; ``eps`` regularizes the pivot sqrt."""
    m = S.shape[-1]
    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = S[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, eps))
            else:
                L[i][j] = s / L[j][j]
    return L


def cholesky_small(S: jnp.ndarray, *, eps: float = 0.0) -> jnp.ndarray:
    """Lower Cholesky factor of a batch of small PSD matrices, unrolled.

    ``S``: (…, m, m) with static ``m`` ≤ ~8. Matches
    ``jnp.linalg.cholesky`` (up to the ``eps`` pivot floor) without a
    linalg library call.
    """
    m = S.shape[-1]
    L = _chol_entries(S, eps)
    rows = []
    for i in range(m):
        entries = [L[i][j] if j <= i else jnp.zeros_like(S[..., 0, 0])
                   for j in range(m)]
        rows.append(jnp.stack(entries, axis=-1))
    return jnp.stack(rows, axis=-2)


def solve_psd_small(S: jnp.ndarray, B: jnp.ndarray, *,
                    eps: float = 0.0) -> jnp.ndarray:
    """``S⁻¹ B`` for batched small PSD ``S`` via unrolled Cholesky.

    ``S``: (…, m, m) with static small ``m``; ``B``: (…, m, k) or (…, m).
    Pure elementwise/broadcast ops — no linalg custom calls.
    """
    m = S.shape[-1]
    vec = B.ndim == S.ndim - 1
    if vec:
        B = B[..., None]
    L = _chol_entries(S, eps)
    # forward substitution L y = B
    y = []
    for i in range(m):
        acc = B[..., i, :]
        for k in range(i):
            acc = acc - L[i][k][..., None] * y[k]
        y.append(acc / L[i][i][..., None])
    # back substitution Lᵀ x = y
    x = [None] * m
    for i in reversed(range(m)):
        acc = y[i]
        for k in range(i + 1, m):
            acc = acc - L[k][i][..., None] * x[k]
        x[i] = acc / L[i][i][..., None]
    out = jnp.stack(x, axis=-2)
    return out[..., 0] if vec else out


def solve_psd(S: jnp.ndarray, B: jnp.ndarray, *, eps: float = 0.0,
              max_unrolled: int = MAX_UNROLLED) -> jnp.ndarray:
    """PSD solve that picks the unrolled path by static size.

    Small static ``m`` → :func:`solve_psd_small` (unrolled, batch-free);
    larger ``m`` → ``jnp.linalg.solve`` (library call, fine at sizes where
    compute dominates launch cost).
    """
    if S.shape[-1] <= max_unrolled:
        return solve_psd_small(S, B, eps=eps)
    if B.ndim == S.ndim - 1:                       # batched vector rhs
        return jnp.linalg.solve(S, B[..., None])[..., 0]
    return jnp.linalg.solve(S, B)


def spd_inverse(K: jnp.ndarray) -> jnp.ndarray:
    """Inverse of a batch of SPD matrices ``K`` (…, n, n).

    Batched Cholesky, then ``cho_solve`` against the identity. A lane whose
    matrix is not SPD (or holds NaN) comes back NaN without touching its
    neighbours — the callers' per-lane status and quarantine absorb it.
    """
    n = K.shape[-1]
    L = jnp.linalg.cholesky(K)
    eye = jnp.broadcast_to(jnp.eye(n, dtype=K.dtype), K.shape)
    return jax.scipy.linalg.cho_solve((L, True), eye)
