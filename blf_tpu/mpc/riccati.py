"""Riccati/LQR solvers: sequential scan + parallel-in-time associative scan.

The framework's "sequence parallelism" component (SURVEY.md §5 long-context
row): the reference has no sequence dimension at all — its integrator loops
time serially (``FixedStepIntegrator.tpp:48-61``) — and the structural
analogue of long-context parallelism here is the **MPC horizon**. This module
provides the linear-quadratic backbone both ways:

- :func:`solve_lqr` with ``parallel=False``: classic backward Riccati
  recursion as a ``lax.scan`` (O(T) depth, cache-friendly — the default);
- ``parallel=True``: the associative-scan formulation of Särkkä &
  García-Fernández ("Temporal Parallelization of Dynamic Programming and
  Linear Quadratic ..."), O(log T) depth — the building block for sharding a
  long horizon across a mesh axis (block exchange), enabled single-device
  first exactly as SURVEY.md §7 plans ("gate behind a flag; serial scan is
  the fallback");
- :func:`solve_lqr_sharded`: the horizon SHARDED over a mesh axis — each
  device scans its own contiguous time block, block summaries are exchanged
  with one ``all_gather`` (+ one ``ppermute`` halo for the next-knot values),
  and the O(P)-element cross-block prefix runs redundantly per device. This
  is the framework's ring-attention analogue: communication is two tiny
  collectives of (nx, nx) blocks per solve, independent of the local horizon
  length.

Problem: ``min Σ_k ½ xₖᵀQₖxₖ + ½ uₖᵀRₖuₖ  +  ½ x_TᵀQ_T x_T``
subject to ``x_{k+1} = Fₖ xₖ + Lₖ uₖ + cₖ``.

Both paths return identical feedback gains/value functions (tests assert it)
and the optimal trajectory from any ``x₀``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

__all__ = ["LQRSolution", "solve_lqr", "solve_lqr_sharded"]

_PREC = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC)


class LQRSolution(NamedTuple):
    gains: jnp.ndarray          # (T, nu, nx) feedback K_k (u = −K x − k_ff)
    feedforward: jnp.ndarray    # (T, nu)
    value_matrices: jnp.ndarray  # (T+1, nx, nx) Riccati P_k
    value_vectors: jnp.ndarray   # (T+1, nx) linear value terms p_k
    states: jnp.ndarray         # (T+1, nx) optimal rollout from x0
    controls: jnp.ndarray       # (T, nu)


def _sequential_value(Fs, cs, Ls, Qs, Rs, QT):
    """Backward Riccati via lax.scan: P_k, p_k for k = T..0."""
    nx = Fs.shape[-1]

    def step(carry, inputs):
        P, p = carry
        F, c, L, Q, R = inputs
        # u* = −(R + LᵀPL)⁻¹ Lᵀ(P(Fx + c) + p)
        H = R + _mm(L.T, _mm(P, L))
        G = _mm(L.T, _mm(P, F))
        g = _mm(L.T, (_mm(P, c[:, None])[:, 0] + p)[:, None])[:, 0]
        K = jnp.linalg.solve(H, G)
        kff = jnp.linalg.solve(H, g[:, None])[:, 0]
        FKL = F - _mm(L, K)
        P_new = Q + _mm(F.T, _mm(P, FKL))
        p_new = (
            _mm(FKL.T, (p + _mm(P, c[:, None])[:, 0])[:, None])[:, 0]
            - _mm(G.T, kff[:, None])[:, 0] * 0.0
        )
        # p_new: standard form p⁻ = Fᵀ(p + Pc) − Kᵀ(g) … keep the exact
        # derivation: p_new = FKLᵀ (P c + p)  (+ Q x_ref terms = 0 here)
        p_new = _mm(FKL.T, (_mm(P, c[:, None])[:, 0] + p)[:, None])[:, 0]
        return (P_new, p_new), (K, kff, P_new, p_new)

    (P0, p0), (Ks, kffs, Ps, ps) = jax.lax.scan(
        step, (QT, jnp.zeros((nx,), Fs.dtype)), (Fs, cs, Ls, Qs, Rs),
        reverse=True,
    )
    Ps = jnp.concatenate([Ps, QT[None]], axis=0)
    ps = jnp.concatenate([ps, jnp.zeros((1, nx), Fs.dtype)], axis=0)
    # scan with reverse=True returns ys in forward order; Ps[k] is the value
    # at knot k (after the backward update), terminal appended.
    return Ks, kffs, Ps, ps


def _value_elements(Fs, cs, Ls, Qs, Rs):
    """Per-interval Särkkä elements e = (A, b, C, η, J)."""
    nx = Fs.shape[-1]
    dtype = Fs.dtype
    Cs = jnp.einsum("kij,kjl,kml->kim", Ls, jnp.linalg.inv(Rs), Ls,
                    precision=_PREC)
    return (
        Fs,                                   # A
        cs,                                   # b
        Cs,                                   # C
        jnp.zeros((Fs.shape[0], nx), dtype),  # η
        Qs,                                   # J
    )


def _terminal_element(QT):
    nx = QT.shape[-1]
    dtype = QT.dtype
    return (
        jnp.zeros((nx, nx), dtype),
        jnp.zeros((nx,), dtype),
        jnp.zeros((nx, nx), dtype),
        jnp.zeros((nx,), dtype),
        QT,
    )


def _combine_value(e_ij, e_jk):
    """Compose two conditional-value elements, earlier (i→j) first.

    Associative; works on any matching leading batch dims.
    """
    A1, b1, C1, eta1, J1 = e_ij
    A2, b2, C2, eta2, J2 = e_jk
    eye = jnp.eye(A1.shape[-1], dtype=A1.dtype)
    I = jnp.broadcast_to(eye, A1.shape)
    D = jnp.linalg.inv(I + _mm(C1, J2))        # (…, nx, nx)
    Dt = jnp.linalg.inv(I + _mm(J2, C1))
    A = _mm(A2, _mm(D, A1))
    b = _mm(A2, _mm(D, (b1 + _mm(C1, eta2[..., None])[..., 0])[..., None])
            )[..., 0] + b2
    C = _mm(A2, _mm(D, _mm(C1, jnp.swapaxes(A2, -1, -2)))) + C2
    eta = _mm(
        jnp.swapaxes(A1, -1, -2),
        _mm(Dt, (eta2 - _mm(J2, b1[..., None])[..., 0])[..., None]),
    )[..., 0] + eta1
    J = _mm(jnp.swapaxes(A1, -1, -2), _mm(Dt, _mm(J2, A1))) + J1
    return (A, b, C, eta, J)


def _suffix_scan(elems):
    """Suffix combine along axis 0: out[k] = e_k ⊗ e_{k+1} ⊗ … ⊗ e_last.

    reverse=True flips, prefix-scans, flips back — so the binary op sees its
    arguments in (later, earlier) original-order; swap to keep combine's
    (e_ij, e_jk) convention.
    """
    return jax.lax.associative_scan(
        lambda a, b: _combine_value(b, a), elems, reverse=True, axis=0
    )


def _gains_one(F, c, L, R, P_next, p_next):
    """One-step argmin against V_{k+1}: feedback K and feedforward kff."""
    H = R + _mm(L.T, _mm(P_next, L))
    K = jnp.linalg.solve(H, _mm(L.T, _mm(P_next, F)))
    g = _mm(L.T, (_mm(P_next, c[:, None])[:, 0] + p_next)[:, None])[:, 0]
    kff = jnp.linalg.solve(H, g[:, None])[:, 0]
    return K, kff


def _parallel_value(Fs, cs, Ls, Qs, Rs, QT):
    """Associative-scan Riccati (Särkkä & García-Fernández elements).

    Element e = (A, b, C, η, J) represents the conditional value function
    between two knots; composition is associative, so a reversed
    ``associative_scan`` yields every suffix value function in O(log T) depth.
    """
    elems = _value_elements(Fs, cs, Ls, Qs, Rs)
    term = jax.tree_util.tree_map(lambda t: t[None], _terminal_element(QT))
    elems = jax.tree_util.tree_map(
        lambda a, t: jnp.concatenate([a, t], axis=0), elems, term
    )
    suffix = _suffix_scan(elems)
    _, _, _, etas, Js = suffix
    # value at knot k: V_k(x) = ½xᵀ J_k x − η_kᵀ x (+const)
    Ps = Js
    ps = -etas
    Ks, kffs = jax.vmap(_gains_one)(Fs, cs, Ls, Rs, Ps[1:], ps[1:])
    return Ks, kffs, Ps, ps


def solve_lqr(
    Fs: jnp.ndarray,   # (T, nx, nx)
    cs: jnp.ndarray,   # (T, nx)
    Ls: jnp.ndarray,   # (T, nx, nu)
    Qs: jnp.ndarray,   # (T, nx, nx) state costs at knots 0..T−1
    Rs: jnp.ndarray,   # (T, nu, nu)
    QT: jnp.ndarray,   # (nx, nx) terminal cost
    x0: jnp.ndarray,   # (nx,)
    *,
    parallel: bool = False,
) -> LQRSolution:
    """Finite-horizon time-varying LQR; see module docstring.

    ``parallel=True`` uses the O(log T)-depth associative scan (identical
    result; wins when T is large and/or the horizon is sharded over a mesh).
    """
    if parallel:
        Ks, kffs, Ps, ps = _parallel_value(Fs, cs, Ls, Qs, Rs, QT)
    else:
        Ks, kffs, Ps, ps = _sequential_value(Fs, cs, Ls, Qs, Rs, QT)

    def rollout(x, inputs):
        F, c, L, K, kff = inputs
        u = -(_mm(K, x[:, None])[:, 0] + kff)
        x_next = _mm(F, x[:, None])[:, 0] + _mm(L, u[:, None])[:, 0] + c
        return x_next, (x_next, u)

    _, (xs, us) = jax.lax.scan(rollout, x0, (Fs, cs, Ls, Ks, kffs))
    xs = jnp.concatenate([x0[None], xs], axis=0)
    return LQRSolution(
        gains=Ks, feedforward=kffs, value_matrices=Ps, value_vectors=ps,
        states=xs, controls=us,
    )


def _combine_affine(e1, e2):
    """Compose affine maps x ↦ Mx + d, earlier first: e2 ∘ e1."""
    M1, d1 = e1
    M2, d2 = e2
    return _mm(M2, M1), _mm(M2, d1[..., None])[..., 0] + d2


def solve_lqr_sharded(
    Fs: jnp.ndarray,   # (T, nx, nx) — T must divide by the mesh axis size
    cs: jnp.ndarray,   # (T, nx)
    Ls: jnp.ndarray,   # (T, nx, nu)
    Qs: jnp.ndarray,   # (T, nx, nx)
    Rs: jnp.ndarray,   # (T, nu, nu)
    QT: jnp.ndarray,   # (nx, nx)
    x0: jnp.ndarray,   # (nx,)
    mesh,
    axis_name: str,
) -> LQRSolution:
    """Horizon-sharded LQR: the SP component proper (SURVEY.md §2.3/§5).

    The time axis is sharded over ``mesh.shape[axis_name]`` devices via
    ``shard_map``. Per solve, cross-device traffic is exactly:

    1. one ``all_gather`` of each block's composed value element — P elements
       of ~(nx, nx) floats (the "block exchange");
    2. one ``ppermute`` halo shifting each block's first (P_k, p_k) to the
       previous device (next-knot values for the gain computation);
    3. one ``all_gather`` of each block's composed closed-loop affine map for
       the forward rollout.

    Everything else — the O(B log B) local suffix/prefix scans and the
    redundant O(P)-element cross-block prefix — is device-local, so
    communication volume is independent of the local horizon length B.
    Results match :func:`solve_lqr` to roundoff (tests assert it on an
    8-virtual-device mesh).

    Reference parity note: the reference integrates time strictly serially
    (``FixedStepIntegrator.tpp:48-61``); this capability has no counterpart
    there; it spreads one long horizon over the cards of a mesh.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    T = Fs.shape[0]
    n_shards = mesh.shape[axis_name]
    if T % n_shards:
        raise ValueError(f"horizon {T} not divisible by {n_shards} shards")
    nx = Fs.shape[-1]
    dtype = Fs.dtype

    def block(Fs, cs, Ls, Qs, Rs, QT, x0):
        B = Fs.shape[0]          # local block length
        idx = jax.lax.axis_index(axis_name)
        # --- backward value pass -------------------------------------------
        elems = _value_elements(Fs, cs, Ls, Qs, Rs)
        S = _suffix_scan(elems)                 # S[i] = e_i ⊗ … ⊗ e_{B−1}
        comp = jax.tree_util.tree_map(lambda x: x[0], S)
        gathered = jax.lax.all_gather(comp, axis_name)      # (P, …)
        term = _terminal_element(QT)
        allb = jax.tree_util.tree_map(
            lambda g, t: jnp.concatenate([g, t[None]], axis=0), gathered, term
        )
        Rfull = _suffix_scan(allb)      # Rfull[j] = block_j ⊗ … ⊗ term
        Rsel = jax.tree_util.tree_map(
            lambda x: jax.lax.dynamic_index_in_dim(x, idx + 1, 0,
                                                   keepdims=False),
            Rfull,
        )
        Rb = jax.tree_util.tree_map(
            lambda r: jnp.broadcast_to(r, (B,) + r.shape), Rsel
        )
        _, _, _, etas, Js = _combine_value(S, Rb)
        P_loc, p_loc = Js, -etas                # values at local knots

        # next-knot values: local shift + one-element halo from device d+1
        first = (P_loc[0], p_loc[0])
        perm = [(d, d - 1) for d in range(1, n_shards)]
        recvP, recvp = jax.lax.ppermute(first, axis_name, perm)
        is_last = idx == n_shards - 1
        lastP = jnp.where(is_last, QT, recvP)
        lastp = jnp.where(is_last, jnp.zeros((nx,), dtype), recvp)
        P_next = jnp.concatenate([P_loc[1:], lastP[None]], axis=0)
        p_next = jnp.concatenate([p_loc[1:], lastp[None]], axis=0)
        Ks, kffs = jax.vmap(_gains_one)(Fs, cs, Ls, Rs, P_next, p_next)

        # --- forward rollout (closed-loop affine prefix) -------------------
        M = Fs - _mm(Ls, Ks)
        dv = cs - _mm(Ls, kffs[..., None])[..., 0]
        Pinc = jax.lax.associative_scan(_combine_affine, (M, dv), axis=0)
        bcomp = jax.tree_util.tree_map(lambda x: x[-1], Pinc)
        gmaps = jax.lax.all_gather(bcomp, axis_name)        # (P, …)
        Ginc = jax.lax.associative_scan(_combine_affine, gmaps, axis=0)
        safe = jnp.maximum(idx - 1, 0)
        Esel = jax.tree_util.tree_map(
            lambda x: jax.lax.dynamic_index_in_dim(x, safe, 0,
                                                   keepdims=False), Ginc
        )
        ident = (jnp.eye(nx, dtype=dtype), jnp.zeros((nx,), dtype))
        EM = jnp.where(idx == 0, ident[0], Esel[0])
        Ed = jnp.where(idx == 0, ident[1], Esel[1])
        x_b = _mm(EM, x0[:, None])[:, 0] + Ed   # state at the block start
        xs_rest = (
            _mm(Pinc[0][:-1], x_b[None, :, None])[..., 0] + Pinc[1][:-1]
        )
        xs = jnp.concatenate([x_b[None], xs_rest], axis=0)  # knots b..b+B−1
        us = -(_mm(Ks, xs[..., None])[..., 0] + kffs)
        return Ks, kffs, P_loc, p_loc, xs, us

    sharded = shard_map(
        block, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name),
                  P(axis_name), P(), P()),
        out_specs=(P(axis_name),) * 6,
    )
    Ks, kffs, Ps, ps, xs, us = sharded(Fs, cs, Ls, Qs, Rs, QT, x0)
    # terminal knot, computed once outside the sharded region
    xT = (_mm(Fs[-1], xs[-1][:, None])[:, 0]
          + _mm(Ls[-1], us[-1][:, None])[:, 0] + cs[-1])
    return LQRSolution(
        gains=Ks, feedforward=kffs,
        value_matrices=jnp.concatenate([Ps, QT[None]], axis=0),
        value_vectors=jnp.concatenate([ps, jnp.zeros((1, nx), dtype)], 0),
        states=jnp.concatenate([xs, xT[None]], axis=0),
        controls=us,
    )


def parallel_value_general(As, Bs, lx, lu, lxx, luu, lux, VxT, VxxT):
    """O(log T)-depth value functions for the iLQR/SQP quadratic subproblem.

    The SQP backward pass (:mod:`blf_tpu.mpc.sqp`) quadraticizes an
    augmented-Lagrangian cost with **cross terms** (``lux``) and **linear
    terms** (``lx``/``lu``), which the plain Särkkä elements of
    :func:`solve_lqr` don't carry. Completing the square in the control —
    ``u = v − luu⁻¹(lu + lux·x)`` — reduces each stage to the canonical
    affine-LQR form whose elements DO compose associatively (the η slot
    carries the linear state cost):

        F̃ = A − B·luu⁻¹·lux        c̃ = −B·luu⁻¹·lu        L̃ = B
        Q̃ = lxx − luxᵀ·luu⁻¹·lux   q̃ = lx − luxᵀ·luu⁻¹·lu  R̃ = luu

    Returns ``(Vxs, Vxxs)`` with shapes ``(T+1, nx)`` / ``(T+1, nx, nx)``:
    the gradients/Hessians of the value function at every knot about the
    current iterate — identical (to fp) to the sequential backward
    recursion, in log instead of linear depth. Connects the long-context SP
    machinery to the nonlinear stack (SURVEY.md §5 long-context row).

    Precision note: composed interval maps carry products of the open-loop
    ``A`` blocks, which for UNSTABLE dynamics grow like ``ρ(A)^T`` — e.g.
    the DCM flow at ω·dt ≈ 0.33 reaches 1e9 by T = 64, past f32's useful
    range (tests pin f32 agreement to T ≲ 24; f64 is exact at T = 64+).
    For long unstable horizons in f32 use the sequential backward, or shard
    the horizon (:func:`solve_lqr_sharded` composes only block-local maps).
    """
    sol = lambda M, X: jnp.linalg.solve(M, X)
    luu_lu = sol(luu, lu[..., None])[..., 0]            # (T, nu)
    luu_lux = sol(luu, lux)                             # (T, nu, nx)
    luxT = jnp.swapaxes(lux, -1, -2)
    Ft = As - _mm(Bs, luu_lux)
    ct = -_mm(Bs, luu_lu[..., None])[..., 0]
    Qt = lxx - _mm(luxT, luu_lux)
    Qt = 0.5 * (Qt + jnp.swapaxes(Qt, -1, -2))
    qt = lx - _mm(luxT, luu_lu[..., None])[..., 0]
    Cs = jnp.einsum("kij,kjl,kml->kim", Bs, jnp.linalg.inv(luu), Bs,
                    precision=_PREC)
    elems = (Ft, ct, Cs, -qt, Qt)
    term = (
        jnp.zeros_like(VxxT), jnp.zeros_like(VxT), jnp.zeros_like(VxxT),
        -VxT, VxxT,
    )
    elems = jax.tree_util.tree_map(
        lambda a, t: jnp.concatenate([a, t[None]], axis=0), elems, term
    )
    _, _, _, etas, Js = _suffix_scan(elems)
    return -etas, Js
