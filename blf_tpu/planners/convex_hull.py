"""Convex hulls → half-space constraints ``A x ≤ b``, host + device paths.

Re-design of the reference's ``ConvexHullHelper`` (``src/Planners/src/
ConvexHullHelper.cpp``; SURVEY.md §2 row 9, §3.4), which wraps Qhull to turn
support-polygon vertices into ZMP half-space constraints and test membership.

Two paths, per SURVEY.md §7:

- **Host** :func:`halfspaces_from_points` — exact V-rep → H-rep for any
  dimension via scipy's Qhull binding (same library the reference links);
  used at planning time to bake constraint matrices.
- **Device** :func:`monotone_chain_2d` — a fixed-size 2-D Andrew monotone
  chain in pure JAX (padded to ``max_vertices``, no data-dependent shapes)
  for dynamic footholds inside jitted/vmapped MPC, plus
  :func:`point_in_halfspaces` for batched membership.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "halfspaces_from_points",
    "point_in_halfspaces",
    "monotone_chain_2d",
    "halfspaces_from_polygon",
    "Polygon2D",
]


def halfspaces_from_points(points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Convex hull of ``points`` → ``(A, b)`` with hull = ``{x : A x ≤ b}``.

    Equivalent of ``ConvexHullHelper::buildConvexHull``
    (``ConvexHullHelper.cpp:35-89``): facet hyperplanes with unit outward
    normals ``V`` and offsets, ``A = V``, ``b = −offset``. ``points`` is
    ``(n, d)`` (the reference takes ``d × n``; row-major here).
    """
    from scipy.spatial import ConvexHull  # Qhull, as in the reference

    points = np.asarray(points, dtype=np.float64)
    hull = ConvexHull(points)
    # scipy equations: A x + b0 ≤ 0 with unit normals
    A = hull.equations[:, :-1]
    b = -hull.equations[:, -1]
    return A, b


def point_in_halfspaces(A, b, point, tol=None):
    """Batched membership ``A p ≤ b (+tol)``
    (``ConvexHullHelper::doesPointBelongToConvexHull``,
    ``ConvexHullHelper.cpp:101-117``). Broadcasts over leading axes of
    ``point``; returns bool array.

    ``tol=None`` (default) uses a dtype-scaled slack
    ``64·eps·(1 + max|b|)`` so hull *vertices* stay members under the
    active precision — in f32 a fixed absolute slack either rejects
    boundary points (too tight) or admits interior violations (too loose).
    """
    A, b, point = jnp.asarray(A), jnp.asarray(b), jnp.asarray(point)
    if tol is None:
        eps = jnp.finfo(jnp.result_type(A, b, point)).eps
        tol = 64.0 * eps * (1.0 + jnp.max(jnp.abs(b)))
    margins = jnp.einsum("...fd,...d->...f", A, point) - b
    return jnp.all(margins <= tol, axis=-1)


class Polygon2D(NamedTuple):
    """Fixed-size padded 2-D convex polygon: CCW ``vertices`` with only the
    first ``count`` valid (padding repeats the last valid vertex)."""

    vertices: jnp.ndarray  # (…, K, 2)
    count: jnp.ndarray     # (…,) int


def monotone_chain_2d(points: jnp.ndarray, valid=None) -> Polygon2D:
    """2-D convex hull (Andrew monotone chain) with static shapes.

    ``points`` is ``(K, 2)``; ``valid`` an optional ``(K,)`` bool mask of real
    points (padding allowed). Returns the hull as a :class:`Polygon2D` with at
    most ``K`` CCW vertices. Entirely ``lax``-structured (sort + fori_loop over
    a fixed bound) so it jits, vmaps, and runs on the device — the device-side
    replacement for calling Qhull per scenario (SURVEY.md §3.4).
    """
    K = points.shape[0]
    if valid is None:
        valid = jnp.ones((K,), dtype=bool)
    big = jnp.asarray(jnp.finfo(points.dtype).max)
    # Sort lexicographically by (x, y); invalid points to the end.
    sort_key = jnp.where(valid, points[:, 0], big)
    order = jnp.lexsort((jnp.where(valid, points[:, 1], big), sort_key))
    pts = points[order]
    valid_sorted = valid[order]
    n = jnp.sum(valid).astype(jnp.int32)

    def cross(o, a, b):
        return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - (
            a[..., 1] - o[..., 1]
        ) * (b[..., 0] - o[..., 0])

    def half_hull(indices):
        """One monotone-chain pass visiting ``pts[indices]``, skipping padding."""

        def body(i, carry):
            hull, hlen = carry
            j = indices[i]
            p = pts[j]

            def process(args):
                hull, hlen = args

                def pop_cond(state):
                    _, hlen_ = state
                    return (hlen_ >= 2) & (
                        cross(hull[jnp.maximum(hlen_ - 2, 0)],
                              hull[jnp.maximum(hlen_ - 1, 0)], p) <= 0.0
                    )

                # popping only moves the length pointer; slots get overwritten
                hull, hlen = jax.lax.while_loop(
                    pop_cond, lambda s: (s[0], s[1] - 1), (hull, hlen)
                )
                return hull.at[hlen].set(p), hlen + 1

            return jax.lax.cond(valid_sorted[j], process, lambda a: a, (hull, hlen))

        hull0 = jnp.zeros((K + 1, 2), dtype=points.dtype)
        return jax.lax.fori_loop(
            0, K, body, (hull0, jnp.asarray(0, jnp.int32))
        )

    lower_hull, lower_len = half_hull(jnp.arange(K))
    upper_hull, upper_len = half_hull(K - 1 - jnp.arange(K))

    # CCW hull = lower[:-1] ++ upper[:-1] (each pass ends on the other's start).
    idx = jnp.arange(2 * K)
    in_lower = idx < lower_len - 1
    in_upper = (idx >= lower_len - 1) & (idx < lower_len + upper_len - 2)
    low_take = jnp.clip(idx, 0, K)
    up_take = jnp.clip(idx - (lower_len - 1), 0, K)
    out = jnp.where(
        in_lower[:, None], lower_hull[low_take],
        jnp.where(in_upper[:, None], upper_hull[up_take], 0.0),
    )
    count = jnp.maximum(lower_len + upper_len - 2, 0)

    # Degenerate inputs (n ≤ 2): the hull is just the valid points.
    degen = n <= 2
    count = jnp.where(degen, n, count)
    out = jnp.where(degen, jnp.concatenate([pts, pts], axis=0), out)
    # Pad by repeating the last valid vertex.
    last = out[jnp.maximum(count - 1, 0)]
    out = jnp.where((idx < count)[:, None], out, last)
    return Polygon2D(vertices=out, count=count)


def halfspaces_from_polygon(poly: Polygon2D, tol: float = 1e-12):
    """CCW padded polygon → padded ``(A, b)`` with outward unit normals.

    Edge ``v_i → v_{i+1}`` yields normal ``(e_y, −e_x)/‖e‖``; padded edges
    (zero length) produce the always-true constraint ``0·x ≤ 1`` so downstream
    ``A x ≤ b`` checks need no masking.
    """
    v = poly.vertices
    K = v.shape[-2]
    idx = jnp.arange(K)
    nxt = jnp.where(idx + 1 < poly.count[..., None], idx + 1, 0)
    v_next = jnp.take_along_axis(v, nxt[..., None].repeat(2, -1), axis=-2)
    e = v_next - v
    norm = jnp.linalg.norm(e, axis=-1, keepdims=True)
    good = (norm[..., 0] > tol) & (idx < poly.count[..., None])
    n_hat = jnp.where(
        good[..., None], jnp.stack([e[..., 1], -e[..., 0]], -1) / jnp.maximum(norm, tol), 0.0
    )
    b = jnp.where(good, jnp.sum(n_hat * v, axis=-1), 1.0)
    return n_hat, b
