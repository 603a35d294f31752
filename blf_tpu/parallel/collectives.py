"""Collective-reduction module: fleet-wide statistics over mesh axes.

The "collective QP reduce" of BASELINE.json: per-shard solver diagnostics
(convergence flags, residuals, costs) reduced across the ``data`` axis with
XLA collectives (``psum``/``pmax``/``pmin``), replacing
nothing in the reference (it has no distributed layer, SURVEY.md §2.3) but
required by the north star's multi-host sweep.

These helpers are meant to be called *inside* ``shard_map``-decorated
functions (see :mod:`blf_tpu.parallel.sweep`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["FleetStats", "reduce_fleet_stats", "psum_tree", "pmax_tree"]


class FleetStats(NamedTuple):
    """Global (all-shard) solver statistics for one control tick."""

    num_scenarios: jnp.ndarray     # total lanes
    num_converged: jnp.ndarray     # lanes with converged QPs
    max_primal_residual: jnp.ndarray
    max_dual_residual: jnp.ndarray
    mean_objective: jnp.ndarray


def psum_tree(tree, axis_name: str):
    return jax.tree_util.tree_map(lambda x: jax.lax.psum(x, axis_name), tree)


def pmax_tree(tree, axis_name: str):
    return jax.tree_util.tree_map(lambda x: jax.lax.pmax(x, axis_name), tree)


def reduce_fleet_stats(qp_solution, axis_name: str) -> FleetStats:
    """Reduce a per-lane :class:`blf_tpu.mpc.qp.QPSolution` shard to global
    fleet statistics (call inside ``shard_map``; result is replicated)."""
    local_n = jnp.asarray(qp_solution.converged.size, jnp.float32)
    local_conv = jnp.sum(qp_solution.converged.astype(jnp.float32))
    local_obj = jnp.sum(qp_solution.objective)
    n = jax.lax.psum(local_n, axis_name)
    return FleetStats(
        num_scenarios=n,
        num_converged=jax.lax.psum(local_conv, axis_name),
        max_primal_residual=jax.lax.pmax(
            jnp.max(qp_solution.primal_residual), axis_name
        ),
        max_dual_residual=jax.lax.pmax(
            jnp.max(qp_solution.dual_residual), axis_name
        ),
        mean_objective=jax.lax.psum(local_obj, axis_name) / n,
    )
