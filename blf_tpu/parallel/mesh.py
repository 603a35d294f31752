"""Mesh/topology module — the framework's distribution substrate.

The reference is single-threaded, single-process (verified exhaustively,
SURVEY.md §2.3); scaling is a *new* first-class component of this build:
scenario data-parallelism over a ``("data",)`` axis is the primary strategy
(thousands of independent MPC scenarios), with a ``("model",)`` axis reserved
for sharding within one solve (horizon/constraint-row blocks).

This module owns mesh construction and pytree sharding helpers; the
collective reductions live in :mod:`blf_tpu.parallel.collectives`; the
sharded fleet step in :mod:`blf_tpu.parallel.sweep`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_batch", "replicate", "data_parallel_specs"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    n_devices: Optional[int] = None,
    model_axis: int = 1,
    axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS),
) -> Mesh:
    """Build a ``(data, model)`` mesh over the available devices.

    ``n_devices`` defaults to all of ``jax.devices()``; ``model_axis`` is how
    many devices each scenario-shard group spans (1 = pure DP). The cards of
    one host reach each other all to all at one rate, so devices are placed
    in enumeration order: the shape follows the algorithm alone.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
    if n_devices % model_axis != 0:
        raise ValueError("n_devices must be divisible by model_axis")
    shape = (n_devices // model_axis, model_axis)
    grid = np.asarray(devices[:n_devices]).reshape(shape)
    return Mesh(grid, axis_names)


def data_parallel_specs(mesh: Mesh):
    """(sharded, replicated) PartitionSpecs for scenario-batched arrays."""
    return P(mesh.axis_names[0]), P()


def shard_batch(pytree, mesh: Mesh, axis_name: str = DATA_AXIS):
    """Place a scenario-batched pytree with its leading axis sharded over
    ``axis_name`` (lanes stay resident on their device across ticks)."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree_util.tree_map(
        lambda leaf: jax.device_put(leaf, sharding), pytree
    )


def replicate(pytree, mesh: Mesh):
    """Replicate (broadcast) a pytree across every device of the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda leaf: jax.device_put(leaf, sharding), pytree
    )
