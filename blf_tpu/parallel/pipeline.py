"""Pipeline parallelism: a GPipe-style microbatched stage pipeline over a
mesh axis.

SURVEY.md §2.3 lists pipeline parallelism as a strategy absent from the
reference (which is single-threaded end to end) that this build must still
provide as a first-class component: "stage the MPC pipeline (rollout →
linearization → QP factor → QP solve → line search) across mesh axes with
``jax.lax`` collective permutes". This module is that component — a generic
combinator, not MPC-specific:

- ``S`` pipeline stages are placed one per device along a mesh axis;
- a stream of ``M`` microbatches enters at stage 0; every tick each device
  applies *its* stage and hands its output to the next device with ONE
  ``ppermute`` hop (neighbor-only traffic — no all-to-all, no gather);
- after the classic ``S − 1``-tick fill bubble the pipeline is full: all
  ``S`` devices compute concurrently on consecutive microbatches, and one
  finished microbatch exits per tick. Total ``M + S − 1`` ticks; bubble
  fraction ``(S − 1)/(M + S − 1)``.

All stages must map a common "carrier" pytree to a pytree of the same
structure/shapes (the rotating buffer is a single static-shape pytree —
XLA-friendly: the whole schedule is one ``lax.scan`` with a ``ppermute``
inside, traced once). Heterogeneous intermediate payloads are carried by
padding the carrier to the union of what stages need, the same static-shape
discipline the rest of the framework uses for contact schedules.

Relative cost note: each per-device step runs under ``lax.switch`` over the
stage functions, so a tick costs one stage evaluation (the switch selects,
it does not run all branches). Use :func:`pipeline_stages` when stages are
genuinely serial bottlenecks wider than the data-parallel axis can hide;
for embarrassingly parallel fleets, the DP sweep (``parallel/sweep.py``)
remains the right tool — exactly the priority SURVEY.md §2.3 assigns.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ["pipeline_stages"]


def pipeline_stages(
    stage_fns: Sequence[Callable],
    mesh: Mesh,
    axis_name: str,
):
    """Build a pipelined ``fn(microbatches) -> outputs`` over ``mesh``.

    ``stage_fns``: one pure function per device along ``axis_name``; each
    maps a carrier pytree to a same-shaped carrier pytree. The composed
    semantics are ``f_{S-1} ∘ … ∘ f_0`` applied independently per microbatch
    (tests assert equality with the serial composition).

    ``microbatches``: a carrier pytree with a leading microbatch axis of
    length ``M`` on every leaf. Returns the same pytree with every
    microbatch fully processed. Inputs and outputs are replicated across the
    pipeline axis (payloads here are small MPC-tick-sized pytrees; the
    schedule's point is overlapping heterogeneous *compute*, not sharding
    *storage*).
    """
    n_stages = mesh.shape[axis_name]
    if len(stage_fns) != n_stages:
        raise ValueError(
            f"{len(stage_fns)} stage fns for a {n_stages}-device "
            f"'{axis_name}' axis"
        )
    fns = tuple(stage_fns)

    def block(mbs):
        M = jax.tree_util.tree_leaves(mbs)[0].shape[0]
        idx = jax.lax.axis_index(axis_name)
        # carry must be device-varying from the start (ppermute outputs are),
        # per jax 0.9's varying-manual-axes typing
        zero = jax.lax.pcast(
            jax.tree_util.tree_map(
                lambda a: jnp.zeros(a.shape[1:], a.dtype), mbs
            ),
            axis_name,
            to="varying",
        )
        perm = [(d, d + 1) for d in range(n_stages - 1)]

        def tick(buf, t):
            # stage 0 ingests microbatch t while it exists; later stages
            # consume the buffer handed to them on the previous tick
            inject = jax.tree_util.tree_map(
                lambda a: jax.lax.dynamic_index_in_dim(
                    a, jnp.clip(t, 0, M - 1), 0, keepdims=False
                ),
                mbs,
            )
            ingest = jnp.logical_and(idx == 0, t < M)
            x_in = jax.tree_util.tree_map(
                lambda i, b: jnp.where(ingest, i, b), inject, buf
            )
            y = jax.lax.switch(idx, fns, x_in)
            handed = jax.lax.ppermute(y, axis_name, perm)
            return handed, y

        _, ys = jax.lax.scan(tick, zero, jnp.arange(M + n_stages - 1))
        # microbatch m exits the last stage at tick m + S − 1
        done = jax.tree_util.tree_map(lambda a: a[n_stages - 1:], ys)
        # replicate the result: only the last stage holds it; psum a mask
        is_last = (idx == n_stages - 1).astype(
            jax.tree_util.tree_leaves(done)[0].dtype
        )
        out = jax.tree_util.tree_map(
            lambda a: jax.lax.psum(
                a * jnp.asarray(is_last, a.dtype), axis_name
            ),
            done,
        )
        return out

    return shard_map(
        block, mesh=mesh, in_specs=(P(),), out_specs=P(),
    )
