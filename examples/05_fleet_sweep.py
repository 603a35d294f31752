"""BASELINE config 5 — batched push-recovery MPC sweep, collective reduce.

The production fleet tick: a mesh-sharded batch of DCM-MPC scenarios
(disturbance-ensemble axis + data axis), warm-started batched QP solve,
collective reduction of solver statistics, state advance, and per-lane RLS
disturbance estimation — one jitted shard_map program per tick. The
auxiliary subsystems ride along the way SURVEY.md §5 prescribes: per-lane
``SolverStatus`` codes + NaN quarantine (carried in ``TickResult``), a
``TelemetryStream`` publishing one JSONL record per tick (single
device→host transfer), and a mid-run checkpoint that is reloaded and
verified to continue **bitwise** identically.

On a GPU this is the bench.py fleet size (98304 lanes per card); on CPU it
runs a miniature fleet over 8 virtual devices:

Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
         python examples/05_fleet_sweep.py
or on a GPU:  python examples/05_fleet_sweep.py
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import os

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from blf_tpu.models.lipm import LIPMParams
    from blf_tpu.parallel.mesh import make_mesh, shard_batch
    from blf_tpu.parallel.sweep import init_fleet, make_fleet_step

    on_gpu = jax.default_backend() == "gpu"
    n_dev = len(jax.devices())
    batch = 98304 if on_gpu else 64 * n_dev
    horizon = 16

    dtype = jnp.float32
    params = LIPMParams(jnp.asarray(0.9, dtype), jnp.asarray(9.81, dtype))
    mesh = make_mesh(n_dev, model_axis=2 if n_dev % 2 == 0 else 1)
    model_axis = mesh.devices.shape[1]

    stance = jnp.zeros(2, dtype)
    zmp_ref = jnp.broadcast_to(stance, (horizon, 2))
    dcm_ref = jnp.broadcast_to(stance, (horizon + 1, 2))
    poly_A = jnp.tile(jnp.asarray([[1.0, 0], [-1.0, 0], [0, 1.0], [0, -1.0]],
                                  dtype), (horizon, 1, 1))
    poly_b = jnp.broadcast_to(jnp.asarray([0.1, 0.1, 0.06, 0.06], dtype),
                              (horizon, 4))
    num_constraints = 2 * horizon + horizon * poly_A.shape[-2]
    state = init_fleet(batch, horizon, num_constraints,
                       jnp.array([0.03, -0.02], dtype),
                       jnp.array([0.03, -0.02], dtype), dtype=dtype)
    state = shard_batch(state, mesh)
    rng = np.random.default_rng(0)
    dist = jnp.asarray(rng.normal(0, 0.004, (batch, model_axis, 2)), dtype)

    step = make_fleet_step(mesh, params, 0.1, iterations=50)
    print(f"mesh {mesh.devices.shape} {mesh.axis_names}, fleet {batch} "
          f"scenarios on {jax.default_backend()}")

    import tempfile

    from blf_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
    from blf_tpu.utils.status import status_counts
    from blf_tpu.utils.telemetry import TelemetryStream

    telemetry = TelemetryStream(name="fleet_sweep")
    ckpt_path = os.path.join(tempfile.mkdtemp(prefix="blf_ckpt_"), "fleet.npz")

    def run(state, ticks, first_tick=0):
        for tick in range(first_tick, first_tick + ticks):
            state, result = step(state, dist, dcm_ref, zmp_ref, poly_A, poly_b)
            s = result.stats
            counts = status_counts(result.status)
            telemetry.publish({
                "converged": s.num_converged,
                "max_primal_residual": s.max_primal_residual,
                "max_dual_residual": s.max_dual_residual,
                "worst_margin": result.worst_margin,
                "quarantined": result.num_quarantined,
            }, step=tick)
            print(f"tick {tick}: converged {int(s.num_converged)}/{batch}  "
                  f"max rp {float(s.max_primal_residual):.2e}  "
                  f"worst hull margin {float(result.worst_margin):+.4f}  "
                  f"status {counts}")
        return state

    # run 3 ticks, checkpoint, run 2 more
    state = run(state, 3)
    save_checkpoint(ckpt_path, state, step=3)
    final = run(state, 2, first_tick=3)

    # resume from the checkpoint: the continuation must be BITWISE identical
    # (same jitted program, same inputs — restart-safe sweeps, SURVEY.md §5)
    resumed = shard_batch(load_checkpoint(ckpt_path, state), mesh)
    refinal = run(resumed, 2, first_tick=3)
    same = all(
        bool(jnp.all(a == b))
        for a, b in zip(jax.tree_util.tree_leaves(final),
                        jax.tree_util.tree_leaves(refinal))
    )
    print(f"checkpoint resume bitwise-identical: {same}")
    assert same, "resumed sweep diverged from the original run"


if __name__ == "__main__":
    main()
