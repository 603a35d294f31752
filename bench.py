"""Benchmark: batched DCM-MPC fleet tick on one GPU (BASELINE config 5).

Metric: **warm-started DCM-MPC solves per second per card** on the
push-recovery fleet tick (batched QP solve + fleet reduction + state advance
+ RLS update, all in one jitted program) at batch 98,304, horizon 32 and 50
ADMM iterations per tick, with 20 ticks scanned inside one jit.

Exits non-zero without a GPU. Prints ONE JSON line.
"""

import json
import sys
import time

import numpy as np

BATCH = 98304            # fleet size (96 × 1024 lanes)
HORIZON = 32             # 3.2 s lookahead at 0.1 s knots: (m, n) = (192, 128)
ITERATIONS = 50          # warm-started receding-horizon budget
TICKS = 20               # control ticks scanned inside one jit


def build_fleet_tick(mesh, batch=BATCH, horizon=HORIZON,
                     iterations=ITERATIONS, ticks=TICKS):
    """The config-5 program on ``mesh``: returns ``(run_ticks, state, dist,
    tick)`` where ``run_ticks(state, dist) -> (state, last TickResult)``
    scans ``ticks`` fleet ticks inside one jit and ``tick`` is one jitted
    tick with the same signature."""
    import jax
    import jax.numpy as jnp

    from blf_tpu.parallel.mesh import shard_batch
    from blf_tpu.parallel.sweep import init_fleet, make_fleet_step
    from __graft_entry__ import _example_problem

    dtype = jnp.float32
    params, dt, _, _, _, _, _ = _example_problem(batch, horizon, dtype)
    # Stationary push-recovery task: time-invariant receding horizon, so the
    # warm-started steady state is the true production workload.
    stance = jnp.zeros(2, dtype)
    zmp_ref = jnp.broadcast_to(stance, (horizon, 2))
    dcm_ref = jnp.broadcast_to(stance, (horizon + 1, 2))
    poly_A = jnp.tile(
        jnp.asarray([[1.0, 0], [-1.0, 0], [0, 1.0], [0, -1.0]], dtype),
        (horizon, 1, 1),
    )
    poly_b = jnp.broadcast_to(jnp.asarray([0.1, 0.1, 0.06, 0.06], dtype),
                              (horizon, 4))
    num_constraints = 2 * horizon + horizon * poly_A.shape[-2]
    state = init_fleet(
        batch, horizon, num_constraints,
        jnp.array([0.01, -0.01], dtype), jnp.array([0.01, -0.01], dtype),
        dtype=dtype,
    )
    state = shard_batch(state, mesh)
    rng = np.random.default_rng(0)
    dist = shard_batch(
        jnp.asarray(rng.normal(0, 0.004, (batch, 1, 2)), dtype), mesh)

    # refine=False: the two-GEMM v-space iteration (warm-started fleets
    # converge fully without the refinement pass)
    step = make_fleet_step(mesh, params, dt, iterations=iterations,
                           refine=False)

    def tick(s, dist):
        return step.sharded_fn(s, dist, dcm_ref, zmp_ref, poly_A, poly_b)

    @jax.jit
    def run_ticks(state, dist):
        s, results = jax.lax.scan(lambda s, _: tick(s, dist), state, None,
                                  length=ticks)
        return s, jax.tree_util.tree_map(lambda a: a[-1], results)

    return run_ticks, state, dist, jax.jit(tick)


def main():
    import jax

    from blf_tpu.parallel.mesh import make_mesh
    from blf_tpu.utils.compile_cache import enable_compile_cache
    from blf_tpu.utils.profiling import require_gpu
    from blf_tpu.utils.status import status_counts
    from blf_tpu.utils.telemetry import TelemetryStream

    device = require_gpu()
    enable_compile_cache()
    run_ticks, state, dist, _ = build_fleet_tick(make_mesh(1, model_axis=1))

    # warmup: compile + reach the warm-started steady state
    t0 = time.perf_counter()
    state, result = run_ticks(state, dist)
    jax.block_until_ready(state.dcm)
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    state, result = run_ticks(state, dist)
    jax.block_until_ready(state.dcm)
    tick_time = (time.perf_counter() - t0) / TICKS

    # telemetry + per-lane status ride the production tick (SURVEY.md §5);
    # the stream sinks to stderr so stdout stays ONE JSON line
    telemetry = TelemetryStream(sink=sys.stderr, name="bench_fleet")
    record = telemetry.publish({
        "converged": result.stats.num_converged,
        "max_primal_residual": result.stats.max_primal_residual,
        "max_dual_residual": result.stats.max_dual_residual,
        "worst_margin": result.worst_margin,
        "quarantined": result.num_quarantined,
    }, step=2 * TICKS)

    print(json.dumps({
        "metric": "dcm_mpc_solves_per_sec_per_card",
        "value": BATCH / tick_time,
        "unit": "solves/s/card",
        "detail": {
            "batch": BATCH,
            "horizon_knots": HORIZON,
            "admm_iterations": ITERATIONS,
            "tick_ms": tick_time * 1e3,
            "compile_s": compile_s,
            "num_converged": float(result.stats.num_converged),
            "max_primal_residual": float(result.stats.max_primal_residual),
            "max_dual_residual": float(result.stats.max_dual_residual),
            "status_counts": status_counts(result.status),
            "quarantined": float(result.num_quarantined),
            "telemetry_record": {k: v for k, v in record.items()
                                 if k not in ("stream", "time")},
            "device": device,
            "dtype": "float32",
        },
    }))


if __name__ == "__main__":
    main()
