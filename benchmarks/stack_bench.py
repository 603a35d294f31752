"""BASELINE config 4 benchmark — hierarchical control-stack throughput.

A fleet of FULL control stacks (23-DoF humanoid plant, 10 Hz DCM-MPC outer
loop with horizon 8, 100 Hz whole-body QP inner loop with 10 solves per
outer tick, stiff ROS2-W contact physics at 2 substeps, momentum observer +
RLS push filter in the loop — ``blf_tpu.mpc.stack``) on one GPU. Reports
**outer ticks/s/card** and the derived real-time fleet size (each stack
needs 10 outer ticks/s), plus convergence counts so the number is honest
about solve quality, not just speed.

Batch bucketing: the requested batch is padded up to a bucket size (256,
then powers of two), so one compilation per bucket covers the whole
operating range and a warm persistent compilation cache serves any new
batch size in the bucket.

Run:   python benchmarks/stack_bench.py [batch]
Exits non-zero without a GPU. Prints ONE JSON line.
"""

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

HORIZON = 8
TICKS = 5


def bucket_batch(batch: int) -> int:
    """Smallest bucket ≥ batch: 256, 512, 1024, ... (one compile each)."""
    b = 256
    while b < batch:
        b *= 2
    return b


def production_config():
    """The config-4 operating point.

    Stiff ROS2-W plant at 2 substeps (closed-loop DCM within 7.5e-4 m of
    the 40-substep RK4 reference over 0.4 s; pinned by
    tests/test_control_stack.py) with the per-tick lagged mass-matrix
    inverse and the stiff-path-only stage operator; one KKT factorization
    per WBC solve (check_every = iterations); warm starts and adaptive ρ
    carried across ticks.
    """
    from blf_tpu.mpc.stack import StackConfig

    return StackConfig(mpc_dt=0.1, horizon=HORIZON, wbc_per_mpc=10,
                       physics_per_wbc=2, plant_method="rosenbrock",
                       mpc_iterations=100, wbc_iterations=150,
                       wbc_check_every=150, wbc_polish_iters=0,
                       wbc_scaling_iters=4, wbc_backend="pallas",
                       plant_lagged_minv=True, ros_op_stiff=True)


def build_stack(batch: int, config=None):
    """The config-4 fleet at ``batch`` lanes (unpadded).

    Returns ``(step, state, pushes, refs)``: ``step(state, pushes, *refs)``
    is one fleet outer tick (not jitted), ``state`` the standing fleet and
    ``pushes`` (batch, 2) per-lane push forces drawn from seed 0.
    """
    import jax
    import jax.numpy as jnp

    from blf_tpu.models import rigid_body as rb
    from blf_tpu.models.kinematics import forward_kinematics, frame_pose
    from blf_tpu.models.lipm import LIPMParams
    from blf_tpu.models.robots import HUMANOID_SOLE_FRAMES, make_humanoid_23dof
    from blf_tpu.mpc.stack import init_stack, make_fleet_stack_step
    from blf_tpu.mpc.wholebody import WholeBodyParams

    config = config or production_config()
    tree = make_humanoid_23dof()
    wbc = WholeBodyParams(contact_frames=HUMANOID_SOLE_FRAMES)
    n = tree.num_dofs
    dtype = jnp.float32

    # standing posture (same as tests/test_control_stack.py, f32)
    q = np.zeros(n)
    names, dof = tree.link_names, tree.dof_index
    for side in ("l", "r"):
        q[dof[names.index(f"{side}_upper_leg")]] = 0.25
        q[dof[names.index(f"{side}_lower_leg")]] = -0.5
        q[dof[names.index(f"{side}_ankle_1")]] = 0.25
    qj = jnp.asarray(q, dtype)
    poses0 = forward_kinematics(tree, jnp.zeros(3, dtype),
                                jnp.eye(3, dtype=dtype), qj)
    _, p_sole = frame_pose(tree, poses0, "l_sole")
    plant = rb.FloatingBaseState(
        base_twist=jnp.zeros(6, dtype),
        joint_velocities=jnp.zeros(n, dtype),
        base_position=jnp.asarray([0.0, 0.0, -float(p_sole[2])], dtype),
        base_rotation=jnp.eye(3, dtype=dtype),
        joint_positions=qj,
    )
    poses = forward_kinematics(tree, plant.base_position, plant.base_rotation,
                               plant.joint_positions)
    com = rb.com_position(tree, poses)
    lipm = LIPMParams(jnp.asarray(float(com[2]), dtype),
                      jnp.asarray(9.81, dtype))
    stance = jnp.asarray(com[:2], dtype)
    zmp_ref = jnp.broadcast_to(stance, (HORIZON, 2))
    dcm_ref = jnp.broadcast_to(stance, (HORIZON + 1, 2))
    poly_A = jnp.tile(jnp.asarray(
        [[1.0, 0], [-1.0, 0], [0, 1.0], [0, -1.0]], dtype), (HORIZON, 1, 1))
    half = jnp.asarray([0.09, 0.09, 0.11, 0.11], dtype)
    poly_b = jnp.broadcast_to(
        jnp.asarray([stance[0], -stance[0], stance[1], -stance[1]],
                    dtype) + half,
        (HORIZON, 4),
    )
    null_poses = {}
    for f in HUMANOID_SOLE_FRAMES:
        _, p0 = frame_pose(tree, poses, f)
        null_poses[f] = (jnp.eye(3, dtype=dtype),
                         p0 + jnp.asarray([0.0, 0.0, config.ground_sag],
                                          dtype))
    step = make_fleet_stack_step(tree, wbc, lipm, config, null_poses,
                                 q_ref=plant.joint_positions,
                                 com_height_ref=float(com[2]))
    state0 = init_stack(tree, lipm, config, plant, 2 * HORIZON + HORIZON * 4)
    state = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (batch,) + x.shape), state0)
    rng = np.random.default_rng(0)
    pushes = jnp.asarray(rng.uniform(-8.0, 8.0, (batch, 2)), dtype)
    return step, state, pushes, (dcm_ref, zmp_ref, poly_A, poly_b)


def make_run_ticks(step, refs, ticks):
    """jit of ``ticks`` outer ticks scanned; returns (state, last trace)."""
    import jax

    # pushes ride as a jit ARGUMENT (not a closure constant): closed-over
    # concrete arrays are baked into the HLO as constants, so two batch
    # sizes in the same bucket would produce different programs and defeat
    # the persistent compilation cache the bucketing exists to exploit
    @jax.jit
    def run_ticks(state, pushes):
        def body(s, _):
            return step(s, pushes, *refs)
        state, traces = jax.lax.scan(body, state, None, length=ticks)
        return state, jax.tree_util.tree_map(lambda a: a[-1], traces)

    return run_ticks


def main(batch: int = 512) -> None:
    import jax
    import jax.numpy as jnp

    from blf_tpu.utils.compile_cache import enable_compile_cache
    from blf_tpu.utils.profiling import require_gpu
    from blf_tpu.utils.status import status_counts

    device = require_gpu()
    enable_compile_cache()
    padded = bucket_batch(batch)
    config = production_config()
    step, state, pushes, refs = build_stack(padded, config)
    # bucket-padded lanes run unpushed and are excluded from reporting
    pushes = pushes.at[batch:].set(0.0)
    run_ticks = make_run_ticks(step, refs, TICKS)

    t0 = time.perf_counter()
    state, trace = run_ticks(state, pushes)
    jax.block_until_ready(state.plant.base_position)
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    state, trace = run_ticks(state, pushes)
    jax.block_until_ready(state.plant.base_position)
    outer_tick_s = (time.perf_counter() - t0) / TICKS

    sel = lambda a: a[:batch]                         # reported lanes only
    ticks_per_sec = batch / outer_tick_s              # real lanes only
    print(json.dumps({
        "metric": "stack_outer_ticks_per_sec_per_card",
        "value": ticks_per_sec,
        "unit": "ticks/s/card",
        "detail": {
            "batch": batch,
            "bucket": padded,
            "realtime_stacks_per_card": ticks_per_sec / 10.0,
            "fleet_tick_ms": outer_tick_s * 1e3,
            "mpc_converged": int(jnp.sum(sel(trace.mpc_converged))),
            "wbc_converged": int(jnp.sum(sel(trace.wbc_converged))),
            "status_counts": status_counts(sel(trace.status)),
            "wbc_max_rp": float(jnp.max(sel(trace.wbc_max_rp))),
            "wbc_median_rp": float(jnp.median(sel(trace.wbc_max_rp))),
            "wbc_max_rd": float(jnp.max(sel(trace.wbc_max_rd))),
            "wbc_median_rd": float(jnp.median(sel(trace.wbc_max_rd))),
            "all_finite": bool(jnp.all(jnp.isfinite(
                sel(state.plant.base_position)))),
            "compile_s": compile_s,
            "config": config._asdict(),
            "device": device,
            "dtype": "float32",
        },
    }))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 512)
