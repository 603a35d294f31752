"""BASELINE config 4 — the full hierarchical stack under an unseen push.

DCM-MPC outer loop (10 Hz) → whole-body QP inner loop (100 Hz) → 23-DoF
humanoid plant grounded on the spring–damper contact model, with the
momentum-residual wrench observer and an RLS push filter feeding the
controller: the robot is pushed with a constant force it never measures
directly, estimates it from its own momentum residual, and shifts its
commanded ZMP to cancel it.

Run: JAX_PLATFORMS=cpu python examples/04_push_recovery_stack.py
(~2-3 min: one compile of the whole 0.1 s control tick, then 6 ticks)

This example uses the single-robot vmappable tick (`make_stack_step`).
For FLEETS on a card, use `make_fleet_stack_step` — identical semantics,
but the batch is explicit so the two QP solves run as single batched calls
(the WBC on the fused lane kernel, ``wbc_backend="pallas"``, with
``plant_lagged_minv=True``) — the production path of
`benchmarks/stack_bench.py`.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

from blf_tpu.models import rigid_body as rb
from blf_tpu.models.kinematics import forward_kinematics, frame_pose
from blf_tpu.models.lipm import LIPMParams
from blf_tpu.models.robots import HUMANOID_SOLE_FRAMES, make_humanoid_23dof
from blf_tpu.mpc.stack import StackConfig, init_stack, make_stack_step
from blf_tpu.mpc.wholebody import WholeBodyParams

HORIZON = 8


def standing_humanoid(tree):
    q = np.zeros(tree.num_dofs)
    names, dof = tree.link_names, tree.dof_index
    for side in ("l", "r"):
        q[dof[names.index(f"{side}_upper_leg")]] = 0.25
        q[dof[names.index(f"{side}_lower_leg")]] = -0.5
        q[dof[names.index(f"{side}_ankle_1")]] = 0.25
    q = jnp.asarray(q)
    poses = forward_kinematics(tree, jnp.zeros(3), jnp.eye(3), q)
    _, p_sole = frame_pose(tree, poses, "l_sole")
    return rb.FloatingBaseState(
        jnp.zeros(6), jnp.zeros(tree.num_dofs),
        jnp.array([0.0, 0.0, -float(p_sole[2])]), jnp.eye(3), q)


def main():
    tree = make_humanoid_23dof()
    wbc = WholeBodyParams(contact_frames=HUMANOID_SOLE_FRAMES)
    plant = standing_humanoid(tree)
    poses = forward_kinematics(tree, plant.base_position,
                               plant.base_rotation, plant.joint_positions)
    com = rb.com_position(tree, poses)
    lipm = LIPMParams(jnp.asarray(float(com[2])), jnp.asarray(9.81))
    stance = jnp.asarray(com[:2])

    config = StackConfig(horizon=HORIZON, mpc_iterations=60,
                         wbc_iterations=250)
    null_poses = {}
    for f in HUMANOID_SOLE_FRAMES:
        _, p0 = frame_pose(tree, poses, f)
        null_poses[f] = (jnp.eye(3),
                         p0 + jnp.array([0.0, 0.0, config.ground_sag]))
    step = jax.jit(make_stack_step(tree, wbc, lipm, config, null_poses,
                                   com_height_ref=float(com[2])))

    zmp_ref = jnp.broadcast_to(stance, (HORIZON, 2))
    dcm_ref = jnp.broadcast_to(stance, (HORIZON + 1, 2))
    poly_A = jnp.tile(jnp.asarray([[1.0, 0], [-1.0, 0], [0, 1.0], [0, -1.0]]),
                      (HORIZON, 1, 1))
    poly_b = jnp.broadcast_to(
        jnp.asarray([stance[0], -stance[0], stance[1], -stance[1]])
        + jnp.asarray([0.09, 0.09, 0.11, 0.11]), (HORIZON, 4))
    state = init_stack(tree, lipm, config, plant, 2 * HORIZON + HORIZON * 4)

    true_push = jnp.asarray([20.0, 6.0])          # [N], applied at the chest
    print(f"true push (invisible to the controller): {np.asarray(true_push)}")
    for k in range(6):
        state, trace = step(state, true_push, dcm_ref, zmp_ref,
                            poly_A, poly_b)
        print(f"t={0.1*(k+1):.1f}s  DCM err "
              f"{np.round(np.asarray(trace.dcm - stance), 4)}  "
              f"push estimate {np.round(np.asarray(state.push_theta), 1)}  "
              f"R33 {float(state.plant.base_rotation[2, 2]):.4f}")
    est = np.asarray(state.push_theta)
    print(f"final estimate {np.round(est, 2)} vs true "
          f"{np.asarray(true_push)} "
          f"({100*np.abs(est-np.asarray(true_push)).max()/20:.1f}% max err)")


if __name__ == "__main__":
    main()
