"""Hierarchical control stack (blf_tpu.mpc.stack) — BASELINE config 4 full:
DCM-MPC outer loop + 100 Hz whole-body inner loop with the momentum observer
and RLS push filter IN the loop.

Verification follows the reference's closed-loop/statistical style
(SURVEY.md §4 patterns 5-6): the plant is the real articulated humanoid, the
push is invisible to the controller, and the tests check (a) stability,
(b) estimator convergence to the true push, and (c) that the estimate
actually FEEDS the controller — the compensation ablation must measurably
degrade tracking.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blf_tpu.models import rigid_body as rb
from blf_tpu.models.kinematics import forward_kinematics, frame_pose
from blf_tpu.models.lipm import LIPMParams
from blf_tpu.models.robots import HUMANOID_SOLE_FRAMES, make_humanoid_23dof
from blf_tpu.mpc.stack import (
    StackConfig,
    init_stack,
    make_stack_step,
)
from blf_tpu.mpc.wholebody import WholeBodyParams

TREE = make_humanoid_23dof()
WBC = WholeBodyParams(contact_frames=HUMANOID_SOLE_FRAMES)
N = TREE.num_dofs
HORIZON = 8


def standing_state():
    q = np.zeros(N)
    names, dof = TREE.link_names, TREE.dof_index

    def set_joint(link, value):
        q[dof[names.index(link)]] = value

    for side in ("l", "r"):
        set_joint(f"{side}_upper_leg", 0.25)
        set_joint(f"{side}_lower_leg", -0.5)
        set_joint(f"{side}_ankle_1", 0.25)
    q = jnp.asarray(q)
    poses = forward_kinematics(TREE, jnp.zeros(3), jnp.eye(3), q)
    _, p_sole = frame_pose(TREE, poses, "l_sole")
    return rb.FloatingBaseState(
        base_twist=jnp.zeros(6),
        joint_velocities=jnp.zeros(N),
        base_position=jnp.array([0.0, 0.0, -float(p_sole[2])]),
        base_rotation=jnp.eye(3),
        joint_positions=q,
    )


@functools.lru_cache(maxsize=8)
def setup(compensate=True, plant_method="rk4", physics_per_wbc=40,
          wbc_iterations=250, wbc_polish_iters=0):
    """(step_fn jitted, init StackState, refs, lipm) — cached per config so
    each compilation happens once across the module."""
    plant = standing_state()
    poses = forward_kinematics(TREE, plant.base_position, plant.base_rotation,
                               plant.joint_positions)
    com = rb.com_position(TREE, poses)
    lipm = LIPMParams(jnp.asarray(float(com[2])), jnp.asarray(9.81))

    stance = jnp.asarray(com[:2])
    zmp_ref = jnp.broadcast_to(stance, (HORIZON, 2))
    dcm_ref = jnp.broadcast_to(stance, (HORIZON + 1, 2))
    poly_A = jnp.tile(
        jnp.asarray([[1.0, 0], [-1.0, 0], [0, 1.0], [0, -1.0]]),
        (HORIZON, 1, 1),
    )
    half = jnp.asarray([0.09, 0.09, 0.11, 0.11])
    poly_b = jnp.broadcast_to(
        jnp.asarray([stance[0], -stance[0], stance[1], -stance[1]]) + half,
        (HORIZON, 4),
    )
    config = StackConfig(
        mpc_dt=0.1, horizon=HORIZON, wbc_per_mpc=10,
        physics_per_wbc=physics_per_wbc, plant_method=plant_method,
        mpc_iterations=60, wbc_iterations=wbc_iterations,
        wbc_polish_iters=wbc_polish_iters, compensate_push=compensate,
    )
    # ground anchors: zero-force pose one static-sag above each sole so the
    # compliant ground starts pre-loaded at the standing weight
    null_poses = {}
    for f in HUMANOID_SOLE_FRAMES:
        from blf_tpu.models.kinematics import frame_pose as _fp
        _, p0 = _fp(TREE, poses, f)
        null_poses[f] = (jnp.eye(3),
                         p0 + jnp.array([0.0, 0.0, config.ground_sag]))
    q_ref = plant.joint_positions
    step = make_stack_step(TREE, WBC, lipm, config, null_poses, q_ref=q_ref,
                           com_height_ref=float(com[2]))
    num_constraints = 2 * HORIZON + HORIZON * 4
    state0 = init_stack(TREE, lipm, config, plant, num_constraints)
    jitted = jax.jit(step)
    refs = (dcm_ref, zmp_ref, poly_A, poly_b)
    return jitted, state0, refs, lipm, stance


def run(steps, push_xy, compensate=True):
    step, state, refs, lipm, stance = setup(compensate)
    push = jnp.asarray(push_xy, state.plant.joint_positions.dtype)
    traces = []
    for _ in range(steps):
        state, tr = step(state, push, *refs)
        traces.append(tr)
    return state, traces, stance


class TestBalance:
    def test_stack_holds_posture_without_push(self):
        state, traces, stance = run(3, (0.0, 0.0))
        p = state.plant
        assert float(p.base_rotation[2, 2]) > 0.99
        assert np.abs(np.asarray(p.base_twist)).max() < 0.5
        # DCM stays at the stance reference
        assert np.abs(np.asarray(traces[-1].dcm - stance)).max() < 0.02
        # no phantom push: the estimator must not invent a force
        assert np.abs(np.asarray(state.push_theta)).max() < 4.0
        assert all(bool(t.wbc_converged) for t in traces)

    def test_push_recovery_with_estimation(self):
        """0.8 s under an unseen constant 18 N push: the stack must stay up,
        the RLS estimate must converge to the true force, and the DCM must
        settle back near the reference (compensated equilibrium)."""
        push = (18.0, 7.0)
        state, traces, stance = run(6, push)
        p = state.plant
        assert float(p.base_rotation[2, 2]) > 0.98
        assert np.abs(np.asarray(p.base_twist)).max() < 0.6
        est = np.asarray(state.push_theta)
        np.testing.assert_allclose(est, np.asarray(push), rtol=0.3, atol=3.0)
        # final DCM within the support box
        assert np.abs(np.asarray(traces[-1].dcm - stance)).max() < 0.06

    def test_compensation_feeds_controller(self):
        """Ablation: with the estimator output disconnected
        (compensate_push=False) the steady-state DCM offset under the same
        push must be LARGER than with the estimate in the loop — the
        filters demonstrably feed the controller."""
        push = (25.0, 0.0)
        s_on, tr_on, stance = run(6, push, compensate=True)
        s_off, tr_off, _ = run(6, push, compensate=False)
        err_on = float(jnp.linalg.norm(tr_on[-1].dcm - stance))
        err_off = float(jnp.linalg.norm(tr_off[-1].dcm - stance))
        # both variants share a small tilt-induced offset (the push's MOMENT
        # tilts the base against the finite orientation gain); the ZMP
        # compensation must still visibly shrink the translational error
        assert err_off > 1.25 * err_on, (err_on, err_off)
        assert err_off - err_on > 0.008, (err_on, err_off)


class TestFleet:
    def test_vmap_push_fleet(self):
        """Scenario batching: three pushes as one vmapped program."""
        step, state, refs, lipm, stance = setup(True)
        pushes = jnp.asarray([[0.0, 0.0], [12.0, 4.0], [-10.0, 6.0]])
        fleet0 = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (3,) + a.shape), state)
        vstep = jax.jit(jax.vmap(lambda s, p: step(s, p, *refs)))
        fleet, tr = vstep(fleet0, pushes)
        fleet, tr = vstep(fleet, pushes)
        assert tr.dcm.shape == (3, 2)
        assert bool(jnp.all(jnp.isfinite(fleet.plant.base_position)))
        assert bool(jnp.all(jnp.isfinite(fleet.push_theta)))

    def test_fleet_step_matches_vmapped_step(self):
        """The fleet-native tick (batched QP solves — the kernel-backend
        entry point, r5) must reproduce the vmapped per-lane tick: same
        math, different batching structure."""
        from blf_tpu.mpc.stack import make_fleet_stack_step
        from blf_tpu.models.kinematics import frame_pose as _fp

        step, state, refs, lipm, stance = setup(True)
        plant = standing_state()
        poses = forward_kinematics(TREE, plant.base_position,
                                   plant.base_rotation, plant.joint_positions)
        com = rb.com_position(TREE, poses)
        config = StackConfig(
            mpc_dt=0.1, horizon=HORIZON, wbc_per_mpc=10,
            physics_per_wbc=40, plant_method="rk4",
            mpc_iterations=60, wbc_iterations=250,
            wbc_polish_iters=0, compensate_push=True,
        )
        null_poses = {}
        for f in HUMANOID_SOLE_FRAMES:
            _, p0 = _fp(TREE, poses, f)
            null_poses[f] = (jnp.eye(3),
                             p0 + jnp.array([0.0, 0.0, config.ground_sag]))
        fleet_step = jax.jit(make_fleet_stack_step(
            TREE, WBC, lipm, config, null_poses,
            q_ref=plant.joint_positions, com_height_ref=float(com[2])))

        pushes = jnp.asarray([[12.0, 4.0], [-10.0, 6.0]])
        fleet0 = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (2,) + a.shape), state)
        vstep = jax.jit(jax.vmap(lambda s, p: step(s, p, *refs)))
        ref_state, ref_tr = vstep(fleet0, pushes)
        new_state, new_tr = fleet_step(fleet0, pushes, *refs)

        # same per-lane physics/estimates to float reassociation tolerance
        np.testing.assert_allclose(
            np.asarray(new_state.plant.base_position),
            np.asarray(ref_state.plant.base_position), atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(new_state.plant.joint_positions),
            np.asarray(ref_state.plant.joint_positions), atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(new_state.push_theta),
            np.asarray(ref_state.push_theta), atol=1e-3)
        np.testing.assert_allclose(
            np.asarray(new_tr.dcm), np.asarray(ref_tr.dcm), atol=1e-6)
        assert new_tr.status.shape == (2,)
        assert bool(jnp.all(new_tr.wbc_converged == ref_tr.wbc_converged))

    def test_fleet_step_kernel_backends(self):
        """Kernel-backend fleet tick (interpret mode on CPU): the WBC solve
        on the fused lane kernel must stay finite and converge like the XLA
        path on a small fleet."""
        from blf_tpu.mpc.stack import make_fleet_stack_step
        from blf_tpu.models.kinematics import frame_pose as _fp

        step, state, refs, lipm, stance = setup(True)
        plant = standing_state()
        poses = forward_kinematics(TREE, plant.base_position,
                                   plant.base_rotation, plant.joint_positions)
        com = rb.com_position(TREE, poses)
        config = StackConfig(
            mpc_dt=0.1, horizon=HORIZON, wbc_per_mpc=10,
            physics_per_wbc=4, plant_method="rosenbrock",
            mpc_iterations=60, wbc_iterations=150,
            wbc_check_every=150, wbc_polish_iters=25, compensate_push=True,
            wbc_backend="pallas",
            # production tolerance: cold-start lanes at 150 fused v-space
            # iterations/ tick sit ~3e-3 dual in f64 (no warm history in a
            # 2-tick test); the bench's convergence contract is 1e-4
            wbc_eps=1e-4,
        )
        null_poses = {}
        for f in HUMANOID_SOLE_FRAMES:
            _, p0 = _fp(TREE, poses, f)
            null_poses[f] = (jnp.eye(3),
                             p0 + jnp.array([0.0, 0.0, config.ground_sag]))
        fleet_step = jax.jit(make_fleet_stack_step(
            TREE, WBC, lipm, config, null_poses,
            q_ref=plant.joint_positions, com_height_ref=float(com[2])))
        pushes = jnp.asarray([[8.0, -3.0], [-6.0, 5.0]])
        fleet = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (2,) + a.shape), state)
        for _ in range(2):
            fleet, tr = fleet_step(fleet, pushes, *refs)
        assert bool(jnp.all(jnp.isfinite(fleet.plant.base_position)))
        assert bool(jnp.all(tr.wbc_converged)), (
            np.asarray(tr.wbc_max_rp), np.asarray(tr.wbc_max_rd))
        assert bool(jnp.all(tr.status == 0))


class TestStiffPlant:
    """The production plant integrator (ROS2-W, one lagged stage operator
    per outer tick) against the explicit-RK4 reference plant."""

    def test_rosenbrock_plant_matches_rk4_closed_loop(self):
        """Same controller, same push: the 4-substep ROS2 plant's closed-loop
        DCM/CoM trajectory must track the 40-substep RK4 plant's to
        millimetres over 0.4 s — the stiff sole transients it smooths decay
        anyway; what must agree is the behavior the benchmark measures."""
        push = (14.0, 5.0)
        s_rk, tr_rk, stance = run(4, push)
        step, state, refs, _, _ = setup(
            True, plant_method="rosenbrock", physics_per_wbc=4)
        pushv = jnp.asarray(push, state.plant.joint_positions.dtype)
        tr_ros = []
        for _ in range(4):
            state, tr = step(state, pushv, *refs)
            tr_ros.append(tr)
        for a, b in zip(tr_ros, tr_rk):
            np.testing.assert_allclose(np.asarray(a.dcm), np.asarray(b.dcm),
                                       atol=3e-3)
            np.testing.assert_allclose(np.asarray(a.com), np.asarray(b.com),
                                       atol=3e-3)
        np.testing.assert_allclose(
            np.asarray(state.push_theta), np.asarray(s_rk.push_theta),
            atol=1.5)

    def test_stiff_operator_fleet_matches_rk4(self):
        """Production fleet plant (ROS2-W at 2 substeps, per-tick lagged
        M⁻¹, STIFF-PATH-ONLY stage operator — r5 `ros_op_stiff`) against
        the explicit-RK4 fleet: a W-method may lag/approximate its
        operator, but the closed-loop behavior the benchmark measures must
        stay within the same millimetre contract as the full operator.
        Measured profile: error peaks ~1.0e-3 m in the push transient and
        decays to ~3e-4 in steady state (bounded, not accumulating)."""
        from blf_tpu.mpc.stack import make_fleet_stack_step
        from blf_tpu.models.kinematics import frame_pose as _fp

        plant = standing_state()
        poses = forward_kinematics(TREE, plant.base_position,
                                   plant.base_rotation, plant.joint_positions)
        com = rb.com_position(TREE, poses)
        lipm = LIPMParams(jnp.asarray(float(com[2])), jnp.asarray(9.81))
        stance = jnp.asarray(com[:2])
        refs = (jnp.broadcast_to(stance, (HORIZON + 1, 2)),
                jnp.broadcast_to(stance, (HORIZON, 2)),
                jnp.tile(jnp.asarray([[1.0, 0], [-1.0, 0],
                                      [0, 1.0], [0, -1.0]]), (HORIZON, 1, 1)),
                jnp.broadcast_to(
                    jnp.asarray([stance[0], -stance[0],
                                 stance[1], -stance[1]])
                    + jnp.asarray([0.09, 0.09, 0.11, 0.11]), (HORIZON, 4)))

        def make(method, substeps, stiff):
            cfg = StackConfig(
                mpc_dt=0.1, horizon=HORIZON, wbc_per_mpc=10,
                physics_per_wbc=substeps, plant_method=method,
                mpc_iterations=60, wbc_iterations=250,
                plant_lagged_minv=stiff, ros_op_stiff=stiff)
            null_poses = {}
            for f in HUMANOID_SOLE_FRAMES:
                _, p0 = _fp(TREE, poses, f)
                null_poses[f] = (jnp.eye(3),
                                 p0 + jnp.array([0.0, 0.0, cfg.ground_sag]))
            stp = jax.jit(make_fleet_stack_step(
                TREE, WBC, lipm, cfg, null_poses,
                q_ref=plant.joint_positions, com_height_ref=float(com[2])))
            st = init_stack(TREE, lipm, cfg, plant, 2 * HORIZON + HORIZON * 4)
            return stp, jax.tree_util.tree_map(
                lambda a: jnp.broadcast_to(a, (2,) + a.shape), st)

        pushes = jnp.asarray([[14.0, 5.0], [-10.0, 7.0]])
        step_rk, st_rk = make("rk4", 40, False)
        step_st, st_st = make("rosenbrock", 2, True)
        worst = 0.0
        for _ in range(4):
            st_rk, tr_rk = step_rk(st_rk, pushes, *refs)
            st_st, tr_st = step_st(st_st, pushes, *refs)
            worst = max(worst, float(jnp.max(jnp.abs(tr_st.dcm - tr_rk.dcm))))
        assert worst < 3e-3, worst
        np.testing.assert_allclose(np.asarray(st_st.push_theta),
                                   np.asarray(st_rk.push_theta), atol=1.5)

    def test_status_and_quarantine(self):
        """Nominal lanes report CONVERGED; a lane whose plant state is
        poisoned mid-episode goes NUMERICAL_ERROR and is reset to its
        pre-tick state with cleared warm starts (fleet-tick semantics)."""
        from blf_tpu.utils.status import SolverStatus

        step, state, refs, _, _ = setup(
            True, plant_method="rosenbrock", physics_per_wbc=4)
        push = jnp.asarray((5.0, 2.0), state.plant.joint_positions.dtype)
        state1, tr1 = step(state, push, *refs)
        assert int(tr1.status) == int(SolverStatus.CONVERGED)

        poisoned = state1._replace(
            plant=state1.plant._replace(
                base_twist=state1.plant.base_twist.at[0].set(jnp.nan)))
        state2, tr2 = step(poisoned, push, *refs)
        assert int(tr2.status) == int(SolverStatus.NUMERICAL_ERROR)
        # quarantine: restart from the (poisoned) pre-tick lane with NaNs
        # sanitized and warm starts cleared — all finite again
        assert bool(jnp.all(jnp.isfinite(
            jax.flatten_util.ravel_pytree(state2)[0])))
        assert float(jnp.max(jnp.abs(state2.warm_wbc_x))) == 0.0
