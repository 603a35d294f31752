"""URDF-lite loader/serializer tests.

The reference's model-ingestion path is iDynTree's URDF loader
(``FloatingBaseSystemDynamics.cpp:163-172`` consumes the resulting
``KinDynComputations``); here the committed ``humanoid_23dof.urdf`` must
lower to exactly the programmatic factory tree.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from blf_tpu.models.kinematics import (
    FIXED,
    PRISMATIC,
    REVOLUTE,
    forward_kinematics,
    frame_pose,
)
from blf_tpu.models.robots import make_humanoid_23dof
from blf_tpu.models.urdf import load_urdf, loads_urdf, to_urdf
from blf_tpu.ops.lie import so3_exp

URDF_PATH = os.path.join(
    os.path.dirname(__file__), "..", "blf_tpu", "models", "humanoid_23dof.urdf"
)


def assert_trees_equal(a, b, atol=1e-12):
    assert a.link_names == b.link_names
    assert a.parent == b.parent
    assert a.joint_type == b.joint_type
    for attr in ("axis", "joint_position", "joint_rotation", "mass", "com",
                 "inertia"):
        np.testing.assert_allclose(getattr(a, attr), getattr(b, attr),
                                   atol=atol, err_msg=attr)
    assert set(a.frames) == set(b.frames)
    for k in a.frames:
        (la, pa, Ra), (lb, pb, Rb) = a.frames[k], b.frames[k]
        assert la == lb
        np.testing.assert_allclose(pa, pb, atol=atol)
        np.testing.assert_allclose(Ra, Rb, atol=atol)


class TestRoundTrip:
    def test_committed_urdf_equals_factory(self):
        """The checked-in humanoid URDF is the factory model."""
        tree = load_urdf(URDF_PATH)
        assert_trees_equal(tree, make_humanoid_23dof())
        assert tree.num_dofs == 23

    def test_serialize_parse_identity(self):
        tree = make_humanoid_23dof()
        assert_trees_equal(loads_urdf(to_urdf(tree)), tree)

    def test_fk_matches_factory(self):
        """End-to-end: the loaded tree drives the batched FK identically."""
        tree_u = load_urdf(URDF_PATH)
        tree_f = make_humanoid_23dof()
        q = jnp.asarray(np.random.default_rng(0).normal(0, 0.3, 23))
        base_p = jnp.asarray([0.1, -0.2, 0.8])
        base_R = so3_exp(jnp.asarray([0.1, 0.2, -0.1]))
        pu = forward_kinematics(tree_u, base_p, base_R, q)
        pf = forward_kinematics(tree_f, base_p, base_R, q)
        np.testing.assert_allclose(pu.position, pf.position, atol=1e-12)
        np.testing.assert_allclose(pu.rotation, pf.rotation, atol=1e-12)


class TestUrdfSemantics:
    def test_rpy_is_fixed_axis_xyz(self):
        """URDF rpy = Rz(yaw)·Ry(pitch)·Rx(roll) (fixed-axis convention)."""
        text = """
        <robot name="r">
          <link name="base"><inertial><mass value="1"/>
            <inertia ixx="1" iyy="1" izz="1"/></inertial></link>
          <link name="child"><inertial><mass value="1"/>
            <inertia ixx="1" iyy="1" izz="1"/></inertial></link>
          <joint name="j" type="revolute">
            <origin xyz="0.1 0.2 0.3" rpy="0.3 -0.4 0.5"/>
            <parent link="base"/><child link="child"/>
            <axis xyz="0 0 1"/>
          </joint>
        </robot>"""
        tree = loads_urdf(text)
        ex, ey, ez = np.eye(3)
        R_expected = (np.asarray(so3_exp(jnp.asarray(0.5 * ez)))
                      @ np.asarray(so3_exp(jnp.asarray(-0.4 * ey)))
                      @ np.asarray(so3_exp(jnp.asarray(0.3 * ex))))
        np.testing.assert_allclose(tree.joint_rotation[1], R_expected,
                                   atol=1e-12)
        np.testing.assert_allclose(tree.joint_position[1], [0.1, 0.2, 0.3])

    def test_inertia_rotated_into_link_frame(self):
        """<inertial origin rpy> rotates the tensor: I_link = R I R^T."""
        text = """
        <robot name="r">
          <link name="base"><inertial>
            <origin xyz="0 0 0" rpy="0 0 1.5707963267948966"/>
            <mass value="2"/>
            <inertia ixx="1" iyy="4" izz="9"/></inertial></link>
        </robot>"""
        tree = loads_urdf(text)
        np.testing.assert_allclose(
            np.diag(tree.inertia[0]), [4.0, 1.0, 9.0], atol=1e-9)

    def test_fixed_massless_leaf_becomes_frame(self):
        text = """
        <robot name="r">
          <link name="base"><inertial><mass value="1"/>
            <inertia ixx="1" iyy="1" izz="1"/></inertial></link>
          <link name="sole"/>
          <joint name="j" type="fixed">
            <origin xyz="0 0 -0.05"/>
            <parent link="base"/><child link="sole"/>
          </joint>
        </robot>"""
        tree = loads_urdf(text)
        assert tree.num_links == 1
        assert "sole" in tree.frames
        link, p, R = tree.frames["sole"]
        assert link == 0
        np.testing.assert_allclose(p, [0, 0, -0.05])

    def test_fixed_massy_link_stays_a_link(self):
        text = """
        <robot name="r">
          <link name="base"><inertial><mass value="1"/>
            <inertia ixx="1" iyy="1" izz="1"/></inertial></link>
          <link name="battery"><inertial><mass value="0.5"/>
            <inertia ixx="1e-3" iyy="1e-3" izz="1e-3"/></inertial></link>
          <joint name="j" type="fixed">
            <parent link="base"/><child link="battery"/>
          </joint>
        </robot>"""
        tree = loads_urdf(text)
        assert tree.num_links == 2
        assert tree.joint_type[1] == FIXED
        assert tree.num_dofs == 0

    def test_prismatic_and_continuous(self):
        text = """
        <robot name="r">
          <link name="base"><inertial><mass value="1"/>
            <inertia ixx="1" iyy="1" izz="1"/></inertial></link>
          <link name="slider"><inertial><mass value="1"/>
            <inertia ixx="1" iyy="1" izz="1"/></inertial></link>
          <link name="wheel"><inertial><mass value="1"/>
            <inertia ixx="1" iyy="1" izz="1"/></inertial></link>
          <joint name="a" type="prismatic">
            <parent link="base"/><child link="slider"/>
            <axis xyz="1 0 0"/>
          </joint>
          <joint name="b" type="continuous">
            <parent link="slider"/><child link="wheel"/>
            <axis xyz="0 1 0"/>
          </joint>
        </robot>"""
        tree = loads_urdf(text)
        assert tree.joint_type[1] == PRISMATIC
        assert tree.joint_type[2] == REVOLUTE
        assert tree.num_dofs == 2

    def test_axis_normalized(self):
        text = """
        <robot name="r">
          <link name="base"><inertial><mass value="1"/>
            <inertia ixx="1" iyy="1" izz="1"/></inertial></link>
          <link name="c"><inertial><mass value="1"/>
            <inertia ixx="1" iyy="1" izz="1"/></inertial></link>
          <joint name="j" type="revolute">
            <parent link="base"/><child link="c"/>
            <axis xyz="0 0 2"/>
          </joint>
        </robot>"""
        tree = loads_urdf(text)
        np.testing.assert_allclose(tree.axis[1], [0, 0, 1])


class TestUrdfErrors:
    BASE = """
        <robot name="r">
          <link name="a"/><link name="b"/><link name="c"/>
          {joints}
        </robot>"""

    def test_two_roots_rejected(self):
        text = self.BASE.format(joints="""
          <joint name="j" type="fixed">
            <parent link="a"/><child link="b"/></joint>""")
        with pytest.raises(ValueError, match="exactly one root"):
            loads_urdf(text)

    def test_two_parents_rejected(self):
        text = self.BASE.format(joints="""
          <joint name="j1" type="fixed">
            <parent link="a"/><child link="c"/></joint>
          <joint name="j2" type="fixed">
            <parent link="b"/><child link="c"/></joint>""")
        with pytest.raises(ValueError, match="two parent joints"):
            loads_urdf(text)

    def test_unsupported_joint_type_rejected(self):
        text = self.BASE.format(joints="""
          <joint name="j1" type="floating">
            <parent link="a"/><child link="b"/></joint>
          <joint name="j2" type="fixed">
            <parent link="b"/><child link="c"/></joint>""")
        with pytest.raises(ValueError, match="unsupported joint type"):
            loads_urdf(text)

    def test_unknown_link_rejected(self):
        text = self.BASE.format(joints="""
          <joint name="j1" type="fixed">
            <parent link="a"/><child link="zzz"/></joint>""")
        with pytest.raises(ValueError, match="unknown"):
            loads_urdf(text)


class TestExternalModel:
    """Third-party-convention ingestion: an
    iCub-style URDF written in the public iCub model's conventions — mesh
    visuals, materials, joint limit/dynamics/safety tags, transmission and
    gazebo extensions, an interior fixed joint carrying a massive link
    (locked neck + head), continuous joints, scientific-notation numbers —
    none of which ``to_urdf`` ever emits. The loader must ingest it and the
    full engine + control stack must run on it (the reference consumes
    arbitrary iDynTree models the same way,
    ``FloatingBaseSystemDynamics.cpp:163-172``).

    Provenance: ``icub_style.urdf`` is
    AUTHORED IN THIS REPO to third-party conventions — this environment has
    no network access, so no genuinely external file could be vendored.
    What these tests therefore demonstrate is that the loader handles the
    URDF *dialect features* real exported models use (none of which our own
    serializer emits), not that it was validated on a file the authors
    never touched."""

    PATH = os.path.join(os.path.dirname(__file__), "..", "blf_tpu", "models",
                        "icub_style.urdf")

    def _tree(self):
        return load_urdf(self.PATH)

    def test_loads_with_foreign_features(self):
        tree = self._tree()
        assert tree.num_dofs == 23
        # head rides as a FIXED interior link (not a frame: it has mass)
        assert "head" in tree.link_names
        np.testing.assert_allclose(float(tree.total_mass), 34.32, atol=1e-6)
        # fixed massless leaves became frames
        assert set(tree.frames) == {"imu", "l_hand", "r_hand",
                                    "l_sole", "r_sole"}

    def test_fk_and_gravity_sanity(self):
        from blf_tpu.models import rigid_body as rb

        tree = self._tree()
        q = jnp.zeros(tree.num_dofs)
        poses = forward_kinematics(tree, jnp.zeros(3), jnp.eye(3), q)
        _, pl = frame_pose(tree, poses, "l_sole")
        _, pr = frame_pose(tree, poses, "r_sole")
        # legs symmetric, soles level, ~0.56 m below the root
        np.testing.assert_allclose(np.asarray(pl)[[0, 2]],
                                   np.asarray(pr)[[0, 2]], atol=1e-12)
        np.testing.assert_allclose(float(pl[1]), -float(pr[1]), atol=1e-12)
        assert -0.7 < float(pl[2]) < -0.4
        # generalized gravity balances the total weight on the base rows
        G = rb.generalized_gravity(tree, jnp.zeros(3), jnp.eye(3), q)
        np.testing.assert_allclose(
            float(G[2]), float(tree.total_mass) * 9.81, rtol=1e-6)

    def test_free_fall_dynamics(self):
        from blf_tpu.models import rigid_body as rb

        tree = self._tree()
        state = rb.FloatingBaseState(
            base_twist=jnp.zeros(6),
            joint_velocities=jnp.zeros(tree.num_dofs),
            base_position=jnp.zeros(3), base_rotation=jnp.eye(3),
            joint_positions=jnp.zeros(tree.num_dofs),
        )
        d = rb.floating_base_dynamics(
            tree, state,
            rb.FloatingBaseInput(joint_torques=jnp.zeros(tree.num_dofs),
                                 contact_wrenches={}))
        acc = np.asarray(jnp.concatenate([d.base_twist, d.joint_velocities]))
        assert np.all(np.isfinite(acc))
        # free fall: CoM linear acceleration = g, zero joint accelerations
        np.testing.assert_allclose(acc[2], -9.81, atol=1e-6)
        np.testing.assert_allclose(acc[6:], 0.0, atol=1e-5)

    def test_short_stack_episode(self):
        """The full config-4 stack (DCM-MPC + WBC + estimators + stiff
        plant) closed over the EXTERNAL model: two outer ticks must stay
        upright, converged, finite."""
        import jax

        from blf_tpu.models import rigid_body as rb
        from blf_tpu.models.lipm import LIPMParams
        from blf_tpu.mpc.stack import StackConfig, init_stack, make_stack_step
        from blf_tpu.mpc.wholebody import WholeBodyParams
        from blf_tpu.utils.status import SolverStatus

        tree = self._tree()
        n = tree.num_dofs
        names, dof = tree.link_names, tree.dof_index
        q = np.zeros(n)
        for side in ("l", "r"):
            q[dof[names.index(f"{side}_hip_1")]] = 0.25      # hip pitch
            q[dof[names.index(f"{side}_lower_leg")]] = -0.5  # knee
            q[dof[names.index(f"{side}_ankle_1")]] = 0.25    # ankle pitch
        qj = jnp.asarray(q)
        poses = forward_kinematics(tree, jnp.zeros(3), jnp.eye(3), qj)
        _, p_sole = frame_pose(tree, poses, "l_sole")
        plant = rb.FloatingBaseState(
            base_twist=jnp.zeros(6), joint_velocities=jnp.zeros(n),
            base_position=jnp.asarray([0.0, 0.0, -float(p_sole[2])]),
            base_rotation=jnp.eye(3), joint_positions=qj)
        poses = forward_kinematics(tree, plant.base_position,
                                   plant.base_rotation, qj)
        com = rb.com_position(tree, poses)
        lipm = LIPMParams(jnp.asarray(float(com[2])), jnp.asarray(9.81))
        stance = jnp.asarray(com[:2])
        H = 8
        zmp_ref = jnp.broadcast_to(stance, (H, 2))
        dcm_ref = jnp.broadcast_to(stance, (H + 1, 2))
        poly_A = jnp.tile(jnp.asarray(
            [[1.0, 0], [-1.0, 0], [0, 1.0], [0, -1.0]]), (H, 1, 1))
        half = jnp.asarray([0.09, 0.09, 0.11, 0.11])
        poly_b = jnp.broadcast_to(
            jnp.asarray([stance[0], -stance[0], stance[1], -stance[1]])
            + half, (H, 4))
        config = StackConfig(mpc_dt=0.1, horizon=H, wbc_per_mpc=10,
                             physics_per_wbc=4, plant_method="rosenbrock",
                             mpc_iterations=60, wbc_iterations=150)
        wbc = WholeBodyParams(contact_frames=("l_sole", "r_sole"))
        null_poses = {}
        for f in ("l_sole", "r_sole"):
            _, p0 = frame_pose(tree, poses, f)
            null_poses[f] = (jnp.eye(3),
                             p0 + jnp.asarray([0.0, 0.0, config.ground_sag]))
        step = jax.jit(make_stack_step(
            tree, wbc, lipm, config, null_poses, q_ref=qj,
            com_height_ref=float(com[2])))
        state = init_stack(tree, lipm, config, plant, 2 * H + H * 4)
        push = jnp.asarray([6.0, -3.0])
        for _ in range(2):
            state, tr = step(state, push, dcm_ref, zmp_ref, poly_A, poly_b)
        assert int(tr.status) == int(SolverStatus.CONVERGED)
        assert float(state.plant.base_rotation[2, 2]) > 0.98
        assert bool(jnp.all(jnp.isfinite(state.plant.base_position)))
        assert float(jnp.abs(tr.dcm - stance).max()) < 0.05
