"""Floating-base rigid-body dynamics: mass matrix, bias forces, forward dynamics.

The dynamics half of the engine SURVEY.md §7 requires: the subset of
iDynTree the reference consumes — ``getFreeFloatingMassMatrix`` (CRBA),
``generalizedBiasForces`` (RNEA), frame Jacobians — plus the reference's own
``FloatingBaseDynamicalSystem::dynamics`` (``FloatingBaseSystemDynamics.cpp:
102-251``) rebuilt as a pure function suitable for ``vmap``/``lax.scan``/
Pallas rollouts.

Formulation (all in the mixed representation, like iDynTree):

- Per-link spatial inertia at the link origin, world axes:
  ``I_i = [[m·1, −m ĉ], [m ĉ, R I_c Rᵀ − m ĉ ĉ]]`` with ``c = R c_local``.
- Mass matrix by Jacobian composition: ``M(q) = Σ_i J_iᵀ I_i J_i`` — a batch
  of tiny batched GEMMs; equivalent to (not a translation of) CRBA.
- Bias forces by the Newton–Euler balance in the hybrid frame:
  ``h = Σ_i J_iᵀ (I_i (J̇_i ν) + β_i − f_i^grav)`` with the hybrid-frame
  velocity bias ``β_i = [m ω×(ω×c); ω̂ (R I_c Rᵀ) ω + m c×(ω×(ω×c))]``.
  The awkward term ``J̇_i ν`` is obtained **exactly** via ``jax.jvp`` of the
  link-velocity map along the state flow (ṗ = v, Ṙ = ω̂R, q̇ = s_dot) — no
  finite differences, no hand-derived recursion.
- Forward dynamics exactly as the reference:
  ``ν̇ = (M [+ M_reg])⁻¹ (−h + Σ J_cᵀ w_c + B τ)`` via Cholesky
  (``FloatingBaseSystemDynamics.cpp:229-244``), with the same SO(3) Baumgarte
  rotation propagation (``:135-140``).

Functions are single-sample; ``vmap`` provides scenario batching.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from blf_tpu.models.kinematics import (
    KinematicTree,
    LinkPoses,
    forward_kinematics,
    frame_jacobian,
    frame_pose,
    link_jacobians,
)
from blf_tpu.ops.lie import skew, so3_baumgarte_rate

__all__ = [
    "spatial_inertias",
    "mass_matrix",
    "link_velocities",
    "bias_forces",
    "generalized_gravity",
    "total_momentum",
    "kinetic_energy",
    "FloatingBaseState",
    "FloatingBaseInput",
    "floating_base_dynamics",
    "frame_velocity",
    "frame_kinematics",
    "frame_bias_acceleration",
    "com_position",
    "com_jacobian",
    "com_velocity",
    "com_bias_acceleration",
]

GRAVITY = jnp.array([0.0, 0.0, -9.81])


def spatial_inertias(tree: KinematicTree, poses: LinkPoses) -> jnp.ndarray:
    """(L, 6, 6) mixed-frame spatial inertia of every link at its origin."""
    dtype = poses.rotation.dtype
    R = poses.rotation
    m = jnp.asarray(tree.mass, dtype=dtype)[:, None, None]
    c = (R @ jnp.asarray(tree.com, dtype=dtype)[..., None])[..., 0]  # (L, 3)
    c_hat = skew(c)
    I_c = R @ jnp.asarray(tree.inertia, dtype=dtype) @ jnp.swapaxes(R, -1, -2)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), c_hat.shape)
    top = jnp.concatenate([m * eye, -m * c_hat], axis=-1)
    bottom = jnp.concatenate([m * c_hat, I_c - m * (c_hat @ c_hat)], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


from blf_tpu.ops.precision import f32_matmuls


@f32_matmuls
def mass_matrix(tree: KinematicTree, base_position, base_rotation, q,
                poses: Optional[LinkPoses] = None) -> jnp.ndarray:
    """Free-floating mass matrix (6+n, 6+n) w.r.t. mixed ν — the equivalent of
    ``KinDynComputations::getFreeFloatingMassMatrix``
    (``FloatingBaseSystemDynamics.cpp:175-180``)."""
    if poses is None:
        poses = forward_kinematics(tree, base_position, base_rotation, q)
    J = link_jacobians(tree, poses)          # (L, 6, nv)
    I = spatial_inertias(tree, poses)        # (L, 6, 6)
    return jnp.einsum("lki,lkm,lmj->ij", J, I, J)


def link_velocities(tree: KinematicTree, base_position, base_rotation, q, nu,
                    poses: Optional[LinkPoses] = None) -> jnp.ndarray:
    """(L, 6) mixed velocity of every link origin: ``v_i = J_i ν``."""
    if poses is None:
        poses = forward_kinematics(tree, base_position, base_rotation, q)
    J = link_jacobians(tree, poses)
    return jnp.einsum("lij,j->li", J, nu)


def _velocity_bias(tree: KinematicTree, poses: LinkPoses, vels: jnp.ndarray):
    """Hybrid-frame Newton–Euler velocity bias β_i (see module docstring)."""
    dtype = poses.rotation.dtype
    R = poses.rotation
    m = jnp.asarray(tree.mass, dtype=dtype)[:, None]
    c = (R @ jnp.asarray(tree.com, dtype=dtype)[..., None])[..., 0]
    I_c = R @ jnp.asarray(tree.inertia, dtype=dtype) @ jnp.swapaxes(R, -1, -2)
    omega = vels[:, 3:]
    wxc = jnp.cross(omega, c)
    wxwxc = jnp.cross(omega, wxc)
    beta_lin = m * wxwxc
    beta_ang = jnp.cross(omega, jnp.einsum("lij,lj->li", I_c, omega)) + m * jnp.cross(
        c, wxwxc
    )
    return jnp.concatenate([beta_lin, beta_ang], axis=-1)


def _gravity_wrenches(tree: KinematicTree, poses: LinkPoses, gravity) -> jnp.ndarray:
    """(L, 6) mixed gravity wrench on each link at its origin."""
    dtype = poses.rotation.dtype
    m = jnp.asarray(tree.mass, dtype=dtype)[:, None]
    c = (poses.rotation @ jnp.asarray(tree.com, dtype=dtype)[..., None])[..., 0]
    f = m * gravity
    tau = jnp.cross(c, f)
    return jnp.concatenate([f, tau], axis=-1)


@f32_matmuls
def bias_forces(tree: KinematicTree, base_position, base_rotation, q,
                base_twist, qdot, gravity=GRAVITY,
                poses: Optional[LinkPoses] = None) -> jnp.ndarray:
    """Generalized bias forces ``h(q, ν) = C ν + G`` (6+n,) — the equivalent of
    ``KinDynComputations::generalizedBiasForces``
    (``FloatingBaseSystemDynamics.cpp:183-188``)."""
    nu = jnp.concatenate([base_twist, qdot])
    if poses is None:
        poses = forward_kinematics(tree, base_position, base_rotation, q)

    # J̇ν exactly, via jvp along the state flow (ṗ=v, Ṙ=ω̂R, q̇=s_dot).
    omega = base_twist[3:]

    def vel_map(bp, bR, qq):
        return link_velocities(tree, bp, bR, qq, nu)

    _, jdot_nu = jax.jvp(
        vel_map,
        (base_position, base_rotation, q),
        (base_twist[:3], skew(omega) @ base_rotation, qdot),
    )

    J = link_jacobians(tree, poses)
    I = spatial_inertias(tree, poses)
    vels = jnp.einsum("lij,j->li", J, nu)
    beta = _velocity_bias(tree, poses, vels)
    f_grav = _gravity_wrenches(tree, poses, jnp.asarray(gravity, dtype=q.dtype))
    net = jnp.einsum("lij,lj->li", I, jdot_nu) + beta - f_grav
    return jnp.einsum("lij,li->j", J, net)


def generalized_gravity(tree: KinematicTree, base_position, base_rotation, q,
                        gravity=GRAVITY) -> jnp.ndarray:
    """Gravity part ``G(q)`` alone (h with ν = 0)."""
    poses = forward_kinematics(tree, base_position, base_rotation, q)
    J = link_jacobians(tree, poses)
    f_grav = _gravity_wrenches(tree, poses, jnp.asarray(gravity, dtype=q.dtype))
    return -jnp.einsum("lij,li->j", J, f_grav)


def total_momentum(tree: KinematicTree, base_position, base_rotation, q, nu
                   ) -> jnp.ndarray:
    """Total spatial momentum (6,) about the world origin — conserved for a
    free-floating system without external forces (engine test invariant)."""
    poses = forward_kinematics(tree, base_position, base_rotation, q)
    I = spatial_inertias(tree, poses)
    v = link_velocities(tree, base_position, base_rotation, q, nu, poses)
    h_links = jnp.einsum("lij,lj->li", I, v)     # momenta at link origins
    lin = jnp.sum(h_links[:, :3], axis=0)
    ang = jnp.sum(
        h_links[:, 3:] + jnp.cross(poses.position, h_links[:, :3]), axis=0
    )
    return jnp.concatenate([lin, ang])


def kinetic_energy(tree: KinematicTree, base_position, base_rotation, q, nu):
    M = mass_matrix(tree, base_position, base_rotation, q)
    return 0.5 * nu @ M @ nu


# ---------------------------------------------------------------------------
# Frame kinematics (contact attachment points)
# ---------------------------------------------------------------------------

def frame_velocity(tree: KinematicTree, poses: LinkPoses, frame: str, nu):
    """Mixed 6D velocity of a named frame (``KinDynComputations::getFrameVel``,
    consumed at ``FloatingBaseSystemDynamics.cpp:221``)."""
    return frame_jacobian(tree, poses, frame) @ nu


def frame_kinematics(tree: KinematicTree, poses: LinkPoses, frame: str, nu):
    """(rotation, position, velocity6) of a named frame in one go."""
    R, p = frame_pose(tree, poses, frame)
    return R, p, frame_jacobian(tree, poses, frame) @ nu


@f32_matmuls
def frame_bias_acceleration(tree: KinematicTree, base_position, base_rotation,
                            q, base_twist, qdot, frame: str) -> jnp.ndarray:
    """``J̇_f ν`` (6,) — the frame acceleration at zero generalized
    acceleration, exact via ``jax.jvp`` along the state flow (the same trick
    :func:`bias_forces` uses). Needed by acceleration-level contact
    constraints in the whole-body QP."""
    nu = jnp.concatenate([base_twist, qdot])

    def vel(bp, bR, qq):
        poses = forward_kinematics(tree, bp, bR, qq)
        return frame_jacobian(tree, poses, frame) @ nu

    _, jdot_nu = jax.jvp(
        vel,
        (base_position, base_rotation, q),
        (base_twist[:3], skew(base_twist[3:]) @ base_rotation, qdot),
    )
    return jdot_nu


# -- Centre of mass ---------------------------------------------------------

def com_position(tree: KinematicTree, poses: LinkPoses) -> jnp.ndarray:
    """World CoM (3,)."""
    m = jnp.asarray(tree.mass, dtype=poses.position.dtype)
    com_links = poses.position + jnp.einsum(
        "lij,lj->li", poses.rotation,
        jnp.asarray(tree.com, dtype=poses.position.dtype),
    )
    return (m @ com_links) / jnp.sum(m)


def com_jacobian(tree: KinematicTree, poses: LinkPoses) -> jnp.ndarray:
    """Linear CoM Jacobian (3, 6+n): ``ẋ_com = J_com ν``
    (iDynTree ``getCenterOfMassJacobian`` equivalent)."""
    from blf_tpu.models.kinematics import point_jacobian_columns

    m = jnp.asarray(tree.mass, dtype=poses.position.dtype)
    total = jnp.sum(m)
    J = jnp.zeros((3, 6 + tree.num_dofs), dtype=poses.position.dtype)
    for i in range(tree.num_links):
        ci = poses.position[i] + poses.rotation[i] @ jnp.asarray(
            tree.com[i], dtype=poses.position.dtype
        )
        J = J + m[i] * point_jacobian_columns(tree, poses, i, ci)[:3]
    return J / total


def com_velocity(tree: KinematicTree, poses: LinkPoses, nu) -> jnp.ndarray:
    return com_jacobian(tree, poses) @ nu


def com_bias_acceleration(tree: KinematicTree, base_position, base_rotation,
                          q, base_twist, qdot) -> jnp.ndarray:
    """``J̇_com ν`` (3,), exact via jvp (see :func:`frame_bias_acceleration`)."""
    nu = jnp.concatenate([base_twist, qdot])

    def vel(bp, bR, qq):
        poses = forward_kinematics(tree, bp, bR, qq)
        return com_jacobian(tree, poses) @ nu

    _, jdot_nu = jax.jvp(
        vel,
        (base_position, base_rotation, q),
        (base_twist[:3], skew(base_twist[3:]) @ base_rotation, qdot),
    )
    return jdot_nu


# ---------------------------------------------------------------------------
# The reference's FloatingBaseDynamicalSystem as a pure function
# ---------------------------------------------------------------------------

class FloatingBaseState(NamedTuple):
    """State tuple mirroring ``FloatingBaseSystemDynamics.h:51-146``:
    (base twist ν_b, joint velocities ṡ, base position, base rotation, joints s)."""

    base_twist: jnp.ndarray       # (6,) mixed
    joint_velocities: jnp.ndarray  # (n,)
    base_position: jnp.ndarray    # (3,)
    base_rotation: jnp.ndarray    # (3, 3)
    joint_positions: jnp.ndarray  # (n,)


class FloatingBaseInput(NamedTuple):
    """Input: joint torques + per-contact-frame wrenches.

    ``contact_wrenches`` maps frame name → (6,) mixed wrench — the pure-data
    equivalent of the reference's ``ContactWrench`` list
    (``ContactWrench.h:24-56``). For contact *models* (wrench computed from
    frame state), see :func:`make_contact_dynamics` below.
    """

    joint_torques: jnp.ndarray
    contact_wrenches: Dict[str, jnp.ndarray]


@f32_matmuls
def floating_base_dynamics(
    tree: KinematicTree,
    state: FloatingBaseState,
    inp: FloatingBaseInput,
    t=0.0,
    *,
    rho: float = 0.0,
    gravity=GRAVITY,
    mass_matrix_regularization: Optional[jnp.ndarray] = None,
    minv: Optional[jnp.ndarray] = None,
    minv_refine: int = 2,
) -> FloatingBaseState:
    """Full articulated forward dynamics, the reference's
    ``FloatingBaseDynamicalSystem::dynamics`` (``FloatingBaseSystemDynamics.cpp:
    102-251``) as a pure function:

    1. base kinematics with Baumgarte SO(3) stabilisation (``:135-140``);
    2. ``M``, ``h`` from the articulated model (``:175-188``);
    3. ``known = −h + Σ J_cᵀ w_c + B τ`` (``:191-229``);
    4. ``ν̇ = (M [+ M_reg])⁻¹ known`` by Cholesky (``:237-244``).

    Returns the state derivative as a :class:`FloatingBaseState` (same pytree
    structure, integrator-ready).

    ``minv``: optional LAGGED mass-matrix inverse (nv, nv), e.g. computed
    once per control tick. When given, the Cholesky solve is replaced by
    the preconditioned iterate ``ν̇ ← ν̇ + minv·(known − M ν̇)``
    (``minv_refine`` refinement passes against the EXACT current ``M``, so
    the solve error is ‖I − minv·M‖^(refine+1) — with joint motion ≲1 %
    per tick and 2 passes, ~1e-6 relative). This turns the hot-loop solve
    into matvecs: the fleet plant pays one batched factorization per TICK
    instead of per dynamics evaluation (the r5 profile found XLA's batched
    Cholesky at ~90 % of the plant's substep cost).
    """
    nu = jnp.concatenate([state.base_twist, state.joint_velocities])
    poses = forward_kinematics(
        tree, state.base_position, state.base_rotation, state.joint_positions
    )

    M = mass_matrix(tree, state.base_position, state.base_rotation,
                    state.joint_positions, poses)
    h = bias_forces(tree, state.base_position, state.base_rotation,
                    state.joint_positions, state.base_twist,
                    state.joint_velocities, gravity, poses)

    known = -h
    for frame_name, wrench in inp.contact_wrenches.items():
        Jc = frame_jacobian(tree, poses, frame_name)
        known = known + Jc.T @ wrench
    n = tree.num_dofs
    known = known.at[6:].add(inp.joint_torques)

    if mass_matrix_regularization is not None:
        M = M + mass_matrix_regularization
    if minv is not None:
        nu_dot = minv @ known
        for _ in range(max(0, minv_refine)):
            nu_dot = nu_dot + minv @ (known - M @ nu_dot)
    else:
        L = jnp.linalg.cholesky(M)
        nu_dot = jax.scipy.linalg.cho_solve((L, True), known)

    return FloatingBaseState(
        base_twist=nu_dot[:6],
        joint_velocities=nu_dot[6:],
        base_position=state.base_twist[:3],
        base_rotation=so3_baumgarte_rate(
            state.base_rotation, state.base_twist[3:], rho
        ),
        joint_positions=state.joint_velocities,
    )


def make_contact_dynamics(
    tree: KinematicTree,
    contact_params_by_frame: Dict[str, "object"],
    *,
    rho: float = 0.0,
    gravity=GRAVITY,
    mass_matrix_regularization: Optional[jnp.ndarray] = None,
):
    """Close the loop with :mod:`blf_tpu.models.contact`: wrenches computed
    from the live frame kinematics, as the reference wires ``ContactWrench`` →
    ``ContinuousContactModel`` (``FloatingBaseSystemDynamics.cpp:199-226``).

    ``contact_params_by_frame``: frame name → ``ContactParams``. Returns a
    dynamics function ``f(state, null_poses, t)`` where ``null_poses`` maps
    frame name → (null_rotation, null_position) (the contact model's
    zero-force pose, typically the planned foothold).
    """
    from blf_tpu.models import contact as contact_mod

    def dynamics(state: FloatingBaseState, null_poses, t=0.0) -> FloatingBaseState:
        poses = forward_kinematics(
            tree, state.base_position, state.base_rotation, state.joint_positions
        )
        nu = jnp.concatenate([state.base_twist, state.joint_velocities])
        wrenches = {}
        for frame_name, cparams in contact_params_by_frame.items():
            R_f, p_f, v_f = frame_kinematics(tree, poses, frame_name, nu)
            R0, p0 = null_poses[frame_name]
            cstate = contact_mod.ContactState(
                position=p_f, rotation=R_f,
                linear_velocity=v_f[:3], angular_velocity=v_f[3:],
                null_position=p0, null_rotation=R0,
            )
            wrenches[frame_name] = contact_mod.contact_wrench(cparams, cstate)
        inp = FloatingBaseInput(
            joint_torques=jnp.zeros(tree.num_dofs, dtype=state.joint_positions.dtype),
            contact_wrenches=wrenches,
        )
        return floating_base_dynamics(
            tree, state, inp, t, rho=rho, gravity=gravity,
            mass_matrix_regularization=mass_matrix_regularization,
        )

    return dynamics
