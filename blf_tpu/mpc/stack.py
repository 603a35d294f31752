"""Hierarchical control stack — DCM-MPC outer loop, whole-body QP inner
loop, estimators in the loop (BASELINE config 4 in full).

The reference snapshot ships the *substrate* for this controller (dynamics +
integrators ``FixedStepIntegrator.tpp:22-72``, the RLS estimator
``RecursiveLeastSquare.cpp:96-133``, contact data structures) but never
wires a closed loop; later upstream versions do exactly this wiring. Here
the whole stack is ONE pure, jittable, vmappable function:

    outer tick (MPC rate, e.g. 10 Hz)
      ├─ measure: CoM/DCM from the plant state (ξ = c + ċ/ω)
      ├─ freeze the RLS push estimate f̂ for this tick (feeding the 100 Hz
      │    estimate straight back into the same tick's torques closes an
      │    estimator→torque loop that rings the joints — r4 diagnosis)
      ├─ plan: batched DCM-MPC (blf_tpu.mpc.dcm) from the measured DCM
      └─ inner ticks (WBC rate, e.g. 100 Hz), lax.scan:
           ├─ instantaneous DCM controller: z_cmd = z_plan
           │    + (1+k_ξ/ω)(ξ−ξ_ref) + ∫k_i(ξ−ξ_ref) — the integral soaks
           │    constant flow biases (compliant-sole model mismatch,
           │    estimate residue) no feedforward can
           ├─ whole-body QP (blf_tpu.mpc.wholebody) tracking
           │    ω²(c − z_cmd) in xy + height/posture PD, with f̂ MODELED in
           │    the dynamics equality (the estimator feeds the controller's
           │    model, so the push's moment no longer biases realized
           │    accelerations)
           ├─ plant: rigid-body dynamics + TRUE (unknown) push — stiff
           │    ROS2-W substeps (or reference-faithful RK4)
           ├─ momentum observer tick on (sampled state, commanded torques)
           └─ wrench attribution over [feet…, push frame] + RLS update of
              the push-force estimate  ←  "Estimators … batched filters
              feeding the controller" (BASELINE.json north star)

Everything is static-shape: fixed inner-tick counts, fixed contact sets,
fixed MPC horizon — one compilation covers the whole episode, and ``vmap``
over :class:`StackState` runs scenario fleets (push-recovery sweeps) on the
batch axis.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from blf_tpu.estimators.rls import RLSParams, RLSState, rls_step
from blf_tpu.models.contact import ContactParams, ContactState, contact_wrench
from blf_tpu.estimators.wrench_observer import (
    MomentumObserverParams,
    MomentumObserverState,
    init_momentum_observer,
    momentum_observer_step,
    wrenches_from_residual,
)
from blf_tpu.models import rigid_body as rb
from blf_tpu.models.kinematics import (
    KinematicTree,
    forward_kinematics,
    frame_jacobian,
)
from blf_tpu.models.lipm import LIPMParams, lipm_omega
from blf_tpu.mpc.dcm import DCMWeights, solve_dcm_mpc
from blf_tpu.mpc.qp import solve_qp
from blf_tpu.mpc.wholebody import (
    WholeBodyParams,
    WholeBodyTask,
    build_wholebody_qp,
    solve_wholebody_qp,
)
from blf_tpu.ops.integrators import (
    integrate,
    integrate_rosenbrock,
    rosenbrock_operator,
)
from blf_tpu.ops.linalg import solve_psd_small, spd_inverse
from blf_tpu.ops.precision import f32_matmuls
from blf_tpu.ops.lie import so3_log
from blf_tpu.utils.status import SolverStatus, nan_quarantine

__all__ = ["StackConfig", "StackState", "StackTrace", "init_stack",
           "make_stack_step", "make_fleet_stack_step"]


class StackConfig(NamedTuple):
    """Static configuration of the hierarchical controller (hashable —
    safe to close over under jit)."""

    mpc_dt: float = 0.1             # outer replan period [s]
    horizon: int = 16               # MPC knots
    wbc_per_mpc: int = 10           # inner ticks per outer tick (→ 100 Hz)
    physics_per_wbc: int = 40       # plant substeps per inner tick. With
                                    # plant_method="rk4" the sole-ground
                                    # modes on the light (0.6 kg) foot links
                                    # need ~0.25 ms (40 substeps) for
                                    # stability (measured: 1 ms diverges,
                                    # 0.25 ms matches 0.1 ms); the L-stable
                                    # "rosenbrock" plant runs 4 substeps
                                    # (2.5 ms) at equal closed-loop accuracy
    plant_method: str = "rk4"       # "rk4" (explicit, reference-faithful) or
                                    # "rosenbrock" (stiff ROS2-W, one lagged
                                    # stage operator per OUTER tick — the
                                    # production/bench integrator; accuracy
                                    # pinned by tests/test_control_stack.py)
    ground_sag: float = 2e-3        # static ground compression per foot [m]
    mpc_iterations: int = 60
    wbc_iterations: int = 250
    wbc_check_every: int = 25       # ADMM stage length (ρ-adaptation cadence)
    wbc_polish_iters: int = 0       # low-ρ dual-polish tail (solve_qp)
    dcm_gain: float = 1.2           # k_ξ of the instantaneous DCM controller
    dcm_ki: float = 0.06            # integral gain on the DCM error [1/s]:
    #   absorbs EVERY constant flow bias — compliant-sole model mismatch,
    #   residual estimate error — that neither the WBC wrench model nor a
    #   feedforward z-shift can (r4 diagnosis: med. steady DCM offset
    #   ~3.5 cm ∝ push without it). Stability: ξ̈ + k_ξ ξ̇ + ω k_i ξ = 0 ⇒
    #   damped for k_i ≤ k_ξ²/(4ω) ≈ 0.085 at the bench ω
    dcm_int_limit: float = 0.06     # anti-windup clamp on the integral [m]
    height_kp: float = 100.0
    height_kd: float = 20.0
    base_kp: float = 60.0           # base-orientation restoring gain (the
    base_kd: float = 15.0           # push applies a MOMENT at the push frame)
    posture_kp: float = 100.0
    posture_kd: float = 20.0
    observer_gain: float = 60.0     # momentum-residual bandwidth [rad/s]
    rls_lambda: float = 0.97
    rls_noise: float = 1e-2
    compensate_push: bool = True    # feed f̂ into the WBC model (ablation)
    wbc_eps: Optional[float] = None  # WBC QP convergence tolerance; None →
    #   1e-5 in f64, 1e-4 in f32 (the realistic single-precision residual
    #   floor of the per-lane ADMM — same dtype reasoning as solve_qp's
    #   rho_eq_scale default)
    wbc_backend: str = "xla"        # fleet path only: WBC QP backend —
    #   "pallas" routes the per-lane solve through the fused lane kernel
    #   (blf_tpu.ops.pallas.admm_lane)
    wbc_scaling_iters: int = 10     # Ruiz equilibration rounds per WBC
    #   solve. The solver default (10, OSQP-style) is conservative for the
    #   100 Hz loop where consecutive problems are near-identical; the
    #   production bench runs 4 (measured: same convergence/residuals,
    #   ~1.3 ms/solve of batched max-reductions saved at B=256)
    plant_lagged_minv: bool = False  # fleet path only: solve the plant's
    #   M(q)ν̇ = known with a per-TICK mass-matrix inverse + 2 refinement
    #   passes against the exact per-substep M (rel. error ~‖ΔM/M‖³ ≈ 1e-6
    #   at ≲1 % joint motion per tick) instead of a per-evaluation batched
    #   Cholesky. The production bench turns this on.
    ros_op_stiff: bool = False      # fleet path only (requires
    #   plant_lagged_minv): build the ROS2-W stage operator by
    #   differentiating ONLY the stiff sole-ground path (frozen J_cᵀ,
    #   lagged M⁻¹) instead of the full dynamics — halves the per-tick
    #   jacfwd; accuracy vs the RK4 reference pinned by the stack tests.


class StackState(NamedTuple):
    """Everything the closed loop carries tick to tick (vmap batch axis on
    every leaf for fleets)."""

    plant: rb.FloatingBaseState
    observer: MomentumObserverState
    push_theta: jnp.ndarray         # (2,) RLS xy push-force estimate [N]
    push_cov: jnp.ndarray           # (2, 2)
    warm_zmp: jnp.ndarray           # (N, 2) previous MPC plan
    warm_y: jnp.ndarray             # (M,) previous MPC duals
    warm_s: jnp.ndarray             # (1,) adapted ADMM ρ multiplier
    warm_wbc_x: jnp.ndarray         # (nx,) previous WBC primal (tick-to-tick)
    warm_wbc_y: jnp.ndarray         # (mw,) previous WBC duals
    warm_wbc_s: jnp.ndarray         # (1,) adapted WBC ADMM ρ multiplier
    dcm_int: jnp.ndarray            # (2,) DCM-error integral state [m]


class StackTrace(NamedTuple):
    """Per-outer-tick diagnostics."""

    dcm: jnp.ndarray                # (2,) measured DCM at tick start
    com: jnp.ndarray                # (3,)
    zmp_cmd: jnp.ndarray            # (2,) last inner-tick commanded ZMP
    push_estimate: jnp.ndarray      # (2,) RLS estimate fed to the controller
    mpc_converged: jnp.ndarray      # () bool
    wbc_converged: jnp.ndarray      # () bool: all inner ticks converged
    wbc_max_rp: jnp.ndarray         # () worst inner-tick WBC primal residual
    wbc_max_rd: jnp.ndarray         # () worst inner-tick WBC dual residual
    status: jnp.ndarray             # () int32 SolverStatus: worst of MPC /
    #   WBC / plant-finiteness this tick (failure handling as data,
    #   SURVEY.md §5; lanes at NUMERICAL_ERROR are quarantined — reset to
    #   the pre-tick state with cleared warm starts, like the fleet tick)


def _com_state(tree, lipm, state):
    poses = forward_kinematics(tree, state.base_position, state.base_rotation,
                               state.joint_positions)
    com = rb.com_position(tree, poses)
    nu = jnp.concatenate([state.base_twist, state.joint_velocities])
    com_vel = rb.com_velocity(tree, poses, nu)
    omega = lipm_omega(lipm)
    dcm = com[:2] + com_vel[:2] / omega
    return com, com_vel, dcm


def init_stack(
    tree: KinematicTree,
    lipm: LIPMParams,
    config: StackConfig,
    plant: rb.FloatingBaseState,
    num_constraints: int,
    num_contacts: int = 2,
) -> StackState:
    """Stack state at rest: observer seeded at p(0), zero push estimate,
    zero MPC and WBC warm starts (``num_contacts`` sizes the WBC decision/
    constraint vectors — see :mod:`blf_tpu.mpc.wholebody`)."""
    dtype = plant.joint_positions.dtype
    _, obs = init_momentum_observer(
        tree, plant, config.observer_gain,
        config.mpc_dt / config.wbc_per_mpc,
    )
    n, nv, C = tree.num_dofs, tree.nv, num_contacts
    nx = nv + 6 * C + n
    mw = nv + 6 * C + 11 * C + n
    return StackState(
        plant=plant,
        observer=obs,
        push_theta=jnp.zeros(2, dtype),
        push_cov=jnp.eye(2, dtype=dtype) * 1e2,
        warm_zmp=jnp.zeros((config.horizon, 2), dtype),
        warm_y=jnp.zeros((num_constraints,), dtype),
        warm_s=jnp.ones((1,), dtype),
        warm_wbc_x=jnp.zeros((nx,), dtype),
        warm_wbc_y=jnp.zeros((mw,), dtype),
        warm_wbc_s=jnp.ones((1,), dtype),
        dcm_int=jnp.zeros(2, dtype),
    )


def _default_ground(tree, wbc_params, config):
    """Default spring–damper ground: k_eff sized for ``config.ground_sag``
    static compression per foot, damping ≈ 0.4 of critical on the body's
    vertical mode (higher rings the light foot links into RK4 instability
    at the 1 ms substep)."""
    total_mass = float(tree.total_mass)
    n_feet = max(1, len(wbc_params.contact_frames))
    L, W = 2 * wbc_params.foot_half_length, 2 * wbc_params.foot_half_width
    per_foot = total_mass * 9.81 / n_feet
    k_eff = per_foot / config.ground_sag
    c_eff = 0.8 * (k_eff * total_mass / n_feet) ** 0.5
    return {
        f: ContactParams(jnp.asarray(L), jnp.asarray(W),
                         jnp.asarray(k_eff / (L * W)),
                         jnp.asarray(c_eff / (L * W)))
        for f in wbc_params.contact_frames
    }


def _plant_functions(tree, ground, null_poses, push_frame):
    """Shared plant closures for both stack variants.

    Returns ``(ground_wrenches, fdyn)`` where ``fdyn(s, tau, t, push_w)``
    is the contact-closed single-lane plant dynamics with the (unknown)
    push wrench applied at ``push_frame``, and ``ground_wrenches(plant,
    poses)`` maps stance frames to their spring–damper reactions (the foot
    F/T "sensor" readings of the estimator chain).
    """

    def ground_wrenches(plant, poses):
        nu = jnp.concatenate([plant.base_twist, plant.joint_velocities])
        out = {}
        for fname, cparams in ground.items():
            R_f, p_f, v_f = rb.frame_kinematics(tree, poses, fname, nu)
            R0, p0 = null_poses[fname]
            out[fname] = contact_wrench(cparams, ContactState(
                position=p_f, rotation=R_f,
                linear_velocity=v_f[:3], angular_velocity=v_f[3:],
                null_position=p0, null_rotation=R0,
            ))
        return out

    def fdyn(s, tau, t, push_w, minv=None):
        poses_s = forward_kinematics(
            tree, s.base_position, s.base_rotation, s.joint_positions)
        wrenches_s = ground_wrenches(s, poses_s)
        wrenches_s[push_frame] = push_w
        return rb.floating_base_dynamics(
            tree, s,
            rb.FloatingBaseInput(joint_torques=tau,
                                 contact_wrenches=wrenches_s),
            t, rho=1.0, minv=minv)

    def fdyn_stiff(s, minv, jac_frozen):
        """Reduced dynamics for the ROS2-W STAGE OPERATOR only (never
        integrated): kinematic rows exact; ``ν̇ = M⁻¹ Σ J_frozenᵀ w_c(x)``
        — just the sole-ground spring–damper path, whose ~3e3/s modes are
        what the operator must capture for L-stability. The parts omitted
        from the Jacobian (bias forces, gravity, M(q) variation, the
        constant push/torques) move at |λ| ≲ 50/s and are handled
        explicitly at dt·λ ≪ 1 — a W-method lags/approximates the operator
        freely as long as the stiff directions survive. Differentiating
        this instead of the full dynamics halves the per-tick ``jacfwd``
        (no CRBA/RNEA/jvp in the tangent graph); closed-loop accuracy vs
        the RK4 reference is pinned by tests/test_control_stack.py.
        ``jac_frozen`` maps frame name → (6, nv) tick-start Jacobian."""
        from blf_tpu.ops.lie import so3_baumgarte_rate

        poses_s = forward_kinematics(
            tree, s.base_position, s.base_rotation, s.joint_positions)
        wrenches_s = ground_wrenches(s, poses_s)
        tau_gen = sum(jac_frozen[f].T @ wrenches_s[f] for f in ground)
        nu_dot = minv @ tau_gen
        return rb.FloatingBaseState(
            base_twist=nu_dot[:6],
            joint_velocities=nu_dot[6:],
            base_position=s.base_twist[:3],
            base_rotation=so3_baumgarte_rate(
                s.base_rotation, s.base_twist[3:], 1.0),
            joint_positions=s.joint_velocities,
        )

    return ground_wrenches, fdyn, fdyn_stiff


def make_stack_step(
    tree: KinematicTree,
    wbc_params: WholeBodyParams,
    lipm: LIPMParams,
    config: StackConfig,
    null_poses,
    *,
    ground: Optional[dict] = None,
    push_frame: str = "imu",
    q_ref: Optional[jnp.ndarray] = None,
    com_height_ref: Optional[float] = None,
):
    """Build the jitted outer-tick function.

    Returns ``step(stack_state, true_push_xy, dcm_ref, zmp_ref, poly_A,
    poly_b) -> (StackState, StackTrace)`` where ``true_push_xy`` (2,) is the
    UNKNOWN constant horizontal force applied at ``push_frame`` — the
    controller only ever sees its estimate. Single-sample; ``vmap`` for
    push-recovery fleets.

    The plant is grounded through the framework's own spring–damper
    continuous contact model (the reference's ``ContinuousContactModel``,
    BASELINE config 2 physics): ``null_poses`` maps each stance frame to its
    zero-force (ground-anchor) pose ``(R0, p0)``, and ``ground`` optionally
    overrides the per-frame :class:`ContactParams` (default: a patch sized
    to the WBC sole rectangle with ``config.ground_sag`` static compression).
    The WBC's solution wrenches are NOT applied to the plant — its torques
    are, and the ground reaction emerges from the contact dynamics; the
    plant's contact wrenches at each sample play the role of foot F/T
    sensors for the estimator stack.
    """
    total_mass = float(tree.total_mass)
    omega = lipm_omega(lipm)
    wbc_dt = config.mpc_dt / config.wbc_per_mpc
    physics_dt = wbc_dt / config.physics_per_wbc
    obs_params = MomentumObserverParams(
        gain=jnp.asarray(config.observer_gain),
        dt=jnp.asarray(wbc_dt),
    )
    rls_params = RLSParams(
        lam=jnp.asarray(config.rls_lambda),
        measurement_covariance=config.rls_noise * jnp.eye(2),
    )
    if ground is None:
        ground = _default_ground(tree, wbc_params, config)

    _ground_wrenches, _fdyn, _fdyn_stiff = _plant_functions(
        tree, ground, null_poses, push_frame)

    @f32_matmuls
    def step(stack: StackState, true_push_xy, dcm_ref, zmp_ref,
             poly_A, poly_b) -> Tuple[StackState, StackTrace]:
        dtype = stack.plant.joint_positions.dtype
        mass = jnp.asarray(total_mass, dtype)
        com0, _, dcm0 = _com_state(tree, lipm, stack.plant)
        # push compensation (r4 redesign): the OUTER-tick RLS estimate feeds
        # the WBC's dynamics model (ext_w below), so the inverse dynamics
        # realizes commanded accelerations under the disturbance and the
        # DCM flow is nominal WITHOUT a z_cmd shift. Two hard-won rules:
        # (1) the estimate is frozen per outer tick — feeding the 100 Hz
        #     inner-tick estimate back into the same tick's torques closes
        #     an estimator→torque loop at the observer bandwidth that rang
        #     the joints at >10 rad/s within one outer tick (on-chip r4);
        # (2) the old z_cmd shift f̂/(mω²) must NOT be combined with the
        #     modeled wrench — it compensated the flow bias the unmodeled
        #     push used to cause, so keeping both double-compensates and
        #     biases the DCM by the same amount the shift once fixed.
        ext_w = (jnp.concatenate([stack.push_theta, jnp.zeros(4, dtype)])
                 if config.compensate_push
                 else jnp.zeros(6, dtype))[None]            # (1, 6)

        plan = solve_dcm_mpc(
            lipm, config.mpc_dt, dcm0, com0[:2], dcm_ref, zmp_ref,
            poly_A, poly_b, iterations=config.mpc_iterations,
            warm_start=stack.warm_zmp, warm_start_dual=stack.warm_y,
            s0=stack.warm_s, shared=True,
        )

        height_ref = jnp.asarray(
            com_height_ref if com_height_ref is not None else lipm.com_height,
            dtype,
        )
        posture_ref = (stack.plant.joint_positions if q_ref is None
                       else jnp.asarray(q_ref, dtype))

        # WBC warm starts: the 100 Hz problems are near-identical tick to
        # tick (and across the outer-tick boundary — the plant state is
        # continuous even when the plan replans), so primal/dual AND the
        # adapted per-lane ρ multiplier carry through StackState exactly as
        # the MPC loop's warm starts do.

        # plant: torques drive the joints; the ground reaction emerges from
        # the spring–damper sole contact; the TRUE push (invisible to the
        # controller) acts at the push frame
        push_wrench = jnp.concatenate([true_push_xy, jnp.zeros(4, dtype)])

        def fdyn(s, tau, t):
            return _fdyn(s, tau, t, push_wrench)

        # stiff-plant stage operator, ONE per outer tick (W-method: the
        # lagged Jacobian keeps L-stability of the sole-ground modes, which
        # move on pose timescales — see ops.integrators.integrate_rosenbrock)
        if config.plant_method == "rosenbrock":
            zero_tau = jnp.zeros_like(stack.plant.joint_positions)
            ros_op = rosenbrock_operator(
                fdyn, stack.plant, u=zero_tau, dt=physics_dt)
        elif config.plant_method != "rk4":
            raise ValueError(
                f"unknown plant_method {config.plant_method!r}")

        def inner(carry, k):
            plant, obs, theta, cov, x_w, y_w, s_w, dcm_i = carry
            com, com_vel, dcm = _com_state(tree, lipm, plant)
            # interpolate the MPC plan between knots 0 and 1
            frac = (k.astype(dtype) + 1.0) / config.wbc_per_mpc
            dcm_ref_now = plan.dcm[0] + frac * (plan.dcm[1] - plan.dcm[0])
            z_plan = plan.zmp[0]
            # instantaneous DCM controller + slow integral bias absorber
            # (push force handled in the WBC model; the integral soaks the
            # compliant-sole / estimate-residual flow biases — see dcm_ki)
            dcm_i = jnp.clip(
                dcm_i + config.dcm_ki * wbc_dt * (dcm - dcm_ref_now),
                -config.dcm_int_limit, config.dcm_int_limit)
            z_cmd = (z_plan + (1.0 + config.dcm_gain / omega)
                     * (dcm - dcm_ref_now) + dcm_i)
            com_acc_xy = omega**2 * (com[:2] - z_cmd)
            com_acc_z = (config.height_kp * (height_ref - com[2])
                         - config.height_kd * com_vel[2])
            # the (outer-tick) RLS push estimate feeds the WBC's MODEL: the
            # estimated wrench enters the dynamics equality, so the inverse
            # dynamics realizes the commanded accelerations under the
            # disturbance. Without this the push's moment (force × lever
            # arm to the push frame) biases every realized acceleration;
            # the orientation loop then drifts and a tail of large-push
            # lanes slowly falls (diagnosed on-chip in r4: tilt decaying
            # from t≈1 s regardless of WBC iteration budget).
            task = WholeBodyTask(
                com_acc_des=jnp.concatenate([com_acc_xy, com_acc_z[None]]),
                base_ang_acc_des=(
                    -config.base_kp * so3_log(plant.base_rotation)
                    - config.base_kd * plant.base_twist[3:]),
                posture_acc_des=(
                    config.posture_kp * (posture_ref - plant.joint_positions)
                    - config.posture_kd * plant.joint_velocities),
                contact_active=jnp.ones(len(wbc_params.contact_frames), dtype),
                ext_wrench=ext_w,
            )
            eps = config.wbc_eps if config.wbc_eps is not None else (
                1e-5 if jnp.finfo(dtype).bits >= 64 else 1e-4)
            sol = solve_wholebody_qp(tree, wbc_params, plant, task,
                                     iterations=config.wbc_iterations,
                                     x0=x_w, y0=y_w, s0=s_w,
                                     check_every=config.wbc_check_every,
                                     polish_iters=config.wbc_polish_iters,
                                     scaling_iters=config.wbc_scaling_iters,
                                     ext_frames=(push_frame,),
                                     eps_abs=eps, eps_rel=eps)

            if config.plant_method == "rosenbrock":
                plant_next = integrate_rosenbrock(
                    fdyn, plant, dt=physics_dt,
                    num_steps=config.physics_per_wbc,
                    u=sol.torques, operator=ros_op)
            else:
                plant_next = integrate(fdyn, plant, dt=physics_dt,
                                       num_steps=config.physics_per_wbc,
                                       u=sol.torques, method="rk4")

            # estimators: observer tick at the WBC rate. The plant's contact
            # wrenches at the sample ARE the foot F/T sensor readings, so
            # subtract their generalized force from the momentum residual and
            # attribute only the remainder to the push frame — the clean
            # 6-unknown LS (attributing the feet as unknowns too lets
            # foot-load asymmetry bleed into the push estimate and
            # destabilize the compensation loop; diagnosed in round 2)
            obs_next, residual = momentum_observer_step(
                tree, obs_params, obs, plant_next, sol.torques)
            poses_next = forward_kinematics(
                tree, plant_next.base_position, plant_next.base_rotation,
                plant_next.joint_positions)
            ft_meas = _ground_wrenches(plant_next, poses_next)
            tau_known = sum(
                frame_jacobian(tree, poses_next, f).T @ ft_meas[f]
                for f in wbc_params.contact_frames)
            wrenches = wrenches_from_residual(
                tree, plant_next, (push_frame,), residual - tau_known)
            push_meas = wrenches[-1, :2]
            est = rls_step(rls_params, RLSState(theta, cov),
                           jnp.eye(2, dtype=dtype), push_meas)
            return ((plant_next, obs_next, est.theta, est.covariance,
                     sol.qp.x, sol.qp.y, sol.qp.rho_scale, dcm_i),
                    (z_cmd, sol.qp.converged,
                     sol.qp.primal_residual, sol.qp.dual_residual))

        (plant, obs, theta, cov, wbc_x, wbc_y, wbc_s, dcm_i), (
            z_cmds, wbc_conv, wbc_rps, wbc_rds) = jax.lax.scan(
            inner,
            (stack.plant, stack.observer, stack.push_theta, stack.push_cov,
             stack.warm_wbc_x, stack.warm_wbc_y, stack.warm_wbc_s,
             stack.dcm_int),
            jnp.arange(config.wbc_per_mpc),
        )

        new_stack = StackState(
            plant=plant, observer=obs, push_theta=theta, push_cov=cov,
            warm_zmp=plan.zmp, warm_y=plan.qp.y,
            warm_s=plan.qp.rho_scale,
            warm_wbc_x=wbc_x, warm_wbc_y=wbc_y, warm_wbc_s=wbc_s,
            dcm_int=dcm_i,
        )

        # per-lane status (worst of MPC / WBC / plant finiteness) + NaN
        # quarantine, exactly as the fleet tick (parallel/sweep.py): a lane
        # whose tick went non-finite restarts from its pre-tick state with
        # cleared warm starts instead of poisoning every later warm start.
        plant_finite = jnp.stack(
            [jnp.all(jnp.isfinite(leaf)) for leaf in plant]
        ).all()
        wbc_finite = (jnp.all(jnp.isfinite(wbc_rps))
                      & jnp.all(jnp.isfinite(wbc_rds)))
        wbc_all_conv = jnp.all(wbc_conv)
        numerical = (~plant_finite) | (~wbc_finite)
        converged_tick = wbc_all_conv & plan.qp.converged
        status = jnp.where(
            numerical, jnp.int32(SolverStatus.NUMERICAL_ERROR),
            jnp.where(converged_tick, jnp.int32(SolverStatus.CONVERGED),
                      jnp.int32(SolverStatus.MAX_ITERATIONS)),
        )
        reset = StackState(
            plant=stack.plant, observer=stack.observer,
            push_theta=jnp.zeros_like(stack.push_theta),
            push_cov=jnp.eye(2, dtype=dtype) * 1e2,
            warm_zmp=jnp.zeros_like(stack.warm_zmp),
            warm_y=jnp.zeros_like(stack.warm_y),
            warm_s=jnp.ones_like(stack.warm_s),
            warm_wbc_x=jnp.zeros_like(stack.warm_wbc_x),
            warm_wbc_y=jnp.zeros_like(stack.warm_wbc_y),
            warm_wbc_s=jnp.ones_like(stack.warm_wbc_s),
            dcm_int=jnp.zeros_like(stack.dcm_int),
        )
        new_stack = nan_quarantine(new_stack, status, reset)

        trace = StackTrace(
            dcm=dcm0, com=com0, zmp_cmd=z_cmds[-1],
            push_estimate=stack.push_theta,
            mpc_converged=plan.qp.converged,
            wbc_converged=wbc_all_conv,
            wbc_max_rp=jnp.max(wbc_rps),
            wbc_max_rd=jnp.max(wbc_rds),
            status=status,
        )
        return new_stack, trace

    return step


def make_fleet_stack_step(
    tree: KinematicTree,
    wbc_params: WholeBodyParams,
    lipm: LIPMParams,
    config: StackConfig,
    null_poses,
    *,
    ground: Optional[dict] = None,
    push_frame: str = "imu",
    q_ref: Optional[jnp.ndarray] = None,
    com_height_ref: Optional[float] = None,
):
    """Fleet-native outer tick: same per-lane semantics as
    :func:`make_stack_step`, but the batch is EXPLICIT instead of vmapped —
    ``fleet_step(states, pushes, dcm_ref, zmp_ref, poly_A, poly_b)`` takes a
    :class:`StackState` with a leading batch axis on every leaf (and per-lane
    pushes), while the references/polygons are shared.

    Why a second entry point: under ``vmap`` the two QP solves are per-lane
    programs, which pins them to the XLA batched path. Here the solves are
    single BATCHED calls: the DCM-MPC runs the shared-factor fleet solve
    (every lane shares one transcription), and ``config.wbc_backend`` can
    route the WBC through the fused per-lane-operator kernel.
    Kinematics, plant physics, and estimators stay vmapped (elementwise
    per-lane programs batch fine under vmap). Equivalence with the vmapped
    step is pinned by ``tests/test_control_stack.py``.
    """
    total_mass = float(tree.total_mass)
    omega = lipm_omega(lipm)
    wbc_dt = config.mpc_dt / config.wbc_per_mpc
    physics_dt = wbc_dt / config.physics_per_wbc
    obs_params = MomentumObserverParams(
        gain=jnp.asarray(config.observer_gain),
        dt=jnp.asarray(wbc_dt),
    )
    rls_params = RLSParams(
        lam=jnp.asarray(config.rls_lambda),
        measurement_covariance=config.rls_noise * jnp.eye(2),
    )
    if ground is None:
        ground = _default_ground(tree, wbc_params, config)
    _ground_wrenches, _fdyn, _fdyn_stiff = _plant_functions(
        tree, ground, null_poses, push_frame)
    n, nv, C = tree.num_dofs, tree.nv, len(wbc_params.contact_frames)

    @f32_matmuls
    def fleet_step(stack: StackState, true_push_xy, dcm_ref, zmp_ref,
                   poly_A, poly_b) -> Tuple[StackState, StackTrace]:
        dtype = stack.plant.joint_positions.dtype
        B = stack.push_theta.shape[0]
        com0, _, dcm0 = jax.vmap(
            lambda p: _com_state(tree, lipm, p))(stack.plant)        # (B, ·)
        # frozen per-tick push estimate → WBC model (see make_stack_step)
        ext_w = (jnp.concatenate(
            [stack.push_theta, jnp.zeros((B, 4), dtype)], axis=-1)
            if config.compensate_push
            else jnp.zeros((B, 6), dtype))[:, None, :]               # (B,1,6)

        plan = solve_dcm_mpc(
            lipm, config.mpc_dt, dcm0, com0[:, :2], dcm_ref, zmp_ref,
            poly_A, poly_b, iterations=config.mpc_iterations,
            warm_start=stack.warm_zmp, warm_start_dual=stack.warm_y,
            s0=stack.warm_s, shared=True,
        )

        height_ref = jnp.asarray(
            com_height_ref if com_height_ref is not None else lipm.com_height,
            dtype,
        )
        posture_ref = (stack.plant.joint_positions if q_ref is None
                       else jnp.asarray(q_ref, dtype))

        push_wrench = jnp.concatenate(
            [true_push_xy, jnp.zeros((B, 4), dtype)], axis=-1)       # (B, 6)

        if config.plant_lagged_minv:
            # per-TICK plant mass-matrix inverse; fdyn refines against the
            # exact per-substep M
            M_tick = jax.vmap(
                lambda p: rb.mass_matrix(tree, p.base_position,
                                         p.base_rotation, p.joint_positions)
            )(stack.plant)
            minv_tick = spd_inverse(M_tick)                          # (B,ν,ν)
            minv_axis = 0
        else:
            minv_tick = None
            minv_axis = None

        if config.plant_method == "rosenbrock":
            zero_tau = jnp.zeros(n, dtype)
            if config.ros_op_stiff:
                if not config.plant_lagged_minv:
                    raise ValueError(
                        "ros_op_stiff requires plant_lagged_minv")

                def op_lane(p, mi):
                    poses_p = forward_kinematics(
                        tree, p.base_position, p.base_rotation,
                        p.joint_positions)
                    jfro = {f: frame_jacobian(tree, poses_p, f)
                            for f in wbc_params.contact_frames}
                    return rosenbrock_operator(
                        lambda s, u_, t_: _fdyn_stiff(s, mi, jfro),
                        p, u=zero_tau, dt=physics_dt)

                ros_op = jax.vmap(op_lane)(stack.plant, minv_tick)
            else:
                ros_op = jax.vmap(
                    lambda p, pw, mi: rosenbrock_operator(
                        lambda s, tau, t: _fdyn(s, tau, t, pw, minv=mi),
                        p, u=zero_tau, dt=physics_dt),
                    in_axes=(0, 0, minv_axis),
                )(stack.plant, push_wrench, minv_tick)               # (B,D,D)
        elif config.plant_method != "rk4":
            raise ValueError(f"unknown plant_method {config.plant_method!r}")

        def integrate_lane(plant, torques, pw, mi, *op):
            f_lane = lambda s, tau, t: _fdyn(s, tau, t, pw, minv=mi)
            if config.plant_method == "rosenbrock":
                return integrate_rosenbrock(
                    f_lane, plant, dt=physics_dt,
                    num_steps=config.physics_per_wbc,
                    u=torques, operator=op[0])
            return integrate(f_lane, plant, dt=physics_dt,
                             num_steps=config.physics_per_wbc,
                             u=torques, method="rk4")

        def est_lane(obs, plant_next, torques):
            # per-lane assembly only; the tiny (6, 6) attribution solve is
            # hoisted out of the vmap as one unrolled batched solve
            from blf_tpu.estimators.wrench_observer import (
                wrench_normal_equations)

            obs_next, residual = momentum_observer_step(
                tree, obs_params, obs, plant_next, torques)
            poses_next = forward_kinematics(
                tree, plant_next.base_position, plant_next.base_rotation,
                plant_next.joint_positions)
            ft_meas = _ground_wrenches(plant_next, poses_next)
            tau_known = sum(
                frame_jacobian(tree, poses_next, f).T @ ft_meas[f]
                for f in wbc_params.contact_frames)
            G, Jr = wrench_normal_equations(
                tree, plant_next, (push_frame,), residual - tau_known)
            return obs_next, G, Jr

        eps = config.wbc_eps if config.wbc_eps is not None else (
            1e-5 if jnp.finfo(dtype).bits >= 64 else 1e-4)

        def inner(carry, k):
            plant, obs, theta, cov, x_w, y_w, s_w, dcm_i = carry
            com, com_vel, dcm = jax.vmap(
                lambda p: _com_state(tree, lipm, p))(plant)
            frac = (k.astype(dtype) + 1.0) / config.wbc_per_mpc
            dcm_ref_now = (plan.dcm[:, 0]
                           + frac * (plan.dcm[:, 1] - plan.dcm[:, 0]))
            z_plan = plan.zmp[:, 0]
            dcm_i = jnp.clip(
                dcm_i + config.dcm_ki * wbc_dt * (dcm - dcm_ref_now),
                -config.dcm_int_limit, config.dcm_int_limit)
            z_cmd = (z_plan + (1.0 + config.dcm_gain / omega)
                     * (dcm - dcm_ref_now) + dcm_i)
            com_acc_xy = omega**2 * (com[:, :2] - z_cmd)
            com_acc_z = (config.height_kp * (height_ref - com[:, 2])
                         - config.height_kd * com_vel[:, 2])
            task = WholeBodyTask(
                com_acc_des=jnp.concatenate(
                    [com_acc_xy, com_acc_z[:, None]], axis=-1),
                base_ang_acc_des=(
                    -config.base_kp * jax.vmap(so3_log)(plant.base_rotation)
                    - config.base_kd * plant.base_twist[:, 3:]),
                posture_acc_des=(
                    config.posture_kp * (posture_ref - plant.joint_positions)
                    - config.posture_kd * plant.joint_velocities),
                contact_active=jnp.ones((B, C), dtype),
                ext_wrench=ext_w,
            )
            P, qv, A, l, u = jax.vmap(
                lambda st, tk: build_wholebody_qp(
                    tree, wbc_params, st, tk, (push_frame,))
            )(plant, task)
            sol = solve_qp(P, qv, A, l, u,
                           iterations=config.wbc_iterations,
                           x0=x_w, y0=y_w, s0=s_w,
                           check_every=config.wbc_check_every,
                           polish_iters=config.wbc_polish_iters,
                           scaling_iters=config.wbc_scaling_iters,
                           eps_abs=eps, eps_rel=eps,
                           backend=config.wbc_backend)
            torques = sol.x[:, nv + 6 * C:]

            if config.plant_method == "rosenbrock":
                plant_next = jax.vmap(
                    integrate_lane, in_axes=(0, 0, 0, minv_axis, 0))(
                    plant, torques, push_wrench, minv_tick, ros_op)
            else:
                plant_next = jax.vmap(
                    integrate_lane, in_axes=(0, 0, 0, minv_axis))(
                    plant, torques, push_wrench, minv_tick)

            obs_next, G_est, Jr_est = jax.vmap(est_lane)(
                obs, plant_next, torques)
            push_meas = solve_psd_small(G_est, Jr_est)[:, :2]
            # the carry's dtype is authoritative (an f32 fleet under x64)
            rls_p = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, dtype), rls_params)
            est = jax.vmap(
                lambda th, cv, pm: rls_step(
                    rls_p, RLSState(th, cv),
                    jnp.eye(2, dtype=dtype), pm)
            )(theta, cov, push_meas)
            s_next = sol.rho_scale
            return ((plant_next, obs_next, est.theta, est.covariance,
                     sol.x, sol.y, s_next, dcm_i),
                    (z_cmd, sol.converged,
                     sol.primal_residual, sol.dual_residual))

        (plant, obs, theta, cov, wbc_x, wbc_y, wbc_s, dcm_i), (
            z_cmds, wbc_conv, wbc_rps, wbc_rds) = jax.lax.scan(
            inner,
            (stack.plant, stack.observer, stack.push_theta, stack.push_cov,
             stack.warm_wbc_x, stack.warm_wbc_y, stack.warm_wbc_s,
             stack.dcm_int),
            jnp.arange(config.wbc_per_mpc),
        )

        new_stack = StackState(
            plant=plant, observer=obs, push_theta=theta, push_cov=cov,
            warm_zmp=plan.zmp, warm_y=plan.qp.y,
            warm_s=plan.qp.rho_scale,
            warm_wbc_x=wbc_x, warm_wbc_y=wbc_y, warm_wbc_s=wbc_s,
            dcm_int=dcm_i,
        )

        # per-lane status + quarantine, same semantics as make_stack_step
        lane_all = lambda a: jnp.all(
            a.reshape(a.shape[0], -1) if a.ndim > 1 else a[:, None], axis=-1)
        plant_finite = None
        for leaf in plant:
            fin = lane_all(jnp.isfinite(leaf))
            plant_finite = fin if plant_finite is None else plant_finite & fin
        wbc_finite = (jnp.all(jnp.isfinite(wbc_rps), axis=0)
                      & jnp.all(jnp.isfinite(wbc_rds), axis=0))
        wbc_all_conv = jnp.all(wbc_conv, axis=0)
        numerical = (~plant_finite) | (~wbc_finite)
        converged_tick = wbc_all_conv & plan.qp.converged
        status = jnp.where(
            numerical, jnp.int32(SolverStatus.NUMERICAL_ERROR),
            jnp.where(converged_tick, jnp.int32(SolverStatus.CONVERGED),
                      jnp.int32(SolverStatus.MAX_ITERATIONS)),
        )
        reset = StackState(
            plant=stack.plant, observer=stack.observer,
            push_theta=jnp.zeros_like(stack.push_theta),
            push_cov=jnp.broadcast_to(jnp.eye(2, dtype=dtype) * 1e2,
                                      stack.push_cov.shape),
            warm_zmp=jnp.zeros_like(stack.warm_zmp),
            warm_y=jnp.zeros_like(stack.warm_y),
            warm_s=jnp.ones_like(stack.warm_s),
            warm_wbc_x=jnp.zeros_like(stack.warm_wbc_x),
            warm_wbc_y=jnp.zeros_like(stack.warm_wbc_y),
            warm_wbc_s=jnp.ones_like(stack.warm_wbc_s),
            dcm_int=jnp.zeros_like(stack.dcm_int),
        )
        new_stack = nan_quarantine(new_stack, status, reset)

        trace = StackTrace(
            dcm=dcm0, com=com0, zmp_cmd=z_cmds[-1],
            push_estimate=stack.push_theta,
            mpc_converged=plan.qp.converged,
            wbc_converged=wbc_all_conv,
            wbc_max_rp=jnp.max(wbc_rps, axis=0),
            wbc_max_rd=jnp.max(wbc_rds, axis=0),
            status=status,
        )
        return new_stack, trace

    return fleet_step
