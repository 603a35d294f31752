"""Fixed-topology kinematic trees: spec, forward kinematics, Jacobians.

The reference delegates all articulated kinematics/dynamics to iDynTree's
``KinDynComputations`` (``FloatingBaseSystemDynamics.cpp:163-226`` calls
``setRobotState``/``getFreeFloatingMassMatrix``/``generalizedBiasForces``/
``getFrameFreeFloatingJacobian``). SURVEY.md §7 marks rebuilding that subset —
batched, fixed-shape, accelerator-native — as the hard part of the port. This module
is the kinematic half; :mod:`blf_tpu.models.rigid_body` builds dynamics on it.

Conventions (matching iDynTree so the reference's call sites translate 1:1):

- **Mixed (hybrid) representation** everywhere: a frame's 6D velocity is
  ``[ṗ; ω]`` with both parts expressed in world axes, at the frame origin.
- Generalized velocity ``ν = [base twist (mixed, 6); joint rates (n)]``.
- The tree spec is **static** (plain numpy in a frozen dataclass): inside
  ``jit`` it becomes compile-time constants — ancestor masks, offsets and
  axes bake into the program, keeping every array shape static.

The per-link loops below unroll at trace time (L ≈ 25 for a humanoid); XLA
fuses them into a few batched GEMMs — there is no data-dependent control flow.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from blf_tpu.ops.lie import skew, so3_exp

__all__ = [
    "JointType",
    "KinematicTreeBuilder",
    "KinematicTree",
    "LinkPoses",
    "forward_kinematics",
    "link_jacobians",
    "frame_pose",
    "frame_jacobian",
    "point_jacobian_columns",
]

FIXED, REVOLUTE, PRISMATIC = 0, 1, 2


class JointType:
    FIXED = FIXED
    REVOLUTE = REVOLUTE
    PRISMATIC = PRISMATIC


@dataclass(frozen=True)
class KinematicTree:
    """Static articulated-tree description (URDF-lite).

    Link 0 is the floating base. ``parent[i] < i`` (topological order).
    Joint ``i`` connects ``parent[i]`` → link ``i``: the joint frame sits at
    ``joint_position[i]``/``joint_rotation[i]`` in the parent frame, the link
    frame coincides with the joint frame at zero joint value, and the joint
    moves about/along ``axis[i]`` (joint-frame coordinates).
    """

    parent: Tuple[int, ...]
    joint_type: Tuple[int, ...]
    axis: np.ndarray            # (L, 3)
    joint_position: np.ndarray  # (L, 3)  parent-frame offset
    joint_rotation: np.ndarray  # (L, 3, 3) parent-frame orientation
    mass: np.ndarray            # (L,)
    com: np.ndarray             # (L, 3) link-frame CoM offset
    inertia: np.ndarray         # (L, 3, 3) about CoM, link frame
    link_names: Tuple[str, ...]
    frames: Dict[str, Tuple[int, np.ndarray, np.ndarray]] = field(default_factory=dict)
    # name -> (link index, position offset, rotation offset), link-frame

    @property
    def num_links(self) -> int:
        return len(self.parent)

    @property
    def dof_index(self) -> Tuple[int, ...]:
        """Joint-space column of each link's joint; -1 for fixed joints."""
        idx, k = [], 0
        for t in self.joint_type:
            if t == FIXED:
                idx.append(-1)
            else:
                idx.append(k)
                k += 1
        return tuple(idx)

    @property
    def num_dofs(self) -> int:
        """Actuated DoFs (excludes the 6 base DoFs)."""
        return sum(1 for t in self.joint_type if t != FIXED)

    @property
    def nv(self) -> int:
        """Generalized-velocity size 6 + n."""
        return 6 + self.num_dofs

    @property
    def ancestor_mask(self) -> np.ndarray:
        """(L, L) bool: ``mask[i, j]`` iff link j is on the path base → link i
        (inclusive). Static; bakes into jitted programs."""
        L = self.num_links
        mask = np.zeros((L, L), dtype=bool)
        for i in range(L):
            j = i
            while j >= 0:
                mask[i, j] = True
                j = self.parent[j] if j > 0 else -1
        return mask

    @property
    def total_mass(self) -> float:
        return float(np.sum(self.mass))

    def frame_names(self) -> List[str]:
        return list(self.frames)


class KinematicTreeBuilder:
    """Imperative builder: ``add_link(...)`` then ``finalize()``."""

    def __init__(self, base_name: str = "base", base_mass: float = 1.0,
                 base_com=(0.0, 0.0, 0.0), base_inertia: Optional[np.ndarray] = None):
        self._names = [base_name]
        self._parent = [-1]
        self._jtype = [FIXED]
        self._axis = [np.array([0.0, 0.0, 1.0])]
        self._jpos = [np.zeros(3)]
        self._jrot = [np.eye(3)]
        self._mass = [float(base_mass)]
        self._com = [np.asarray(base_com, dtype=float)]
        self._inertia = [
            np.asarray(base_inertia, dtype=float) if base_inertia is not None
            else np.eye(3) * 0.01
        ]
        self._frames: Dict[str, Tuple[int, np.ndarray, np.ndarray]] = {}

    def add_link(
        self,
        name: str,
        parent: str,
        joint_type: int = REVOLUTE,
        axis=(0.0, 0.0, 1.0),
        joint_position=(0.0, 0.0, 0.0),
        joint_rotation: Optional[np.ndarray] = None,
        mass: float = 1.0,
        com=(0.0, 0.0, 0.0),
        inertia: Optional[np.ndarray] = None,
    ) -> "KinematicTreeBuilder":
        if name in self._names:
            raise ValueError(f"duplicate link name {name!r}")
        if parent not in self._names:
            raise ValueError(f"unknown parent link {parent!r}")
        self._names.append(name)
        self._parent.append(self._names.index(parent))
        self._jtype.append(joint_type)
        a = np.asarray(axis, dtype=float)
        if joint_type != FIXED:
            a = a / np.linalg.norm(a)
        self._axis.append(a)
        self._jpos.append(np.asarray(joint_position, dtype=float))
        self._jrot.append(
            np.asarray(joint_rotation, dtype=float) if joint_rotation is not None
            else np.eye(3)
        )
        self._mass.append(float(mass))
        self._com.append(np.asarray(com, dtype=float))
        self._inertia.append(
            np.asarray(inertia, dtype=float) if inertia is not None
            else np.eye(3) * 1e-3 * mass
        )
        return self

    def add_frame(self, name: str, link: str, position=(0.0, 0.0, 0.0),
                  rotation: Optional[np.ndarray] = None) -> "KinematicTreeBuilder":
        if name in self._frames:
            raise ValueError(f"duplicate frame name {name!r}")
        self._frames[name] = (
            self._names.index(link),
            np.asarray(position, dtype=float),
            np.asarray(rotation, dtype=float) if rotation is not None else np.eye(3),
        )
        return self

    def finalize(self) -> KinematicTree:
        return KinematicTree(
            parent=tuple(self._parent),
            joint_type=tuple(self._jtype),
            axis=np.stack(self._axis),
            joint_position=np.stack(self._jpos),
            joint_rotation=np.stack(self._jrot),
            mass=np.asarray(self._mass),
            com=np.stack(self._com),
            inertia=np.stack(self._inertia),
            link_names=tuple(self._names),
            frames=dict(self._frames),
        )


class LinkPoses(NamedTuple):
    """World pose of every link: ``position`` (…, L, 3), ``rotation`` (…, L, 3, 3)."""

    position: jnp.ndarray
    rotation: jnp.ndarray


from blf_tpu.ops.precision import f32_matmuls


@f32_matmuls
def forward_kinematics(tree: KinematicTree, base_position, base_rotation, q) -> LinkPoses:
    """World poses of all links (iDynTree ``getWorldTransform`` equivalent).

    ``q``: (n,) joint values. Single-sample; use ``vmap`` for batches.
    """
    positions = [base_position]
    rotations = [base_rotation]
    dof = tree.dof_index
    for i in range(1, tree.num_links):
        p = tree.parent[i]
        Rp, pp = rotations[p], positions[p]
        # parent -> joint frame (static offsets)
        Rj = Rp @ jnp.asarray(tree.joint_rotation[i], dtype=base_rotation.dtype)
        pj = pp + Rp @ jnp.asarray(tree.joint_position[i], dtype=base_rotation.dtype)
        t = tree.joint_type[i]
        if t == REVOLUTE:
            qi = q[dof[i]]
            Ri = Rj @ so3_exp(qi * jnp.asarray(tree.axis[i], dtype=base_rotation.dtype))
            pi = pj
        elif t == PRISMATIC:
            qi = q[dof[i]]
            Ri = Rj
            pi = pj + Rj @ (qi * jnp.asarray(tree.axis[i], dtype=base_rotation.dtype))
        else:  # FIXED
            Ri, pi = Rj, pj
        positions.append(pi)
        rotations.append(Ri)
    return LinkPoses(jnp.stack(positions), jnp.stack(rotations))


def _world_joint_axes(tree: KinematicTree, poses: LinkPoses):
    """World-frame joint axis and anchor point of each link's joint.

    The axis is fixed in the *joint* frame, which rotates with the link for a
    revolute joint only about the axis itself — so expressing it through the
    link rotation is exact: ``a_w = R_link a_local`` (rotation about ``a``
    leaves ``a`` invariant). Prismatic links translate, so the same holds.
    """
    axes = poses.rotation @ jnp.asarray(tree.axis, dtype=poses.rotation.dtype)[..., None]
    return axes[..., 0], poses.position


def _movable_joints(tree: KinematicTree):
    """Static (link-index array, revolute mask) of the movable joints, in
    DoF-column order (``dof_index`` increments in link order, so sorting by
    link index IS the column order)."""
    jm = np.array([j for j in range(tree.num_links)
                   if tree.joint_type[j] != FIXED], dtype=int)
    rev = np.array([tree.joint_type[j] == REVOLUTE for j in jm])
    return jm, rev


def _joint_columns(tree: KinematicTree, poses: LinkPoses):
    """(n, 3) world axis / anchor / revolute-mask of every DoF column —
    the shared operands of all Jacobian assemblies, computed ONCE as
    whole-tree ops (no per-joint Python loop)."""
    axes_w, anchors_w = _world_joint_axes(tree, poses)
    jm, rev = _movable_joints(tree)
    return axes_w[jm], anchors_w[jm], rev


def _base_rows(point_w, base_p, dtype):
    eye3 = jnp.eye(3, dtype=dtype)
    zero3 = jnp.zeros((3, 3), dtype=dtype)
    base_lin = jnp.concatenate([eye3, -skew(point_w - base_p)], axis=-1)
    base_ang = jnp.concatenate([zero3, eye3], axis=-1)
    return base_lin, base_ang


def point_jacobian_columns(tree: KinematicTree, poses: LinkPoses, link_index: int,
                           point_w):
    """Mixed Jacobian (6, 6+n) of the frame at world point ``point_w`` rigidly
    attached to ``link_index``.

    Equivalent of ``KinDynComputations::getFrameFreeFloatingJacobian``
    (consumed at ``FloatingBaseSystemDynamics.cpp:199-226``). Columns:

    - base (6): ``[[I, −(p − p_b)̂]; [0, I]]`` — mixed base twist transport;
    - revolute joint j on the support path: ``[a_j × (p − p_j); a_j]``;
    - prismatic: ``[a_j; 0]``; other joints: zero.

    Assembled as whole-DoF-vector ops (one cross + static masks), not a
    per-joint loop — the trace-time unrolled version cost L·n tiny ops per
    call and dominated every dynamics evaluation's op count.
    """
    dtype = poses.rotation.dtype
    n = tree.num_dofs
    base_lin, base_ang = _base_rows(point_w, poses.position[0], dtype)
    if not n:
        return jnp.concatenate([base_lin, base_ang], axis=-2)
    a, anchors, rev = _joint_columns(tree, poses)
    jm, _ = _movable_joints(tree)
    onpath = tree.ancestor_mask[link_index][jm]            # (n,) static bool
    diff = point_w[None, :] - anchors                      # (n, 3)
    crossed = jnp.cross(a, diff)                           # (n, 3)
    revc = rev[:, None]                                    # static bool
    lin = jnp.where(revc, crossed, a) * jnp.asarray(
        onpath[:, None], dtype)
    ang = jnp.where(revc, a, jnp.zeros_like(a)) * jnp.asarray(
        (onpath & rev)[:, None], dtype)
    Jlin = jnp.concatenate([base_lin, lin.T], axis=-1)
    Jang = jnp.concatenate([base_ang, ang.T], axis=-1)
    return jnp.concatenate([Jlin, Jang], axis=-2)


def link_jacobians(tree: KinematicTree, poses: LinkPoses) -> jnp.ndarray:
    """Mixed Jacobians of every link origin, stacked ``(L, 6, 6+n)``.

    Fully vectorized over links AND joints: one (L, n, 3) cross product +
    two static masks instead of L·n per-joint column ops (the former
    trace-time unrolled assembly was the op-count hot spot of the
    articulated plant — mass matrix, bias forces, and every ``jacfwd``
    tangent all route through here)."""
    dtype = poses.rotation.dtype
    n = tree.num_dofs
    L = tree.num_links
    p = poses.position                                     # (L, 3)
    base_lin = jnp.concatenate(
        [jnp.broadcast_to(jnp.eye(3, dtype=dtype), (L, 3, 3)),
         -skew(p - p[0])], axis=-1)                        # (L, 3, 6)
    base_ang = jnp.broadcast_to(
        jnp.concatenate([jnp.zeros((3, 3), dtype=dtype),
                         jnp.eye(3, dtype=dtype)], axis=-1), (L, 3, 6))
    if not n:
        return jnp.concatenate([base_lin, base_ang], axis=-2)
    a, anchors, rev = _joint_columns(tree, poses)          # (n, 3) each
    jm, _ = _movable_joints(tree)
    diff = p[:, None, :] - anchors[None, :, :]             # (L, n, 3)
    crossed = jnp.cross(jnp.broadcast_to(a, (L, n, 3)), diff)
    revc = rev[None, :, None]                              # static bool
    onpath = jnp.asarray(tree.ancestor_mask[:, jm][..., None],
                         dtype)                            # (L, n, 1) static
    lin = jnp.where(revc, crossed, a[None]) * onpath
    ang = jnp.broadcast_to(jnp.where(revc, a[None], 0.0), (L, n, 3)) * (
        onpath * jnp.asarray(rev[None, :, None], dtype))
    Jlin = jnp.concatenate([base_lin, jnp.swapaxes(lin, -1, -2)], axis=-1)
    Jang = jnp.concatenate([base_ang, jnp.swapaxes(ang, -1, -2)], axis=-1)
    return jnp.concatenate([Jlin, Jang], axis=-2)


def frame_pose(tree: KinematicTree, poses: LinkPoses, frame: str):
    """World (rotation, position) of a named frame."""
    link, off_p, off_R = tree.frames[frame]
    R = poses.rotation[link] @ jnp.asarray(off_R, dtype=poses.rotation.dtype)
    p = poses.position[link] + poses.rotation[link] @ jnp.asarray(
        off_p, dtype=poses.rotation.dtype
    )
    return R, p


def frame_jacobian(tree: KinematicTree, poses: LinkPoses, frame: str) -> jnp.ndarray:
    """Mixed free-floating Jacobian (6, 6+n) of a named frame."""
    link, _, _ = tree.frames[frame]
    _, p = frame_pose(tree, poses, frame)
    return point_jacobian_columns(tree, poses, link, p)
