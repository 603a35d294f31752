"""blf_tpu — a batched, accelerator-native bipedal-locomotion framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
``bipedal-locomotion-framework`` C++ suite (reference layer map in SURVEY.md §1):

- ``utils``      — configuration (ParametersHandler equivalent), containers,
                   telemetry, checkpointing, status codes.
- ``ops``        — Lie-group math, integrators, linear algebra, Pallas kernels.
- ``models``     — dynamical systems, contact models, rigid-body dynamics, LIPM/DCM.
- ``estimators`` — batched recursive least squares and filters.
- ``planners``   — contact timelines, convex hulls, variables registry.
- ``mpc``        — batched DCM-MPC transcription and QP/SQP solvers.
- ``parallel``   — device meshes, shardings and collective reductions.

Everything on the compute path is a pure function of explicit state, shaped for
``jax.jit``/``vmap``/``shard_map``; host-side planning utilities mirror the
reference's semantics exactly (citations in each module's docstring).
"""

__version__ = "0.1.0"

from blf_tpu.utils import params  # noqa: F401
