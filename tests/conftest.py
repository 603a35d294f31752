"""Test configuration.

Tests run on a virtual 8-device CPU mesh (SURVEY.md §4 "multi-node testing"):
sharding/collective tests exercise real `jax.sharding` paths without a
multi-card machine. Tests marked ``gpu`` need a card and skip elsewhere
(decided in the :func:`gpu` fixture, never at import time).

Two dtype lanes (production runs f32, but an f64-only suite would let f32
dtype traps surface on the card only):

- default: float64 enabled, so the reference's tight tolerances (down to
  1e-7, BASELINE.md) are checkable;
- ``BLF_TPU_TEST_F32=1``: x64 stays off — every default-dtype array is f32,
  matching the on-chip numerics. Numerically-sensitive assertions pick
  their tolerance via :func:`tol` / :data:`F32_LANE`; CI runs both lanes.

Must set env vars before importing jax anywhere in the test process.
"""

import os

# CPU unless the caller set JAX_PLATFORMS explicitly (e.g. ``cuda`` to run
# the ``gpu``-marked tests on a card); the 8 virtual devices are CPU-only.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

#: True when the suite runs the reduced-precision lane (f32 default dtype).
F32_LANE = os.environ.get("BLF_TPU_TEST_F32", "0") == "1"

jax.config.update("jax_enable_x64", not F32_LANE)


def tol(f64_value, f32_value):
    """Pick the assertion tolerance for the active dtype lane.

    f64 tolerances pin the reference-parity bounds (BASELINE.md); the f32
    values are the realistic single-precision bounds the on-card path is
    held to (documented per call site when they differ by more than the
    naive sqrt(eps) scaling).
    """
    return f32_value if F32_LANE else f64_value


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX sees no GPU."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
    return gpus[0]
