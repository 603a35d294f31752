"""Matmul-precision discipline for GPU numerics.

On an NVIDIA card an f32 matrix product at ``Precision.DEFAULT`` may run on
the tensor cores in TF32, which keeps a 10-bit mantissa (~2⁻¹¹ relative
product error). That is fine for neural nets and wrong for this framework's
linear algebra: rotation-chain forward kinematics drift, mass-matrix solves
lose ~3 digits, and ADMM/QP fixed points shift by more than the convergence
tolerance. A CPU run hides the problem (the CPU has no TF32 path), so it
would surface only on the card.

:func:`f32_matmuls` is the one shared decorator: it runs everything traced
inside the function under ``jax.default_matmul_precision("float32")``.
Apply it to public entry points whose outputs feed solvers or integrators.
:func:`reduced_precision_dots` audits a lowered program for any product the
guards missed; the test suite and ``chip_smoke.py`` hold the production
programs to zero.
"""

from __future__ import annotations

import functools
import re

import jax

__all__ = ["f32_matmuls", "reduced_precision_dots"]


def f32_matmuls(fn):
    """Run every matmul traced inside ``fn`` at full f32 (no TF32)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped


_DOT = re.compile(r"stablehlo\.(dot_general|dot|convolution)\b")


def reduced_precision_dots(lowered) -> list:
    """StableHLO lines of the products in ``lowered`` (a ``jax.stages.
    Lowered``) that are not at ``Precision.HIGHEST`` on both operands."""
    return [line.strip() for line in lowered.as_text().splitlines()
            if _DOT.search(line)
            and "precision = [HIGHEST, HIGHEST]" not in line]
