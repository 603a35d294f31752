"""Every matrix product of the production programs runs at full f32.

On the GPU an f32 product at ``Precision.DEFAULT`` may run in TF32; the
``f32_matmuls`` guards and explicit ``Precision.HIGHEST`` keep it out of the
solvers and the plant. These tests lower the config-5 fleet tick and the
config-4 stack tick (small batches — the program text does not depend on
the batch) and audit the StableHLO for any product below HIGHEST.
"""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "benchmarks")]

import bench  # noqa: E402
import stack_bench  # noqa: E402

from blf_tpu.ops.precision import reduced_precision_dots  # noqa: E402
from blf_tpu.parallel.mesh import make_mesh  # noqa: E402


def test_fleet_tick_products_are_f32():
    run, state, dist, _ = bench.build_fleet_tick(make_mesh(1, 1), batch=8,
                                                 horizon=8, ticks=2)
    assert reduced_precision_dots(run.lower(state, dist)) == []


def test_stack_tick_products_are_f32():
    step, state, pushes, refs = stack_bench.build_stack(2)
    run = stack_bench.make_run_ticks(step, refs, 1)
    assert reduced_precision_dots(run.lower(state, pushes)) == []
