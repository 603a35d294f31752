"""Speed-of-light accounting subsystem (blf_tpu.utils.profiling).

The reference ships zero instrumentation (SURVEY.md §5); BASELINE's
efficiency row requires per-kernel roofline accounting in the new framework.
These tests pin the subsystem's math and its integration with XLA's
post-fusion cost model on the CPU test backend.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from blf_tpu.utils.profiling import (
    CHIP_SPECS,
    ChipSpec,
    cost_analysis,
    detect_chip,
    measure,
    roofline_seconds,
    sol_report,
    trace,
)


class TestChipSpecs:
    def test_detect_h100_by_device_kind(self):
        class FakeDevice:
            device_kind = "NVIDIA H100 80GB HBM3"

        spec = detect_chip(FakeDevice())
        assert spec.name == "NVIDIA H100 SXM"

    def test_unknown_device_is_an_error(self):
        """No made-up default: the CPU test device has no published peaks."""
        with pytest.raises(KeyError, match="no published peaks"):
            detect_chip(jax.devices()[0])

    def test_h100_peaks_match_data_sheet(self):
        spec = CHIP_SPECS["NVIDIA H100 80GB HBM3"]
        assert spec.peak_flops("bf16") == pytest.approx(989e12)
        assert spec.peak_flops("tf32") == pytest.approx(495e12)
        assert spec.peak_flops("f32") == pytest.approx(67e12)
        assert spec.hbm_bytes_per_s == pytest.approx(3.35e12)

    def test_peaks_ordered_by_precision(self):
        for spec in CHIP_SPECS.values():
            assert (spec.peak_flops("bf16") >= spec.peak_flops("tf32")
                    >= spec.peak_flops("f32"))


class TestRoofline:
    SPEC = ChipSpec("test", peak_flops_bf16=2e12, peak_flops_tf32=2e12,
                    peak_flops_f32=1e12, hbm_bytes_per_s=1e11)

    def test_compute_bound_case(self):
        # 1e12 FLOP at 1e12 FLOP/s = 1 s; 1e9 B at 1e11 B/s = 0.01 s
        assert roofline_seconds(1e12, 1e9, self.SPEC) == pytest.approx(1.0)

    def test_memory_bound_case(self):
        assert roofline_seconds(1e9, 1e11, self.SPEC) == pytest.approx(1.0)

    def test_dtype_selects_ceiling(self):
        t_bf16 = roofline_seconds(2e12, 0.0, self.SPEC, dtype="bf16")
        t_f32 = roofline_seconds(2e12, 0.0, self.SPEC, dtype="f32")
        assert t_bf16 == pytest.approx(1.0)
        assert t_f32 == pytest.approx(2.0)


class TestCostAnalysis:
    def test_matmul_flops_counted(self):
        n = 256
        a = jnp.ones((n, n), jnp.float32)

        cost = cost_analysis(lambda x: x @ x, a)
        # XLA counts 2·n³ (multiply-add) for a dense matmul.
        assert cost["flops"] == pytest.approx(2 * n**3, rel=0.2)
        assert cost["bytes"] > 0.0

    def test_accepts_prejitted_function(self):
        a = jnp.ones((64, 64), jnp.float32)
        cost = cost_analysis(jax.jit(lambda x: x @ x + x), a)
        assert cost["flops"] > 0.0


class TestMeasureAndReport:
    def test_measure_returns_positive_seconds(self):
        f = jax.jit(lambda x: (x @ x).sum())
        x = jnp.ones((128, 128), jnp.float32)
        t = measure(f, x, warmup=1, repeats=3, inner=2)
        assert 0.0 < t < 10.0

    def test_sol_report_fields_consistent(self):
        f = jax.jit(lambda x: x @ x)
        x = jnp.ones((256, 256), jnp.float32)
        r = sol_report(f, x, label="mm", warmup=1, repeats=3,
                       spec=TestRoofline.SPEC)
        assert r["label"] == "mm"
        assert r["bound"] in ("compute", "memory")
        assert r["time_s"] > 0.0
        # SOL fraction is a ratio of the roofline bound to measured time;
        # it must be finite and reproduce sol_time/time.
        assert r["sol_frac"] == pytest.approx(r["sol_time_s"] / r["time_s"])
        assert r["achieved_tflops"] == pytest.approx(
            r["flops"] / r["time_s"] / 1e12)

    def test_report_on_fleet_qp_program(self):
        """The accounting subsystem must work on the real hot path."""
        from blf_tpu.mpc.qp import factor_shared_qp, solve_qp_factored

        n, m, batch = 8, 12, 32
        rng = np.random.default_rng(0)
        L = jnp.asarray(rng.normal(size=(n, n)))
        P = L @ L.T + 0.5 * jnp.eye(n)
        A = jnp.asarray(rng.normal(size=(m, n)))
        is_eq = jnp.arange(m) < 4
        factors = factor_shared_qp(P, A, is_eq)
        q = jnp.asarray(rng.normal(size=(batch, n)))
        l = jnp.full((batch, m), -1.0).at[:, :4].set(0.0)
        u = jnp.ones((batch, m)).at[:, :4].set(0.0)

        solve = jax.jit(lambda qq, ll, uu: jax.vmap(
            lambda a, b, c: solve_qp_factored(factors, a, b, c,
                                              iterations=20)
        )(qq, ll, uu))
        r = sol_report(solve, q, l, u, label="qp", warmup=1, repeats=2,
                       spec=TestRoofline.SPEC)
        assert r["flops"] > 0.0
        assert r["time_s"] > 0.0


class TestTrace:
    def test_trace_context_wraps_computation(self):
        with trace("test-region"):
            y = jax.jit(lambda x: x * 2)(jnp.ones(4))
        assert float(y.sum()) == pytest.approx(8.0)

    def test_trace_nested_names_allowed(self):
        with trace("outer"):
            with trace("inner/qp-iteration"):
                pass
