"""Tracing / profiling / speed-of-light accounting.

The reference has **no** instrumentation at all (SURVEY.md §5: no timers
anywhere in `/root/reference/src`; CI wall-clock is the only signal). The
BASELINE efficiency row, however, requires the new framework to account for
its hot kernels against speed-of-light per chip. This module is that
subsystem:

- :class:`ChipSpec` + :func:`detect_chip` — published peak FLOP/s and
  device-memory bandwidth (roofline ceilings), keyed by
  ``Device.device_kind``. A device missing from :data:`CHIP_SPECS` is an
  error: no number is ever scored against a made-up ceiling.
- :func:`measure` — ``block_until_ready`` timing harness (warmup + best-of /
  median over repeats, so one-off dispatch jitter never pollutes a number).
- :func:`cost_analysis` — XLA's own compiled-program FLOP / bytes-accessed
  estimate (``Compiled.cost_analysis()``), which sees the program *after*
  fusion — the honest numerator/denominator for a roofline.
- :func:`sol_report` — ties the two together: measured time vs. the roofline
  bound ``max(flops/peak_flops, bytes/bandwidth)``, reporting the achieved
  fraction of speed-of-light and whether the program is compute- or
  memory-bound.
- :func:`trace` — ``jax.profiler`` annotation context so regions show up
  named in profiler traces (the mechanism SURVEY.md §5 prescribes for
  rollout/QP-iteration regions).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import jax

__all__ = [
    "ChipSpec",
    "CHIP_SPECS",
    "detect_chip",
    "require_gpu",
    "measure",
    "cost_analysis",
    "roofline_seconds",
    "sol_report",
    "sol_score",
    "trace",
]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Roofline ceilings for one accelerator card.

    Dense peak rates in FLOP/s per precision — ``bf16`` and ``tf32`` on the
    tensor cores, ``f32`` outside them (what ``Precision.HIGHEST`` products
    run at) — and ``hbm_bytes_per_s`` in B/s.
    """

    name: str
    peak_flops_bf16: float
    peak_flops_tf32: float
    peak_flops_f32: float
    hbm_bytes_per_s: float

    def peak_flops(self, dtype: str = "f32") -> float:
        return {"bf16": self.peak_flops_bf16, "tf32": self.peak_flops_tf32,
                "f32": self.peak_flops_f32}[dtype]


CHIP_SPECS: Dict[str, ChipSpec] = {
    # keyed by jax Device.device_kind. NVIDIA H100 SXM data sheet, dense
    # rates without sparsity, at the card's full 700 W power limit (a card
    # capped lower cannot hold its top clock under matrix-heavy load — read
    # power.limit beside any number scored against these).
    "NVIDIA H100 80GB HBM3": ChipSpec(
        "NVIDIA H100 SXM", peak_flops_bf16=989e12, peak_flops_tf32=495e12,
        peak_flops_f32=67e12, hbm_bytes_per_s=3.35e12),
}


def require_gpu() -> Dict[str, Any]:
    """Device record of a measurement run; raises ``SystemExit`` without a
    GPU, so no CPU number is ever reported under a device metric."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX found {devices[0].platform} devices only")
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def detect_chip(device: Optional[jax.Device] = None) -> ChipSpec:
    """The :class:`ChipSpec` of ``device`` (default: the first device).

    Raises ``KeyError`` for a device kind the table does not hold.
    """
    if device is None:
        device = jax.devices()[0]
    try:
        return CHIP_SPECS[device.device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device.device_kind!r}; "
            f"known: {sorted(CHIP_SPECS)}") from None


def measure(
    fn: Callable[..., Any],
    *args: Any,
    warmup: int = 2,
    repeats: int = 5,
    inner: int = 1,
    reduce: str = "median",
) -> float:
    """Wall-clock seconds for one call of ``fn(*args)`` on device.

    ``fn`` should already be jitted; the first ``warmup`` calls absorb
    compilation and cache effects. Each repeat times ``inner`` back-to-back
    calls (raise ``inner`` for sub-millisecond programs so the host timer
    resolution stops mattering) and blocks on the result.
    """
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    jax.block_until_ready(out)
    samples = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        for _ in range(max(inner, 1)):
            out = fn(*args)
        jax.block_until_ready(out)
        samples.append((time.perf_counter() - t0) / max(inner, 1))
    samples.sort()
    if reduce == "min":
        return samples[0]
    return samples[len(samples) // 2]


def sol_score(
    time_s: float,
    *,
    label: str = "program",
    dtype: str = "f32",
    spec: Optional[ChipSpec] = None,
    flops: float = 0.0,
    nbytes: float = 0.0,
) -> Dict[str, Any]:
    """Score an externally measured time against the chip roofline, given
    the program's ``flops``/``nbytes`` (e.g. from :func:`cost_analysis`)."""
    spec = spec or detect_chip()
    sol_t = roofline_seconds(flops, nbytes, spec, dtype)
    compute_t = flops / spec.peak_flops(dtype)
    memory_t = nbytes / spec.hbm_bytes_per_s if spec.hbm_bytes_per_s else 0.0
    if flops == 0.0 and nbytes == 0.0:
        bound = "unknown"
    else:
        bound = "compute" if compute_t >= memory_t else "memory"
    return {
        "label": label,
        "chip": spec.name,
        "dtype": dtype,
        "time_s": time_s,
        "flops": flops,
        "bytes": nbytes,
        "achieved_tflops": flops / time_s / 1e12,
        "achieved_gbps": nbytes / time_s / 1e9,
        "sol_time_s": sol_t,
        "sol_frac": (sol_t / time_s) if sol_t > 0 else 0.0,
        "bound": bound,
    }


def cost_analysis(fn: Callable[..., Any], *args: Any) -> Dict[str, float]:
    """Post-fusion FLOPs / bytes accessed for ``jit(fn)(*args)`` from XLA.

    Returns ``{"flops": ..., "bytes": ...}``; zero when the backend does not
    publish an estimate (some CPU builds), so callers must treat 0 as
    "unknown", not "free".
    """
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    compiled = jitted.lower(*args).compile()
    stats = compiled.cost_analysis()
    if isinstance(stats, (list, tuple)):  # older jax returns [dict]
        stats = stats[0] if stats else {}
    stats = stats or {}
    return {
        "flops": float(stats.get("flops", 0.0)),
        "bytes": float(stats.get("bytes accessed", 0.0)),
    }


def roofline_seconds(flops: float, nbytes: float, spec: ChipSpec,
                     dtype: str = "f32") -> float:
    """Speed-of-light time: max of the compute and memory roofline bounds."""
    peak = spec.peak_flops(dtype)
    return max(flops / peak if peak else 0.0,
               nbytes / spec.hbm_bytes_per_s if spec.hbm_bytes_per_s else 0.0)


def sol_report(
    fn: Callable[..., Any],
    *args: Any,
    label: str = "program",
    dtype: str = "f32",
    spec: Optional[ChipSpec] = None,
    warmup: int = 2,
    repeats: int = 5,
    inner: int = 1,
) -> Dict[str, Any]:
    """Measure ``fn`` and score it against the chip roofline.

    The FLOP/byte numerators come from XLA's post-fusion ``cost_analysis``,
    which reports **0 for Pallas kernels** (custom calls are opaque to the
    HLO cost model) — count such programs by hand and use :func:`sol_score`.

    Returns a flat metrics dict (telemetry-friendly):
    ``time_s``, ``flops``, ``bytes``, ``achieved_tflops``, ``achieved_gbps``,
    ``sol_time_s``, ``sol_frac`` (measured speed-of-light fraction, 1.0 =
    at the roofline), and ``bound`` ("compute" | "memory" | "unknown").
    """
    spec = spec or detect_chip()
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    t = measure(jitted, *args, warmup=warmup, repeats=repeats, inner=inner)
    cost = cost_analysis(jitted, *args)
    return sol_score(t, label=label, dtype=dtype, spec=spec,
                     flops=cost["flops"], nbytes=cost["bytes"])


@contextlib.contextmanager
def trace(name: str):
    """Named profiler region: shows up in profiler traces.

    Host-side region naming (``jax.profiler.TraceAnnotation``) combined with
    ``jax.named_scope`` so the annotation survives into the HLO too.
    """
    with jax.profiler.TraceAnnotation(name), jax.named_scope(name):
        yield
