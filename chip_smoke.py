"""Smoke test of the production paths on NVIDIA GPUs.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the data-parallel paths only

One card, in one process:

1. the card's name and power limit (``nvidia-smi``);
2. config 5 — the DCM-MPC fleet tick (``bench.py``) at full width: 98,304
   lanes, horizon 32, 50 warm-started ADMM iterations, 20 ticks scanned in
   one jit. Compile seconds, tick time, memory analysis; every lane must
   converge; one more tick of a 256-lane slice is recomputed on the CPU
   device and compared lane for lane;
3. config 4 — the control stack (``benchmarks/stack_bench.py``) at 512
   lanes: everything finite after 2 outer ticks, convergence counts, 8 lanes
   compared with the same stack run on the CPU device, then 2 timed ticks;
4. each hand-written kernel and library replacement against its plain
   reference at the production widths, and an audit that every matrix
   product of both programs runs at full f32 (no TF32);
5. ``peak_bytes_in_use``.

With ``--four``: config 5 on a ``(data=4, model=1)`` mesh at 4 × 98,304
lanes and the config-4 stack data-parallel at 4 × 512 lanes, each compared
lane for lane with the same lanes on one card.

Any failed check raises, so the script exits non-zero; without a GPU it
exits non-zero before printing any result. The last line of standard output
is one JSON object: ``{"ok": true, "device": {...}}``.
"""

import functools
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
CPU_SLICE = 256          # config-5 lanes recomputed on the CPU device
STACK_BATCH = 512
STACK_CPU_LANES = 8      # config-4 lanes recomputed on the CPU device


def card_line() -> str:
    """``name, power.limit`` of every card, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


class Report:
    """Prints each informative line tagged with the card it was read on."""

    def __init__(self, card: str):
        self.tag = card.splitlines()[0]

    def __call__(self, phase: str, **values):
        print(f"[{self.tag}] {phase}: {json.dumps(values)}", flush=True)


def check(cond, what: str):
    if not cond:
        raise AssertionError(what)


def max_abs_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64))))


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def memory_summary(compiled) -> dict:
    m = compiled.memory_analysis()
    return {k: getattr(m, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(m, k)}


def cpu_mesh(jax):
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1),
                ("data", "model"))


# --------------------------------------------------------------- config 5

def config5(report, jax, jnp):
    import bench
    from blf_tpu.ops.precision import reduced_precision_dots
    from blf_tpu.parallel.mesh import make_mesh
    from blf_tpu.utils.status import SolverStatus

    run, state, dist, tick = bench.build_fleet_tick(make_mesh(1, 1))
    lowered = run.lower(state, dist)
    bad = reduced_precision_dots(lowered)
    check(not bad, f"config 5: {len(bad)} products below f32: {bad[:3]}")
    t0 = time.perf_counter()
    compiled = lowered.compile()
    compile_s = time.perf_counter() - t0
    (state, _), warm_s = timed(compiled, state, dist)   # reach steady state
    (state, result), run_s = timed(compiled, state, dist)
    B = state.dcm.shape[0]
    status = np.asarray(result.status)
    report("config5", batch=B, horizon=bench.HORIZON,
           iterations=bench.ITERATIONS, compile_s=compile_s,
           tick_ms=1e3 * run_s / bench.TICKS,
           solves_per_s=B * bench.TICKS / run_s,
           converged=float(result.stats.num_converged),
           max_primal_residual=float(result.stats.max_primal_residual),
           max_dual_residual=float(result.stats.max_dual_residual),
           memory=memory_summary(compiled))
    check(float(result.stats.num_converged) == B
          and np.all(status == SolverStatus.CONVERGED),
          f"config 5: {int(np.sum(status == SolverStatus.CONVERGED))}/{B} "
          "lanes converged (primal and dual residual under eps_abs + "
          "eps_rel·scale per lane)")
    check(np.all(np.isfinite(np.asarray(state.dcm))), "config 5: non-finite")

    # one more tick: all lanes on the card, a slice on the CPU device, from
    # the same warm-started state; f32 with every product at HIGHEST on both
    new_gpu, res_gpu = tick(state, dist)
    cpu = jax.devices("cpu")[0]
    sl = lambda a: jax.device_put(np.asarray(a)[:CPU_SLICE], cpu)
    with jax.default_device(cpu):
        _, _, _, tick_cpu = bench.build_fleet_tick(
            cpu_mesh(jax), batch=CPU_SLICE)
        new_cpu, res_cpu = tick_cpu(jax.tree_util.tree_map(sl, state),
                                    sl(dist))
    tol = {"warm_zmp": 1e-4, "dcm": 1e-5, "com": 1e-5}
    diffs = {k: max_abs_diff(getattr(new_gpu, k)[:CPU_SLICE],
                             getattr(new_cpu, k)) for k in tol}
    same_status = bool(np.all(np.asarray(res_gpu.status)[:CPU_SLICE]
                              == np.asarray(res_cpu.status)))
    report("config5_vs_cpu", lanes=CPU_SLICE, precision="f32, HIGHEST",
           max_abs_diff=diffs, tolerance_m=tol, same_status=same_status)
    for k, t in tol.items():
        check(diffs[k] <= t, f"config 5 vs CPU: {k} differs by {diffs[k]}")
    check(same_status, "config 5 vs CPU: lane status differs")


# --------------------------------------------------------------- config 4

def config4(report, jax, jnp):
    import stack_bench as sb
    from blf_tpu.ops.precision import reduced_precision_dots
    from blf_tpu.utils.status import status_counts

    step, state, pushes, refs = sb.build_stack(STACK_BATCH)
    run = sb.make_run_ticks(step, refs, 2)
    lowered = run.lower(state, pushes)
    bad = reduced_precision_dots(lowered)
    check(not bad, f"config 4: {len(bad)} products below f32: {bad[:3]}")
    t0 = time.perf_counter()
    compiled = lowered.compile()
    compile_s = time.perf_counter() - t0
    (state2, trace), _ = timed(compiled, state, pushes)
    finite = all(bool(jnp.all(jnp.isfinite(leaf)))
                 for leaf in jax.tree_util.tree_leaves(state2))
    report("config4", batch=STACK_BATCH, outer_ticks=2, compile_s=compile_s,
           all_finite=finite,
           mpc_converged=int(jnp.sum(trace.mpc_converged)),
           wbc_converged=int(jnp.sum(trace.wbc_converged)),
           status_counts=status_counts(trace.status),
           wbc_max_rp=float(jnp.max(trace.wbc_max_rp)),
           wbc_max_rd=float(jnp.max(trace.wbc_max_rd)),
           memory=memory_summary(compiled))
    check(finite, "config 4: non-finite state after 2 outer ticks")

    # the same stack, same pushes (seed 0 draws lane by lane), on the CPU
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        step_c, state_c, pushes_c, refs_c = sb.build_stack(STACK_CPU_LANES)
        state_c, trace_c = sb.make_run_ticks(step_c, refs_c, 2)(
            state_c, pushes_c)
        jax.block_until_ready(state_c)
    n = STACK_CPU_LANES
    tol = {"base_position": 1e-4, "joint_positions": 1e-3}
    diffs = {k: max_abs_diff(getattr(state2.plant, k)[:n],
                             getattr(state_c.plant, k)) for k in tol}
    diffs["dcm"] = max_abs_diff(trace.dcm[:n], trace_c.dcm)
    tol["dcm"] = 1e-4
    report("config4_vs_cpu", lanes=n, outer_ticks=2,
           precision="f32, HIGHEST", max_abs_diff=diffs,
           tolerance=tol, units="m, rad, m")
    for k, t in tol.items():
        check(diffs[k] <= t, f"config 4 vs CPU: {k} differs by {diffs[k]}")

    (state4, trace4), run_s = timed(compiled, state2, pushes)
    report("config4_timed", outer_ticks=2,
           outer_tick_ms=1e3 * run_s / 2,
           outer_ticks_per_s=STACK_BATCH * 2 / run_s,
           mpc_converged=int(jnp.sum(trace4.mpc_converged)),
           wbc_converged=int(jnp.sum(trace4.wbc_converged)))
    check(all(bool(jnp.all(jnp.isfinite(leaf)))
              for leaf in jax.tree_util.tree_leaves(state4)),
          "config 4: non-finite state after 4 outer ticks")


# ------------------------------------------- config-5 solve vs roofline

def stage_loop(report, jax, jnp):
    """The config-5 solve alone (50 iterations on prebuilt shared factors,
    XLA at HIGHEST) against the card's roofline. Minimal traffic per lane
    and iteration: read v, l, u (m each) and q·W (n), write v (m) and τ (n);
    work: two (m × n) products."""
    import bench
    from blf_tpu.mpc.dcm import build_dcm_qp
    from blf_tpu.mpc.qp import factor_shared_qp, solve_qp_factored
    from blf_tpu.utils.profiling import detect_chip, measure, sol_score
    from __graft_entry__ import _example_problem

    B, h, iters = bench.BATCH, bench.HORIZON, bench.ITERATIONS
    params, dt, dcm0, dcm_ref, zmp_ref, poly_A, poly_b = _example_problem(
        B, h, jnp.float32)
    P, q, A, l, u = build_dcm_qp(params, dt, dcm0, dcm_ref, zmp_ref,
                                 poly_A, poly_b)
    P = P[(0,) * (P.ndim - 2)]              # shared across lanes
    A = A[(0,) * (A.ndim - 2)]
    m, n = A.shape
    f = jax.jit(factor_shared_qp)(P, A, jnp.arange(m) < 2 * h)
    solve = jax.jit(lambda f, q, l, u: solve_qp_factored(
        f, q, l, u, iterations=iters, refine=False).x)
    t = measure(solve, f, q, l, u, warmup=2, repeats=9)
    spec = detect_chip()
    r = sol_score(t, label="config-5 solve", dtype="f32", spec=spec,
                  flops=4.0 * B * m * n * iters,
                  nbytes=4.0 * (4 * m + 2 * n) * B * iters)
    report("shared_operator_admm_xla", batch=B, m=m, n=n, iterations=iters,
           solve_ms=1e3 * t, bytes=r["bytes"], flops=r["flops"],
           hbm_roofline_share=r["bytes"] / spec.hbm_bytes_per_s / t,
           f32_compute_roofline_share=r["flops"] / spec.peak_flops("f32") / t,
           bound=r["bound"])


# -------------------------------------------------------- kernels vs refs

def kernels(report, jax, jnp):
    from blf_tpu.mpc.qp import solve_qp
    from blf_tpu.ops.linalg import spd_inverse
    from blf_tpu.ops.pallas.admm_lane import (
        admm_lane_stage, admm_lane_stage_reference)

    rng = np.random.default_rng(0)
    B, m, n = STACK_BATCH, 86, 64            # the WBC's QP shape

    # one 150-iteration stage: same recursion, kernel vs batched XLA
    A = rng.normal(size=(B, m, n)) * 0.3
    rho = np.abs(rng.normal(size=(B, m))) + 0.5
    Kinv = np.linalg.inv(np.eye(n) + np.einsum("bmi,bm,bmj->bij", A, rho, A))
    lo, hi = -np.abs(rng.normal(size=(B, m))), np.abs(rng.normal(size=(B, m)))
    lo[:, 1] = -np.inf
    args = [jnp.asarray(a, jnp.float32) for a in (
        rng.normal(size=(B, m)) * 0.1, rho, A, Kinv, rng.normal(size=(B, n)),
        lo, hi)]
    v_k, x_k = admm_lane_stage(*args, iters=150)
    v_r, x_r = jax.jit(functools.partial(
        admm_lane_stage_reference, iters=150))(*args)
    rel = max(max_abs_diff(v_k, v_r) / float(jnp.max(jnp.abs(v_r))),
              max_abs_diff(x_k, x_r) / float(jnp.max(jnp.abs(x_r))))
    report("admm_lane_stage_vs_xla", batch=B, m=m, n=n, iters=150,
           precision="f32 (kernel: no dot; reference: HIGHEST)",
           max_rel_diff=rel, tolerance=1e-4)
    check(rel <= 1e-4, f"lane kernel vs XLA recursion: {rel}")

    # whole solves: fused lane path vs solve_qp(backend="xla")
    P = rng.normal(size=(B, n, n)) * 0.3
    P = P @ np.swapaxes(P, -1, -2) + np.eye(n)
    q = rng.normal(size=(B, n))
    xs = rng.normal(size=(B, n))
    Ax = np.einsum("bmn,bn->bm", A, xs)
    l = Ax - np.abs(rng.normal(size=(B, m))) * 0.5
    u = Ax + np.abs(rng.normal(size=(B, m))) * 0.5
    l[:, :18] = u[:, :18] = Ax[:, :18]       # equality rows (dynamics)
    qp = [jnp.asarray(a, jnp.float32) for a in (P, q, A, l, u)]
    kw = dict(iterations=400, eps_abs=1e-4, eps_rel=1e-4)
    lane = solve_qp(*qp, backend="pallas", **kw)
    ref = solve_qp(*qp, backend="xla", **kw)
    both = np.asarray(lane.converged & ref.converged)
    dx = max_abs_diff(np.asarray(lane.x)[both], np.asarray(ref.x)[both])
    report("solve_qp_pallas_vs_xla", batch=B, m=m, n=n,
           precision="f32, HIGHEST", converged_pallas=int(lane.converged.sum()),
           converged_xla=int(ref.converged.sum()), both=int(both.sum()),
           max_abs_dx=dx, tolerance=5e-3)
    check(both.sum() >= 0.95 * B, "lane vs XLA solve: too few converged")
    check(dx <= 5e-3, f"lane vs XLA solve: x differs by {dx}")

    # batched SPD inverse (cuSOLVER) vs float64 NumPy at the stack's shapes
    for k in (64, 29):
        G = rng.normal(size=(B, k, k)) * 0.3
        K = G @ np.swapaxes(G, -1, -2) + 2 * np.eye(k)
        inv = np.asarray(jax.jit(spd_inverse)(jnp.asarray(K, jnp.float32)))
        ref64 = np.linalg.inv(K)
        rel = float(np.max(np.abs(inv - ref64)) / np.max(np.abs(ref64)))
        report("spd_inverse_vs_f64", shape=[B, k, k], precision="f32",
               max_rel_diff=rel, tolerance=1e-5)
        check(rel <= 1e-5, f"spd_inverse ({k}): {rel}")


# ------------------------------------------------------------ four cards

def four_cards(report, jax, jnp):
    import bench
    import stack_bench as sb
    from jax import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from blf_tpu.parallel.mesh import make_mesh

    devices = jax.devices()
    check(len(devices) >= 4, f"--four needs 4 cards, found {len(devices)}")
    per = bench.BATCH

    # config 5, data-parallel over 4 cards, weak scaling (98,304 per card)
    # 20 warm-up ticks, then 20 timed ticks, on both sides
    run4, state4, dist4, _ = bench.build_fleet_tick(make_mesh(4, 1),
                                                    batch=4 * per)
    run4 = run4.lower(state4, dist4).compile()
    s4, _ = run4(state4, dist4)
    (s4, r4), t4 = timed(run4, s4, dist4)
    quarter = lambda k: lambda a: jax.device_put(
        np.asarray(a)[k * per:(k + 1) * per], devices[0])
    mesh1 = Mesh(np.array(devices[:1]).reshape(1, 1), ("data", "model"))
    run1, state1, _, _ = bench.build_fleet_tick(mesh1, batch=per)
    run1 = run1.lower(state1, quarter(0)(dist4)).compile()
    conv1, rp1, diff, t1 = 0.0, 0.0, 0.0, []
    for k in range(4):
        sl = quarter(k)
        s1, _ = run1(jax.tree_util.tree_map(sl, state4), sl(dist4))
        (s1, r1), t = timed(run1, s1, sl(dist4))
        t1.append(t)
        conv1 += float(r1.stats.num_converged)
        rp1 = max(rp1, float(r1.stats.max_primal_residual))
        diff = max(diff, max_abs_diff(
            np.asarray(s4.warm_zmp)[k * per:(k + 1) * per], s1.warm_zmp))
    t1 = float(np.median(t1))
    report("config5_four", lanes=4 * per, tick_ms_4cards=1e3 * t4 / bench.TICKS,
           tick_ms_1card=1e3 * t1 / bench.TICKS,
           weak_scaling_efficiency=t1 / t4,
           converged_4cards=float(r4.stats.num_converged),
           converged_1card_sum=conv1, max_abs_diff_zmp=diff, tolerance=1e-5)
    check(float(r4.stats.num_converged) == conv1 == 4 * per,
          "config 5 four cards: psum'd convergence count differs")
    rp4 = float(r4.stats.max_primal_residual)
    check(abs(rp4 - rp1) <= 1e-7 + 0.1 * rp1,
          f"config 5 four cards: pmax'd residual {rp4} vs {rp1}")
    check(diff <= 1e-5, f"config 5 four cards: plan differs by {diff}")

    # config 4, data-parallel stack tick over 4 cards (4 × 512 lanes)
    step, state, pushes, refs = sb.build_stack(4 * STACK_BATCH)
    dp = Mesh(np.array(devices[:4]), ("data",))
    lane_spec = lambda a: P(*(("data",) + (None,) * (a.ndim - 1)))

    def local_ticks(fleet, push):
        def body(s, _):
            return step(s, push, *refs)
        fleet, tr = jax.lax.scan(body, fleet, None, length=2)
        return fleet, jax.lax.psum(
            jnp.sum((tr.status[-1] == 0).astype(jnp.int32)), "data")

    specs = jax.tree_util.tree_map(lane_spec, state)
    stack_dp = jax.jit(shard_map(
        local_ticks, mesh=dp, in_specs=(specs, P("data", None)),
        out_specs=(specs, P()), check_vma=False))
    put = lambda a: jax.device_put(a, NamedSharding(dp, lane_spec(a)))
    (f4, conv4), _ = timed(stack_dp, jax.tree_util.tree_map(put, state),
                           put(pushes))
    run1 = sb.make_run_ticks(step, refs, 2)
    conv, diff = 0, 0.0
    for k in range(4):
        sl = lambda a, k=k: jax.device_put(
            np.asarray(a)[k * STACK_BATCH:(k + 1) * STACK_BATCH], devices[0])
        f1, tr1 = run1(jax.tree_util.tree_map(sl, state), sl(pushes))
        conv += int(jnp.sum(tr1.status == 0))
        diff = max(diff, max_abs_diff(
            np.asarray(f4.plant.base_position)[
                k * STACK_BATCH:(k + 1) * STACK_BATCH],
            f1.plant.base_position))
    report("config4_four", lanes=4 * STACK_BATCH, outer_ticks=2,
           converged_4cards=int(conv4), converged_1card_sum=conv,
           max_abs_diff_base_position=diff, tolerance_m=1e-5)
    check(int(conv4) == conv, "config 4 four cards: convergence differs")
    check(diff <= 1e-5, f"config 4 four cards: state differs by {diff}")


def main(argv) -> int:
    import jax
    import jax.numpy as jnp

    sys.path[:0] = [str(ROOT), str(ROOT / "benchmarks")]
    from blf_tpu.utils.compile_cache import enable_compile_cache
    from blf_tpu.utils.profiling import require_gpu

    device = require_gpu()
    enable_compile_cache()
    card = card_line()
    print(card, flush=True)
    report = Report(card)
    if "--four" in argv:
        four_cards(report, jax, jnp)
    else:
        config5(report, jax, jnp)
        config4(report, jax, jnp)
        kernels(report, jax, jnp)
        stage_loop(report, jax, jnp)
    report("memory", peak_bytes_in_use=[
        d.memory_stats().get("peak_bytes_in_use") for d in jax.devices()])
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
