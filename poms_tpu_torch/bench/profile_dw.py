"""Where one iteration of the headline dw-PCG, or one correction of the
defect-correction solver, spends its time on the card.

    python -m poms_tpu_torch.bench.profile_dw [n_el] [levels] [reps] [solver]
        [low] [problem]

Builds the headline solver of ``chip_smoke.py`` (3D Poisson, p = 3,
Kronecker-sum operator, double-word recurrences, Chebyshev(4) over
[λmax/16, λmax], ν1 = ν2 = 1; defaults n_el = 128, 5 levels) or, with
``solver`` = ``defect``, ``MixedPrecisionMG(residual="twofloat")`` over
[λmax/32, λmax]; ``low`` = ``bf16`` runs the cycle on a bf16 hierarchy and
``problem`` = ``periodic`` takes the periodic shifted problem (σ = 1, over
[λmax/16, λmax]) instead of Poisson; runs one warm-up solve, then runs
``reps`` (default 5)
eager steps from the start state, each ended by the ‖r‖ read that the solve
loop makes (one host sync per iteration):

- ``step_ms``: host clock per iteration, no profiler;
- under ``torch.profiler``, in one run: ``profiled_step_ms`` (CUDA events
  around the iterations) and ``busy_ms`` (the trace's device intervals
  merged), so ``idle_share`` = 1 − busy_ms / profiled_step_ms is measured;
- ``kernel_ms`` and ``kernels``: device time and launches per iteration of
  every kernel; ``k1_ms``, ``k5_ms``, ``k6r_ms``, ``k6u_ms``, ``k7_ms``: the
  hand-written kernels' shares;
- ``launches``: every wrapper's launches per iteration, K6 and K7 included;
- ``replayed_step_ms``, ``replayed_busy_ms``, ``replayed_idle_share`` and
  ``replayed_kernels``: the same ``reps`` steps as replays of the captured
  CUDA graph (the path of ``solve_compiled``), host clock and, under the
  profiler, merged device intervals;
- ``ap_ms`` and ``precond_ms`` (PCG only): CUDA events around the
  double-word A·p and the f32 V-cycle alone.

Prints the kernels with the most device time, then one ``RESULT {...}``
line.  Needs a CUDA card: there is no CPU fallback.
"""
import json
import sys
import time


def main():
    n_el = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    levels = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    solver = sys.argv[4] if len(sys.argv) > 4 else "pcg"
    if solver not in ("pcg", "defect"):
        raise SystemExit(f"solver is 'pcg' or 'defect', got {solver!r}")
    low = sys.argv[5] if len(sys.argv) > 5 else "f32"
    problem = sys.argv[6] if len(sys.argv) > 6 else "poisson"
    if low not in ("f32", "bf16") or problem not in ("poisson", "periodic"):
        raise SystemExit("low is 'f32' or 'bf16', problem 'poisson' or "
                         f"'periodic', got {low!r} {problem!r}")

    import torch

    from poms_tpu_torch.bench.device import nvidia_smi_name_power
    from poms_tpu_torch.bench.kernel_probe import cuda_event_ms
    from poms_tpu_torch.bench.profile_banded import profiled_run
    from poms_tpu_torch.mg.cycles import CycleConfig
    from poms_tpu_torch.mg.graph import GraphedStep
    from poms_tpu_torch.mg.mixed import MGPreconditionedCG, MixedPrecisionMG
    from poms_tpu_torch.mg.smoother import SmootherConfig
    from poms_tpu_torch.models.periodic import periodic_problem
    from poms_tpu_torch.models.poisson import poisson_problem
    from poms_tpu_torch.ops import counters
    from poms_tpu_torch.ops.twofloat import dw_norm2

    if not torch.cuda.is_available():
        raise SystemExit("profile_dw measures the card: no CUDA device found")
    dev = torch.device("cuda", 0)
    if problem == "periodic":
        prob = periodic_problem(3, n_el, degree=3, device=dev)
    else:
        prob = poisson_problem(3, n_el, degree=3, dtype=torch.float64,
                               device=dev, operator="kron")
    fraction = 16.0 if solver == "pcg" or problem == "periodic" else 32.0
    low_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[low]
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SmootherConfig("chebyshev",
                                              cheb_fraction=fraction,
                                              cheb_degree=4))
    if solver == "pcg":
        sol = MGPreconditionedCG(prob, num_levels=levels, cfg=cfg, mixed=True,
                                 operator="kron", precision="dw",
                                 low_dtype=low_dtype)
    else:
        sol = MixedPrecisionMG(prob, num_levels=levels, cfg=cfg,
                               operator="kron", residual="twofloat",
                               low_dtype=low_dtype)
    sol.solve(tol=1e-10, maxiter=30)
    state0, consts, step = sol._start(prob.b)[:3]

    def run():
        state = state0
        for _ in range(reps):
            *state, rn = step(*state, *consts)
            float(rn)

    graph = GraphedStep(step, state0, consts)

    def replay():
        graph.load(state0, consts)
        for _ in range(reps):
            float(graph.replay())

    run()
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / reps
    launches = {k: v / reps for k, v in counters.snapshot().items() if v}

    profiled_ms, busy_ms, stats = profiled_run(run, reps)
    kernel_ms = sum(e.self_device_time_total for e in stats) / 1e3 / reps

    def share(kernel):
        return sum(e.self_device_time_total for e in stats
                   if kernel in e.key) / 1e3 / reps
    for e in stats[:14]:
        print(f"{e.self_device_time_total / 1e3 / reps:9.4f} ms "
              f"{e.count / reps:7.1f}x  {e.key[:100]}", flush=True)

    replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replay()
    torch.cuda.synchronize()
    replayed_ms = (time.perf_counter() - t0) * 1e3 / reps
    r_profiled_ms, r_busy_ms, r_stats = profiled_run(replay, reps)

    extra = {}
    if solver == "pcg":
        xh, xl, rh, rl, z, p, rz = state0
        rn = dw_norm2(rh, rl)
        extra = {"ap_ms": cuda_event_ms(lambda: sol._apply_A_dw(p)),
                 "precond_ms": cuda_event_ms(
                     lambda: sol._precond_dw(rh, rl, rn))}
    power = nvidia_smi_name_power().rsplit(",", 1)[-1].strip()
    print("RESULT " + json.dumps({
        "name": (f"pcg3d_n{n_el}_p3_dw_step" if solver == "pcg"
                 else f"vcycle3d_n{n_el}_p3_twofloat_step")
        + ("" if low == "f32" else f"_{low}")
        + ("" if problem == "poisson" else f"_{problem}"),
        "levels": levels, "reps": reps, "step_ms": step_ms,
        "profiled_step_ms": profiled_ms, "busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / profiled_ms, "kernel_ms": kernel_ms,
        "kernels": sum(e.count for e in stats) / reps,
        "k1_ms": share("kron_march_kernel"),
        "k5_ms": share("kron_march_dw_kernel"),
        "k6r_ms": share("dw_reduce_kernel"),
        "k6u_ms": share("dw_update_kernel"),
        "k7_ms": share("transfer_kernel"),
        "launches": launches,
        "replayed_step_ms": replayed_ms,
        "replayed_profiled_step_ms": r_profiled_ms,
        "replayed_busy_ms": r_busy_ms,
        "replayed_idle_share": 1.0 - r_busy_ms / r_profiled_ms,
        "replayed_kernels": sum(e.count for e in r_stats) / reps,
        **extra,
        "device": torch.cuda.get_device_name(0), "power_limit": power}),
        flush=True)


if __name__ == "__main__":
    main()
