"""Where one banded PCG iteration or defect correction spends its time on
the card.

    python -m poms_tpu_torch.bench.profile_banded [n_el] [levels] [reps]
        [pcg|defect] [f32|bf16]

Builds the banded f64-mixed PCG of ``chip_smoke.py`` (3D Poisson, p = 3,
Chebyshev(4) over [λmax/16, λmax], ν1 = ν2 = 1; defaults n_el = 128, 5
levels) or, with ``defect``, its banded defect correction
(``MixedPrecisionMG(residual="f64")``, Chebyshev(4) over [λmax/32, λmax]),
with the cycle in f32 or bf16; runs one warm-up solve, then runs ``reps``
(default 5) steps from the start state, each ended by the ‖r‖ read that the
solve loop makes (one host sync per step):

- ``step_ms``: host clock per iteration, no profiler;
- under ``torch.profiler``, in one run: ``profiled_step_ms`` (CUDA events
  around the iterations) and ``busy_ms`` (the trace's device intervals —
  kernels, copies, memsets — merged), so ``idle_share`` =
  1 − busy_ms / profiled_step_ms is measured, not inferred;
- ``kernel_ms``, ``kernels``, ``k2_ms`` and ``k3_ms``: device time,
  launches and the banded kernels' share of it per iteration, from the
  same trace (K3 under ``POMS_TPU_SPMV=v2``, which ``engine`` names);
- ``replayed_step_ms``, ``replayed_busy_ms``, ``replayed_idle_share``,
  ``replayed_kernels``: the same iterations as replays of the step's
  captured CUDA graph (the path of ``solve_compiled``);
- ``ap_ms`` and ``precond_ms``: CUDA events around the f64 A·p (``defect``:
  the f64 residual; ghost refresh included) and the low-precision V-cycle
  alone.

Prints the kernels with the most device time, then one ``RESULT {...}``
line.  Needs a CUDA card: there is no CPU fallback.
"""
import json
import sys
import time


def _merged_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profiled_run(run, reps):
    """(CUDA-event ms per step, merged device ms per step, kernel stats)
    of ``run`` under the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = _merged_us([(e.time_range.start, e.time_range.end)
                          for e in device]) / 1e3 / reps
    if not busy_ms > 0:
        raise AssertionError("the profiler recorded no device time")
    stats = sorted((e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA),
                   key=lambda e: -e.self_device_time_total)
    return start.elapsed_time(end) / reps, busy_ms, stats


def main():
    n_el = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    levels = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    which = sys.argv[4] if len(sys.argv) > 4 else "pcg"
    low_name = sys.argv[5] if len(sys.argv) > 5 else "f32"
    if which not in ("pcg", "defect") or low_name not in ("f32", "bf16"):
        raise SystemExit(__doc__)

    import torch

    from poms_tpu_torch.bench.device import nvidia_smi_name_power
    from poms_tpu_torch.bench.kernel_probe import cuda_event_ms
    from poms_tpu_torch.core.vector import StencilVector
    from poms_tpu_torch.mg.cycles import CycleConfig
    from poms_tpu_torch.mg.graph import GraphedStep
    from poms_tpu_torch.mg.mixed import MGPreconditionedCG, MixedPrecisionMG
    from poms_tpu_torch.mg.smoother import SmootherConfig
    from poms_tpu_torch.models.poisson import poisson_problem
    from poms_tpu_torch.ops import dispatch
    from poms_tpu_torch.ops.stencil_v2 import stencil_apply_v2

    if not torch.cuda.is_available():
        raise SystemExit("profile_banded measures the card: no CUDA device "
                         "found")
    dev = torch.device("cuda", 0)
    prob = poisson_problem(3, n_el, degree=3, dtype=torch.float64, device=dev)
    low = torch.bfloat16 if low_name == "bf16" else torch.float32
    cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0 if which == "pcg" else 32.0,
        cheb_degree=4))
    if which == "pcg":
        pcg = MGPreconditionedCG(prob, num_levels=levels, cfg=cfg, mixed=True,
                                 precision="f64", low_dtype=low)
    else:
        pcg = MixedPrecisionMG(prob, levels, cfg, operator="banded",
                               residual="f64", low_dtype=low)
    pcg.solve(tol=1e-10, maxiter=30)
    state0, consts, step = pcg._start(prob.b)[:3]

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
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / reps
    profiled_ms, busy_ms, stats = profiled_run(run, reps)
    kernel_ms = sum(e.self_device_time_total for e in stats) / 1e3 / reps

    def share(kernel):
        return sum(e.self_device_time_total for e in stats
                   if kernel in e.key) / 1e3 / reps
    for e in stats[:16]:
        print(f"{e.self_device_time_total / 1e3 / reps:9.4f} ms "
              f"{e.count / reps:7.1f}x  {e.key[:100]}", flush=True)

    replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    replay()
    torch.cuda.synchronize()
    replayed_ms = (time.perf_counter() - t0) * 1e3 / reps
    r_profiled_ms, r_busy_ms, r_stats = profiled_run(replay, reps)

    sp = prob.space
    if which == "pcg":
        _, r, _, p, _ = (StencilVector.from_interior(sp, t) if t.ndim else t
                         for t in state0)
        ap_ms = cuda_event_ms(lambda: pcg.levels[0].A.dot(p))
        precond_ms = cuda_event_ms(lambda: pcg._precond(r))
    else:
        A = pcg.levels64[0].A
        r_low = StencilVector.from_interior(
            pcg.levels32[0].A.space,
            (prob.b.interior / prob.b.norm()).to(low))
        ap_ms = cuda_event_ms(lambda: A.residual(prob.b, prob.b))
        precond_ms = cuda_event_ms(lambda: pcg._error_cycles(r_low))
    power = nvidia_smi_name_power().rsplit(",", 1)[-1].strip()
    print("RESULT " + json.dumps({
        "name": f"banded_{which}3d_n{n_el}_p3_f64mixed_{low_name}_step",
        "levels": levels, "reps": reps, "step_ms": step_ms,
        "profiled_step_ms": profiled_ms, "busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / profiled_ms, "kernel_ms": kernel_ms,
        "kernels": sum(e.count for e in stats) / reps,
        "k2_ms": share("stencil_apply_kernel"),
        "k3_ms": share("stencil_apply_v2_kernel"),
        "k7_ms": share("transfer_axis_kernel"),
        "engine": "v2" if dispatch.engine() is stencil_apply_v2 else "v1",
        "replayed_step_ms": replayed_ms,
        "replayed_profiled_step_ms": r_profiled_ms,
        "replayed_busy_ms": r_busy_ms,
        "replayed_idle_share": 1.0 - r_busy_ms / r_profiled_ms,
        "replayed_kernels": sum(e.count for e in r_stats) / reps,
        "ap_ms": ap_ms, "precond_ms": precond_ms,
        "device": torch.cuda.get_device_name(0), "power_limit": power}),
        flush=True)


if __name__ == "__main__":
    main()
