"""Where one banded PCG iteration spends its time on the card.

    python -m poms_tpu_torch.bench.profile_banded [n_el] [levels] [reps]

Builds the banded f64-mixed PCG of ``chip_smoke.py`` (3D Poisson, p = 3,
Chebyshev(4) over [λmax/16, λmax], ν1 = ν2 = 1; defaults n_el = 128, 5
levels), runs one warm-up solve, then runs ``reps`` (default 5) PCG
iterations from the start state, each ended by the ‖r‖ read that the solve
loop makes (one host sync per iteration):

- ``step_ms``: host clock per iteration, no profiler;
- under ``torch.profiler``, in one run: ``profiled_step_ms`` (CUDA events
  around the iterations) and ``busy_ms`` (the trace's device intervals —
  kernels, copies, memsets — merged), so ``idle_share`` =
  1 − busy_ms / profiled_step_ms is measured, not inferred;
- ``kernel_ms``, ``kernels``, ``k2_ms`` and ``k3_ms``: device time,
  launches and the banded kernels' share of it per iteration, from the
  same trace (K3 under ``POMS_TPU_SPMV=v2``, which ``engine`` names);
- ``ap_ms`` and ``precond_ms``: CUDA events around the f64 A·p (ghost
  refresh included) and the f32 V-cycle alone.

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


def main():
    n_el = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    levels = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 5

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from poms_tpu_torch.bench.device import nvidia_smi_name_power
    from poms_tpu_torch.bench.kernel_probe import cuda_event_ms
    from poms_tpu_torch.mg.cycles import CycleConfig
    from poms_tpu_torch.mg.mixed import MGPreconditionedCG
    from poms_tpu_torch.mg.smoother import SmootherConfig
    from poms_tpu_torch.models.poisson import poisson_problem
    from poms_tpu_torch.ops import dispatch
    from poms_tpu_torch.ops.stencil_v2 import stencil_apply_v2

    if not torch.cuda.is_available():
        raise SystemExit("profile_banded measures the card: no CUDA device "
                         "found")
    dev = torch.device("cuda", 0)
    prob = poisson_problem(3, n_el, degree=3, dtype=torch.float64, device=dev)
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SmootherConfig("chebyshev", cheb_fraction=16.0,
                                              cheb_degree=4))
    pcg = MGPreconditionedCG(prob, num_levels=levels, cfg=cfg, mixed=True,
                             precision="f64")
    pcg.solve_compiled(tol=1e-10, maxiter=30)
    state0, step, _ = pcg._start(prob.b)

    def run():
        state = state0
        for _ in range(reps):
            *state, rn = step(*state)
            float(rn)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / reps

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
    profiled_ms = start.elapsed_time(end) / reps
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = _merged_us([(e.time_range.start, e.time_range.end)
                          for e in device]) / 1e3 / reps
    if not busy_ms > 0:
        raise AssertionError("the profiler recorded no device time")
    stats = sorted((e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA),
                   key=lambda e: -e.self_device_time_total)
    kernel_ms = sum(e.self_device_time_total for e in stats) / 1e3 / reps

    def share(kernel):
        return sum(e.self_device_time_total for e in stats
                   if kernel in e.key) / 1e3 / reps
    for e in stats[:12]:
        print(f"{e.self_device_time_total / 1e3 / reps:9.4f} ms "
              f"{e.count / reps:7.1f}x  {e.key[:100]}", flush=True)

    _, r, _, p, _ = state0
    ap_ms = cuda_event_ms(lambda: pcg.levels[0].A.dot(p))
    precond_ms = cuda_event_ms(lambda: pcg._precond(r))
    power = nvidia_smi_name_power().rsplit(",", 1)[-1].strip()
    print("RESULT " + json.dumps({
        "name": f"banded_pcg3d_n{n_el}_p3_f64mixed_step",
        "levels": levels, "reps": reps, "step_ms": step_ms,
        "profiled_step_ms": profiled_ms, "busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / profiled_ms, "kernel_ms": kernel_ms,
        "kernels": sum(e.count for e in stats) / reps,
        "k2_ms": share("stencil_apply_kernel"),
        "k3_ms": share("stencil_apply_v2_kernel"),
        "engine": "v2" if dispatch.engine() is stencil_apply_v2 else "v1",
        "ap_ms": ap_ms, "precond_ms": precond_ms,
        "device": torch.cuda.get_device_name(0), "power_limit": power}),
        flush=True)


if __name__ == "__main__":
    main()
