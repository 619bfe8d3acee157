"""Where one iteration of the headline dw-PCG spends its time on the card.

    python -m poms_tpu_torch.bench.profile_dw [n_el] [levels] [reps]

Builds the headline solver of ``chip_smoke.py`` (3D Poisson, p = 3,
Kronecker-sum operator, double-word recurrences, Chebyshev(4) over
[λmax/16, λmax], ν1 = ν2 = 1; defaults n_el = 128, 5 levels), runs one
warm-up solve, then runs ``reps`` (default 5) ``_step_dw`` iterations from
the start state, each ended by the ‖r‖ read that the solve loop makes (one
host sync per iteration):

- ``step_ms``: host clock per iteration, no profiler;
- under ``torch.profiler``, in one run: ``profiled_step_ms`` (CUDA events
  around the iterations) and ``busy_ms`` (the trace's device intervals
  merged), so ``idle_share`` = 1 − busy_ms / profiled_step_ms is measured;
- ``kernel_ms`` and ``kernels``: device time and launches per iteration of
  every kernel; ``k1_ms`` and ``k5_ms``: the hand-written kernels' share;
- ``k1_launches`` (per mode) and ``k5_launches`` per iteration, from the
  wrappers' counters;
- ``ap_ms`` and ``precond_ms``: CUDA events around the double-word A·p and
  the f32 V-cycle alone.

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

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from poms_tpu_torch.bench.device import nvidia_smi_name_power
    from poms_tpu_torch.bench.kernel_probe import cuda_event_ms
    from poms_tpu_torch.bench.profile_banded import _merged_us
    from poms_tpu_torch.mg.cycles import CycleConfig
    from poms_tpu_torch.mg.mixed import MGPreconditionedCG
    from poms_tpu_torch.mg.smoother import SmootherConfig
    from poms_tpu_torch.models.poisson import poisson_problem
    from poms_tpu_torch.ops.kron import MODES, kron_mode
    from poms_tpu_torch.ops.twofloat import dw_norm2, residual_kron_df

    if not torch.cuda.is_available():
        raise SystemExit("profile_dw measures the card: no CUDA device found")
    dev = torch.device("cuda", 0)
    prob = poisson_problem(3, n_el, degree=3, dtype=torch.float64,
                           device=dev, operator="kron")
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SmootherConfig("chebyshev", cheb_fraction=16.0,
                                              cheb_degree=4))
    pcg = MGPreconditionedCG(prob, num_levels=levels, cfg=cfg, mixed=True,
                             operator="kron", precision="dw")
    pcg.solve_compiled(tol=1e-10, maxiter=30)
    state0, step, _ = pcg._start(prob.b)

    def run():
        state = state0
        for _ in range(reps):
            *state, rn = step(*state)
            float(rn)

    run()
    torch.cuda.synchronize()
    for mode in MODES:
        kron_mode.launches[mode] = 0
    residual_kron_df.launches = 0
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / reps
    k1_launches = {m: kron_mode.launches[m] / reps for m in MODES}
    k5_launches = residual_kron_df.launches / reps

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
    for e in stats[:14]:
        print(f"{e.self_device_time_total / 1e3 / reps:9.4f} ms "
              f"{e.count / reps:7.1f}x  {e.key[:100]}", flush=True)

    xh, xl, rh, rl, z, p, rz = state0
    ap_ms = cuda_event_ms(lambda: pcg._apply_A_dw(p))
    rn = dw_norm2(rh, rl)
    precond_ms = cuda_event_ms(lambda: pcg._precond_dw(rh, rl, rn))
    power = nvidia_smi_name_power().rsplit(",", 1)[-1].strip()
    print("RESULT " + json.dumps({
        "name": f"pcg3d_n{n_el}_p3_dw_step",
        "levels": levels, "reps": reps, "step_ms": step_ms,
        "profiled_step_ms": profiled_ms, "busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / profiled_ms, "kernel_ms": kernel_ms,
        "kernels": sum(e.count for e in stats) / reps,
        "k1_ms": share("kron_march_kernel"),
        "k5_ms": share("kron_march_dw_kernel"),
        "k1_launches": k1_launches, "k5_launches": k5_launches,
        "ap_ms": ap_ms, "precond_ms": precond_ms,
        "device": torch.cuda.get_device_name(0), "power_limit": power}),
        flush=True)


if __name__ == "__main__":
    main()
