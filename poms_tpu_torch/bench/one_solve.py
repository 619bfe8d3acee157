"""Headline-solve bench, defect-correction variant: V-cycle wall time to
‖r‖ ≤ tol on 3D Poisson, on the card.

    python -m poms_tpu_torch.bench.one_solve <n_el> [degree] [tol] [residual]
        [inner_cycles] [cheb_fraction] [cheb_degree] [low]

Counterpart of ``poms_tpu.bench.one_solve`` with its command line: the
Kronecker-sum operator, Chebyshev-smoothed f32 cycles (ν1 = ν2 = 1) inside
the defect-correction loop of ``MixedPrecisionMG``; ``residual`` is ``auto``
(→ twofloat), ``twofloat`` or ``f64``; the Chebyshev window defaults to
[λmax/32, λmax] at n_el ≥ 128 and [λmax/16, λmax] below; ``low`` is ``f32``
or ``bf16`` (the cycle on a bf16 hierarchy, K1 and K7 in bf16), e.g.
``one_solve 128 3 1e-10 twofloat 1 32 4 bf16``.

Prints one ``RESULT {...}`` line with the JAX bench's keys
(``per_iter_s``/``wall_to_tol_s``: the second ``solve_compiled`` call, which
replays the captured graph; ``host_loop_per_iter_s``: the median of the
eager ``solve``'s steady iterations) plus ``device``, ``power_limit``,
``setup_s`` (cold: kernel build, hierarchy, λ estimates) and ``launches``
(every wrapper's launches in the timed solve, replays included).  Times are
host clocks around ``torch.cuda.synchronize()``.  Needs a CUDA card; there
is no CPU fallback.
"""
import json
import os
import sys
import time


def main():
    n_el = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    degree = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    tol = float(sys.argv[3]) if len(sys.argv) > 3 else 1e-10
    residual = sys.argv[4] if len(sys.argv) > 4 else "auto"
    inner = int(sys.argv[5]) if len(sys.argv) > 5 else 1
    cheb_fraction = (float(sys.argv[6]) if len(sys.argv) > 6
                     else (32.0 if n_el >= 128 else 16.0))
    cheb_degree = int(sys.argv[7]) if len(sys.argv) > 7 else 4
    low = sys.argv[8] if len(sys.argv) > 8 else "f32"  # f32 | bf16

    import numpy as np
    import torch

    from poms_tpu_torch.bench.device import nvidia_smi_name_power
    from poms_tpu_torch.mg.cycles import CycleConfig
    from poms_tpu_torch.mg.mixed import MixedPrecisionMG
    from poms_tpu_torch.mg.smoother import SmootherConfig
    from poms_tpu_torch.models.poisson import poisson_problem
    from poms_tpu_torch.ops import counters
    from poms_tpu_torch.ops.twofloat import split_f64

    if not torch.cuda.is_available():
        raise SystemExit("one_solve measures the card: no CUDA device found")
    dev = torch.device("cuda", 0)
    num_levels = max(2, (n_el - 1).bit_length() - 2)  # coarsest ~8 el/dim
    t0 = time.perf_counter()
    prob = poisson_problem(3, n_el, degree=degree, operator="kron",
                           dtype=torch.float64, device=dev)
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SmootherConfig("chebyshev",
                                              cheb_fraction=cheb_fraction,
                                              cheb_degree=cheb_degree))
    low_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[low]
    mg = MixedPrecisionMG(prob, num_levels=num_levels, cfg=cfg,
                          operator="kron", residual=residual,
                          inner_cycles=inner, low_dtype=low_dtype)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # host loop: the residual history, the convergence check and the
    # per-iteration median with one host sync per correction; skipped on
    # giant grids, whose memory the compiled solve needs
    skip_host = n_el >= 384 or os.environ.get("POMS_SKIP_HOST_LOOP")
    if skip_host:
        host_per_iter, host_conv, host_iters = None, True, None
    else:
        res = mg.solve(tol=tol, maxiter=100)
        steady = res.wall_times[1:] or res.wall_times
        host_per_iter = float(np.median(steady))
        host_conv, host_iters = bool(res.converged), res.iterations
    kw = {}
    if skip_host and mg.residual_mode == "twofloat":
        kw = {"b_pair": split_f64(prob.b.interior), "return_x": False}
        prob.b = None            # frees the padded f64 right-hand side
    x, rn, it = mg.solve_compiled(tol=tol, maxiter=100, **kw)  # captures
    torch.cuda.synchronize()
    del x
    counters.reset()
    t0 = time.perf_counter()
    x, rn, it = mg.solve_compiled(tol=tol, maxiter=100, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    power = nvidia_smi_name_power().rsplit(",", 1)[-1].strip()
    print("RESULT " + json.dumps({
        "name": (f"vcycle3d_n{n_el}_p{degree}_to_{tol:g}_"
                 f"{mg.residual_mode}_ic{inner}"
                 f"_cheb{cheb_degree}f{cheb_fraction:g}"
                 + ("" if low == "f32" else f"_{low}")),
        "converged": host_conv and float(rn) <= tol,
        "iterations": it,
        "per_iter_s": wall / max(it, 1),
        "wall_to_tol_s": wall,
        "host_loop_per_iter_s": host_per_iter,
        "host_loop_iterations": host_iters,
        "final_residual": float(rn),
        "residual_mode": mg.residual_mode,
        "grid": [n_el] * 3, "levels": num_levels,
        "device": torch.cuda.get_device_name(0), "power_limit": power,
        "setup_s": setup_s,
        "launches": {k: v for k, v in counters.snapshot().items() if v}}),
        flush=True)


if __name__ == "__main__":
    main()
