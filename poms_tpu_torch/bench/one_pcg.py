"""Headline-solve bench, PCG variant: dw-precision MG-preconditioned CG on
the card.

    python -m poms_tpu_torch.bench.one_pcg <n_el> [degree] [tol] [precision]
        [cheb_fraction] [cheb_degree] [low]

Prints one ``RESULT {...}`` line with the JAX bench's keys plus ``device``,
``power_limit``, ``setup_s`` (cold: kernel build, hierarchy, λ estimates)
``k1_launches`` (K1 launches per mode in the timed solve) and
``k5_launches`` (the double-word A·p kernel).  Needs a CUDA card; there is
no CPU fallback.
"""
import json
import sys
import time


def main():
    n_el = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    degree = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    tol = float(sys.argv[3]) if len(sys.argv) > 3 else 1e-10
    precision = sys.argv[4] if len(sys.argv) > 4 else "dw"
    cheb_fraction = float(sys.argv[5]) if len(sys.argv) > 5 else 16.0
    cheb_degree = int(sys.argv[6]) if len(sys.argv) > 6 else 4
    low = sys.argv[7] if len(sys.argv) > 7 else "f32"  # f32 | bf16

    import torch

    from poms_tpu_torch.bench.device import nvidia_smi_name_power
    from poms_tpu_torch.mg.cycles import CycleConfig
    from poms_tpu_torch.mg.mixed import MGPreconditionedCG
    from poms_tpu_torch.mg.smoother import SmootherConfig
    from poms_tpu_torch.models.poisson import poisson_problem
    from poms_tpu_torch.ops.kron import MODES, kron_mode
    from poms_tpu_torch.ops.twofloat import residual_kron_df, split_f64

    if not torch.cuda.is_available():
        raise SystemExit("one_pcg measures the card: no CUDA device found")
    dev = torch.device("cuda", 0)
    num_levels = max(2, (n_el - 1).bit_length() - 2)
    t0 = time.perf_counter()
    prob = poisson_problem(3, n_el, degree=degree, operator="kron",
                           dtype=torch.float64, device=dev)
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SmootherConfig("chebyshev",
                                              cheb_fraction=cheb_fraction,
                                              cheb_degree=cheb_degree))
    low_dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[low]
    pcg = MGPreconditionedCG(prob, num_levels=num_levels, cfg=cfg,
                             mixed=True, operator="kron",
                             precision=precision, low_dtype=low_dtype)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # big grids: free the f64 RHS and skip the result vector
    kw = {}
    if n_el >= 384 and precision == "dw":
        kw = {"b_pair": split_f64(prob.b.interior), "return_x": False}
        prob.b = None
    x, rn, it = pcg.solve_compiled(tol=tol, maxiter=100, **kw)
    torch.cuda.synchronize()
    del x
    for mode in MODES:
        kron_mode.launches[mode] = 0
    residual_kron_df.launches = 0
    t0 = time.perf_counter()
    x, rn, it = pcg.solve_compiled(tol=tol, maxiter=100, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    power = nvidia_smi_name_power().rsplit(",", 1)[-1].strip()
    print("RESULT " + json.dumps({
        "name": (f"pcg3d_n{n_el}_p{degree}_to_{tol:g}_{precision}"
                 f"_cheb{cheb_degree}f{cheb_fraction:g}"
                 + ("" if low == "f32" else f"_{low}")),
        "converged": float(rn) <= tol,
        "iterations": it,
        "per_iter_s": wall / max(it, 1),
        "wall_to_tol_s": wall,
        "final_residual": float(rn),
        "grid": [n_el] * 3, "levels": num_levels,
        "device": torch.cuda.get_device_name(0), "power_limit": power,
        "setup_s": setup_s, "k1_launches": dict(kron_mode.launches),
        "k5_launches": residual_kron_df.launches}), flush=True)


if __name__ == "__main__":
    main()
