#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's headline solve once on one CUDA card.

    python3 chip_smoke.py

Imports torch, numpy and ``poms_tpu_torch`` only.  Phases, in order; no
exception is caught, so any failure exits non-zero:

1. build   — nvcc the kron_apply kernel (K1) from poms_tpu_torch/csrc.
2. K1      — the kernel against its plain PyTorch version on the card, at
             the shapes of the headline solve's levels and a few ragged and
             periodic ones, f32 and f64 (max|Δ|/max|y| ≤ 1e-5 and ≤ 1e-12:
             the summation order differs and the kernel uses FMA); the
             device time (profiler) and stream time (CUDA events) of both
             at 129³ f32.
3. EFT     — two_sum, two_prod and dw_mul on the card are exact (checked in
             f64), also with broadcast operands.
4. solve   — 3D Poisson, cubic B-splines, n_el = 128 (129³ unknowns), 5
             levels, Chebyshev(4) over [λmax/16, λmax] with ν1 = ν2 = 1,
             dw-precision MG-preconditioned CG to ‖r‖₂ ≤ 1e-10: it converges,
             the true residual recomputed in f64 (K1's f64 instantiation) is
             ≤ 5e-10, and every kernel of the path launched during the run.
             A second, warm solve is timed.
5. check   — the same solve at n_el = 16 on the card and on the CPU (plain
             versions): same iteration count, solutions agree to 1e-6.

Prints the card's name and power limit early, one JSON line of per-kernel
results before the last line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import json
import math
import sys
import time

import numpy as np
import torch

from poms_tpu_torch.bench.device import nvidia_smi_name_power
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.mixed import MGPreconditionedCG
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.models.poisson import (l2_error_manufactured,
                                           poisson_problem)
from poms_tpu_torch.ops import _build
from poms_tpu_torch.ops.kron import kron_apply, kron_apply_plain
from poms_tpu_torch.ops.twofloat import (dw_add, dw_mul, split_f64,
                                         two_prod, two_sum)

K1_SHAPES = [((9, 9, 9), 3, False), ((17, 17, 17), 3, False),
             ((33, 33, 33), 3, False), ((65, 65, 65), 3, False),
             ((129, 129, 129), 3, False), ((17, 33, 65), 3, False),
             ((8, 8, 128), 2, True)]
K1_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
HEADLINE = dict(n_el=128, degree=3, levels=5, tol=1e-10, maxiter=30)


def log(msg):
    print(msg, flush=True)


def _k1_operands(npts, p, dtype, dev, seed):
    """Poisson-shaped terms (K on axis a, M elsewhere) and x from numpy."""
    rng = np.random.default_rng(seed)
    Ks = [torch.as_tensor(rng.standard_normal((n, 2 * p + 1)) / 4,
                          dtype=dtype, device=dev) for n in npts]
    Ms = [torch.as_tensor(rng.standard_normal((n, 2 * p + 1)) / 4,
                          dtype=dtype, device=dev) for n in npts]
    terms = [[Ks[b] if b == a else Ms[b] for b in range(3)] for a in range(3)]
    x = torch.as_tensor(rng.standard_normal(npts), dtype=dtype, device=dev)
    return terms, x


def _cuda_ms(fn, reps=20):
    """Stream time per call by CUDA events (includes the gaps in which the
    host is still enqueuing: wrapper and launch overhead)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps=20):
    """Kernel time per call on the card: the profiler's device time summed
    over every kernel the call launched."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if not us > 0:
        raise AssertionError("the profiler recorded no device time")
    return us / 1e3 / reps


def phase_build():
    t0 = time.perf_counter()
    path = _build.build("kron_apply")
    _build.load("kron_apply")
    log(f"[build] kron_apply.cu -> {path.name} in "
        f"{time.perf_counter() - t0:.3f} s (cold nvcc, sm_90a)")
    report = (_build.BUILD_DIR / "kron_apply.log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {line.strip()}")


def phase_k1(dev):
    result = {}
    for npts, p, periodic in K1_SHAPES:
        for dtype in (torch.float32, torch.float64):
            terms, x = _k1_operands(npts, p, dtype, dev, seed=sum(npts) + p)
            args = (npts, (p,) * 3, (periodic,) * 3)
            y = kron_apply(terms, x, *args)
            torch.cuda.synchronize()
            want = kron_apply_plain(terms, x, *args)
            err = float((y - want).abs().max())
            rel = err / float(want.abs().max())
            log(f"[K1] {npts} p={p} periodic={periodic} {dtype}: "
                f"max|d|={err:.3e} rel={rel:.3e}")
            if not (math.isfinite(rel) and rel <= K1_TOL[dtype]):
                raise AssertionError(f"K1 disagrees at {npts} {dtype}: {rel}")
            if npts == (129, 129, 129) and dtype == torch.float32:
                result["max_abs_err"] = err

                def kernel():
                    return kron_apply(terms, x, *args)

                def plain():
                    return kron_apply_plain(terms, x, *args)

                result["ms"] = _device_ms(kernel)
                result["plain_ms"] = _device_ms(plain)
                events = (_cuda_ms(kernel), _cuda_ms(plain))
    log(f"[K1] 129^3 p3 f32 device time (profiler, mean of 20): kernel "
        f"{result['ms']:.4f} ms, plain {result['plain_ms']:.4f} ms")
    log(f"[K1] 129^3 p3 f32 stream time (CUDA events, mean of 20, host "
        f"overhead included): kernel {events[0]:.4f} ms, plain "
        f"{events[1]:.4f} ms")
    return result


def phase_eft(dev):
    g = torch.Generator(device="cpu").manual_seed(3)
    a = torch.randn(1 << 20, generator=g, dtype=torch.float64)
    b = torch.randn(1 << 20, generator=g, dtype=torch.float64) * 1e-3
    af, bf = a.to(torch.float32).to(dev), b.to(torch.float32).to(dev)
    s, e = two_sum(af, bf)
    assert torch.equal(s.double() + e.double(), af.double() + bf.double())
    p, e = two_prod(af, bf)
    assert torch.equal(p.double() + e.double(), af.double() * bf.double())
    # the check of tests/test_twofloat.py::
    # test_eft_exact_under_jit_with_broadcast, on the card
    c64 = torch.randn(8, 1, generator=g, dtype=torch.float64).to(dev)
    x64 = torch.randn(8, 16, generator=g, dtype=torch.float64).to(dev)
    y64 = torch.randn(8, 16, generator=g, dtype=torch.float64).to(dev)
    C, X, Y = split_f64(c64), split_f64(x64), split_f64(y64)
    tru = c64 * x64
    zh, zl = dw_mul(*C, *X)
    err = float((zh.double() + zl.double() - tru).abs().max())
    assert err < 1e-13 * float(tru.abs().max()), err
    p, e = two_prod(C[0], X[0])
    d = float((p.double() + e.double() - C[0].double() * X[0].double())
              .abs().max())
    assert d == 0.0, d
    zh2, zl2 = dw_add(*dw_mul(*C, *X), *Y)
    tru2 = tru + y64
    err2 = float((zh2.double() + zl2.double() - tru2).abs().max())
    assert err2 < 1e-13 * float(tru2.abs().max()), err2
    log(f"[EFT] two_sum/two_prod exact on 2^20 pairs; dw_mul err {err:.3e}, "
        f"dw_mul+dw_add err {err2:.3e}, broadcast two_prod exact")


def _solver(n_el, levels, dev):
    prob = poisson_problem(3, n_el, degree=HEADLINE["degree"],
                           dtype=torch.float64, device=dev)
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SmootherConfig("chebyshev", cheb_fraction=16.0,
                                              cheb_degree=4))
    pcg = MGPreconditionedCG(prob, num_levels=levels, cfg=cfg, mixed=True,
                             operator="kron", precision="dw")
    return prob, pcg


def phase_solve(dev):
    h = HEADLINE
    torch.cuda.synchronize()
    kron_apply.launches = 0
    t0 = time.perf_counter()
    prob, pcg = _solver(h["n_el"], h["levels"], dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    t1 = time.perf_counter()
    res = pcg.solve(tol=h["tol"], maxiter=h["maxiter"])
    torch.cuda.synchronize()
    first = time.perf_counter() - t1
    launches = kron_apply.launches
    x = res.x.interior
    assert tuple(x.shape) == prob.space.npts and bool(torch.isfinite(x).all())
    log(f"[solve] 129^3 dw-PCG: {res.iterations} iterations, converged="
        f"{res.converged}, history {['%.3e' % r for r in res.residuals]}")
    assert res.converged, res.residuals
    true_rn = float(torch.linalg.vector_norm(
        prob.b.interior - prob.A.dot(res.x).interior))
    l2 = l2_error_manufactured(prob, res.x)
    log(f"[solve] final |r| {res.residuals[-1]:.3e}, true f64 |b - Ax| "
        f"{true_rn:.3e} (K1 f64), L2 error vs manufactured {l2:.3e}")
    assert true_rn <= 5e-10, true_rn
    assert launches > 0, "the solve never launched the kron_apply kernel"
    t2 = time.perf_counter()
    _, rn, it = pcg.solve_compiled(tol=h["tol"], maxiter=h["maxiter"])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t2
    assert float(rn) <= h["tol"] and it == res.iterations, (float(rn), it)
    log(f"[solve] cold setup (hierarchy + lambda) {cold:.3f} s; first solve "
        f"{first:.3f} s; warm solve {warm:.3f} s = "
        f"{warm / it * 1e3:.2f} ms/iteration; K1 launches {launches}")
    return {"launches": launches, "l2": l2}


def phase_check(dev, l2_fine):
    """The card against the CPU's plain versions on a small input."""
    out, lams = {}, None
    for d in (dev, torch.device("cpu")):
        prob, pcg = _solver(16, 2, d)
        pcg.lams = lams = lams or pcg.lams   # the card's λs on both
        out[d.type] = (pcg.solve(tol=1e-10, maxiter=30), prob)
    (rc, pc), (rh, _) = out["cuda"], out["cpu"]
    xc, xh = rc.x.interior.cpu(), rh.x.interior
    rel = float((xc - xh).abs().max() / xh.abs().max())
    l2 = l2_error_manufactured(pc, rc.x)
    log(f"[check] 19^3: card {rc.iterations} it, cpu {rh.iterations} it, "
        f"max|x_card - x_cpu|/max|x| {rel:.3e}; L2 error 16^3 {l2:.3e} "
        f"vs 128^3 {l2_fine:.3e}")
    assert rc.converged and rh.converged
    assert rc.iterations == rh.iterations, (rc.iterations, rh.iterations)
    assert rel <= 1e-6, rel
    assert l2_fine < l2, (l2_fine, l2)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card "
                         "(torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log("card (nvidia-smi name, power.limit):")
    log(nvidia_smi_name_power())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    phase_build()
    k1 = phase_k1(dev)
    phase_eft(dev)
    solve = phase_solve(dev)
    phase_check(dev, solve["l2"])
    log(json.dumps({"kernels": [{
        "name": "kron_apply", "route": "cuda",
        "source": "poms_tpu_torch/csrc/kron_apply.cu",
        "replaces": "poms_tpu/ops/pallas/kron.py:157",
        "launches": solve["launches"], "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
