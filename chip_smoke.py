#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one CUDA card.

    python3 chip_smoke.py

Imports torch, numpy and ``poms_tpu_torch`` only.  Phases, in order; no
exception is caught, so any failure exits non-zero:

1. build   — nvcc the kernels of poms_tpu_torch/csrc (K1 kron_apply, K5
             kron_apply_dw, K2 stencil_apply, K3 stencil_apply_v2, K4
             stream_probe, K4v probe_v15), one nvcc per source, all started
             together; prints ptxas registers and spills.
2. K1      — each mode (apply, residual, dinv, cheb first and later step)
             against its plain PyTorch version on the card, f32 and f64, at
             the shapes of the headline solve's levels, a few ragged and
             periodic ones, a 2D, a 1D and a mixed-periodic 3D shape with
             unequal pads, and a 4-term operator that takes two launches
             (max|Δ|/max|y| ≤ 1e-5 and ≤ 1e-12: the summation order differs
             and the kernel uses FMA); the device time (profiler) of each
             mode at 129³, 65³, 33³, 17³ f32 beside its bound (bytes each
             moved once at the card's published bandwidth), and of the plain
             versions at 129³.
3. EFT     — two_sum, two_prod and dw_mul on the card are exact (checked in
             f64), also with broadcast operands.
3b. K5     — the double-word Kronecker residual kernel against
             residual_kron_df_plain on the card at the level shapes, a
             ragged, a periodic, a 2D and a 1D one, with b and x_l given and
             with the zero flags of the A·p call: the words are bit-equal;
             the kernel's own two_sum/two_prod/dw_mul/dw_add (its test
             entry) are bit-equal to the toolbox's and exact in f64; device
             time at 129³ beside plain and both bounds.
4. solve   — 3D Poisson, cubic B-splines, n_el = 128 (129³ unknowns), 5
             levels, Chebyshev(4) over [λmax/16, λmax] with ν1 = ν2 = 1,
             dw-precision MG-preconditioned CG to ‖r‖₂ ≤ 1e-10: it converges
             in at most 8 iterations, the true residual recomputed in f64
             (K1's f64 instantiation) is ≤ 5e-10; K1's cheb and residual
             modes and K5 launched and K1's apply mode did not (no
             apply-then-subtract); launches per iteration per kernel.  A
             second, warm solve is timed.
5. check   — the same solve at n_el = 16 on the card and on the CPU (plain
             versions): same iteration count, solutions agree to 1e-6.
6. K4      — the stream ceiling at n = 128, p = 3 (a band-sized f32
             buffer, 343 planes), library and contiguous layouts, in GB/s
             with the reference's byte count (w³ + 2)·n³·4; the kernel
             against torch.sum (≤ 1e-5).
7. K2      — each mode (spmv, residual, jacobi, rbgs) in f32 and f64
             against its plain version on the card, at the 3D level shapes
             129³, 65³, 33³, 17³ (p3), a ragged 3D shape, 2D 1025² p3, 1D
             2²⁰ p3, a periodic-ghosted 2D case, the 2D level shapes of
             phase 9 (513², 257², 129², 65², 33² p3), RB-GS with starts 0 and 1
             (max|Δ|/max|y| ≤ 1e-5 f32, ≤ 1e-12 f64; RB-GS points of the
             other colour bit-equal to x); at 129³ p3 f32 the device and
             stream times of kernel and plain, GB/s, Gnnz/s and % of K4.
8. banded PCG — 3D Poisson p3, n_el = 128, 5 levels, banded operator,
             f64-mixed MG-preconditioned CG, Chebyshev(4) over
             [λmax/16, λmax], ν1 = ν2 = 1, to 1e-10: converges, the true
             f64 residual through K2's f64 spmv is ≤ 5e-10, K2's spmv and
             residual launched.
9. banded MG — MultigridSolver(operator="banded"), f64: 3D p3 n_el = 128,
             5 levels, RB-GS ω = 1, ν1 = ν2 = 2, 3 cycles (the residual
             falls every cycle); 2D p3 n_el = 512, 6 levels, Jacobi
             ω = 0.8, ν1 = ν2 = 2, to 1e-10.
10. banded check — phase 8's solve at n_el = 16 on the card and on the
             CPU's plain versions, with the card's λs: same iterations,
             solutions within 1e-6 of max|x|.
11. K3      — the v2 engine's kernel in each mode, f32 and f64, against its
             plain version (from the same pack) at every K2 shape, with K2's
             tolerances and the RB-GS other-colour bit-equality; device and
             stream times of K3, K2 and plain at 129³ and 128³ p3 f32, with
             GB/s, Gnnz/s and % of K4.
12. v2 banded — POMS_TPU_SPMV=v2 set in-process (restored after): phases 8
             and 9 again through K3 (every banded level packed once at
             setup): the PCG in phase 8's iteration count with a true f64
             residual ≤ 5e-10, the MG runs converging as there; K3 launched
             in all four modes and K2 not at all.
13. probes  — K4c (compute), K4v (v15) and K4a (ablate: full, noshift,
             nolane, nomul) against their plain versions at 32³ and 128³ p3
             f32; each probe's timing path (probe_compute, probe_v15,
             probe_ablate) at 128³ p3, and one table of device times beside
             K4, K2 and K3.

Prints the card's name and power limit early, one JSON line of per-kernel
results before the last line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The launch counts of the JSON line come from the paths, each counted from
0 just before it: K1 and K5 from phase 4 (setup and both solves), K4 from
phase 6's ceiling, K2 from phases 8 and 9, K3 from phase 12, the probes
from phase 13's timing paths; launches made to compare a kernel with its
plain version are not counted.  Each kernel's ``bound_ms`` is the larger of
its bytes (every input read once, every output written once) over 3.35 TB/s
and its operations over 67 TFLOP/s (f32 outside the tensor cores), from
this run's shapes; ``library_ms`` times one PyTorch call of the same
function where there is one (``torch.sum`` for K4; a sparse CSR product,
built on the card from the band, for the kernels that compute a banded
spmv), which the port itself never calls.
"""
import json
import math
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from poms_tpu_torch.bench.device import device_ms as _device_ms
from poms_tpu_torch.bench.device import nvidia_smi_name_power
from poms_tpu_torch.bench import kernel_probe as kp
from poms_tpu_torch.bench.kernel_probe import (cuda_event_ms, make_band,
                                               probe_stream, stream_probe,
                                               stream_probe_plain)
from poms_tpu_torch.core.vector import ghost_pad
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.mixed import MGPreconditionedCG
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.mg.solver import MultigridSolver
from poms_tpu_torch.models.poisson import (l2_error_manufactured,
                                           poisson_problem)
from poms_tpu_torch.ops import _build
from poms_tpu_torch.ops import kron as k1
from poms_tpu_torch.ops import twofloat
from poms_tpu_torch.ops.stencil import (MODES, color_mask, stencil_apply,
                                        stencil_apply_plain)
from poms_tpu_torch.ops.stencil_v2 import (pack_band_v2, stencil_apply_v2,
                                           stencil_apply_v2_plain)
from poms_tpu_torch.ops.twofloat import (dw_add, dw_mul, split_f64,
                                         two_prod, two_sum)

K1_SHAPES = [((9, 9, 9), 3, False), ((17, 17, 17), 3, False),
             ((33, 33, 33), 3, False), ((65, 65, 65), 3, False),
             ((129, 129, 129), 3, False), ((17, 33, 65), 3, False),
             ((8, 8, 128), 2, True)]
# further K1 shapes: (npts, pads, periodic): 2D, 1D, mixed-periodic 3D
K1_MORE = [((300, 257), (3, 3), (False, False)),
           ((1 << 16,), (3,), (True,)),
           ((12, 20, 40), (2, 3, 1), (True, False, True))]
K1_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
K1_TIMED = (129, 65, 33, 17)      # the smoothed levels of the headline solve
K1_FIELDS = {"apply": 2, "residual": 3, "dinv": 2, "cheb": 5}  # moved once
K5_SHAPES = [((n,) * 3, (3,) * 3, (False,) * 3) for n in (129, 65, 33, 17, 9)]
K5_SHAPES += [((17, 33, 65), (3, 3, 3), (False,) * 3),
              ((8, 8, 128), (2, 2, 2), (True,) * 3),
              ((300, 257), (3, 3), (False, False)), ((5000,), (2,), (True,))]
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, published
F32_FLOPS = 67e12             # f32 outside the tensor cores, published
HEADLINE = dict(n_el=128, degree=3, levels=5, tol=1e-10, maxiter=30)
# K2 shapes: (npts, pads, periodic, starts of the second RB-GS check)
K2_SHAPES = [((129, 129, 129), (3, 3, 3), (False,) * 3, (1, 0, 0)),
             ((65, 65, 65), (3, 3, 3), (False,) * 3, (0, 1, 0)),
             ((33, 33, 33), (3, 3, 3), (False,) * 3, (0, 0, 1)),
             ((17, 17, 17), (3, 3, 3), (False,) * 3, (1, 1, 1)),
             ((20, 45, 70), (3, 2, 3), (False,) * 3, (1, 0, 0)),
             ((1025, 1025), (3, 3), (False, False), (1, 0)),
             ((1 << 20,), (3,), (False,), (1,)),
             ((256, 300), (3, 3), (True, False), (0, 1))]
# the smoothed levels of phase 9's 2D solve (n_el = 512, 6 levels)
K2_SHAPES += [((n, n), (3, 3), (False, False), (0, 1))
              for n in (513, 257, 129, 65, 33)]
K2_REPLACES = {"spmv": 343, "residual": 349, "jacobi": 359, "rbgs": 369}
K3_REPLACES = {"spmv": 795, "residual": 802, "jacobi": 813, "rbgs": 823}
# banded multigrid: 3D RB-GS cycles and the 2D Jacobi solve (n_el, levels)
BANDED_MG = dict(rbgs=(128, 5), jacobi=(512, 6))
K4_SIZE = (128, 3)   # the stream probe's (n, p): a 129^3 p3 band's size
PROBE_SIZES = (32, 128)   # p = 3, f32; the probes are timed at 128^3


def log(msg):
    print(msg, flush=True)


def _k1_operands(npts, pads, dtype, dev, seed, free_terms=0):
    """Poisson-shaped terms (K on axis a, M elsewhere; ``free_terms`` > 0:
    that many terms sharing nothing) with a dominant centre column, and
    three fields, from numpy."""
    rng = np.random.default_rng(seed)
    d = len(npts)

    def band(n, p):
        return torch.as_tensor(
            rng.standard_normal((n, 2 * p + 1)) / 4
            + 2.0 * (np.arange(2 * p + 1) == p), dtype=dtype, device=dev)

    if free_terms:
        terms = [[band(n, p) for n, p in zip(npts, pads)]
                 for _ in range(free_terms)]
    else:
        Ks = [band(n, p) for n, p in zip(npts, pads)]
        Ms = [band(n, p) for n, p in zip(npts, pads)]
        terms = [[Ks[b] if b == a else Ms[b] for b in range(d)]
                 for a in range(d)]
    fields = [torch.as_tensor(rng.standard_normal(npts), dtype=dtype,
                              device=dev) for _ in range(3)]
    return terms, fields


def _k1_runs(b, d):
    """(label, mode, kwargs) of every K1 check: cheb as the first step
    (no direction yet) and as a later one."""
    return [("apply", "apply", {}), ("residual", "residual", {"b": b}),
            ("dinv", "dinv", {}),
            ("cheb0", "cheb", {"b": b, "d": None, "c1": 0.0, "c2": 0.7}),
            ("cheb", "cheb", {"b": b, "d": d, "c1": 0.3, "c2": 0.7})]


def phase_build():
    names = ("kron_apply", "kron_apply_dw", "stencil_apply", "stream_probe",
             "stencil_apply_v2", "probe_v15")
    t0 = time.perf_counter()

    def build(name):
        path = _build.build(name)
        return path, time.perf_counter() - t0

    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build, names)))
    for name in names:
        path, secs = built[name]
        _build.load(name)
        log(f"[build] {name}.cu -> {path.name} ready at {secs:.3f} s "
            f"(cold nvcc, sm_90a, {len(names)} in parallel)")
        report = (_build.BUILD_DIR / f"{name}.log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    log(f"[build] {name}: {line.strip()}")


def phase_k1(dev):
    result = {m: {} for m in k1.MODES}
    shapes = [(npts, (p,) * 3, (per,) * 3, 0) for npts, p, per in K1_SHAPES]
    shapes += [(*case, 0) for case in K1_MORE]
    shapes.append(((20, 21, 22), (2, 2, 2), (False,) * 3, 4))
    for npts, pads, periodic, free in shapes:
        for dtype in (torch.float32, torch.float64):
            terms, (x, b, d) = _k1_operands(npts, pads, dtype, dev,
                                            sum(npts) + pads[0], free)
            plan = k1.build_kron_plan(terms, npts, pads, periodic)
            diag = plan.diagonal()
            rels = {}
            for label, mode, kw in _k1_runs(b, d):
                kw_k = dict(kw)
                if kw.get("d") is not None:
                    kw_k["d"] = d.clone()     # the kernel updates d in place
                got = k1.kron_mode(mode, plan, x, **kw_k)
                torch.cuda.synchronize()
                want = k1.kron_mode_plain(mode, terms, x, npts, pads,
                                          periodic, diag=diag, **kw)
                if mode != "cheb":
                    got, want = (got,), (want,)
                err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
                rels[label] = max(float((g - w).abs().max() / w.abs().max())
                                  for g, w in zip(got, want))
                if not (math.isfinite(rels[label])
                        and rels[label] <= K1_TOL[dtype]):
                    raise AssertionError(f"K1 {label} disagrees at {npts} "
                                         f"{dtype}: {rels[label]}")
                if (npts == (129, 129, 129) and dtype == torch.float32
                        and label in k1.MODES):
                    result[mode]["max_abs_err"] = err
                    result[mode]["plain_ms"] = _device_ms(
                        lambda: k1.kron_mode_plain(
                            mode, terms, x, npts, pads, periodic, diag=diag,
                            **kw), 5)
            log(f"[K1] {npts} p={pads} periodic={periodic} terms="
                f"{len(terms)} launches/apply={len(plan.plans)} {dtype}: "
                "rel err " + " ".join(f"{k}={v:.2e}"
                                      for k, v in rels.items()))
    for n in K1_TIMED:
        npts, pads, periodic = (n,) * 3, (3,) * 3, (False,) * 3
        terms, (x, b, d) = _k1_operands(npts, pads, torch.float32, dev, n)
        plan = k1.build_kron_plan(terms, npts, pads, periodic)
        out = torch.empty_like(x)
        for label, mode, kw in _k1_runs(b, d):
            if label == "cheb0":
                continue
            ms = _device_ms(lambda: k1.kron_mode(mode, plan, x, out=out,
                                                 **kw))
            bound = K1_FIELDS[mode] * n ** 3 * 4 / HBM_BYTES_PER_S * 1e3
            log(f"[K1] {n}^3 p3 f32 {mode}: device time (profiler, mean of "
                f"20) {ms * 1e3:.2f} us, tiling {plan.tiling}; bound "
                f"{bound * 1e3:.2f} us ({K1_FIELDS[mode]} fields once at "
                f"3.35 TB/s): {100 * bound / ms:.1f}% of it"
                + ("" if n > 33 else "; at this size the launch's own cost "
                   "bounds it, not the bytes"))
            if n == 129:
                result[mode].update(ms=ms, bound_ms=bound)
    for mode in k1.MODES:
        r = result[mode]
        log(f"[K1] 129^3 p3 f32 {mode}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms (device time), max|d| "
            f"{r['max_abs_err']:.3e}")
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


def phase_k5(dev):
    """K5 against its plain version (bit-equality), the kernel's own EFTs,
    and its time at 129^3 as the headline step calls it."""
    result = {}
    for npts, pads, periodic in K5_SHAPES:
        terms, (x, b, _) = _k1_operands(npts, pads, torch.float64, dev,
                                        sum(npts))
        split = {id(B): split_f64(B) for term in terms for B in term}
        tdf = [[split[id(B)] for B in term] for term in terms]
        (xh, xl), (bh, bl) = split_f64(x), split_f64(b)
        plan = twofloat.build_kron_df_plan(tdf, npts, pads, periodic)
        zero = torch.zeros_like(xh)
        for flags, explicit in (((bh, bl, xh, xl), (bh, bl, xh, xl)),
                                ((None, None, xh, None),
                                 (zero, zero, xh, zero))):
            got = twofloat.residual_kron_df(tdf, *flags, pads,
                                            periodic=periodic, plan=plan)
            torch.cuda.synchronize()
            want = twofloat.residual_kron_df_plain(tdf, *explicit, pads,
                                                   None, periodic)
            diff = [float((g - w).abs().max()) for g, w in zip(got, want)]
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"K5 is not bit-equal to its plain "
                                     f"version at {npts}: max|d| {diff}")
        r64 = b - k1.kron_apply_plain(terms, x, npts, pads, periodic)
        rel = float((twofloat.merge_f64(*twofloat.residual_kron_df(
            tdf, bh, bl, xh, xl, pads, periodic=periodic, plan=plan)) - r64)
            .abs().max() / r64.abs().max())
        log(f"[K5] {npts} p={pads} periodic={periodic}: bit-equal to plain "
            f"with b, x_l given and with the zero flags; against the f64 "
            f"residual {rel:.2e}")
        assert rel <= 1e-12, rel
        if npts == (129,) * 3:
            ph = x.to(torch.float32)

            def kernel():
                return twofloat.residual_kron_df(tdf, None, None, ph, None,
                                                 pads, periodic=periodic,
                                                 plan=plan)

            def plain():
                return twofloat.residual_kron_df_plain(
                    tdf, zero, zero, ph, zero, pads, None, periodic)

            n = npts[0]
            # the kernel's f32 operations per point: 8 contractions of 7
            # taps, each a dw_mul (9) and all but the first a dw_add (20),
            # 2 term adds, b - Ax; the fields: p in, two words out
            ops = (8 * (7 * 9 + 6 * 20) + 3 * 20) * n ** 3
            result = {"max_abs_err": max(diff), "ms": _device_ms(kernel),
                      "plain_ms": _device_ms(plain, 2),
                      "bound_bytes_ms": 3 * n ** 3 * 4 / HBM_BYTES_PER_S * 1e3,
                      "bound_ms": ops / F32_FLOPS * 1e3}
            log(f"[K5] 129^3 p3 A.p: device time kernel {result['ms']:.4f} "
                f"ms, plain {result['plain_ms']:.4f} ms; bounds: bytes "
                f"{result['bound_bytes_ms']:.4f} ms, operations "
                f"{result['bound_ms']:.4f} ms ({ops // n ** 3} f32 "
                f"operations per point at 67 TFLOP/s; none of them can "
                f"fuse, so at most half that rate: "
                f"{2 * result['bound_ms']:.4f} ms)")
    # the kernel's own error-free transformations: the toolbox's bits, and
    # exact in f64
    g = torch.Generator(device="cpu").manual_seed(5)
    a64 = torch.randn(1 << 20, generator=g, dtype=torch.float64).to(dev)
    b64 = (torch.randn(1 << 20, generator=g, dtype=torch.float64)
           * 1e-3).to(dev)
    (ah, al), (bh, bl) = split_f64(a64), split_f64(b64)
    out = twofloat.eft_on_card(ah, al, bh, bl)
    torch.cuda.synchronize()
    refs = [*two_sum(ah, bh), *two_prod(ah, bh), *dw_mul(ah, al, bh, bl),
            *dw_add(ah, al, bh, bl)]
    names = ("two_sum", "two_prod", "dw_mul", "dw_add")
    for k, name in enumerate(names):
        if not (torch.equal(out[2 * k], refs[2 * k])
                and torch.equal(out[2 * k + 1], refs[2 * k + 1])):
            raise AssertionError(f"the kernel's {name} differs from the "
                                 "toolbox's")
    assert torch.equal(out[0].double() + out[1].double(),
                       ah.double() + bh.double())
    assert torch.equal(out[2].double() + out[3].double(),
                       ah.double() * bh.double())
    tru = a64 * b64
    err = float((out[4].double() + out[5].double() - tru).abs().max()
                / tru.abs().max())
    assert err < 1e-13, err
    log(f"[K5] the kernel's two_sum and two_prod are exact on 2^20 pairs "
        f"and all four EFTs equal the toolbox's bit for bit; dw_mul err "
        f"{err:.3e}")
    return result


def _solver(n_el, levels, dev):
    prob = poisson_problem(3, n_el, degree=HEADLINE["degree"],
                           dtype=torch.float64, device=dev, operator="kron")
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SmootherConfig("chebyshev", cheb_fraction=16.0,
                                              cheb_degree=4))
    pcg = MGPreconditionedCG(prob, num_levels=levels, cfg=cfg, mixed=True,
                             operator="kron", precision="dw")
    return prob, pcg


def _reset_kron_counts():
    for mode in k1.MODES:
        k1.kron_mode.launches[mode] = 0
    k1.kron_apply.launches = 0
    twofloat.residual_kron_df.launches = 0


def _kron_counts():
    return dict(k1.kron_mode.launches, K5=twofloat.residual_kron_df.launches)


def phase_solve(dev):
    h = HEADLINE
    torch.cuda.synchronize()
    _reset_kron_counts()
    t0 = time.perf_counter()
    prob, pcg = _solver(h["n_el"], h["levels"], dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    setup = _kron_counts()
    t1 = time.perf_counter()
    res = pcg.solve(tol=h["tol"], maxiter=h["maxiter"])
    torch.cuda.synchronize()
    first = time.perf_counter() - t1
    solve = {k: v - setup[k] for k, v in _kron_counts().items()}
    x = res.x.interior
    assert tuple(x.shape) == prob.space.npts and bool(torch.isfinite(x).all())
    log(f"[solve] 129^3 dw-PCG: {res.iterations} iterations, converged="
        f"{res.converged}, history {['%.3e' % r for r in res.residuals]}")
    assert res.converged, res.residuals
    assert res.iterations <= 8, res.iterations
    # the counts of the solve, read before the f64 check below applies A
    assert solve["cheb"] > 0 and solve["residual"] > 0 and solve["K5"] > 0, \
        f"the solve missed a kernel of its path: {solve}"
    assert solve["apply"] == 0, \
        f"the solve applied A and subtracted, outside the kernel: {solve}"
    assert setup["dinv"] > 0, f"the power iteration missed K1: {setup}"
    t2 = time.perf_counter()
    _, rn, it = pcg.solve_compiled(tol=h["tol"], maxiter=h["maxiter"])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t2
    after = _kron_counts()
    assert float(rn) <= h["tol"] and it == res.iterations, (float(rn), it)
    per_it = {k: (after[k] - setup[k] - solve[k]) / it for k in after}
    # the answer certified in f64: K1's apply mode, the last step of the path
    true_rn = float(torch.linalg.vector_norm(
        prob.b.interior - prob.A.dot(res.x).interior))
    launches = _kron_counts()
    l2 = l2_error_manufactured(prob, res.x)
    log(f"[solve] final |r| {res.residuals[-1]:.3e}, true f64 |b - Ax| "
        f"{true_rn:.3e} (K1 f64), L2 error vs manufactured {l2:.3e}")
    assert true_rn <= 5e-10, true_rn
    log(f"[solve] cold setup (hierarchy + lambda) {cold:.3f} s; first solve "
        f"{first:.3f} s; warm solve {warm:.3f} s = "
        f"{warm / it * 1e3:.2f} ms/iteration over {it} iterations")
    log(f"[solve] launches: setup {setup}; first solve {solve}; warm solve "
        f"per iteration (start state included) "
        f"{ {k: round(v, 2) for k, v in per_it.items()} }")
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


def phase_k4(dev):
    """The stream ceiling (the bench's path: probe_stream) in both layouts,
    then the kernel against torch.sum on the same buffer."""
    n, p = K4_SIZE
    stream_probe.launches = 0
    ceiling = {}
    for contiguous in (False, True):
        ms, gbps = probe_stream(n, p, contiguous, device=dev)
        ceiling["contiguous" if contiguous else "library"] = gbps
        log(f"[K4] stream ceiling {n}^3 p{p} f32, "
            f"{'contiguous (w,n,w,w,n,n)' if contiguous else 'library (w,w,w,n,n,n)'}"
            f" layout: {ms:.4f} ms = {gbps:.1f} GB/s (CUDA events, mean "
            f"of 20; (w^3 + 2) n^3 * 4 bytes)")
    launches = stream_probe.launches
    band = make_band(n, p, False, dev, seed=1)
    x = torch.randn((n, n, n), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    y = stream_probe(band, x, False)
    torch.cuda.synchronize()
    want = stream_probe_plain(band, x, False)
    err = float((y - want).abs().max())
    rel = err / float(want.abs().max())
    log(f"[K4] kernel vs torch.sum at {n}^3 p{p}: max|d|={err:.3e} "
        f"rel={rel:.3e}")
    if not (math.isfinite(rel) and rel <= 1e-5):
        raise AssertionError(f"K4 disagrees with torch.sum: {rel}")
    ms = _device_ms(lambda: stream_probe(band, x, False))
    plain_ms = _device_ms(lambda: stream_probe_plain(band, x, False))
    log(f"[K4] device time (profiler, mean of 20): kernel {ms:.4f} ms, "
        f"plain torch.sum {plain_ms:.4f} ms")
    assert launches > 0, "the ceiling was measured without the K4 kernel"
    library_ms = _device_ms(
        lambda: torch.sum(band.reshape(-1, n, n, n), dim=0))
    del band, x, y, want
    torch.cuda.empty_cache()
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "gbps": ceiling["library"]}


def _k2_operands(npts, pads, periodic, dtype, dev, seed):
    """Random band (diagonal plane shifted by 4), ghosted x (zeros or the
    periodic wrap) and b as a strided interior view, drawn on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    win = tuple(2 * p + 1 for p in pads)
    band = torch.randn(win + npts, generator=g, dtype=dtype, device=dev)
    band.div_(8)
    band[tuple(pads)] += 4.0
    x = torch.randn(npts, generator=g, dtype=dtype, device=dev)
    b_pad = torch.randn(tuple(n + 2 * p for n, p in zip(npts, pads)),
                        generator=g, dtype=dtype, device=dev)
    b = b_pad[tuple(slice(p, p + n) for n, p in zip(npts, pads))]
    return band, ghost_pad(x, pads, periodic).contiguous(), b


def _engine(name):
    """(kernel, plain) of K2 or K3 with K2's signature; K3 packs the band
    once per operand set (``prepare``), as an operator does at setup."""
    if name == "K2":
        return (lambda band, npts, pads: None,
                lambda mode, band, pk, *a, **kw: stencil_apply(
                    mode, band, *a, **kw),
                lambda mode, band, pk, *a, **kw: stencil_apply_plain(
                    mode, band, *a, **kw))
    return (pack_band_v2,
            lambda mode, band, pk, *a, **kw: stencil_apply_v2(
                mode, band, *a, packed=pk, **kw),
            lambda mode, band, pk, *a, **kw: stencil_apply_v2_plain(
                mode, pk, *a, **kw))


def _csr_spmv_ms(band, x_pad, npts, pads):
    """Device time of ``A @ x`` with A a ``torch.sparse_csr_tensor`` built
    on the card from the band: a library yardstick the port never calls.
    Every row keeps all of its (2p+1)^3 entries (out-of-grid offsets carry
    value 0 at a clamped column), so the row pointer is an arange."""
    dev = band.device
    n = math.prod(npts)
    w = math.prod(2 * p + 1 for p in pads)
    index = torch.int32 if (n + 1) * w < 2 ** 31 else torch.int64
    col = torch.empty((n, w), dtype=index, device=dev)
    val = torch.empty((n, w), dtype=band.dtype, device=dev)
    idx = [torch.arange(m, device=dev) for m in npts]
    k = 0
    for k0 in range(2 * pads[0] + 1):
        for k1_ in range(2 * pads[1] + 1):
            for k2 in range(2 * pads[2] + 1):
                src = [idx[a] + (o - pads[a])
                       for a, o in enumerate((k0, k1_, k2))]
                ok = [(c >= 0) & (c < m) for c, m in zip(src, npts)]
                src = [c.clamp(0, m - 1) for c, m in zip(src, npts)]
                flat = ((src[0][:, None, None] * npts[1]
                         + src[1][None, :, None]) * npts[2]
                        + src[2][None, None, :])
                inside = (ok[0][:, None, None] & ok[1][None, :, None]
                          & ok[2][None, None, :])
                col[:, k] = flat.reshape(-1).to(index)
                val[:, k] = (band[k0, k1_, k2] * inside).reshape(-1)
                k += 1
    crow = torch.arange(0, (n + 1) * w, w, dtype=index, device=dev)
    A = torch.sparse_csr_tensor(crow, col.reshape(-1), val.reshape(-1),
                                size=(n, n))
    del col, val
    x_int = x_pad[tuple(slice(p, p + m) for m, p in zip(npts, pads))]
    x = x_int.reshape(-1).contiguous()
    # the matrix has zero ghosts, whatever x_pad's ghost region holds
    want = stencil_apply_plain("spmv", band, ghost_pad(
        x_int, pads, (False,) * 3), npts, pads).reshape(-1)
    got = A @ x
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 1e-5, f"the CSR yardstick disagrees with the band: {rel}"
    ms = _device_ms(lambda: A @ x, 5)
    del A
    torch.cuda.empty_cache()
    return ms


def phase_stencil(dev, k4_gbps, name):
    """K2 or K3 (``name``): every mode and dtype against the plain version
    at every K2 shape; device and stream times at 129^3 p3 f32."""
    prepare, kernel_fn, plain_fn = _engine(name)
    result = {m: {"max_abs_err": 0.0} for m in MODES}
    for npts, pads, periodic, starts in K2_SHAPES:
        zero = (0,) * len(npts)
        runs = [("spmv", 0, zero), ("residual", 0, zero), ("jacobi", 0, zero),
                ("rbgs", 0, zero), ("rbgs", 0, starts), ("rbgs", 1, zero)]
        for dtype in (torch.float32, torch.float64):
            band, x_pad, b = _k2_operands(npts, pads, periodic, dtype, dev,
                                          seed=sum(npts))
            pk = prepare(band, npts, pads)
            x_int = x_pad[tuple(slice(p, p + n) for n, p in zip(npts, pads))]
            rels = []
            for mode, color, st in runs:
                kw = dict(b=None if mode == "spmv" else b,
                          omega=0.8 if mode in ("jacobi", "rbgs") else None,
                          color=color, starts=st)
                y = kernel_fn(mode, band, pk, x_pad, npts, pads, **kw)
                torch.cuda.synchronize()
                want = plain_fn(mode, band, pk, x_pad, npts, pads, **kw)
                err = float((y - want).abs().max())
                rel = err / float(want.abs().max())
                rels.append(rel)
                if not (math.isfinite(rel) and rel <= K1_TOL[dtype]):
                    raise AssertionError(f"{name} {mode} disagrees at {npts} "
                                         f"{dtype} starts={st}: {rel}")
                if mode == "rbgs":
                    other = ~color_mask(npts, color, st, device=dev)
                    if not torch.equal(y[other], x_int[other]):
                        raise AssertionError(f"{name} rbgs changed points of "
                                             f"the other colour at {npts}")
                if (npts == (129,) * 3 and dtype == torch.float32
                        and st == zero and color == 0):
                    result[mode]["max_abs_err"] = err

                    def kernel(mode=mode, kw=kw):
                        return kernel_fn(mode, band, pk, x_pad, npts, pads,
                                         **kw)

                    def plain(mode=mode, kw=kw):
                        return plain_fn(mode, band, pk, x_pad, npts, pads,
                                        **kw)

                    result[mode]["ms"] = _device_ms(kernel)
                    result[mode]["plain_ms"] = _device_ms(plain)
                    result[mode]["events"] = (cuda_event_ms(kernel),
                                              cuda_event_ms(plain))
                    if mode == "spmv" and name == "K2":
                        result[mode]["library_ms"] = _csr_spmv_ms(
                            band, x_pad, npts, pads)
                        log(f"[{name}] 129^3 p3 f32 spmv as a sparse CSR "
                            f"product (torch, built on the card from the "
                            f"band): {result[mode]['library_ms']:.4f} ms")
                del y, want
            log(f"[{name}] {npts} p={pads} periodic={periodic} {dtype}: rel "
                "err " + " ".join(
                    f"{m}{'' if m != 'rbgs' else f'(c{c},s{s})'}={r:.2e}"
                    for (m, c, s), r in zip(runs, rels)))
            del band, pk, x_pad, b, x_int
            torch.cuda.empty_cache()
    points, terms = 129 ** 3, 343
    nbytes, nnz = (terms + 2) * points * 4, terms * points
    for mode in MODES:
        r = result[mode]
        log(f"[{name}] 129^3 p3 f32 {mode}: device time (profiler, mean of "
            f"20) kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms; "
            f"stream time (CUDA events, host overhead included) kernel "
            f"{r['events'][0]:.4f} ms, plain {r['events'][1]:.4f} ms")
    r = result["spmv"]
    for who, ms in (("kernel", r["ms"]), ("plain", r["plain_ms"])):
        gbps = nbytes / (ms * 1e-3) / 1e9
        log(f"[{name}] 129^3 p3 f32 spmv {who}: {gbps:.1f} GB/s, "
            f"{nnz / (ms * 1e-3) / 1e9:.2f} Gnnz/s (device time; "
            f"(terms + 2) * points * 4 bytes), {100 * gbps / k4_gbps:.1f}% "
            f"of K4's {k4_gbps:.1f} GB/s")
    return result


def phase_k3_times(dev, k4_gbps):
    """K3, K2 and plain spmv at 128^3 and 129^3 p3 f32 on one band: device
    time (profiler) and stream time (CUDA events), GB/s, Gnnz/s, % of K4;
    K3's pack against the band's bytes."""
    out = {}
    for n in (128, 129):
        npts, pads = (n,) * 3, (3,) * 3
        band, x_pad, _ = _k2_operands(npts, pads, (False,) * 3,
                                      torch.float32, dev, seed=n)
        pk = pack_band_v2(band, npts, pads)
        log(f"[K3] {n}^3 p3 f32 pack: {pk['blk'].numel() / band.numel():.4f}"
            f" x the band's bytes (tile {pk['tile']}, lanes to {pk['N'][2]})")
        fns = {"K3": lambda: stencil_apply_v2("spmv", band, x_pad, npts,
                                               pads, packed=pk),
               "K2": lambda: stencil_apply("spmv", band, x_pad, npts, pads),
               "plain": lambda: stencil_apply_plain("spmv", band, x_pad,
                                                    npts, pads)}
        nbytes, nnz = 345 * n ** 3 * 4, 343 * n ** 3
        for who in ("K3", "K2", "plain", "K3", "K2"):
            ms, ev = _device_ms(fns[who]), cuda_event_ms(fns[who])
            gbps = nbytes / (ms * 1e-3) / 1e9
            out[(n, who)] = ms
            log(f"[K3] {n}^3 p3 f32 spmv {who}: device {ms:.4f} ms, events "
                f"{ev:.4f} ms; {gbps:.1f} GB/s, "
                f"{nnz / (ms * 1e-3) / 1e9:.2f} Gnnz/s, "
                f"{100 * gbps / k4_gbps:.1f}% of K4")
        del band, x_pad, pk
        torch.cuda.empty_cache()
    return out


def _banded_pcg(n_el, levels, dev):
    prob = poisson_problem(3, n_el, degree=HEADLINE["degree"],
                           dtype=torch.float64, device=dev)
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SmootherConfig("chebyshev", cheb_fraction=16.0,
                                              cheb_degree=4))
    pcg = MGPreconditionedCG(prob, num_levels=levels, cfg=cfg, mixed=True,
                             precision="f64")
    return prob, pcg


_WRAPPERS = {"K2": stencil_apply, "K3": stencil_apply_v2}


def _reset_counts():
    for wrapper in _WRAPPERS.values():
        for mode in MODES:
            wrapper.launches[mode] = 0


def phase_banded_pcg(dev, l2_kron, name="K2"):
    """The 128^3 banded f64-mixed PCG through ``name`` (K3: the v2 engine
    is selected by the caller); returns (launches, iterations)."""
    h = HEADLINE
    counts = _WRAPPERS[name].launches
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    prob, pcg = _banded_pcg(h["n_el"], h["levels"], dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    t1 = time.perf_counter()
    res = pcg.solve(tol=h["tol"], maxiter=h["maxiter"])
    torch.cuda.synchronize()
    first = time.perf_counter() - t1
    launches = dict(counts)
    x = res.x.interior
    assert tuple(x.shape) == prob.space.npts and bool(torch.isfinite(x).all())
    log(f"[banded PCG {name}] {h['n_el'] + 1}^3 f64-mixed PCG, banded "
        f"operator: {res.iterations} iterations, converged={res.converged}, "
        f"history {['%.3e' % r for r in res.residuals]}")
    assert res.converged, res.residuals
    true_rn = float(torch.linalg.vector_norm(
        prob.b.interior - prob.A.dot(res.x).interior))
    l2 = l2_error_manufactured(prob, res.x)
    log(f"[banded PCG {name}] final |r| {res.residuals[-1]:.3e}, true f64 "
        f"|b - Ax| {true_rn:.3e} ({name} f64 spmv), L2 error vs "
        f"manufactured {l2:.3e} (kron dw solve: {l2_kron:.3e})")
    assert true_rn <= 5e-10, true_rn
    assert launches["spmv"] > 0 and launches["residual"] > 0, launches
    t2 = time.perf_counter()
    _, rn, it = pcg.solve_compiled(tol=h["tol"], maxiter=h["maxiter"])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t2
    assert float(rn) <= h["tol"] and it == res.iterations, (float(rn), it)
    log(f"[banded PCG {name}] cold setup (band, hierarchy, lambda"
        f"{', packs' if name == 'K3' else ''}) {cold:.3f} s; first solve "
        f"{first:.3f} s; warm solve {warm:.3f} s = "
        f"{warm / it * 1e3:.2f} ms/iteration; {name} launches {launches}; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, res.iterations


def phase_banded_mg(dev, name="K2"):
    """Banded RB-GS cycles at 128^3 and the 2D Jacobi solve at 512^2
    through ``name``; returns the launches per mode."""
    counts = _WRAPPERS[name].launches
    _reset_counts()
    n_el, levels = BANDED_MG["rbgs"]
    prob = poisson_problem(3, n_el, degree=3, dtype=torch.float64,
                           device=dev)
    mg = MultigridSolver(prob, levels, CycleConfig(
        nu1=2, nu2=2, smoother=SmootherConfig("rbgs", omega=1.0)))
    res = mg.solve(tol=1e-10, maxiter=3)
    torch.cuda.synchronize()
    rbgs = dict(counts)
    log(f"[banded MG {name}] {n_el + 1}^3 p3 RB-GS V(2,2), {levels} levels: "
        f"residuals "
        f"{['%.3e' % r for r in res.residuals]}, factors "
        f"{['%.3f' % f for f in res.convergence_factors]}, wall/cycle "
        f"{['%.3f s' % w for w in res.wall_times]}; {name} launches {rbgs}")
    assert len(res.residuals) == 4 and all(
        b < a for a, b in zip(res.residuals, res.residuals[1:])), \
        res.residuals
    assert rbgs["rbgs"] > 0, rbgs
    del prob, mg, res
    torch.cuda.empty_cache()

    _reset_counts()
    t0 = time.perf_counter()
    n_el, levels = BANDED_MG["jacobi"]
    prob = poisson_problem(2, n_el, degree=3, dtype=torch.float64, device=dev)
    mg = MultigridSolver(prob, levels, CycleConfig(
        nu1=2, nu2=2, smoother=SmootherConfig("jacobi", omega=0.8)))
    setup = time.perf_counter() - t0
    res = mg.solve(tol=1e-10, maxiter=200)
    torch.cuda.synchronize()
    jac = dict(counts)
    log(f"[banded MG {name}] {n_el + 1}^2 p3 Jacobi(0.8) V(2,2), {levels} "
        f"levels: {res.iterations} cycles, converged={res.converged}, final "
        f"|r| {res.residuals[-1]:.3e}, median factor "
        f"{float(np.median(res.convergence_factors)):.3f}, setup (host "
        f"SpGEMM RAP) {setup:.3f} s, solve {sum(res.wall_times):.3f} s; "
        f"{name} launches {jac}")
    assert res.converged, res.residuals[-5:]
    assert jac["jacobi"] > 0, jac
    del prob, mg, res
    torch.cuda.empty_cache()
    return {m: rbgs[m] + jac[m] for m in MODES}


def phase_v2_banded(dev, l2_kron, k2_iterations):
    """Phases 8 and 9 under POMS_TPU_SPMV=v2: every banded apply is K3."""
    before = os.environ.get("POMS_TPU_SPMV")
    os.environ["POMS_TPU_SPMV"] = "v2"
    try:
        torch.cuda.reset_peak_memory_stats()
        pcg, iterations = phase_banded_pcg(dev, l2_kron, "K3")
        k2_pcg = dict(stencil_apply.launches)
        torch.cuda.empty_cache()
        mg = phase_banded_mg(dev, "K3")
        k2_mg = dict(stencil_apply.launches)
    finally:
        if before is None:
            del os.environ["POMS_TPU_SPMV"]
        else:
            os.environ["POMS_TPU_SPMV"] = before
    assert iterations == k2_iterations, (iterations, k2_iterations)
    k3 = {m: pcg[m] + mg[m] for m in MODES}
    k2 = {m: k2_pcg[m] + k2_mg[m] for m in MODES}
    log(f"[v2 banded] K3 launches {k3}; K2 launches {k2}")
    missing = [m for m in MODES if not k3[m] > 0]
    assert not missing, f"the v2 banded paths never launched K3 in {missing}"
    assert not any(k2.values()), f"K2 ran under the v2 engine: {k2}"
    return k3


def phase_probes(dev, k4_gbps, times):
    """K4c, K4v and K4a against their plain versions, then each probe's
    timing path at 128^3 p3 f32 and a table of device times beside K4, K2
    and K3 (``times`` from phase_k3_times)."""
    variants = ("compute",) + kp.ABLATE_VARIANTS
    err = dict.fromkeys(variants + ("v15",), 0.0)
    for n in PROBE_SIZES:
        npts, pads = (n,) * 3, (3,) * 3
        band, x_pad = kp.probe_operands(n, 3, dev, seed=n)
        rels = {}
        for v in variants + ("v15",):
            y = (kp.v15_apply(band, x_pad, npts, pads) if v == "v15"
                 else kp.stencil_probe(v, band, x_pad, npts, pads))
            torch.cuda.synchronize()
            want = (stencil_apply_plain("spmv", band, x_pad, npts, pads)
                    if v == "v15"
                    else kp.stencil_probe_plain(v, band, x_pad, npts, pads))
            e = float((y - want).abs().max())
            rels[v] = e / float(want.abs().max())
            if not (math.isfinite(rels[v]) and rels[v] <= 1e-5):
                raise AssertionError(f"probe {v} disagrees at {n}^3: "
                                     f"{rels[v]}")
            if n == 128:
                err[v] = e
            del y, want
        log(f"[probes] {n}^3 p3 f32 against plain, max|d|/max|y|: "
            + " ".join(f"{v}={r:.2e}" for v, r in rels.items()))
        del band, x_pad
        torch.cuda.empty_cache()

    # the timing paths, counted from 0
    for v in kp.PROBE_VARIANTS:
        kp.stencil_probe.launches[v] = 0
    kp.v15_apply.launches = 0
    n, p = 128, 3
    kp.probe_compute(n, p)
    kp.probe_v15(n, p)
    for v in kp.ABLATE_VARIANTS:
        kp.probe_ablate(n, p, v)
    launches = dict(kp.stencil_probe.launches, v15=kp.v15_apply.launches)

    band, x_pad = kp.probe_operands(n, p, dev)
    args = (band, x_pad, (n,) * 3, (p,) * 3)
    fns = {v: (lambda v=v: kp.stencil_probe(v, *args)) for v in variants}
    fns["v15"] = lambda: kp.v15_apply(*args)
    plain = {v: (lambda v=v: kp.stencil_probe_plain(v, *args))
             for v in variants}
    plain["v15"] = lambda: stencil_apply_plain("spmv", *args)
    out = {v: {"launches": launches[v], "max_abs_err": err[v],
               "ms": _device_ms(fns[v]), "plain_ms": _device_ms(plain[v])}
           for v in variants + ("v15",)}
    csr_ms = _csr_spmv_ms(*args)
    log(f"[probes] {n}^3 p3 f32 spmv as a sparse CSR product (torch): "
        f"{csr_ms:.4f} ms")
    points = n ** 3
    stream = (343 + 2) * points * 4 / HBM_BYTES_PER_S * 1e3
    fields = 2 * points * 4 / HBM_BYTES_PER_S * 1e3
    for v in out:   # bounds: the band stream, or the arithmetic without it
        if v == "compute":      # band of one tile only: 343 multiply-adds
            ops = 2 * 343 * points / F32_FLOPS * 1e3
            out[v].update(bound_ms=max(fields, ops), bound_by="operations",
                          library_ms=None)
        elif v == "nomul":      # no band read: 343 adds per point
            ops = 343 * points / F32_FLOPS * 1e3
            out[v].update(bound_ms=max(fields, ops), bound_by="operations",
                          library_ms=None)
        else:                   # the spmv, or its bytes with other offsets
            out[v].update(bound_ms=stream, bound_by="bytes",
                          library_ms=csr_ms if v in ("full", "v15")
                          else None)
    del band, x_pad, args, fns, plain
    torch.cuda.empty_cache()
    floor = 343 * n ** 3 * 4 / (k4_gbps * 1e9) * 1e3
    rows = [("K4 stream (library layout), band bytes only", floor),
            ("K2 spmv", times[(128, "K2")]), ("K3 spmv", times[(128, "K3")]),
            ("K4a full (K2's template)", out["full"]["ms"]),
            ("K4a noshift (axis-1 x offset 0)", out["noshift"]["ms"]),
            ("K4a nolane (axis-2 x offset 0)", out["nolane"]["ms"]),
            ("K4a nomul (no band read)", out["nomul"]["ms"]),
            ("K4c compute (band of tile 0 only)", out["compute"]["ms"]),
            ("K4v v15 (plane reuse, t0=8 t2=8)", out["v15"]["ms"])]
    log(f"[probes] {n}^3 p3 f32, device time (profiler, mean of 20; K4 row: "
        "343 n^3 * 4 bytes at K4's GB/s):")
    for label, ms in rows:
        log(f"[probes]   {label:44s} {ms:8.4f} ms")
    missing = [v for v in out if not out[v]["launches"] > 0]
    assert not missing, f"the probe paths never launched {missing}"
    return out


def phase_banded_check(dev):
    """Phase 8's solve at n_el = 16 on the card and on the CPU."""
    out, lams = {}, None
    for d in (dev, torch.device("cpu")):
        _, pcg = _banded_pcg(16, 2, d)
        pcg.lams = lams = lams or pcg.lams   # the card's λs on both
        out[d.type] = pcg.solve(tol=1e-10, maxiter=30)
    rc, rh = out["cuda"], out["cpu"]
    xc, xh = rc.x.interior.cpu(), rh.x.interior
    rel = float((xc - xh).abs().max() / xh.abs().max())
    log(f"[banded check] 17^3: card {rc.iterations} it, cpu {rh.iterations} "
        f"it, max|x_card - x_cpu|/max|x| {rel:.3e}")
    assert rc.converged and rh.converged
    assert rc.iterations == rh.iterations, (rc.iterations, rh.iterations)
    assert rel <= 1e-6, rel


T_START = time.perf_counter()


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
    k1_res = phase_k1(dev)
    phase_eft(dev)
    k5_res = phase_k5(dev)
    torch.cuda.empty_cache()
    solve = phase_solve(dev)
    phase_check(dev, solve["l2"])
    torch.cuda.empty_cache()
    k4 = phase_k4(dev)
    k2 = phase_stencil(dev, k4["gbps"], "K2")
    torch.cuda.reset_peak_memory_stats()
    pcg_launches, k2_iterations = phase_banded_pcg(dev, solve["l2"])
    torch.cuda.empty_cache()
    mg_launches = phase_banded_mg(dev)
    phase_banded_check(dev)
    k2_launches = {m: pcg_launches[m] + mg_launches[m] for m in MODES}
    missing = [m for m in MODES if not k2_launches[m] > 0]
    assert not missing, f"the banded paths never launched K2 in {missing}"
    k3 = phase_stencil(dev, k4["gbps"], "K3")
    times = phase_k3_times(dev, k4["gbps"])
    k3_launches = phase_v2_banded(dev, solve["l2"], k2_iterations)
    probes = phase_probes(dev, k4["gbps"], times)
    points = 129 ** 3

    def banded_bound(mode):
        """bytes: the band, x and the result once, b where the mode reads
        it; 343 multiply-adds per point are far below that"""
        fields = 343 + 2 + (mode != "spmv")
        return {"bound_ms": fields * points * 4 / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes"}

    kernels = [{
        "name": f"kron_apply.{m}", "route": "cuda",
        "source": "poms_tpu_torch/csrc/kron_apply.cu",
        "replaces": "poms_tpu/ops/pallas/kron.py:157",
        "launches": solve["launches"][m],
        "max_abs_err": k1_res[m]["max_abs_err"], "ms": k1_res[m]["ms"],
        "plain_ms": k1_res[m]["plain_ms"], "bound_ms": k1_res[m]["bound_ms"],
        "bound_by": "bytes", "library_ms": None} for m in k1.MODES]
    kernels.append({
        "name": "residual_kron_df", "route": "cuda",
        "source": "poms_tpu_torch/csrc/kron_apply_dw.cu",
        "replaces": "poms_tpu/ops/twofloat.py:197",
        "launches": solve["launches"]["K5"],
        "max_abs_err": k5_res["max_abs_err"], "ms": k5_res["ms"],
        "plain_ms": k5_res["plain_ms"], "bound_ms": k5_res["bound_ms"],
        "bound_by": "operations", "library_ms": None})
    csr_ms = k2["spmv"]["library_ms"]
    kernels += [{
        "name": f"stencil_apply.{m}", "route": "cuda",
        "source": "poms_tpu_torch/csrc/stencil_apply.cu",
        "replaces": f"poms_tpu/ops/pallas/spmv.py:{K2_REPLACES[m]}",
        "launches": k2_launches[m], "max_abs_err": k2[m]["max_abs_err"],
        "ms": k2[m]["ms"], "plain_ms": k2[m]["plain_ms"],
        **banded_bound(m),
        "library_ms": csr_ms if m == "spmv" else None} for m in MODES]
    n4, p4 = K4_SIZE
    kernels.append({
        "name": "stream_probe", "route": "cuda",
        "source": "poms_tpu_torch/csrc/stream_probe.cu",
        "replaces": "poms_tpu/bench/kernel_probe.py:85",
        "launches": k4["launches"], "max_abs_err": k4["max_abs_err"],
        "ms": k4["ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": ((2 * p4 + 1) ** 3 + 2) * n4 ** 3 * 4
        / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": k4["library_ms"]})
    kernels += [{
        "name": f"stencil_apply_v2.{m}", "route": "cuda",
        "source": "poms_tpu_torch/csrc/stencil_apply_v2.cu",
        "replaces": f"poms_tpu/ops/pallas/spmv.py:{K3_REPLACES[m]}",
        "launches": k3_launches[m], "max_abs_err": k3[m]["max_abs_err"],
        "ms": k3[m]["ms"], "plain_ms": k3[m]["plain_ms"],
        **banded_bound(m),
        "library_ms": csr_ms if m == "spmv" else None} for m in MODES]
    probe_rows = [("compute", "stencil_apply.cu", 145)]
    probe_rows += [("v15", "probe_v15.cu", 266)]
    probe_rows += [(v, "stencil_apply.cu", 392) for v in kp.ABLATE_VARIANTS]
    kernels += [{
        "name": f"stencil_probe.{v}" if v != "v15" else "probe_v15",
        "route": "cuda", "source": f"poms_tpu_torch/csrc/{src}",
        "replaces": f"poms_tpu/bench/kernel_probe.py:{line}",
        **probes[v]} for v, src, line in probe_rows]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for row in kernels:
        assert set(row) == keys, (row["name"], set(row) ^ keys)
        assert row["launches"] > 0, f"{row['name']} never launched on a path"
    log(f"chip_smoke.py took {time.perf_counter() - T_START:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
