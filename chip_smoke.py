#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one CUDA card.

    python3 chip_smoke.py

Imports torch, numpy and ``poms_tpu_torch`` only.  Phases, in order; no
exception is caught (phase 23 catches the refusals one half-width past the
widest it expects, and fails where they do not come, and a failed f32
coarse factorization of a run it only logs), so any failure exits
non-zero:

1. build   — nvcc the kernels of poms_tpu_torch/csrc (K1 kron_apply, K5
             kron_apply_dw, K2 stencil_apply, K3 stencil_apply_v2, K4
             stream_probe, K4v probe_v15, K6r dw_reduce, K6u dw_update, K7
             transfer), one nvcc per source, all started together; prints
             ptxas registers and spills.
2. K1      — each mode (apply, residual, dinv, cheb first and later step)
             against its plain PyTorch version on the card, f32 and f64, at
             the shapes of the headline solve's levels, a few ragged and
             periodic ones, a 2D, a 1D and a mixed-periodic 3D shape with
             unequal pads, a 4-term operator that takes two launches, and
             the periodic shifted operator of phase 17 on every level of
             its hierarchy (128³ down to 8³, 4 terms that K1's plan folds
             to 3: one launch)
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
3c. K6     — the double-word reductions (K6r) against the plain pairwise
             tree at 129³, 65³, 17³, 2²⁰+1 and 12,345 points, as a norm
             (k = 1) and as the step's stacked pair (k = 2, absent low
             words): |Δ| ≤ 1e-13·Σ|terms| (the orders of addition differ),
             two runs bit-equal, one launch a call; the elementwise
             recurrences (K6u) bit-equal to their plain versions in every
             mode; device times at 129³ beside their byte bounds and, for
             K6r's three calls, beside a yardstick that reads the same
             bytes (torch.dot of two f64 vectors, torch.linalg.vector_norm
             of one).
3d. K7     — restriction and prolongation (with the fused x + P·x_c) at
             every level pair of the 128³ hierarchy, at 513² → 257² and at
             every level pair of phase 17's periodic hierarchy (128³ ↔ 64³
             down to 16³ ↔ 8³, wrapped bands of 5 and 3 taps), f32 and
             f64: one launch per transfer, bit-equal to the plain gathers;
             device times of 129³ ↔ 65³ (f32 and f64) and of the periodic
             128³ ↔ 64³ beside the byte bound and the library yardstick (one
             torch.matmul per axis with the dense 1D transfer, no TF32).
4. solve   — 3D Poisson, cubic B-splines, n_el = 128 (129³ unknowns), 5
             levels, Chebyshev(4) over [λmax/16, λmax] with ν1 = ν2 = 1,
             dw-precision MG-preconditioned CG to ‖r‖₂ ≤ 1e-10: it converges
             in at most 8 iterations, the true residual recomputed in f64
             (K1's f64 instantiation) is ≤ 5e-10; K1's cheb and residual
             modes, K5, K6r, K6u and K7 launched and K1's apply mode did not
             (no apply-then-subtract); launches per eager iteration per
             kernel.  solve_compiled then replays the step's captured CUDA
             graph: same count and residual; ms per iteration eager and
             replayed.
4b. defect — this slice's path: MixedPrecisionMG(residual="twofloat") at
             n_el = 128, p = 3, 5 levels, Chebyshev(4) over [λmax/32, λmax],
             ν1 = ν2 = 1, to 1e-10 through solve and solve_compiled (graph
             replay): converged, equal counts, true f64 residual ≤ 5e-10;
             residual="f64" once; the dwrr PCG (count beside dw's).
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
             phase 9 (513², 257², 129², 65², 33² p3), the wrapped levels of
             phase 17 (128³, 64³, 32³, 16³ p3), RB-GS with starts 0 and 1
             (max|Δ|/max|y| ≤ 1e-5 f32, ≤ 1e-12 f64; RB-GS points of the
             other colour bit-equal to x); at 129³ p3 f32 the device and
             stream times of kernel and plain, GB/s, Gnnz/s and % of K4;
             K2's device time in every mode at 129³, 65³, 33³, 17³ and 128³
             p3, f32 and f64, beside each dtype's byte bound.
8. banded PCG — 3D Poisson p3, n_el = 128, 5 levels, banded operator,
             f64-mixed MG-preconditioned CG, Chebyshev(4) over
             [λmax/16, λmax], ν1 = ν2 = 1, to 1e-10: converges, the true
             f64 residual through K2's f64 spmv is ≤ 5e-10, K2's spmv and
             residual launched; the graph-replayed step alone, timed.
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
             GB/s, Gnnz/s and % of K4; K3 and K2 in f64 at 129³ and 128³
             beside the f64 byte bound.
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

14. bf16 kernels — K2 and K3 in bf16 against their plain versions (f32
             arithmetic, one rounding) at every K2 shape, every mode: each
             value within one bf16 unit in the last place (2^-7 of its
             magnitude) plus the f32 sums' own error (1e-5 of max|y|), the
             count of points that differ printed; RB-GS other-colour points
             bit-equal to x; device times at 129³ and 128³ beside the byte
             bound and K4, and K2's per-mode table at the five level
             shapes in bf16.  K1 in bf16, four modes (and the first Chebyshev
             step), at the f32 shapes (mixed-periodic, a two-launch
             operator and the periodic hierarchy's levels among them), same
             tolerance; times at 129³.  K7 in bf16 at its level pairs, the
             periodic ones too: bit-equal to plain; times.  A sparse CSR
             product in bf16 is tried once (its time, or torch's error).
15. K5, 4 histories — the periodic shifted 3D operator (σM⊗M⊗M + K⊗M⊗M +
             M⊗K⊗M + M⊗M⊗K: 2 u, 3 v, 4 histories) at 128³ p3, 32³ p3 and
             16³ p2: bit-equal to plain with b, x_l given and with the zero
             flags; device time at 128³.
16. bf16 solves — at n_el = 128, p = 3, 5 levels, tol 1e-10, each beside its
             f32 run: MixedPrecisionMG(low_dtype=bfloat16) on kron levels,
             twofloat, Chebyshev(4) over [λmax/32, λmax], eager and
             graph-replayed (equal counts, the same bits); the kron dw-PCG
             with a bf16 preconditioner; the banded defect correction
             (residual="f64") under K2 and under v2.  Each converges with a
             true f64 residual ≤ 5e-10, and in each the low hierarchy ran
             the bf16 instantiations alone (the f32 counts of K1/K2/K3/K7
             over the solve are 0).  Then three corrections each of a
             Jacobi- (automatic ω) and an RB-GS-smoothed (ω = 1) bf16
             banded cycle on the same problem, ν1 = ν2 = 2 (K2's and K3's
             jacobi and rbgs modes in bf16 on a solver path).
17. periodic — periodic_problem(3, 128, p = 3, σ = 1), 5 levels (coarsest
             8³): the kron twofloat defect correction (eager and replayed)
             and the kron dw-PCG, K5 with 4 histories and K1 with two
             launches per pass; one banded periodic f64-mixed PCG; true
             f64 residuals ≤ 5e-10; K7's time on the periodic transfers of
             the solver's own levels at 128³ ↔ 64³.

18. distributed — DistributedMG at 128^3 p3 on 2 gloo ranks sharing the
             card and on 1 NCCL rank, the two jobs at once, so no time a
             cycle is logged (see phase_distributed).
19. headline — the port's headline example
             (poms_tpu_torch/examples/headline_solve.py, main) at n_el = 64,
             128, 256 and 512 for pcg and dc: converged, true f64 residual
             <= 5e-10, the counts of phases 4 and 4b at 128^3 (8, 11), every
             other count logged beside the JAX package's record; iterations,
             replayed ms per iteration, cold setup, peak memory and L2 error
             logged.  At 512^3 every kernel of the solve against its plain
             version on the solve's own operands: K1 (every mode) on the
             513^3 and 257^3 cycle levels, K5 (residual and A.p), K6r (the
             stacked pair, the norm) and K6u cg on 513^3 fields, K7 on the
             513^3 <-> 257^3 bands (K1 1e-5 of max|y|, K6r 1e-13 of
             sum|terms|, K5, K6u and K7 bit-equal).  Then the banded
             examples at the JAX examples' default sizes: poisson_1d in 6
             cycles, poisson_2d in 18, poisson_3d's RB-GS cycles stalling
             (60 cycles, median rho 0.9-0.97) and its dw MG-PCG in 13
             iterations (K2 jacobi, rbgs and residual, K1, K5, K7).
20. benches — bench/attr_iter.py at 128^3 (pcg, dc); the dense-matmul
             Kronecker apply (core/kron.py::_apply_interior_matmul, the
             JAX package's POMS_TPU_KRON=matmul) against K1's apply at
             129^3 p3 f32 (1e-5 of max|y|) and timed beside it (K1's library
             column), with TF32 once; bench_vcycle(3, 128, 3, 5) under K2
             and under K3; the plain-PyTorch stream yardsticks xlastream and
             xlastreamrw at 128^3 p3 beside K4.
21. dist examples — distributed_2d, multihost_2d and multihost_3d (every
             leg) on 2 gloo ranks sharing the card, multihost_3d on 1 NCCL
             rank, the census of one twofloat kron step on 2 gloo ranks,
             and multihost_2d in f32 on 2 gloo ranks (logged, not gated),
             the six jobs at once; then alone overlap_trace's A/B
             pair at 128^3 p3 on 2 gloo ranks (overlap fraction, device
             idle share, staged copies' share); the scaling model's
             prediction for 8 ranks at 128^3 a rank (one card shows the
             wiring, not scaling).
22. degrees — every spline degree 1-8 at 64^3 elements (PERF.md section 5
             keeps their 128^3 record; phase 23 runs the headline's 128^3
             at degrees 9-12) through the headline
             example (pcg and dc, f32 cycles) and the dwrr PCG: each converges
             to 1e-10 with a true f64 residual <= 5e-10; every plan at the
             degree's own half-width (the compiled K1 and K5 at 1-3, K1r and
             K5r from 4 on: ops/kron.py::COMPILED_P) and K5, K1 and K7
             launched; on each pcg run's own operands K5 (the residual and
             A.p) bit-equal to plain, K1 in every mode on the first two cycle
             levels (1e-5 of max|y|), K7 between them (bit-equal), K5's
             resources and the device times of K5's A.p and K1's cheb pass.
             bf16 cycles (defect correction, dw-PCG) at degrees 4, 5 and 8 at
             64^3 (counts logged, not gated; only bf16 K1/K7 on the low
             hierarchy), K1 bf16 in every mode against plain on their first two
             levels, its cheb and apply times at half-widths 5 and 8 beside the
             dense bf16 products, and the same solves at 8^3 on the card and
             the CPU; the periodic dw-PCG at degree 8 (48^3, K5 with 4
             histories at P = 8; logged); a 6-term operator whose K5 residual
             takes three chained launches, bit-equal to the single pass; K2 and
             K3 in every mode at degrees 5 to 8 (33^3, rows K2 cuts into
             shorter runs, K3's smaller tiles, 513^2).
23. wide degrees — spline degrees above 8 on the run-time kernels K1r and
             K5r, each three one-axis passes (A on axis 2, B on axis 1, C
             on axis 0) through its plan's scratch: the headline at 128^3
             at degrees 9, 10 and 12 (pcg and dc through the headline
             example, and the dwrr PCG, up to 400 iterations): pcg and dc
             at 9 and 10 and dwrr at 9 converge to 1e-10 with a true f64
             residual <= 5e-10, dwrr at 10 and all three at 12 are logged;
             every plan at the degree's own half-width, every pass of K1r
             and K5r launched; on each pcg run's own operands phase 22's
             checks (K5r bit-equal, K1r in every mode on levels 0-1, K7, K6r,
             K6u).  K1r in every mode (1e-5 of max|y|) and K5r (bit-equal)
             against plain at P = 9, 10, 12, 16 on the 128^3-element grids,
             timed beside their bounds, the plain versions and (K1r's apply)
             the dense per-axis products; at P = 3 and 8 against the compiled
             kernels (equal values, bit-equal words) and K1r at 4, 6 and 7
             beside compiled K1 at 5 and 8; at P = 9 each pass alone against
             its plain version on the same inputs (K1r within 1e-5 of
             max|y|, every mode of pass C; K5r word for word), timed beside
             its own bound; each kernel's widest half-width (K1r 218 in f32,
             108 in f64; K5r 138) on a 5 x 6 x 9 grid, and one past it
             refused with the bytes.

Cut against the earlier version to hold the run time: phase 2 times the
plain K1 versions with 3 repetitions instead of 5.  Every phase logs what it
took on a ``[time]`` line.

Prints the card's name and power limit early, one JSON line of per-kernel
results before the last line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The launch counts of the JSON line come from the paths, each counted from 0
just before it: K1, K5, K6r, K6u and K7 from phases 4 and 4b (setup and
every solve; a graph replay advances the counters by the launches its
capture recorded, since a replay launches them again), K4 from phase 6's
ceiling, K2 from phases 8 and 9, K3 from phase 12, the probes from phase
13's timing paths, the bf16 rows from phase 16 and K5's 4-history row from
phase 17, and to each row the launches of every rank of phase 18 (its
solves), and those of phases 19 (the headline runs and the banded
examples), 20 (the benches), 21 (every rank of the distributed examples),
22 and 23 (their solves); the rows of phase 22's instantiations (K5 at
half-widths 4, 6, 7 and 8, K1 in bf16 at 5 and 8) count its solves at those
half-widths only, and the rows of K1r's and K5r's passes (K1r's pass C
one a mode its solves ran) count phase 23's solves; launches made to
compare a kernel with its plain
version are not counted. Each kernel's ``bound_ms`` is the larger of its bytes
(every input read once, every output written once) over 3.35 TB/s and its
operations over the f32 rate outside the tensor cores (K5's adds and
multiplies may not fuse: 33.5 T a second, half the published 67 TFLOP/s,
which counts an FMA as two), from this run's shapes; ``library_ms`` times
PyTorch's own calls for the same function where there are such (the dense
per-axis ``torch.tensordot`` apply for K1's apply mode; ``torch.sum`` for
K4; a sparse CSR product, built on the card from the band, for the kernels
that compute a banded spmv; one ``torch.matmul`` per axis with the dense 1D
transfer, and the add, for K7), which the port itself never calls.
"""
import gc
import json
import math
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as tdist

from poms_tpu_torch.bench.device import device_ms as _device_ms
from poms_tpu_torch.bench.device import nvidia_smi_name_power
from poms_tpu_torch.bench.k1_compare import rt_kernels
from poms_tpu_torch.bench import kernel_probe as kp
from poms_tpu_torch.bench import one_dist
from poms_tpu_torch.bench.kernel_probe import (cuda_event_ms, make_band,
                                               probe_stream, stream_probe,
                                               stream_probe_plain)
from poms_tpu_torch.core.kron import KroneckerSumOperator
from poms_tpu_torch.core.space import StencilVectorSpace
from poms_tpu_torch.core.vector import StencilVector, ghost_pad
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.mixed import MGPreconditionedCG, MixedPrecisionMG
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.mg.solver import MultigridSolver
from poms_tpu_torch.models.bspline import (assemble_periodic_1d,
                                           prolongation_interior_1d,
                                           prolongation_periodic_1d)
from poms_tpu_torch.models.periodic import (_coarse_bands_periodic,
                                            _kron_periodic, periodic_problem)
from poms_tpu_torch.models.poisson import (l2_error_manufactured,
                                           poisson_problem)
from poms_tpu_torch.ops import _build, counters
from poms_tpu_torch.ops import transfer as k7
from poms_tpu_torch.ops import kron as k1
from poms_tpu_torch.ops import twofloat
from poms_tpu_torch.ops.stencil import (MODES, color_mask, k2_lift, k2_plan,
                                        stencil_apply, stencil_apply_plain)
from poms_tpu_torch.ops.stencil_v2 import (pack_band_v2, stencil_apply_v2,
                                           stencil_apply_v2_plain)
from poms_tpu_torch.ops.twofloat import (dw_add, dw_mul, split_f64,
                                         two_prod, two_sum)
from poms_tpu_torch.parallel.dist import DistributedMG
from poms_tpu_torch.parallel.launch import start

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
# the same pipe in operations that do not fuse (an FMA counts two in 67 T):
# 132 SMs x 128 f32 lanes x 1.98 GHz; the double-word kernels' adds and
# multiplies may not contract, so this is their rate
F32_OPS = F32_FLOPS / 2
HEADLINE = dict(n_el=128, degree=3, levels=5, tol=1e-10, maxiter=30)
K6_SIZES = (129 ** 3, 65 ** 3, 17 ** 3, 2 ** 20 + 1, 12345)
K6_TOL = 1e-13                # of the sum of |terms|: the orders differ
K7_LEVELS = (128, 64, 32, 16)  # fine n_el of each level pair at p = 3
REFERENCE_COUNTS = {"twofloat": 12, "dwrr": 15}   # the JAX package's, 128³
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
# the smoothed levels of phase 17's periodic banded solve (wrapped ghosts)
PERIODIC_LEVELS = (128, 64, 32, 16, 8)   # n_el per level, p = 3; 8^3 is solved
K2_SHAPES += [((n,) * 3, (3,) * 3, (True,) * 3, (1, 0, 1))
              for n in PERIODIC_LEVELS[:-1]]
K2_REPLACES = {"spmv": 343, "residual": 349, "jacobi": 359, "rbgs": 369}
K3_REPLACES = {"spmv": 795, "residual": 802, "jacobi": 813, "rbgs": 823}
# banded multigrid: 3D RB-GS cycles and the 2D Jacobi solve (n_el, levels)
BANDED_MG = dict(rbgs=(128, 5), jacobi=(512, 6))
K4_SIZE = (128, 3)   # the stream probe's (n, p): a 129^3 p3 band's size
PROBE_SIZES = (32, 128)   # p = 3, f32; the probes are timed at 128^3
# phase 18: DistributedMG at the headline's size, p = 3, 5 levels
DIST = dict(dim=3, n_el=128, degree=3, levels=5, tol=1e-10, device="cuda",
            maxiter=600)
DIST_CYCLES = {   # RB-GS: the multichip record's cycle (on 3D p3 it
    # contracts by ~0.95 a cycle); Chebyshev(4): the headline's cycle
    "rbgs": dict(kind="rbgs", omega=1.0, nu1=2, nu2=2),
    "chebyshev": dict(kind="chebyshev", cheb_fraction=16.0, cheb_degree=4,
                      nu1=1, nu2=1)}
DIST_GLOO_MESH = (2, 1, 1)   # 2 gloo ranks sharing the card
# each entry of a distributed history against the serial port's, relative:
# the two differ by the f32 cycles' rounding (plain contractions against K1
# on kron levels; blocks, faces and all_reduce sums against one grid), which
# each correction adds to the next entry.  RB-GS (ρ ≈ 0.95 a cycle) carries
# little of it; the Chebyshev cycle (ρ ≈ 0.2) carries more: its last
# entries differed by 5% in an earlier run
DIST_HISTORY_RTOL = {"rbgs": 1e-3, "chebyshev": 0.1}


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
             "stencil_apply_v2", "probe_v15", "dw_reduce", "dw_update",
             "transfer")
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


def _periodic_kron_levels(dev, dtype):
    """(npts, terms) of every level of phase 17's Kronecker-sum hierarchy:
    the periodic shifted operator (4 terms, which K1's plan folds to 3: one
    launch a pass) from the 1D circulant bands, coarsened as
    build_periodic_hierarchy does."""
    bands = [assemble_periodic_1d(PERIODIC_LEVELS[0], 3)] * 3
    for n in PERIODIC_LEVELS:
        space = StencilVectorSpace(npts=(n,) * 3, pads=3, periodic=True,
                                   dtype=dtype, device=dev)
        yield (n,) * 3, _kron_periodic(bands, 1.0, space).terms
        if n // 2 > 6:
            bands = _coarse_bands_periodic(
                bands, [prolongation_periodic_1d(n // 2, 3)] * 3)


def _k1_fields(npts, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(npts), device=dev).to(dtype)
            for _ in range(3)]


def _k1_against_plain(what, terms, fields, npts, pads, periodic,
                      half_widths=k1.COMPILED_P):
    """Every K1 check of ``_k1_runs`` on one operator, f32 or f64, against
    the plain version, on the plan ``half_widths`` route it to; returns
    max|d| per label."""
    x, b, d = fields
    dtype = x.dtype
    plan = k1.build_kron_plan(terms, npts, pads, periodic,
                              half_widths=half_widths)
    diag = plan.diagonal()
    rels, errs = {}, {}
    for label, mode, kw in _k1_runs(b, d):
        kw_k = dict(kw)
        if kw.get("d") is not None:
            kw_k["d"] = d.clone()     # the kernel updates d in place
        got = k1.kron_mode(mode, plan, x, **kw_k)
        torch.cuda.synchronize()
        want = k1.kron_mode_plain(mode, terms, x, npts, pads, periodic,
                                  diag=diag, **kw)
        if mode != "cheb":
            got, want = (got,), (want,)
        errs[label] = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
        rels[label] = max(float((g - w).abs().max() / w.abs().max())
                          for g, w in zip(got, want))
        if not (math.isfinite(rels[label]) and rels[label] <= K1_TOL[dtype]):
            raise AssertionError(f"K1 {label} disagrees at {what}{npts} "
                                 f"{dtype}: {rels[label]}")
    log(f"[K1] {what}{npts} p={pads} periodic={periodic} terms="
        f"{len(terms)} launches/apply={len(plan.plans)} {dtype}: "
        "rel err " + " ".join(f"{k}={v:.2e}" for k, v in rels.items()))
    return errs


def phase_k1(dev):
    result = {m: {} for m in k1.MODES}
    shapes = [(npts, (p,) * 3, (per,) * 3, 0) for npts, p, per in K1_SHAPES]
    shapes += [(*case, 0) for case in K1_MORE]
    shapes.append(((20, 21, 22), (2, 2, 2), (False,) * 3, 4))
    for npts, pads, periodic, free in shapes:
        for dtype in (torch.float32, torch.float64):
            terms, (x, b, d) = _k1_operands(npts, pads, dtype, dev,
                                            sum(npts) + pads[0], free)
            errs = _k1_against_plain("", terms, (x, b, d), npts, pads,
                                     periodic)
            if npts == (129, 129, 129) and dtype == torch.float32:
                diag = k1.build_kron_plan(terms, npts, pads,
                                          periodic).diagonal()
                for label, mode, kw in _k1_runs(b, d):
                    if label not in k1.MODES:
                        continue
                    result[mode]["max_abs_err"] = errs[label]
                    result[mode]["plain_ms"] = _device_ms(
                        lambda: k1.kron_mode_plain(
                            mode, terms, x, npts, pads, periodic, diag=diag,
                            **kw), 3)
    # phase 17's operators: every level of the periodic kron hierarchy
    for dtype in (torch.float32, torch.float64):
        for npts, terms in _periodic_kron_levels(dev, dtype):
            _k1_against_plain("periodic shifted operator, level ", terms,
                              _k1_fields(npts, dtype, dev, npts[0]), npts,
                              (3,) * 3, (True,) * 3)
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
            res = twofloat.k5_resources(plan)
            log(f"[K5] 129^3 p3 launch: tiles {plan.tiling} (T1, T2, planes "
                f"a run), {res['threads']} threads a block; "
                f"{res['registers']} registers a thread, "
                f"{res['local_bytes']} bytes of local memory (spills), "
                f"{res['smem_bytes']} bytes of shared memory a block, "
                f"{res['blocks_per_sm']} blocks an SM")
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
                      "bound_ms": ops / F32_OPS * 1e3}
            log(f"[K5] 129^3 p3 A.p: device time kernel {result['ms']:.4f} "
                f"ms, plain {result['plain_ms']:.4f} ms; bounds: bytes "
                f"{result['bound_bytes_ms']:.4f} ms, operations "
                f"{result['bound_ms']:.4f} ms ({ops // n ** 3} f32 "
                f"operations per point, none of which may fuse, at "
                f"{F32_OPS / 1e12:.1f} T a second): "
                f"{100 * result['bound_ms'] / result['ms']:.1f}% of it")
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


def _field_ms(fields, n):
    return fields * n * 4 / HBM_BYTES_PER_S * 1e3


def phase_k6(dev):
    """K6r against the plain tree (to K6_TOL, repeatable bit for bit) and
    K6u against its plain versions (bit-equal); times at 129^3."""
    g = torch.Generator(device="cpu").manual_seed(6)
    rows = {}
    for n in K6_SIZES:
        x = torch.randn(n, generator=g, dtype=torch.float64).to(dev)
        y = (torch.randn(n, generator=g, dtype=torch.float64) * 1e-3).to(dev)
        (xh, xl), (yh, yl) = split_f64(x), split_f64(y)
        z = torch.randn(n, generator=g).to(dev)
        pair = [(z, None, xh, xl), (z, None, yh, yl)]
        before = twofloat.dw_dot_stack.launches
        got, again = twofloat.dw_dot_stack(pair), twofloat.dw_dot_stack(pair)
        nrm, nrm2 = twofloat.dw_norm2(xh, xl), twofloat.dw_norm2(xh, xl)
        torch.cuda.synchronize()
        if twofloat.dw_dot_stack.launches != before + 4:
            raise AssertionError("K6r took more than one launch a call")
        if not (torch.equal(got, again) and torch.equal(nrm, nrm2)):
            raise AssertionError(f"K6r is not repeatable at n={n}")
        want = twofloat.dw_dot_stack_plain(pair)
        scale = torch.stack([(z.double() * x).abs().sum(),
                             (z.double() * y).abs().sum()])
        err = (got - want).abs()
        n_want = twofloat.dw_norm2_plain(xh, xl)
        n_rel = float((nrm * nrm - n_want * n_want).abs() / (x * x).sum())
        exact = float(((got - torch.stack([(z.double() * x).sum(),
                                           (z.double() * y).sum()])).abs()
                       / scale).max())
        log(f"[K6r] n={n}: stacked pair |d|/sum|terms| "
            f"{[f'{float(e):.2e}' for e in err / scale]} against the plain "
            f"tree ({exact:.2e} against the f64 sum), norm^2 {n_rel:.2e}; "
            f"two runs bit-equal")
        if not (bool((err <= K6_TOL * scale).all()) and n_rel <= K6_TOL):
            raise AssertionError(f"K6r disagrees with the plain tree at "
                                 f"n={n}: {err / scale}, {n_rel}")
        # K6u, every mode, with device scalars
        f = [torch.randn(n, generator=g).to(dev) for _ in range(7)]
        for k in (1, 3, 6):
            f[k] *= 1e-8
        s0 = torch.tensor(0.37, dtype=torch.float64, device=dev)
        s1 = torch.tensor(1.91, dtype=torch.float64, device=dev)
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        cases = {"cg": (*f, s0, s1), "direction": (f[0], f[2], s0, s1),
                 "defect": (f[0], f[1], f[2], s0),
                 "dwrr": (f[0], f[1], f[2], f[4], f[5], s0, s1),
                 "dwrr, x only": (f[0], f[1], f[2], None, None, s0, s1),
                 "div": (f[0], s0), "mul": (f[0], s1),
                 "div, scale 0": (f[0], zero)}
        worst = 0.0
        for label, ops in cases.items():
            mode = label.split(",")[0]
            out = twofloat.dw_update(mode, *ops)
            torch.cuda.synchronize()
            ref = twofloat.dw_update_plain(mode, *ops)
            if isinstance(out, torch.Tensor):
                out, ref = (out,), (ref,)
            worst = max([worst] + [float((a - b).abs().max())
                                   for a, b in zip(out, ref)])
            if len(out) != len(ref) or not all(
                    torch.equal(a, b) for a, b in zip(out, ref)):
                raise AssertionError(f"K6u {label} is not bit-equal to its "
                                     f"plain version at n={n}")
        log(f"[K6u] n={n}: {len(cases)} cases bit-equal to plain")
        if n == 129 ** 3:
            times = {
                "norm": (_device_ms(lambda: twofloat.dw_norm2(xh, xl)),
                         _device_ms(lambda: twofloat.dw_norm2_plain(xh, xl),
                                    3), _field_ms(2, n)),
                "dot p.Ap": (_device_ms(
                    lambda: twofloat.dw_dot(z, None, xh, xl)), _device_ms(
                    lambda: twofloat.dw_dot_plain(z, None, xh, xl), 3),
                    _field_ms(3, n)),
                "stacked pair": (_device_ms(
                    lambda: twofloat.dw_dot_stack(pair)), _device_ms(
                    lambda: twofloat.dw_dot_stack_plain(pair), 3),
                    _field_ms(5, n))}
            for label, (ms, plain, bound) in times.items():
                log(f"[K6r] 129^3 {label}: kernel {ms * 1e3:.2f} us, plain "
                    f"tree {plain:.4f} ms, bound {bound * 1e3:.2f} us "
                    f"(bytes): {100 * bound / ms:.1f}% of it")
            # a yardstick that reads the same bytes, which the port never
            # calls: an f64 dot of two vectors (16 n bytes beside the pair's
            # 20 n and p.Ap's 12 n) and the f64 norm of one (8 n, as the
            # norm's)
            v1, v2 = x, y.contiguous()
            yard = {"dot": _device_ms(lambda: torch.dot(v1, v2)),
                    "norm": _device_ms(lambda: torch.linalg.vector_norm(v1))}
            log(f"[K6r] 129^3 yardstick (torch, f64): torch.dot "
                f"{yard['dot'] * 1e3:.2f} us, torch.linalg.vector_norm "
                f"{yard['norm'] * 1e3:.2f} us; one launch per K6r call")
            ms, plain, bound = times["stacked pair"]
            rows["dw_reduce"] = {"max_abs_err": float(err.max()), "ms": ms,
                                 "plain_ms": plain, "bound_ms": bound,
                                 "library_ms": yard["dot"]}
            for label, ops in cases.items():
                mode = label.split(",")[0]
                if label != mode and mode != "dwrr":
                    continue
                moved = sum(twofloat.UPDATE_MODES[mode][::2]) \
                    - (4 if label != mode else 0)
                ms = _device_ms(lambda: twofloat.dw_update(mode, *ops))
                plain = _device_ms(
                    lambda: twofloat.dw_update_plain(mode, *ops), 3)
                bound = _field_ms(moved, n)
                log(f"[K6u] 129^3 {label}: kernel {ms * 1e3:.2f} us, plain "
                    f"{plain:.4f} ms, bound {bound * 1e3:.2f} us ({moved} "
                    f"fields once): {100 * bound / ms:.1f}% of it")
                if mode == "cg":
                    rows["dw_update"] = {"max_abs_err": worst, "ms": ms,
                                         "plain_ms": plain,
                                         "bound_ms": bound}
        del x, y, xh, xl, yh, yl, z, pair, f, cases
        torch.cuda.empty_cache()
    return rows


def _k7_pairs():
    """(dim, 1D prolongation) of every transfer the paths apply:
    the level pairs of the 128^3 hierarchy, 513^2 <-> 257^2, and the level
    pairs of phase 17's periodic hierarchy (wrapped rows)."""
    pairs = [(3, prolongation_interior_1d(n_el // 2, 3))
             for n_el in K7_LEVELS]
    pairs.append((2, prolongation_interior_1d(256, 3)))
    pairs += [(3, prolongation_periodic_1d(n_el // 2, 3))
              for n_el in PERIODIC_LEVELS[:-1]]
    return pairs


def _matmul_transfer(Ps, x, add=None):
    """The library yardstick of K7: the tensor-product transfer by one
    torch.matmul per axis with the dense 1D transfer (and one add)."""
    for a, P in enumerate(Ps):
        shape = list(x.shape)
        if a == x.ndim - 1:
            x = torch.matmul(x, P.T)
        else:
            lead = math.prod(shape[:a])
            x = torch.matmul(P, x.reshape(lead, shape[a], -1)).reshape(
                shape[:a] + [P.shape[0]] + shape[a + 1:])
    return x if add is None else x + add


def _k7_times(label, P, res, pro, xf, xc, dtype):
    """Device times of K7, its plain version and the matmul yardstick for
    one level pair, with the byte bound; the yardstick within 1e-5 of the
    kernel's largest value (f32, no TF32) or 2^-6 (bf16: other roundings)."""
    d = xf.ndim
    dense = {"restrict": torch.as_tensor(np.ascontiguousarray(P.T),
                                         device=xf.device).to(dtype),
             "prolong+add": torch.as_tensor(P, device=xf.device).to(dtype)}
    runs = {"restrict": (lambda: k7.apply_transfer(res, xf),
                         lambda: k7.apply_transfer_plain(res, xf),
                         lambda: _matmul_transfer((dense["restrict"],) * d,
                                                  xf)),
            "prolong+add": (
                lambda: k7.apply_transfer(pro, xc, add=xf),
                lambda: k7.apply_transfer_plain(pro, xc, add=xf),
                lambda: _matmul_transfer((dense["prolong+add"],) * d, xc,
                                         add=xf))}
    size = xf.element_size()
    rows = {}
    for kind, (kernel, plain, library) in runs.items():
        got, lib = kernel().float(), library().float()
        rel = float((got - lib).abs().max() / got.abs().max())
        assert rel <= (2.0 ** -6 if dtype == BF16 else 1e-5), (label, kind,
                                                                rel)
        ms, pl, lm = (_device_ms(kernel), _device_ms(plain, 5),
                      _device_ms(library))
        fields = {"restrict": xf.numel() + res[0].n_out ** d,
                  "prolong+add": xc.numel() + 2 * xf.numel()}[kind]
        bound = fields * size / HBM_BYTES_PER_S * 1e3
        log(f"[K7{'' if dtype != BF16 else ' bf16'}] {label} {kind} (one "
            f"launch, widths {res[0].width}/{pro[0].width}): kernel "
            f"{ms * 1e3:.2f} us, plain {pl:.4f} ms, {d} torch.matmul"
            f"{' + add' if kind != 'restrict' else ''} {lm * 1e3:.2f} us, "
            f"bound {bound * 1e3:.2f} us (bytes): {100 * bound / ms:.1f}% "
            f"of it")
        rows[kind] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": pl,
                      "bound_ms": bound, "library_ms": lm}
    return rows


def phase_k7(dev):
    """K7 against the plain gathers: bit-equal at every level pair of the
    headline hierarchy, in 2D and at every level pair of the periodic
    hierarchy, both dtypes, one launch per transfer; times beside the
    matmul yardstick at 129^3 <-> 65^3 and at the periodic 128^3 <-> 64^3."""
    g = torch.Generator(device="cpu").manual_seed(7)
    row = {}
    for d, P in _k7_pairs():
        nf, nc = P.shape
        for dtype in (torch.float32, torch.float64):
            pro = tuple(k7.bands_from_dense(P, dtype, dev) for _ in range(d))
            res = tuple(k7.bands_from_dense(P.T, dtype, dev)
                        for _ in range(d))
            xf = torch.randn((nf,) * d, generator=g,
                             dtype=torch.float64).to(dev).to(dtype)
            xc = torch.randn((nc,) * d, generator=g,
                             dtype=torch.float64).to(dev).to(dtype)
            runs = {"restrict": (lambda: k7.apply_transfer(res, xf),
                                 lambda: k7.apply_transfer_plain(res, xf)),
                    "prolong+add": (
                        lambda: k7.apply_transfer(pro, xc, add=xf),
                        lambda: k7.apply_transfer_plain(pro, xc, add=xf))}
            for label, (kernel, plain) in runs.items():
                before = k7.apply_transfer.launches
                got = kernel()
                torch.cuda.synchronize()
                assert k7.apply_transfer.launches == before + 1, label
                want = plain()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"K7 {label} is not bit-equal to plain at {nf}^{d} "
                        f"{dtype}: {float((got - want).abs().max())}")
            log(f"[K7] {nf}^{d} <-> {nc}^{d} {dtype}, widths "
                f"{res[0].width}/{pro[0].width}"
                f"{' (wrapped)' if res[0].wrap else ''}: restriction and "
                f"prolongation (+ add) bit-equal to plain, one launch each")
            if nf in (129, 128) and d == 3 and (
                    dtype == torch.float32 or nf == 129):
                name = "f32" if dtype == torch.float32 else "f64"
                rows = _k7_times(f"{nf}^3 <-> {nc}^3 {name}", P, res, pro,
                                 xf, xc, dtype)
                if nf == 129 and dtype == torch.float32:
                    row = rows["restrict"]
    return row


def _solver(n_el, levels, dev):
    prob = poisson_problem(3, n_el, degree=HEADLINE["degree"],
                           dtype=torch.float64, device=dev, operator="kron")
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SmootherConfig("chebyshev", cheb_fraction=16.0,
                                              cheb_degree=4))
    pcg = MGPreconditionedCG(prob, num_levels=levels, cfg=cfg, mixed=True,
                             operator="kron", precision="dw")
    return prob, pcg


def _short(counts):
    """The launch counters without the banded engines' (unused here)."""
    return {k: v for k, v in counts.items()
            if not k.startswith("stencil") and (v or "@" not in k)}


NEW_KERNELS = ("dw_reduce", "dw_update", "transfer")


def phase_solve(dev):
    h = HEADLINE
    torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    prob, pcg = _solver(h["n_el"], h["levels"], dev)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    setup = counters.snapshot()
    t1 = time.perf_counter()
    res = pcg.solve(tol=h["tol"], maxiter=h["maxiter"])
    torch.cuda.synchronize()
    first = time.perf_counter() - t1
    solve = counters.diff(counters.snapshot(), setup)
    x = res.x.interior
    assert tuple(x.shape) == prob.space.npts and bool(torch.isfinite(x).all())
    log(f"[solve] 129^3 dw-PCG: {res.iterations} iterations, converged="
        f"{res.converged}, history {['%.3e' % r for r in res.residuals]}")
    assert res.converged, res.residuals
    assert res.iterations <= 9, res.iterations
    # the counts of the solve, read before the f64 check below applies A
    missing = [k for k in ("kron_mode.cheb", "kron_mode.residual",
                           "residual_kron_df", *NEW_KERNELS)
               if not solve.get(k, 0) > 0]
    assert not missing, f"the solve missed kernels of its path: {missing}"
    assert solve.get("kron_mode.apply", 0) == 0, \
        f"the solve applied A and subtracted, outside the kernel: {solve}"
    assert setup["kron_mode.dinv"] > 0, \
        f"the power iteration missed K1: {setup}"
    # one eager step more, alone, for the launches per iteration
    state, _, step, _, _ = pcg._start(prob.b)
    torch.cuda.synchronize()
    before = counters.snapshot()
    step(*state)
    torch.cuda.synchronize()
    per_it = counters.diff(counters.snapshot(), before)
    warm = pcg.solve(tol=h["tol"], maxiter=h["maxiter"])
    eager_ms = float(np.median(warm.wall_times)) * 1e3
    # the graph path: the first call captures, the second is timed
    _, rn, it = pcg.solve_compiled(tol=h["tol"], maxiter=h["maxiter"])
    assert float(rn) == res.residuals[-1] and it == res.iterations, \
        (float(rn), it)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    xg, rn, it = pcg.solve_compiled(tol=h["tol"], maxiter=h["maxiter"])
    torch.cuda.synchronize()
    replayed = time.perf_counter() - t2
    graph = pcg._graphs["dw"]
    assert graph.replays == 2 * it, (graph.replays, it)
    assert torch.equal(xg.interior, x), "the replayed solve left the eager one"
    launches = counters.snapshot()
    alone_ms = _replay_alone_ms(pcg)
    # the answer certified in f64: K1's apply mode, the last step of the path
    true_rn = float(torch.linalg.vector_norm(
        prob.b.interior - prob.A.dot(res.x).interior))
    launches["kron_mode.apply"] = counters.snapshot()["kron_mode.apply"]
    l2 = l2_error_manufactured(prob, res.x)
    log(f"[solve] final |r| {res.residuals[-1]:.3e}, true f64 |b - Ax| "
        f"{true_rn:.3e} (K1 f64), L2 error vs manufactured {l2:.3e}")
    assert true_rn <= 5e-10, true_rn
    log(f"[solve] cold setup (hierarchy + lambda) {cold:.3f} s; first solve "
        f"{first:.3f} s; eager {eager_ms:.3f} ms/iteration (median of a "
        f"warm solve, one ||r|| read each); graph-replayed solve "
        f"{replayed * 1e3:.2f} ms = {replayed / it * 1e3:.3f} ms/iteration "
        f"over {it} iterations (start state included); ten replays alone "
        f"{alone_ms:.3f} ms each")
    log(f"[solve] launches: setup {_short(setup)}; first solve "
        f"{_short(solve)}; one eager iteration {per_it} = "
        f"{sum(v for k, v in per_it.items() if k != 'kron_apply')} launcher "
        f"calls; one graph replay counts the launches its capture recorded: "
        f"{graph.captured}")
    return {"launches": launches, "l2": l2, "iterations": it,
            "replayed_ms": alone_ms}


def phase_defect(dev):
    """This slice's path at full width: the defect-correction solver in both
    residual modes and the residual-replacement PCG; returns the launches."""
    h = HEADLINE
    cfg = CycleConfig(nu1=1, nu2=1,
                      smoother=SmootherConfig("chebyshev", cheb_fraction=32.0,
                                              cheb_degree=4))
    counters.reset()
    prob = poisson_problem(3, h["n_el"], degree=h["degree"],
                           dtype=torch.float64, device=dev, operator="kron")

    def true_residual(x):
        return float(torch.linalg.vector_norm(
            prob.b.interior - prob.A.dot(x).interior))

    mg = MixedPrecisionMG(prob, h["levels"], cfg, operator="kron",
                          residual="twofloat")
    res = mg.solve(tol=h["tol"], maxiter=60)
    torch.cuda.synchronize()
    log(f"[defect] 129^3 twofloat defect correction, Chebyshev(4) over "
        f"[lmax/32, lmax]: {res.iterations} corrections (the JAX package "
        f"recorded {REFERENCE_COUNTS['twofloat']}), converged="
        f"{res.converged}, history {['%.3e' % r for r in res.residuals]}")
    assert res.converged, res.residuals
    eager_ms = float(np.median(res.wall_times[1:])) * 1e3
    _, rn, it = mg.solve_compiled(tol=h["tol"], maxiter=60)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xg, rn, it = mg.solve_compiled(tol=h["tol"], maxiter=60)
    torch.cuda.synchronize()
    replayed = time.perf_counter() - t0
    assert it == res.iterations and float(rn) == res.residuals[-1], \
        (it, float(rn))
    assert float(rn) <= h["tol"]
    assert tuple(xg.interior.shape) == prob.space.npts
    assert torch.equal(xg.interior, res.x.interior)
    true_rn = true_residual(xg)
    l2 = l2_error_manufactured(prob, xg)
    assert true_rn <= 5e-10, true_rn
    f32_run = {"iterations": it, "replayed_ms": _replay_alone_ms(mg)}
    log(f"[defect] solve and solve_compiled: {it} corrections each, the "
        f"same bits; |r| {float(rn):.3e}, true f64 |b - Ax| {true_rn:.3e}, "
        f"L2 error {l2:.3e}; eager {eager_ms:.3f} ms/correction, "
        f"graph-replayed {replayed / it * 1e3:.3f} ms/correction; one replay "
        f"counts {mg._graphs['twofloat'].captured}")
    del mg, res, xg
    torch.cuda.empty_cache()

    mg = MixedPrecisionMG(prob, h["levels"], cfg, operator="kron",
                          residual="f64")
    x64, rn, it = mg.solve_compiled(tol=h["tol"], maxiter=60)
    true_rn = true_residual(x64)
    log(f"[defect] residual='f64' (K1 f64 residual), graph-replayed: {it} "
        f"corrections, |r| {float(rn):.3e}, true {true_rn:.3e}")
    assert float(rn) <= h["tol"] and true_rn <= 5e-10, (float(rn), true_rn)
    del mg, x64
    torch.cuda.empty_cache()

    cfg16 = CycleConfig(nu1=1, nu2=1,
                        smoother=SmootherConfig("chebyshev",
                                                cheb_fraction=16.0))
    rr = MGPreconditionedCG(prob, h["levels"], cfg16, operator="kron",
                            precision="dwrr")
    res = rr.solve(tol=h["tol"], maxiter=60)
    true_rn = true_residual(res.x)
    log(f"[defect] dwrr PCG (f32 A.p through K1, double-word replacement "
        f"every {rr.replace_every}): {res.iterations} iterations (the JAX "
        f"package recorded {REFERENCE_COUNTS['dwrr']}), |r| "
        f"{res.residuals[-1]:.3e}, true f64 {true_rn:.3e}")
    assert res.converged and true_rn <= 5e-10, (res.residuals, true_rn)
    assert res.iterations == REFERENCE_COUNTS["dwrr"], res.iterations
    launches = counters.snapshot()
    missing = [k for k in NEW_KERNELS + ("residual_kron_df",)
               if not launches[k] > 0]
    assert not missing, f"the defect-correction path missed {missing}"
    log(f"[defect] launches of the phase: {_short(launches)}")
    return launches, f32_run


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


def _csr_spmv_ms(band, x_pad, npts, pads, tol=1e-5):
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
    assert rel <= tol, f"the CSR yardstick disagrees with the band: {rel}"
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
    if name == "K2":
        result["levels"] = _k2_level_times(dev, (torch.float32,
                                                 torch.float64))
    r = result["spmv"]
    for who, ms in (("kernel", r["ms"]), ("plain", r["plain_ms"])):
        gbps = nbytes / (ms * 1e-3) / 1e9
        log(f"[{name}] 129^3 p3 f32 spmv {who}: {gbps:.1f} GB/s, "
            f"{nnz / (ms * 1e-3) / 1e9:.2f} Gnnz/s (device time; "
            f"(terms + 2) * points * 4 bytes), {100 * gbps / k4_gbps:.1f}% "
            f"of K4's {k4_gbps:.1f} GB/s")
    return result


K2_LEVELS = (129, 65, 33, 17, 128)   # n^3, p = 3: the banded solvers' levels


def _k2_level_times(dev, dtypes):
    """K2's device time in every mode at every K2_LEVELS shape and each of
    ``dtypes``, beside the byte bound of the dtype (the band, x, the output
    and b once); logs one line a level and dtype."""
    out = {}
    for dtype in dtypes:
        item = torch.empty((), dtype=dtype).element_size()
        name = {torch.float32: "f32", torch.float64: "f64", BF16: "bf16"}[
            dtype]
        for n in K2_LEVELS:
            npts, pads = (n,) * 3, (3,) * 3
            work = torch.float64 if dtype == torch.float64 else torch.float32
            band, x_pad, b = _k2_operands(npts, pads, (False,) * 3, work,
                                          dev, seed=n)
            band, x_pad = band.to(dtype), x_pad.to(dtype)
            b = b.to(dtype).contiguous()
            cells = []
            for mode in MODES:
                kw = dict(b=None if mode == "spmv" else b,
                          omega=0.8 if mode in ("jacobi", "rbgs") else None)
                ms = _device_ms(lambda: stencil_apply(  # noqa: B023
                    mode, band, x_pad, npts, pads, **kw), 10)
                fields = 343 + 2 + (mode != "spmv")
                bound = fields * n ** 3 * item / HBM_BYTES_PER_S * 1e3
                out[name, n, mode] = (ms, bound)
                cells.append(f"{mode} {ms:.4f} ({100 * bound / ms:.0f}%)")
            log(f"[K2 levels] {name} {n}^3 p3, ms (share of the byte bound "
                f"{out[name, n, 'spmv'][1]:.4f} ms): " + ", ".join(cells))
            del band, x_pad, b
            torch.cuda.empty_cache()
    return out


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
    # f64 (the PCG's true-residual pass): K3 and K2 beside the f64 bytes
    for n in (129, 128):
        npts, pads = (n,) * 3, (3,) * 3
        band, x_pad, _ = _k2_operands(npts, pads, (False,) * 3,
                                      torch.float64, dev, seed=n)
        pk = pack_band_v2(band, npts, pads)
        bound = 345 * n ** 3 * 8 / HBM_BYTES_PER_S * 1e3
        for who, fn in (("K3", lambda: stencil_apply_v2(
                "spmv", band, x_pad, npts, pads, packed=pk)),
                        ("K2", lambda: stencil_apply(
                            "spmv", band, x_pad, npts, pads))):
            ms = _device_ms(fn)
            out[(n, who, "f64")] = ms
            log(f"[K3] {n}^3 p3 f64 spmv {who}: device {ms:.4f} ms, bound "
                f"{bound:.4f} ms (bytes): {100 * bound / ms:.1f}% of it")
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
    counters.reset()


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
    eager_ms = float(np.median(res.wall_times[1:])) * 1e3
    # the graph path: the first call captures the step, the second is timed
    pcg.solve_compiled(tol=h["tol"], maxiter=h["maxiter"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _, rn, it = pcg.solve_compiled(tol=h["tol"], maxiter=h["maxiter"])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t2
    assert float(rn) <= h["tol"] and it == res.iterations, (float(rn), it)
    step = _replay_alone_ms(pcg)
    log(f"[banded PCG {name}] replayed step alone (ten replays): "
        f"{step:.3f} ms")
    log(f"[banded PCG {name}] cold setup (band, hierarchy, lambda"
        f"{', packs' if name == 'K3' else ''}) {cold:.3f} s; first solve "
        f"{first:.3f} s, eager {eager_ms:.2f} ms/iteration (median); "
        f"graph-replayed solve {warm:.3f} s = "
        f"{warm / it * 1e3:.2f} ms/iteration (start state included); {name} "
        f"launches {launches}; replayed |r| equals the eager one: "
        f"{float(rn) == res.residuals[-1]}; peak device memory "
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



BF16 = torch.bfloat16
BF16_ULP = 2.0 ** -7          # one bf16 unit in the last place, relative
F32_SUM_ERR = 1e-5            # of max|y|: the f32 sums differ in order
BF16_MAXITER = 400            # a bf16 cycle at 128^3 contracts slowly
PERIODIC_MAXITER = 400        # white-noise b, |b| = 1448; factor 0.85 a cycle


def _csr_bf16_ms(band, x_pad, npts, pads):
    """The CSR product in bf16, if this torch has one: its device time, or
    None with the error on the log."""
    try:
        ms = _csr_spmv_ms(band, x_pad, npts, pads, tol=4 * BF16_ULP)
    except (RuntimeError, NotImplementedError, AssertionError) as exc:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"[K2 bf16] 129^3 p3 spmv as a sparse CSR product in bf16: no "
            f"usable path in torch {torch.__version__}: "
            f"{type(exc).__name__}: {' '.join(str(exc).split())[:240]}")
        return None
    log(f"[K2 bf16] 129^3 p3 spmv as a sparse CSR product in bf16 (torch): "
        f"{ms:.4f} ms")
    return ms


def _bf16_check(what, got, want):
    """A bf16 kernel against its plain version (both f32 arithmetic, one
    rounding): every value within one bf16 unit of the other plus the f32
    sums' error; returns (points that differ, max|d|)."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    bound = (BF16_ULP * torch.maximum(g.abs(), w.abs())
             + F32_SUM_ERR * w.abs().max())
    if got.dtype != BF16 or not bool((d <= bound).all()):
        raise AssertionError(f"{what}: bf16 kernel and plain version "
                             f"disagree, max|d| {float(d.max()):.3e}")
    return int((g != w).sum()), float(d.max())


def phase_stencil_bf16(dev, k4_gbps):
    """K2 and K3 in bf16 against plain at every K2 shape and mode; times at
    129^3 and 128^3 beside the byte bound and K4."""
    rows = {}
    for name in ("K2", "K3"):
        prepare, kernel_fn, plain_fn = _engine(name)
        res = {m: {} for m in MODES}
        for npts, pads, periodic, starts in K2_SHAPES:
            zero = (0,) * len(npts)
            runs = [("spmv", 0, zero), ("residual", 0, zero),
                    ("jacobi", 0, zero), ("rbgs", 0, zero),
                    ("rbgs", 0, starts), ("rbgs", 1, zero)]
            band, x_pad, b = _k2_operands(npts, pads, periodic,
                                          torch.float32, dev, seed=sum(npts))
            band, x_pad = band.to(BF16), x_pad.to(BF16)
            inner = tuple(slice(p, p + n) for n, p in zip(npts, pads))
            b_pad = torch.zeros(x_pad.shape, dtype=BF16, device=dev)
            b_pad[inner] = b.to(BF16)
            b = b_pad[inner]    # a strided view, as in the f32 check
            pk = prepare(band, npts, pads)
            x_int = x_pad[inner]
            differ, total = 0, 0
            for mode, color, st in runs:
                kw = dict(b=None if mode == "spmv" else b,
                          omega=0.8 if mode in ("jacobi", "rbgs") else None,
                          color=color, starts=st)
                y = kernel_fn(mode, band, pk, x_pad, npts, pads, **kw)
                torch.cuda.synchronize()
                want = plain_fn(mode, band, pk, x_pad, npts, pads, **kw)
                n_diff, err = _bf16_check(f"{name} {mode} at {npts}", y, want)
                differ, total = differ + n_diff, total + y.numel()
                if mode == "rbgs":
                    other = ~color_mask(npts, color, st, device=dev)
                    if not torch.equal(y[other], x_int[other]):
                        raise AssertionError(f"{name} bf16 rbgs changed "
                                             f"points of the other colour")
                if npts == (129,) * 3 and st == zero and color == 0:
                    def kernel(mode=mode, kw=kw):
                        return kernel_fn(mode, band, pk, x_pad, npts, pads,
                                         **kw)

                    def plain(mode=mode, kw=kw):
                        return plain_fn(mode, band, pk, x_pad, npts, pads,
                                        **kw)

                    res[mode] = {"max_abs_err": err,
                                 "ms": _device_ms(kernel),
                                 "plain_ms": _device_ms(plain, 3)}
                    if mode == "spmv" and name == "K2":
                        res[mode]["library_ms"] = _csr_bf16_ms(
                            band, x_pad, npts, pads)
                del y, want
            log(f"[{name} bf16] {npts} p={pads} periodic={periodic}: within "
                f"one bf16 unit of plain in every mode; {differ} of {total} "
                f"values differ ({100 * differ / total:.3f}%)")
            if differ > total // 50:
                raise AssertionError(f"{name} bf16: {differ} of {total} "
                                     f"values differ from plain at {npts}")
            del band, pk, x_pad, b, b_pad, x_int
            torch.cuda.empty_cache()
        points = 129 ** 3
        for mode in MODES:
            fields = 343 + 2 + (mode != "spmv")
            bound = fields * points * 2 / HBM_BYTES_PER_S * 1e3
            r = res[mode]
            r["bound_ms"] = bound
            log(f"[{name} bf16] 129^3 p3 {mode}: kernel {r['ms']:.4f} ms, "
                f"plain {r['plain_ms']:.4f} ms, bound {bound:.4f} ms (bytes, "
                f"2-byte items): {100 * bound / r['ms']:.1f}% of it")
        rows[name] = res
    for n in (128, 129):
        npts, pads = (n,) * 3, (3,) * 3
        band, x_pad, _ = _k2_operands(npts, pads, (False,) * 3,
                                      torch.float32, dev, seed=n)
        band, x_pad = band.to(BF16), x_pad.to(BF16)
        pk = pack_band_v2(band, npts, pads)
        fns = {"K3": lambda: stencil_apply_v2("spmv", band, x_pad, npts,
                                               pads, packed=pk),
               "K2": lambda: stencil_apply("spmv", band, x_pad, npts, pads)}
        nbytes, nnz = 345 * n ** 3 * 2, 343 * n ** 3
        for who in ("K3", "K2", "K3", "K2"):
            ms = _device_ms(fns[who])
            gbps = nbytes / (ms * 1e-3) / 1e9
            log(f"[bf16] {n}^3 p3 bf16 spmv {who}: device {ms:.4f} ms; "
                f"{gbps:.1f} GB/s, {nnz / (ms * 1e-3) / 1e9:.2f} Gnnz/s, "
                f"{100 * gbps / k4_gbps:.1f}% of K4 (tile {pk['tile']}, "
                f"lanes to {pk['N'][2]})")
        del band, x_pad, pk
        torch.cuda.empty_cache()
    rows["levels"] = _k2_level_times(dev, (BF16,))
    # the residual pass a banded cycle makes, level by level, f32 and bf16
    for n in (129, 65, 33, 17):
        npts, pads = (n,) * 3, (3,) * 3
        band32, x32, b32 = _k2_operands(npts, pads, (False,) * 3,
                                        torch.float32, dev, seed=n)
        b32 = b32.contiguous()
        ms = {}
        for low in (torch.float32, BF16):
            band, x_pad, b = band32.to(low), x32.to(low), b32.to(low)
            pk = pack_band_v2(band, npts, pads)
            ms["K2", low] = _device_ms(lambda: stencil_apply(
                "residual", band, x_pad, npts, pads, b=b))
            ms["K3", low] = _device_ms(lambda: stencil_apply_v2(
                "residual", band, x_pad, npts, pads, b=b, packed=pk))
        log(f"[bf16] {n}^3 p3 residual pass, f32 / bf16: K2 "
            f"{ms['K2', torch.float32]:.4f} / {ms['K2', BF16]:.4f} ms, K3 "
            f"{ms['K3', torch.float32]:.4f} / {ms['K3', BF16]:.4f} ms")
        del band32, x32, b32, band, x_pad, b, pk
        torch.cuda.empty_cache()
    return rows


def _k1_bf16_against_plain(what, terms, fields, npts, pads, periodic,
                           half_widths=k1.COMPILED_P):
    """Every K1 check on one bf16 operator against the bf16 plain version,
    on the plan ``half_widths`` route it to; returns max|d| per label."""
    x, b, d = fields
    plan = k1.build_kron_plan(terms, npts, pads, periodic,
                              half_widths=half_widths)
    differ, total, errs = 0, 0, {}
    for label, mode, kw in _k1_runs(b, d):
        kw_k = dict(kw)
        if kw.get("d") is not None:
            kw_k["d"] = d.clone()     # the kernel updates d in place
        got = k1.kron_mode(mode, plan, x, **kw_k)
        torch.cuda.synchronize()
        want = k1.kron_mode_plain_bf16(
            mode, plan, x, kw.get("b"), kw.get("d"), kw.get("c1", 0.0),
            kw.get("c2", 1.0))
        if mode != "cheb":
            got, want = (got,), (want,)
        errs[label] = 0.0
        for g, w in zip(got, want):
            n_diff, e = _bf16_check(f"K1 {label} at {what}{npts}", g, w)
            differ, total = differ + n_diff, total + g.numel()
            errs[label] = max(errs[label], e)
    log(f"[K1 bf16] {what}{npts} p={pads} periodic={periodic} terms="
        f"{len(terms)} launches/apply={len(plan.plans)}: every mode "
        f"within one bf16 unit of plain; {differ} of {total} values "
        f"differ ({100 * differ / total:.3f}%)")
    if differ > total // 50:
        raise AssertionError(f"K1 bf16: {differ} of {total} values "
                             f"differ from plain at {what}{npts}")
    return errs


def phase_k1_bf16(dev):
    """K1 in bf16, every mode, against its plain version at the f32 shapes
    and on every level of the periodic hierarchy; times at 129^3 beside the
    byte bounds (2-byte fields)."""
    result = {m: {} for m in k1.MODES}
    shapes = [(npts, (p,) * 3, (per,) * 3, 0) for npts, p, per in K1_SHAPES]
    shapes += [(*case, 0) for case in K1_MORE]
    shapes.append(((20, 21, 22), (2, 2, 2), (False,) * 3, 4))
    for npts, pads, periodic, free in shapes:
        terms, fields = _k1_operands(npts, pads, torch.float32, dev,
                                     sum(npts) + pads[0], free)
        cast = {}
        terms = [[cast.setdefault(id(B), B.to(BF16)) for B in term]
                 for term in terms]
        errs = _k1_bf16_against_plain("", terms,
                                      [f.to(BF16) for f in fields], npts,
                                      pads, periodic)
        if npts == (129,) * 3:
            for mode in k1.MODES:
                result[mode]["max_abs_err"] = errs[mode]
    for npts, terms in _periodic_kron_levels(dev, BF16):
        _k1_bf16_against_plain("periodic shifted operator, level ", terms,
                               _k1_fields(npts, BF16, dev, npts[0]), npts,
                               (3,) * 3, (True,) * 3)
    n = 129
    npts, pads, periodic = (n,) * 3, (3,) * 3, (False,) * 3
    terms, fields = _k1_operands(npts, pads, torch.float32, dev, n)
    cast = {}
    terms = [[cast.setdefault(id(B), B.to(BF16)) for B in term]
             for term in terms]
    x, b, d = (f.to(BF16) for f in fields)
    plan = k1.build_kron_plan(terms, npts, pads, periodic)
    terms32, diag32 = plan.operands_f32()
    out = torch.empty_like(x)
    for label, mode, kw in _k1_runs(b, d):
        if label == "cheb0":
            continue
        ms = _device_ms(lambda: k1.kron_mode(mode, plan, x, out=out, **kw))
        kw32 = {k: v.float() if isinstance(v, torch.Tensor) else v
                for k, v in kw.items()}
        plain = _device_ms(lambda: k1.kron_mode_plain(
            mode, terms32, x.float(), npts, pads, periodic, diag=diag32,
            **kw32), 3)
        bound = K1_FIELDS[mode] * n ** 3 * 2 / HBM_BYTES_PER_S * 1e3
        result[mode].update(ms=ms, plain_ms=plain, bound_ms=bound)
        log(f"[K1 bf16] 129^3 p3 {mode}: kernel {ms * 1e3:.2f} us, plain "
            f"(its f32 arithmetic, casts not counted) {plain:.4f} ms, bound "
            f"{bound * 1e3:.2f} us ({K1_FIELDS[mode]} bf16 fields once): "
            f"{100 * bound / ms:.1f}% of it")
    # the library's computation of the apply on the same bf16 operands:
    # dense per-axis bf16 products (the yardstick of the bf16 row)
    op = KroneckerSumOperator(StencilVectorSpace(
        npts=npts, pads=pads, periodic=periodic, dtype=BF16, device=dev),
        terms)
    result["library_ms"] = _device_ms(lambda: op._apply_interior_matmul(x),
                                      5)
    log(f"[K1 bf16] 129^3 p3 apply as dense bf16 per-axis products "
        f"(_apply_interior_matmul, torch.tensordot): "
        f"{result['library_ms']:.4f} ms")
    return result


def phase_k7_bf16(dev):
    """K7 in bf16: bit-equal to plain at every level pair; times at
    129^3 <-> 65^3."""
    g = torch.Generator(device="cpu").manual_seed(8)
    row = {}
    for d, P in _k7_pairs():
        nf, nc = P.shape
        pro = tuple(k7.bands_from_dense(P, BF16, dev) for _ in range(d))
        res = tuple(k7.bands_from_dense(P.T, BF16, dev) for _ in range(d))
        xf = torch.randn((nf,) * d, generator=g).to(dev).to(BF16)
        xc = torch.randn((nc,) * d, generator=g).to(dev).to(BF16)
        runs = {"restrict": (lambda: k7.apply_transfer(res, xf),
                             lambda: k7.apply_transfer_plain(res, xf)),
                "prolong+add": (
                    lambda: k7.apply_transfer(pro, xc, add=xf),
                    lambda: k7.apply_transfer_plain(pro, xc, add=xf))}
        for label, (kernel, plain) in runs.items():
            got = kernel()
            torch.cuda.synchronize()
            if got.dtype != BF16 or not torch.equal(got, plain()):
                raise AssertionError(f"K7 bf16 {label} is not bit-equal to "
                                     f"plain at {nf}^{d}")
        if nf == 129:
            row = _k7_times(f"{nf}^3 <-> {nc}^3", P, res, pro, xf, xc,
                            BF16)["restrict"]
        log(f"[K7 bf16] {nf}^{d} <-> {nc}^{d}, widths {res[0].width}/"
            f"{pro[0].width}: restriction and prolongation (+ add) bit-equal "
            f"to plain")
    return row


def phase_k5_four(dev):
    """K5's 4-history launch on the periodic shifted 3D operator: bit-equal
    to plain; device time at 128^3."""
    result = {}
    for n_el, p in ((128, 3), (32, 3), (16, 2)):
        prob = periodic_problem(3, n_el, degree=p, device=dev)
        A = _kron_periodic(prob.bands_1d, prob.shift, prob.space)
        split = {id(B): split_f64(B) for term in A.terms for B in term}
        tdf = [[split[id(B)] for B in term] for term in A.terms]
        labels = A._band_labels()
        sp = prob.space
        plan = twofloat.build_kron_df_plan(tdf, sp.npts, sp.pads, sp.periodic,
                                           labels)
        counts = [len(k1.sharing_plan(plan.labels)[k])
                  for k in ("u_lab", "v_src", "w_src", "term_w")]
        assert counts == [2, 3, 4, 4], counts
        g = torch.Generator(device="cpu").manual_seed(n_el)
        x = torch.randn(sp.npts, generator=g, dtype=torch.float64).to(dev)
        (xh, xl), (bh, bl) = split_f64(x), split_f64(prob.b.interior)
        zero = torch.zeros_like(xh)
        for flags, explicit in (((bh, bl, xh, xl), (bh, bl, xh, xl)),
                                ((None, None, xh, None),
                                 (zero, zero, xh, zero))):
            got = twofloat.residual_kron_df(tdf, *flags, sp.pads, labels,
                                            sp.periodic, plan=plan)
            torch.cuda.synchronize()
            want = twofloat.residual_kron_df_plain(tdf, *explicit, sp.pads,
                                                   labels, sp.periodic)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"K5 (4 histories) is not bit-equal to "
                                     f"plain at {sp.npts}")
        r64 = prob.b.interior - prob.A.dot(
            StencilVector.from_interior(sp, x)).interior
        rel = float((twofloat.merge_f64(*twofloat.residual_kron_df(
            tdf, bh, bl, xh, xl, sp.pads, labels, sp.periodic, plan=plan))
            - r64).abs().max() / r64.abs().max())
        log(f"[K5 4h] periodic {sp.npts} p{p}, partials {counts}: bit-equal "
            f"to plain with b, x_l given and with the zero flags; against "
            f"the f64 banded residual {rel:.2e}")
        assert rel <= 1e-12, rel
        if n_el == 128:
            def kernel():
                return twofloat.residual_kron_df(
                    tdf, None, None, xh, None, sp.pads, labels, sp.periodic,
                    plan=plan)

            def plain():
                return twofloat.residual_kron_df_plain(
                    tdf, zero, zero, xh, zero, sp.pads, labels, sp.periodic)

            # 9 contractions of 7 taps (2 u, 3 v, 4 histories), 3 term adds
            # and b - Ax; p in, two words out
            ops = (9 * (7 * 9 + 6 * 20) + 4 * 20) * n_el ** 3
            result = {"max_abs_err": 0.0, "ms": _device_ms(kernel),
                      "plain_ms": _device_ms(plain, 2),
                      "bound_ms": ops / F32_OPS * 1e3}
            res = twofloat.k5_resources(plan)
            log(f"[K5 4h] periodic 128^3 p3 A.p: kernel {result['ms']:.4f} "
                f"ms, plain {result['plain_ms']:.4f} ms; bound (operations, "
                f"{ops // n_el ** 3} per point at {F32_OPS / 1e12:.1f} T a "
                f"second) {result['bound_ms']:.4f} ms: "
                f"{100 * result['bound_ms'] / result['ms']:.1f}% of it; "
                f"tiles {plan.tiling}, {res['registers']} registers, "
                f"{res['local_bytes']} bytes spilled, {res['blocks_per_sm']} "
                f"blocks an SM")
        del prob, A, tdf, plan
        torch.cuda.empty_cache()
    return result


def _replay_alone_ms(solver):
    """The captured step alone: ten more replays of the solver's one graph,
    one ||r|| read each as in the solve loop (past convergence; the next
    solve reloads the state)."""
    (graph,) = solver._graphs.values()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        float(graph.replay())
    return (time.perf_counter() - t0) / 10 * 1e3


def _solve_both_ways(label, solver, true_residual, maxiter=60):
    """solve, then solve_compiled (captures the step and replays it to the
    tolerance): converged, equal counts and bits, a true f64 residual <=
    5e-10; the replayed step is timed alone afterwards; returns (iterations,
    ms per replayed step, launches of the eager solve)."""
    tol = HEADLINE["tol"]
    torch.cuda.synchronize()
    before = counters.snapshot()
    res = solver.solve(tol=tol, maxiter=maxiter)
    torch.cuda.synchronize()
    grown = counters.diff(counters.snapshot(), before)
    assert res.converged, (label, res.residuals)
    x = res.x.interior
    assert bool(torch.isfinite(x).all())
    xg, rn, it = solver.solve_compiled(tol=tol, maxiter=maxiter)
    torch.cuda.synchronize()
    assert it == res.iterations and float(rn) == res.residuals[-1], \
        (label, it, res.iterations, float(rn), res.residuals[-1])
    assert torch.equal(xg.interior, x), f"{label}: replayed left eager"
    replayed = _replay_alone_ms(solver)
    true_rn = true_residual(res.x)
    assert true_rn <= 5e-10, (label, true_rn)
    eager = float(np.median(res.wall_times[1:])) * 1e3
    log(f"[{label}] {res.iterations} steps, |r| {res.residuals[-1]:.3e}, "
        f"true f64 |b - Ax| {true_rn:.3e}; eager {eager:.3f} ms/step, "
        f"graph-replayed {replayed:.3f} ms/step (ten replays alone), the "
        f"same bits")
    return res.iterations, replayed, grown


def _low_is_bf16(label, grown, names):
    """Over a solve the low hierarchy launched the bf16 instantiations of
    ``names`` and never the f32 ones."""
    f32 = {k: v for k, v in grown.items() if k.endswith("@f32")
           and k.split(".")[0].split("@")[0] in names}
    bf16 = sum(v for k, v in grown.items() if k.endswith("@bf16")
               and k.split(".")[0].split("@")[0] in names)
    assert not f32, f"{label}: f32 kernels ran on the bf16 hierarchy: {f32}"
    assert bf16 > 0, f"{label}: no bf16 kernel launched: {grown}"


def phase_bf16_solves(dev, f32_defect, f32_pcg):
    """The bf16 paths at full width, each beside its f32 run."""
    h = HEADLINE
    cfg32 = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=32.0, cheb_degree=4))
    cfg16 = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0, cheb_degree=4))
    counters.reset()
    prob = poisson_problem(3, h["n_el"], degree=h["degree"],
                           dtype=torch.float64, device=dev, operator="kron")

    def true_kron(x):
        return float(torch.linalg.vector_norm(
            prob.b.interior - prob.A.dot(x).interior))

    mg = MixedPrecisionMG(prob, h["levels"], cfg32, operator="kron",
                          residual="twofloat", low_dtype=BF16)
    it, ms, grown = _solve_both_ways("bf16 twofloat", mg, true_kron,
                                     BF16_MAXITER)
    _low_is_bf16("bf16 twofloat", grown, ("kron_mode", "transfer"))
    log(f"[bf16 twofloat] kron defect correction, Chebyshev(4) over "
        f"[lmax/32, lmax]: bf16 {it} corrections at {ms:.3f} ms replayed; "
        f"f32 {f32_defect['iterations']} at "
        f"{f32_defect['replayed_ms']:.3f} ms; launches of the eager solve "
        f"{_short(grown)}")
    del mg
    torch.cuda.empty_cache()
    pcg = MGPreconditionedCG(prob, h["levels"], cfg16, mixed=True,
                             operator="kron", precision="dw", low_dtype=BF16)
    it, ms, grown = _solve_both_ways("bf16 dw-PCG", pcg, true_kron,
                                     BF16_MAXITER)
    _low_is_bf16("bf16 dw-PCG", grown, ("kron_mode", "transfer"))
    log(f"[bf16 dw-PCG] kron dw-PCG with a bf16 preconditioner: bf16 {it} "
        f"iterations at {ms:.3f} ms replayed; f32 {f32_pcg['iterations']} "
        f"at {f32_pcg['replayed_ms']:.3f} ms")
    kron_launches = counters.snapshot()
    del pcg, prob
    torch.cuda.empty_cache()

    # the banded defect correction, f32 and bf16 cycles, K2 then K3
    banded = {}
    before = os.environ.get("POMS_TPU_SPMV")
    try:
        for name in ("K2", "K3"):
            if name == "K3":
                os.environ["POMS_TPU_SPMV"] = "v2"
            else:
                os.environ.pop("POMS_TPU_SPMV", None)
            prob = poisson_problem(3, h["n_el"], degree=h["degree"],
                                   dtype=torch.float64, device=dev)

            def true_banded(x):
                return float(torch.linalg.vector_norm(
                    prob.b.interior - prob.A.dot(x).interior))

            wrapper = "stencil_apply" if name == "K2" else "stencil_apply_v2"
            other = "stencil_apply_v2" if name == "K2" else "stencil_apply"
            runs = {}
            for low in (torch.float32, BF16):
                counters.reset()
                mg = MixedPrecisionMG(prob, h["levels"], cfg32,
                                      operator="banded", residual="f64",
                                      low_dtype=low)
                label = (f"banded {'bf16' if low == BF16 else 'f32'} "
                         f"{name}")
                runs[low] = _solve_both_ways(label, mg, true_banded,
                                             BF16_MAXITER)
                grown = runs[low][2]
                assert not any(v for k, v in grown.items()
                               if k.startswith(other + ".")), grown
                assert grown[f"{wrapper}.residual@f64"] > 0, grown
                if low == BF16:
                    _low_is_bf16(label, grown, (wrapper, "transfer"))
                    banded[name] = counters.snapshot()
                del mg
                torch.cuda.empty_cache()
            log(f"[bf16 banded {name}] defect correction, residual='f64', "
                f"Chebyshev(4) over [lmax/32, lmax]: bf16 "
                f"{runs[BF16][0]} corrections at {runs[BF16][1]:.3f} ms "
                f"replayed; f32 {runs[torch.float32][0]} at "
                f"{runs[torch.float32][1]:.3f} ms")
            # the jacobi and rbgs modes in bf16 on a solver path (the same
            # problem: above 10^6 points the coarse operators come from the
            # 1D triple products, below it from a host SpGEMM that takes
            # half a minute at 65^3)
            for kind, omega in (("jacobi", None), ("rbgs", 1.0)):
                mg = MixedPrecisionMG(
                    prob, h["levels"], CycleConfig(
                        nu1=2, nu2=2, smoother=SmootherConfig(kind, omega)),
                    operator="banded", residual="f64", low_dtype=BF16)
                res = mg.solve(tol=h["tol"], maxiter=3)
                assert all(b < a for a, b in zip(res.residuals,
                                                 res.residuals[1:])), \
                    (kind, res.residuals)
                log(f"[bf16 banded {name}] 129^3 {kind}-smoothed bf16 "
                    f"cycles: residuals "
                    f"{['%.3e' % r for r in res.residuals]}")
                del mg
            now = counters.snapshot()
            for kind in ("jacobi", "rbgs"):
                assert now[f"{wrapper}.{kind}@bf16"] > 0, now
                banded[name][f"{wrapper}.{kind}@bf16"] = \
                    now[f"{wrapper}.{kind}@bf16"]
            del prob
            torch.cuda.empty_cache()
    finally:
        if before is None:
            os.environ.pop("POMS_TPU_SPMV", None)
        else:
            os.environ["POMS_TPU_SPMV"] = before
    return {"kron": kron_launches, "K2": banded["K2"], "K3": banded["K3"]}


def phase_periodic(dev):
    """Periodic shifted problem at 128^3 p3, 5 levels: kron twofloat defect
    correction, kron dw-PCG, one banded f64-mixed PCG; K7 on the wide
    periodic transfers."""
    h = HEADLINE
    cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0, cheb_degree=4))
    counters.reset()
    prob = periodic_problem(3, h["n_el"], degree=h["degree"], shift=1.0,
                            device=dev)

    def true_residual(x):
        return float(torch.linalg.vector_norm(
            prob.b.interior - prob.A.dot(x).interior))

    mg = MixedPrecisionMG(prob, h["levels"], cfg, operator="kron",
                          residual="twofloat")
    tb = mg.levels64[0].prolong[0]
    log(f"[periodic] 128^3 p3 shift 1, {h['levels']} levels (coarsest "
        f"{mg.levels64[-1].A.space.npts}); transfer widths "
        f"{mg.levels64[0].restrict[0].width}/{tb.width} (wrapped: "
        f"{tb.wrap}); K1 "
        f"launches per pass {len(mg.levels64[0].A.plan.plans)}")
    it, ms, grown = _solve_both_ways("periodic twofloat", mg, true_residual,
                                     PERIODIC_MAXITER)
    assert grown["residual_kron_df"] > 0 and grown["kron_mode.cheb"] > 0
    log(f"[periodic] kron twofloat defect correction: {it} corrections at "
        f"{ms:.3f} ms replayed; launches of the eager solve {_short(grown)}")
    # K7 on the periodic transfers of the top level pair
    lev = mg.levels32[0]
    g = torch.Generator(device="cpu").manual_seed(9)
    xf = torch.randn((128,) * 3, generator=g).to(dev)
    xc = torch.randn((64,) * 3, generator=g).to(dev)
    wide = {}
    for label, fn, plain in (
            ("restrict", lambda: k7.apply_transfer(lev.restrict, xf),
             lambda: k7.apply_transfer_plain(lev.restrict, xf)),
            ("prolong+add", lambda: k7.apply_transfer(lev.prolong, xc,
                                                      add=xf),
             lambda: k7.apply_transfer_plain(lev.prolong, xc, add=xf))):
        assert torch.equal(fn(), plain()), f"K7 periodic {label}"
        wide[label] = _device_ms(fn)
        log(f"[periodic] K7 128^3 <-> 64^3 {label}, W = "
            f"{lev.restrict[0].width}/{lev.prolong[0].width} taps: "
            f"{wide[label]:.4f} ms (bit-equal to plain)")
    del mg, lev
    torch.cuda.empty_cache()
    pcg = MGPreconditionedCG(prob, h["levels"], cfg, mixed=True,
                             operator="kron", precision="dw")
    it, ms, grown = _solve_both_ways("periodic dw-PCG", pcg, true_residual,
                                     PERIODIC_MAXITER)
    assert grown["residual_kron_df"] > 0
    log(f"[periodic] kron dw-PCG: {it} iterations at {ms:.3f} ms replayed")
    launches = counters.snapshot()
    del pcg
    torch.cuda.empty_cache()
    pcg = MGPreconditionedCG(prob, h["levels"], cfg, mixed=True,
                             operator="banded", precision="f64")
    it, ms, grown = _solve_both_ways("periodic banded", pcg, true_residual,
                                     PERIODIC_MAXITER)
    assert grown["stencil_apply.residual@f32"] > 0, grown
    assert grown["stencil_apply.spmv@f64"] > 0, grown
    log(f"[periodic] banded f64-mixed PCG (K2, wrapped ghosts): {it} "
        f"iterations at {ms:.3f} ms replayed")
    return launches


def _dist_check(what, got, want, tol, scale=None):
    """One rank-side check: the relative error of ``got`` against ``want``
    (of ``scale``, else of max|want|) within ``tol`` (0: the same bits)."""
    err = float((got - want).abs().max())
    ref = float(want.abs().max() if scale is None else scale)
    rel = err / ref if ref else err
    if tol == 0.0 and not torch.equal(got, want):
        raise AssertionError(f"{what} is not bit-equal to plain: {err}")
    if not (math.isfinite(rel) and rel <= tol):
        raise AssertionError(f"{what} disagrees with plain: {rel} > {tol}")
    return rel


def _dist_kernel_checks(mg):
    """On this rank, after its solve: every kernel of the distributed path
    against its plain version on this rank's operands, at the shapes the
    path gives it.  K2 (or K3 under v2) spmv and both RB-GS colours with the
    rank's global starts on every distributed level's block, in each dtype
    the solver holds (the other colour bit-equal to x); each face band of
    the overlap form on its window of the exchanged block; K7 on every
    distributed level pair (restriction, prolongation + add) over the
    exchanged block, and on the agglomerated tail's pair; with the twofloat
    residual, K6r's norm and K6u's div and defect on the finest block.
    Fields are seeded per rank.  The exchanges are collectives, so every
    rank runs this.  Returns {what: relative error} (0.0: bit-equal)."""
    from poms_tpu_torch.ops import dispatch
    from poms_tpu_torch.parallel.halo import local_starts, pad_and_exchange
    from poms_tpu_torch.parallel.transfers import rank_transfer_operands

    name = "K3" if dispatch.engine() is stencil_apply_v2 else "K2"
    _, kernel_fn, plain_fn = _engine(name)
    dev = mg.b.interior.device
    g = torch.Generator(device=dev).manual_seed(18 + mg.grid.rank)
    out = {}

    def field(shape, dtype):
        return torch.randn(tuple(shape), generator=g, dtype=torch.float64,
                           device=dev).to(dtype)

    hs = [mg._h] + ([mg._h_lo] if mg._h_lo is not mg._h else [])
    for h in hs:
        for l, lv in enumerate(h.levels):
            spec, dtype = lv.spec, lv.diag.dtype
            n_loc, pads = spec.n_loc, spec.pads
            tag = f"{tuple(n_loc)} {str(dtype)[6:]}"
            x = field(n_loc, dtype)
            if lv.labels is None:
                tol = K1_TOL[dtype]
                x_pad = pad_and_exchange(x, spec)
                b = field(n_loc, dtype)
                starts = local_starts(spec)
                y = kernel_fn("spmv", lv.band, lv.packed, x_pad, n_loc, pads)
                out[f"{name} spmv {tag}"] = _dist_check(
                    f"{name} spmv {tag}", y, plain_fn(
                        "spmv", lv.band, lv.packed, x_pad, n_loc, pads), tol)
                for color in (0, 1):
                    kw = dict(b=b, omega=mg.cfg.smoother.omega or 1.0,
                              color=color, starts=starts)
                    what = f"{name} rbgs c{color} starts {starts} {tag}"
                    y = kernel_fn("rbgs", lv.band, lv.packed, x_pad, n_loc,
                                  pads, **kw)
                    out[what] = _dist_check(what, y, plain_fn(
                        "rbgs", lv.band, lv.packed, x_pad, n_loc, pads,
                        **kw), tol)
                    other = ~color_mask(n_loc, color, starts, device=dev)
                    if not torch.equal(y[other], x[other]):
                        raise AssertionError(f"{what} changed points of the "
                                             "other colour")
                x_ghost = x_pad.clone()
                x_ghost[tuple(slice(p, p + n) for p, n in
                              zip(pads, n_loc))] = 0
                for rows, band, pk in lv.faces or ():
                    shape = tuple(r.stop - r.start for r in rows)
                    xw = x_ghost[tuple(slice(r.start, r.stop + 2 * p)
                                       for r, p in zip(rows, pads))]
                    what = f"{name} spmv face {shape} {str(dtype)[6:]}"
                    err = _dist_check(
                        what, kernel_fn("spmv", band, pk, xw, shape, pads),
                        plain_fn("spmv", band, pk, xw, shape, pads), tol)
                    out[what] = max(out.get(what, 0.0), err)
            if l + 1 < len(h.levels):
                meta, coarse = mg.dist[l], h.levels[l + 1].spec
                xc = field(coarse.n_loc, dtype)
                for what, tbs, src, axes, add in (
                        ("restrict", meta.restrict, x, spec.axes, None),
                        ("prolong+add", meta.prolong, xc, coarse.axes, x)):
                    bands, src_pad = rank_transfer_operands(tbs, src, axes,
                                                            mg.grid)
                    what = f"K7 {what} {tuple(src.shape)} {str(dtype)[6:]}"
                    out[what] = _dist_check(
                        what, k7.apply_transfer(bands, src_pad, add=add),
                        k7.apply_transfer_plain(bands, src_pad, add=add), 0.0)
        last = mg.dist[-1].npts
        r_int = field(last, h.levels[0].diag.dtype)
        what = f"K7 tail restrict {tuple(last)} {str(r_int.dtype)[6:]}"
        out[what] = _dist_check(
            what, k7.apply_transfer(h.tail_restrict, r_int),
            k7.apply_transfer_plain(h.tail_restrict, r_int), 0.0)
    if mg.twofloat:
        n0 = mg.dist[0].spec.n_loc
        rh, rl = split_f64(field(n0, torch.float64))
        tag = f"{tuple(n0)}"
        want = twofloat.dw_dot_plain(rh, rl, rh, rl)
        scale = (rh.double() * rh.double()).sum()
        out[f"K6r norm^2 {tag}"] = _dist_check(
            f"K6r norm^2 {tag}", twofloat.dw_dot(rh, rl, rh, rl), want,
            K6_TOL, scale)
        rn = torch.sqrt(want)
        e = field(n0, torch.float32)
        for mode, ops in (("div", (rh, rn)), ("defect", (rh, rl, e, rn))):
            got, ref = (twofloat.dw_update(mode, *ops),
                        twofloat.dw_update_plain(mode, *ops))
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            out[f"K6u {mode} {tag}"] = max(
                _dist_check(f"K6u {mode} {tag}", a, b, 0.0)
                for a, b in zip(got, ref))
    return out


def _dist_ranks(specs):
    """What every rank of phase 18 runs: each spec's solve
    (``bench/one_dist.py::solve_case``) and then the rank-side kernel
    checks (:func:`_dist_kernel_checks`, after the solve's launches are
    read), the cache freed between them; on gloo ranks then the refusal of
    ``solve_compiled`` on CUDA tensors."""
    out = []
    for spec in specs:
        out.append(one_dist.solve_case(spec, check=_dist_kernel_checks))
        gc.collect()
        torch.cuda.empty_cache()
    refused = None
    if tdist.get_backend() == "gloo":
        prob = poisson_problem(2, 16, degree=2, operator="kron",
                               device="cuda")
        mg = DistributedMG(prob, 2, (tdist.get_world_size(), 1),
                           CycleConfig(smoother=SmootherConfig("jacobi",
                                                               0.8)),
                           operator="kron")
        try:
            mg.solve_compiled()
        except RuntimeError as err:
            refused = str(err)
    return out, refused


def _dist_serial(dev, specs):
    """The serial port's MixedPrecisionMG at each spec's configuration on
    this card: (iterations, history, λ estimates) per spec."""
    out = {}
    for name, spec in specs.items():
        os.environ.pop("POMS_TPU_SPMV", None)
        if spec.get("engine") == "v2":
            os.environ["POMS_TPU_SPMV"] = "v2"
        try:
            prob = poisson_problem(3, spec["n_el"], degree=spec["degree"],
                                   operator=spec["operator"], device=dev)
            mg = MixedPrecisionMG(prob, spec["levels"], one_dist.make_cycle(
                spec["cfg"]), operator=spec["operator"],
                residual=spec["options"]["mixed_residual"])
            res = mg.solve(tol=spec["tol"], maxiter=spec["maxiter"])
            out[name] = (res.iterations, res.residuals, list(mg.lams))
        finally:
            os.environ.pop("POMS_TPU_SPMV", None)
        del prob, mg
        torch.cuda.empty_cache()
    return out


def _serial_true_residual(problems, operator, x, dev):
    """‖b − A x‖₂ of a gathered distributed iterate through the serial
    problem's own operator (K1 or K2 in f64), the problem built once per
    operator."""
    if operator not in problems:
        problems[operator] = poisson_problem(
            3, DIST["n_el"], degree=DIST["degree"], operator=operator,
            device=dev)
    prob = problems[operator]
    xv = StencilVector.from_interior(prob.space, torch.as_tensor(x).to(dev))
    return float((prob.b - prob.A.dot(xv)).norm())


def _deciding_entry(label, dist_res, serial_res, tol):
    """Fail with the history entries that decide two different counts."""
    n = min(len(dist_res), len(serial_res))
    k = next((i for i in range(n)
              if (dist_res[i] <= tol) != (serial_res[i] <= tol)), n - 1)
    raise AssertionError(
        f"[dist] {label}: {len(dist_res) - 1} cycles distributed, "
        f"{len(serial_res) - 1} serial; entry {k}: distributed "
        f"{dist_res[k]:.6e}, serial {serial_res[k]:.6e} (tol {tol:g})")


def phase_distributed(dev):
    """2 gloo ranks on the card (mesh (2, 1, 1)) and 1 NCCL rank: the
    distributed solves at 128^3 p3 beside the serial port's counts.  The
    two jobs run at once, so this phase checks counts, histories, true
    residuals, kernels and memory, and logs no time a cycle."""
    specs = {
        "kron twofloat RB-GS": dict(DIST, operator="kron",
                                    cfg=DIST_CYCLES["rbgs"]),
        "kron twofloat Chebyshev(4)": dict(DIST, operator="kron",
                                           cfg=DIST_CYCLES["chebyshev"]),
        "banded f64 RB-GS, K2": dict(DIST, operator="banded",
                                     cfg=DIST_CYCLES["rbgs"]),
        "banded f64 RB-GS, v2 (K3)": dict(DIST, operator="banded",
                                          cfg=DIST_CYCLES["rbgs"],
                                          engine="v2")}
    for name, spec in specs.items():
        spec["options"] = dict(mixed=True, mixed_residual="twofloat"
                               if spec["operator"] == "kron" else "f64")
    serial = _dist_serial(dev, specs)
    for name, spec in specs.items():   # the same λ on both sides
        spec["lams"] = serial[name][2]
    gloo_specs = [dict(spec, mesh=DIST_GLOO_MESH) for spec in specs.values()]
    nccl_spec = dict(specs["kron twofloat RB-GS"], mesh=(1, 1, 1),
                     compiled=True)
    # the gloo job and the NCCL job run at once, to hold the script's time;
    # so no time a cycle is logged here: each job's would be read beside
    # the other's (bench/one_dist.py times a path alone)
    t0 = time.perf_counter()
    gloo_job = start(_dist_ranks, math.prod(DIST_GLOO_MESH),
                     args=(gloo_specs,), backend="gloo", timeout=900)
    nccl_job = start(_dist_ranks, 1, args=([nccl_spec],), backend="nccl",
                     timeout=900)
    (nccl,) = nccl_job.results()
    nccl_s = time.perf_counter() - t0
    gloo = gloo_job.results()
    gloo_s = time.perf_counter() - t0
    log(f"[dist] 2 gloo ranks and 1 NCCL rank at once: the gloo job "
        f"{gloo_s:.1f} s (spawn, setup, 4 solves), the NCCL job {nccl_s:.1f}"
        f" s (spawn, setup, solve, solve_compiled)")
    runs = [(f"{name} [gloo x2]", name, [ranks[0][i] for ranks in gloo])
            for i, name in enumerate(specs)]
    runs.append(("kron twofloat RB-GS [nccl x1]", "kron twofloat RB-GS",
                 nccl[0]))
    tol = DIST["tol"]
    launches = {}
    problems = {}
    for label, name, per_rank in runs:
        r = per_rank[0]
        assert all(q["residuals"] == r["residuals"] for q in per_rank), \
            f"{label}: the ranks' histories differ"
        assert r["converged"], (label, r["residuals"][-5:])
        assert r["true_residual"] <= 5e-10, (label, r["true_residual"])
        true_s = _serial_true_residual(problems, specs[name]["operator"],
                                       per_rank[0].pop("x"), dev)
        for q in per_rank:
            q.pop("x", None)
        assert true_s <= 5e-10, (label, true_s)
        it_s, res_s, _ = serial[name]
        if r["iterations"] != it_s:
            _deciding_entry(label, r["residuals"], res_s, tol)
        rel = [abs(a - b) / abs(b) for a, b in zip(r["residuals"], res_s)]
        k = max(range(len(rel)), key=rel.__getitem__)
        h_tol = DIST_HISTORY_RTOL[specs[name]["cfg"]["kind"]]
        log(f"[dist] {label}: history against the serial port's, entry by "
            f"entry: largest relative difference {rel[k]:.3e} at entry {k} "
            f"({r['residuals'][k]:.6e} against {res_s[k]:.6e}; stated "
            f"tolerance {h_tol:g})")
        assert rel[k] <= h_tol, (label, k, rel[k])
        checks, shapes = {}, {}
        for q in per_rank:
            for what, err in q["check"].items():
                fam = " ".join(what.split()[:2])
                checks[fam] = max(checks.get(fam, 0.0), err)
                shapes.setdefault(fam, set()).add(
                    what[len(fam):].rsplit(" float", 1)[0].strip())
        log(f"[dist] {label}: rank-side kernel checks at the path's shapes "
            f"({sum(len(q['check']) for q in per_rank)} over the ranks, each "
            f"against its plain version on the rank's operands; K2/K3 to "
            f"{K1_TOL[torch.float32]:g} (f32) / {K1_TOL[torch.float64]:g} "
            f"(f64) of max|plain|, K7 and K6u bit-equal, K6r to {K6_TOL:g} "
            f"of sum|terms|): worst relative error per kernel and mode "
            + ", ".join(f"{f} {e:.2e}" for f, e in sorted(checks.items()))
            + "; shapes (f32 and f64 each): " + "; ".join(
                f"{f} " + ", ".join(sorted(v)) for f, v in
                sorted(shapes.items())))
        log(f"[dist] {label}: true f64 |b - Ax| of the gathered iterate "
            f"through the serial operator {true_s:.3e}; device memory per "
            f"rank (GiB): peak in setup "
            f"{[round(q['peak_setup_bytes'] / 2**30, 2) for q in per_rank]}, "
            f"held by the solver "
            f"{[round(q['held_bytes'] / 2**30, 2) for q in per_rank]}, peak "
            f"{[round(q['peak_bytes'] / 2**30, 2) for q in per_rank]}")
        grown = {}
        for q in per_rank:
            for k, v in q["launches"].items():
                grown[k] = grown.get(k, 0) + v
        banded = "banded" in name
        engine = ("stencil_apply_v2" if "v2" in name else "stencil_apply")
        need = (["transfer", "dw_reduce", "dw_update"] if not banded else
                ["transfer", f"{engine}.spmv", f"{engine}.rbgs"])
        missing = [k for k in need if not grown.get(k)]
        assert not missing, f"{label}: never launched {missing}: {grown}"
        if banded:
            other = ("stencil_apply" if "v2" in name else "stencil_apply_v2")
            assert not any(k.startswith(other + ".") and v
                           for k, v in grown.items()), (label, grown)
        for k, v in grown.items():
            launches[k] = launches.get(k, 0) + v
        staged = [q["staged_bytes_per_cycle"] for q in per_rank]
        log(f"[dist] {label}: L_dist {r['L_dist']}, grid {r['N']}, "
            f"{r['iterations']} cycles (serial port {it_s}), |r| "
            f"{r['residuals'][-1]:.3e} (last two {r['residuals'][-2]:.4e}, "
            f"{r['residuals'][-1]:.4e}; the serial port's {res_s[-2]:.4e}, "
            f"{res_s[-1]:.4e}), true f64 |b - Ax| "
            f"{r['true_residual']:.3e}; halo bytes staged through the "
            f"host per cycle per rank {[round(b) for b in staged]}; launches "
            f"{_short(grown) if not banded else grown}")
    c = nccl[0][0]["compiled"]
    assert c["iterations"] == nccl[0][0]["iterations"] and c["same_bits"], c
    log(f"[dist] NCCL rank: solve_compiled (one captured graph a cycle) "
        f"{c['iterations']} cycles, the same bits as solve")
    for ranks in gloo:
        assert ranks[1] is not None and "gloo" in ranks[1], ranks[1]
    log(f"[dist] gloo on CUDA tensors: solve_compiled raised: {gloo[0][1]}")
    return launches


# phase 19: the headline example at the sizes its users run
HEADLINE_SIZES = (64, 128, 256, 512)
# the JAX package's record (BENCH_r05): iterations to 1e-10 per size
HEADLINE_RECORD = {"pcg": {64: 9, 128: 9, 256: 9, 512: 9},
                   "dc": {64: 12, 128: 12, 256: 14}}
# the counts phases 4 and 4b assert at 128^3
HEADLINE_128 = {"pcg": 8, "dc": 11}


def _k6_against_plain(what, xh, xl, bh, bl, g):
    """K6r (the stacked pair z.x, z.b and the norm of x, to K6_TOL of the
    sum of |terms|) and K6u in every mode (bit-equal) against their plain
    versions on a solve's own fields (x and b as double-word pairs) and a
    random f32 z drawn from ``g``; returns K6r's largest |d| / sum|terms|."""
    z = torch.randn(xh.shape, generator=g, device=xh.device)
    pair = [(z, None, xh, xl), (z, None, bh, bl)]
    got = twofloat.dw_dot_stack(pair)
    want = twofloat.dw_dot_stack_plain(pair)
    scale = torch.stack([(z.double() * (h.double() + lo.double())).abs()
                         .sum() for h, lo in ((xh, xl), (bh, bl))])
    err = (got - want).abs() / scale
    nrm, n_want = twofloat.dw_norm2(xh, xl), twofloat.dw_norm2_plain(xh, xl)
    n_rel = float((nrm * nrm - n_want * n_want).abs() / (n_want * n_want))
    worst = max(float(err.max()), n_rel)
    if not worst <= K6_TOL:
        raise AssertionError(f"K6r disagrees with the plain tree at {what} "
                             f"{tuple(xh.shape)}: {err}, norm {n_rel}")
    s0 = torch.tensor(0.37, dtype=torch.float64, device=xh.device)
    s1 = torch.tensor(1.91, dtype=torch.float64, device=xh.device)
    ap = xh * 1e-3
    cases = {"cg": (xh, xl, bh, bl, z, ap, xl, s0, s1),
             "direction": (z, xh, s0, s1), "defect": (xh, xl, z, s0),
             "dwrr": (xh, xl, z, ap, bh, s0, s1),
             "dwrr, x only": (xh, xl, z, None, None, s0, s1),
             "div": (z, s0), "mul": (z, s1)}
    for label, ops in cases.items():
        mode = label.split(",")[0]
        out = twofloat.dw_update(mode, *ops)
        torch.cuda.synchronize()
        ref = twofloat.dw_update_plain(mode, *ops)
        if isinstance(out, torch.Tensor):
            out, ref = (out,), (ref,)
        if len(out) != len(ref) or not all(
                torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"K6u {label} is not bit-equal to its "
                                 f"plain version at {what} "
                                 f"{tuple(xh.shape)}")
        del out, ref
    log(f"[K6] {what} {tuple(xh.shape)}: K6r stacked pair and norm "
        f"{worst:.2e} of sum|terms| from the plain tree, K6u {len(cases)} "
        f"cases bit-equal to plain")
    del z, pair, ap, cases
    torch.cuda.empty_cache()
    return worst


def _headline_kernel_checks(prob, mg, x):
    """Called by the 512^3 PCG run once its numbers are read: every kernel
    the solve launched against its plain version on operands of the solve's
    own sizes (513^3 and 257^3), each field freed after its check; returns
    the launches of the run (read first: the checks' are not counted) and
    max|d| per kernel."""
    launches = counters.snapshot()
    del x
    gc.collect()
    torch.cuda.empty_cache()
    dev = prob.space.device
    g = torch.Generator(device=dev).manual_seed(19)
    errs = {}
    for l in (0, 1):   # K1 on the cycle's f32 levels
        A = mg.levels_pre[l].A
        sp = A.space
        fields = [torch.randn(sp.npts, generator=g, device=dev)
                  for _ in range(3)]
        e = _k1_against_plain(f"headline 512^3 level {l}, ", A.terms,
                              fields, sp.npts, sp.pads, sp.periodic)
        errs[f"K1 {sp.npts[0]}^3"] = max(e.values())
        del fields
        torch.cuda.empty_cache()
    # K5: the double-word A·p and the full residual on the finest level
    sp = prob.space
    x64 = torch.randn(sp.npts, generator=g, dtype=torch.float64, device=dev)
    (xh, xl), (bh, bl) = split_f64(x64), split_f64(prob.b.interior)
    del x64
    zero = torch.zeros_like(xh)
    for flags, explicit in (((bh, bl, xh, xl), (bh, bl, xh, xl)),
                            ((None, None, xh, None), (zero, zero, xh, zero))):
        got = twofloat.residual_kron_df(mg._terms_df, *flags, sp.pads,
                                        labels=mg._labels,
                                        periodic=sp.periodic,
                                        plan=mg._plan_df)
        torch.cuda.synchronize()
        want = twofloat.residual_kron_df_plain(mg._terms_df, *explicit,
                                               sp.pads, mg._labels,
                                               sp.periodic)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("K5 is not bit-equal to its plain version "
                                 "at 513^3")
        del got, want
        torch.cuda.empty_cache()
    errs["K5 513^3"] = 0.0
    errs["K6r 513^3"] = _k6_against_plain("headline 512^3", xh, xl, bh, bl,
                                          g)
    errs["K6u 513^3"] = 0.0
    del xh, xl, bh, bl, zero
    torch.cuda.empty_cache()
    # K7 on the solver's own bands: 513^3 -> 257^3 and back (+ add)
    lev = mg.levels_pre[0]
    xf = torch.randn(lev.A.space.npts, generator=g, device=dev)
    xc = torch.randn(mg.levels_pre[1].A.space.npts, generator=g, device=dev)
    for label, kernel, plain in (
            ("restrict", lambda: k7.apply_transfer(lev.restrict, xf),
             lambda: k7.apply_transfer_plain(lev.restrict, xf)),
            ("prolong+add",
             lambda: k7.apply_transfer(lev.prolong, xc, add=xf),
             lambda: k7.apply_transfer_plain(lev.prolong, xc, add=xf))):
        got = kernel()
        torch.cuda.synchronize()
        if not torch.equal(got, plain()):
            raise AssertionError(f"K7 {label} is not bit-equal to plain at "
                                 "513^3 <-> 257^3")
    errs["K7 513^3 <-> 257^3"] = 0.0
    del xf, xc
    torch.cuda.empty_cache()
    log(f"[headline] 512^3 kernels against their plain versions on the "
        f"solve's operands (K1 rel 1e-5, K5/K7 bit-equal, K6u bit-equal in "
        f"every mode, K6r "
        f"{K6_TOL:g} of sum|terms|): max|d| "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    return {"launches": launches, "errors": errs}


def phase_headline(dev):
    """The port's headline example at 64^3 .. 512^3, PCG and defect
    correction: converged, true f64 residual <= 5e-10, the counts of phases
    4 and 4b at 128^3; at 512^3 the kernels held against plain."""
    from poms_tpu_torch.examples import headline_solve

    launches, rows = {}, {}
    for n in HEADLINE_SIZES:
        for solver in ("pcg", "dc"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            counters.reset()
            check = (_headline_kernel_checks if (n, solver) == (512, "pcg")
                     else lambda prob, mg, x: {
                         "launches": counters.snapshot()})
            t0 = time.perf_counter()
            res = headline_solve.main(n, 3, solver, device=dev,
                                      out=lambda m: log(f"[headline] {m}"),
                                      check=check)
            res["run_s"] = time.perf_counter() - t0
            for k, v in res["check"].pop("launches").items():
                launches[k] = launches.get(k, 0) + v
            rec = HEADLINE_RECORD[solver].get(n)
            log(f"[headline] {n}^3 {solver}: {res['iterations']} "
                f"iterations (JAX record {rec if rec else 'none'}), true f64 "
                f"|b - Ax| {res['true_residual']:.3e}, L2 error "
                f"{res['l2_error']:.3e}, replayed {res['ms_per_iter']:.3f} "
                f"ms/iteration, setup {res['setup_s']:.3f} s, first solve "
                f"(warm-up + capture) {res['cold_solve_s']:.3f} s, peak "
                f"{res['peak_bytes'] / 2 ** 30:.2f} GiB, {res['run_s']:.1f} "
                f"s in all")
            assert res["converged"] and res["true_residual"] <= 5e-10, res
            if n == 128:
                assert res["iterations"] == HEADLINE_128[solver], \
                    (solver, res["iterations"])
            limit = 10 if solver == "pcg" else (rec + 2 if rec else None)
            if limit is not None and res["iterations"] > limit:
                log(f"[headline] FINDING: {n}^3 {solver} took "
                    f"{res['iterations']} iterations, above {limit}")
            rows[f"{n} {solver}"] = res
    missing = [k for k in ("kron_mode.cheb", "kron_mode.residual",
                           "kron_mode.dinv", "residual_kron_df",
                           *NEW_KERNELS) if not launches.get(k, 0) > 0]
    assert not missing, f"the headline runs missed {missing}"
    log(f"[headline] launches of the runs (the 512^3 checks not counted): "
        f"{_short(launches)}")
    log("[headline] RESULT " + json.dumps(rows))
    return launches, rows


# the JAX package's record of its banded examples at their default sizes
POISSON_COUNTS = {"poisson_1d": 6, "poisson_2d": 18, "poisson_3d_pcg": 13}


def phase_poisson_examples(dev):
    """The banded examples at the JAX examples' default sizes on the card:
    1D (p3, 2 levels, Jacobi 2/3) in 6 cycles, 2D (64², p3, 4 levels,
    Jacobi 0.8) in 18, 3D (16³, p3, 3 levels): RB-GS V(2,2)-cycles stall
    (60 cycles, median rho 0.9-0.97, above 1e-6), then the dw MG-PCG
    converges in 13 iterations; returns the launches."""
    import io

    from poms_tpu_torch.examples import poisson_1d, poisson_2d, poisson_3d

    counters.reset()

    def out(m):
        log(f"[examples] {m}")

    for name, mod in (("poisson_1d", poisson_1d), ("poisson_2d", poisson_2d)):
        res = mod.main(device=dev, out=out)
        assert res["converged"] and \
            res["iterations"] == POISSON_COUNTS[name], (name, res)
    res = poisson_3d.main(device=dev, log_stream=io.StringIO(), out=out)
    rb = res["rbgs"]
    log(f"[examples] poisson_3d: RB-GS {rb['iterations']} cycles to "
        f"{rb['residuals'][-1]:.3e}, median rho {rb['rho_median']:.3f}; "
        f"dw MG-PCG {res['pcg_iterations']} iterations to "
        f"{res['pcg_rn']:.3e}")
    assert rb["iterations"] == 60 and rb["residuals"][-1] > 1e-6, rb
    assert 0.9 < rb["rho_median"] < 0.97, rb["rho_median"]
    assert res["converged"] and \
        res["pcg_iterations"] == POISSON_COUNTS["poisson_3d_pcg"], res
    launches = {k: v for k, v in counters.snapshot().items() if v}
    missing = [k for k in ("stencil_apply.jacobi", "stencil_apply.rbgs",
                           "stencil_apply.residual", "kron_mode.cheb",
                           "residual_kron_df", "transfer")
               if not launches.get(k, 0) > 0]
    assert not missing, f"the banded examples missed {missing}"
    log(f"[examples] launches of the three examples: {launches}")
    return launches


def phase_benches(dev, k4):
    """attr_iter at 128^3 (pcg, dc); the dense-matmul Kronecker apply
    against K1's apply at 129^3 p3 f32 and timed (K1's library column);
    bench_vcycle(3, 128, 3, 5) under K2 and K3; the plain-PyTorch stream
    yardsticks at 128^3 p3 beside K4.  Returns the launches of the benches
    (not of the matmul comparison) and the matmul time."""
    from poms_tpu_torch.bench import attr_iter
    from poms_tpu_torch.bench.roofline import bench_spmv, bench_vcycle
    from poms_tpu_torch.core.kron import KroneckerSumOperator

    counters.reset()
    attr = {}
    for what in ("pcg", "dc"):
        out = attr_iter.run(128, 3, what, device=dev)
        attr[what] = out
        log(f"[attr_iter] RESULT {json.dumps(out)}")
        log(f"[attr_iter] 128^3 {what}: step {out['step_s'] * 1e3:.4f} ms "
            f"against {out['parts_ms']:.4f} ms for its parts "
            f"({out['step_over_parts']:.3f})")
        torch.cuda.empty_cache()
    bench_launches = counters.snapshot()
    # the dense-matmul apply (the JAX package's POMS_TPU_KRON=matmul),
    # TF32 off
    npts, pads, periodic = (129,) * 3, (3,) * 3, (False,) * 3
    terms, (x, _, _) = _k1_operands(npts, pads, torch.float32, dev, 20)
    space = StencilVectorSpace(npts=npts, pads=pads, periodic=periodic,
                               dtype=torch.float32, device=dev)
    op = KroneckerSumOperator(space, terms)
    got, want = op._apply_interior_matmul(x), op._mode("apply", x)
    mm_err = float((got - want).abs().max())
    assert mm_err <= 1e-5 * float(want.abs().max()), mm_err
    mm_ms = _device_ms(lambda: op._apply_interior_matmul(x))
    k1_ms = _device_ms(lambda: op._mode("apply", x))
    tf32_ms = _device_ms(lambda: op._apply_interior_matmul(x, tf32=True))
    tf32_err = float((op._apply_interior_matmul(x, tf32=True) - want)
                     .abs().max() / want.abs().max())
    log(f"[matmul] 129^3 p3 f32 Kronecker apply by dense per-axis "
        f"torch.tensordot (no TF32): {mm_ms:.4f} ms "
        f"against K1's apply {k1_ms:.4f} ms (device time), max|d| "
        f"{mm_err:.3e} of max|y| {float(want.abs().max()):.3e}; with TF32 "
        f"{tf32_ms:.4f} ms, rel err {tf32_err:.2e}")
    del got, want, op, terms, x
    torch.cuda.empty_cache()
    counters.reset()
    vcyc = {}
    for engine in ("K2", "K3"):
        if engine == "K3":
            os.environ["POMS_TPU_SPMV"] = "v2"
        try:
            sec, _ = bench_vcycle(3, 128, 3, 5, device=dev)
        finally:
            os.environ.pop("POMS_TPU_SPMV", None)
        vcyc[engine] = sec
        log(f"[vcycle] bench_vcycle(3, 128, 3, 5) under {engine}: "
            f"{sec * 1e3:.3f} ms per V-cycle (Jacobi 0.8, nu 2/2, banded "
            f"f32, five chained cycles by CUDA events)")
        torch.cuda.empty_cache()
    streams = {}
    for impl in ("xlastream", "xlastreamrw"):
        r = bench_spmv((128,) * 3, 3, torch.float32, iters=20, impl=impl)
        streams[impl] = r
        log(f"[stream] {impl} 128^3 p3 f32 (plain PyTorch): "
            f"{r.wall_s * 1e3:.4f} ms, {r.gbytes_per_s:.1f} GB/s "
            f"({r.pct_sol:.1f}% of the published 3.35 TB/s, "
            f"{100 * r.gbytes_per_s / k4['gbps']:.1f}% of K4's "
            f"{k4['gbps']:.1f} GB/s)")
        torch.cuda.empty_cache()
    for k, v in counters.snapshot().items():
        bench_launches[k] = bench_launches.get(k, 0) + v
    log(f"[benches] launches of attr_iter, bench_vcycle and the streams: "
        f"{ {k: v for k, v in bench_launches.items() if v} }")
    return {"launches": bench_launches, "matmul_ms": mm_ms,
            "k1_apply_ms": k1_ms, "attr": attr, "vcycle": vcyc}


def phase_dist_examples(dev, t_comp_ms):
    """The distributed examples on 2 gloo ranks sharing the card at the JAX
    examples' default sizes, multihost_3d also on 1 NCCL rank, and the
    census of one production step on 2 gloo ranks, and multihost_2d in f32
    (logged, not gated), the six jobs at once (their ranks share the card;
    each job's lines are logged together);
    then, alone, overlap_trace's A/B pair at 128^3 p3 on 2 gloo ranks; the
    scaling model's prediction for 8 ranks at 128^3 a rank (one card shows
    the wiring, not scaling)."""
    from poms_tpu_torch.bench import overlap_trace, scaling_model
    from poms_tpu_torch.examples import (distributed_2d, multihost_2d,
                                         multihost_3d)

    jobs = {
        "distributed_2d": lambda out: distributed_2d.main(
            backend="gloo", ranks=2, out=out),
        "multihost_2d": lambda out: multihost_2d.main(
            backend="gloo", ranks=2, out=out),
        "multihost_2d f32": lambda out: multihost_2d.main(
            backend="gloo", ranks=2, dtype=torch.float32, out=out),
        "multihost_3d gloo": lambda out: multihost_3d.main(
            True, True, backend="gloo", ranks=2, out=out),
        "multihost_3d nccl": lambda out: multihost_3d.main(
            True, True, backend="nccl", ranks=1, out=out),
        "census": lambda out: scaling_model.census(
            (2, 1, 1), backend="gloo", device=None)}

    def run(name):
        lines = []
        t0 = time.perf_counter()
        res = jobs[name](lines.append)
        return res, lines, time.perf_counter() - t0

    with ThreadPoolExecutor(len(jobs)) as pool:
        done = dict(zip(jobs, pool.map(run, jobs)))
    launches = {}
    for name, (res, lines, secs) in done.items():
        for line in lines:
            log(f"[dist-examples] {name}: {line}")
        log(f"[dist-examples] {name}: {secs:.1f} s wall, the six jobs at "
            f"once")
        for k, v in res.get("launches", {}).items():
            launches[k] = launches.get(k, 0) + v
    log(f"[dist-examples] launches over the examples' ranks: {launches}")
    res = done["distributed_2d"][0]
    assert res["converged"] and res["drift"] <= 1e-12, res["drift"]
    assert done["multihost_2d"][0]["ok"]
    f32 = done["multihost_2d f32"][0]
    log(f"[dist-examples] multihost_2d f32 (the JAX example's precision on "
        f"an accelerator; logged, not gated: the JAX example stalls near "
        f"1.3e-6 in f32 too, tests/test_torch_examples_dist.py): "
        f"{'OK' if f32['ok'] else 'not converged'}, last |r| "
        f"{f32['residuals'][-1]:.3e}")
    for backend in ("gloo", "nccl"):
        assert done[f"multihost_3d {backend}"][0]["all_ok"], backend
    doc = done["census"][0]
    log(f"[census] one twofloat kron step (8 elements a rank, p3, 3 levels) "
        f"on 2 gloo ranks, mesh (2, 1, 1): message directions a rank "
        f"{doc['messages_per_rank']}, bytes sent a rank "
        f"{doc['bytes_sent_per_rank']}, slabs {json.dumps(doc['slabs'])}, "
        f"collectives {json.dumps(doc['collectives'])}")
    pred = scaling_model.predict(scaling_model.classify(doc), 128, 3,
                                 t_comp_ms * 1e-3)
    log(f"[census] model for 8 ranks at 128^3 a rank (NVLink 4 spec 450 "
        f"GB/s a direction, assumed {scaling_model.T_MSG_S:g} s a message, "
        f"T_comp {t_comp_ms:.3f} ms = this run's 128^3 defect correction "
        f"per iteration): {json.dumps(pred)}; one card shows the wiring, "
        f"not scaling")
    t0 = time.perf_counter()
    ab = overlap_trace.run_overlap_ab(None, n_el=128, backend="gloo",
                                      ranks=2, dim=3, degree=3, levels=5)
    per_rank = ab.pop("per_rank")
    for arm in ("overlap_true", "overlap_false"):
        r = ab[arm]
        log(f"[overlap] 128^3 p3 f32, 2 gloo ranks on one card, "
            f"{arm}: overlap fraction {r['overlap_fraction']}, step "
            f"{r['step_wall_us'] / 1e3:.2f} ms, device busy "
            f"{r['device_busy_us'] / 1e3:.2f} ms (idle share "
            f"{r['device_idle_share']}), card<->host copies "
            f"{r['copy_us'] / 1e3:.2f} ms (share {r['copy_share']}), "
            f"{r['n_comm_events']} comm / {r['n_compute_events']} compute "
            f"events; rank 1: idle share "
            f"{per_rank[1][arm]['device_idle_share']}, copies "
            f"{per_rank[1][arm]['copy_share']}")
    log(f"[overlap] RESULT {json.dumps(ab)} ({time.perf_counter() - t0:.1f}"
        " s)")
    return launches, ab, pred


# phase 22: every spline degree the JAX package takes, on the card
DEGREES = tuple(range(1, 9))
# elements a side: phase 22 at 64^3 since phase 23 runs the headline's 128^3
# (PERF.md section 5 keeps the degrees 1-8 at 128^3)
DEGREE_N = 64
# the residual-replacement PCG's iterations grow with the degree (135 at
# degree 8; the headline example allows pcg and dc its 100)
DWRR_MAXITER = 300
DEGREE_BF16 = (4, 5, 8)   # bf16 cycles at 64^3 elements, counts logged
# pcg and dc may take up to this many (the headline example's default is
# 100; at 64^3, 4 levels, the degree-8 dc takes more)
DEGREE_MAXITER = 400
# bf16 K1r (K1 in bf16 at the degree's half-width, logged), timed on the
# 64^3 runs' finest level cast to bf16, where f32 K1r is timed
DEGREE_BF16_TIMED = (5, 8)
DEGREE_BF16_N = 64
DEGREE_BF16_SMALL = 8      # the same solves on the card and the CPU
# a bf16 cycle stalls from three levels on (PR 6): the counts are logged,
# the solves cut here
DEGREE_BF16_MAXITER = 100
# coarsest 24^3; the cycle does not converge there, in the JAX package
# either (the same history at 34^3 on the CPU): logged, cut at maxiter
DEGREE_PERIODIC = dict(degree=8, n_el=48, levels=2, maxiter=200)
DEGREE_CHAIN_TERMS = 6     # a free operator K5 takes in several launches
DEGREE_CHAIN_SHAPES = (((70, 70, 70), 8), ((40, 41, 42), 3))
# banded operands at degrees 5 and 8: 3D at small n (K3 on its smaller
# tiles at p = 8), rows whose window K2 must cut into shorter runs (129 at
# p = 8 in f64, 256 at p = 7), and the 2D headline level of phase 9
DEGREE_BANDED = [((33, 33, 33), 5), ((33, 33, 33), 8), ((9, 12, 129), 8),
                 ((8, 8, 256), 7), ((513, 513), 5), ((513, 513), 8)]


def _half_width(degree, compiled=k1.COMPILED_P):
    """The half-width K1 (or, given K5's table, K5) runs a degree-p
    operator at: the first of ``compiled`` that holds it, else its own
    (K1r, K5r)."""
    return next((P for P in compiled if P >= degree), degree)


def _low_levels(mg):
    return mg.levels_pre if hasattr(mg, "levels_pre") else mg.levels32


def _k5_ops(P, npts):
    """K5's f32 operations for one residual of the 3D Poisson operator at
    half-width P: 8 contractions (2 u, 3 v, 3 histories) of 2P+1 taps, each
    a dw_mul (9) and all but the first a dw_add (20), 2 term adds, b - Ax."""
    W = 2 * P + 1
    return (8 * (W * 9 + (W - 1) * 20) + 3 * 20) * math.prod(npts)


def _k1_ops(plan, npts):
    """K1's f32 operations for one apply of ``plan`` on ``npts``: each
    contraction of each run of terms (its u, v and pre-summed partials) is
    2P+1 multiply-adds a point, two operations each at the card's 67 T
    (Poisson: 7 contractions)."""
    contractions = sum(len(sp["u_lab"]) + len(sp["v_src"]) + len(sp["g_lab"])
                       for sp in plan.plans)
    return 2 * contractions * (2 * plan.P + 1) * math.prod(npts)


def _k1_bound(plan, mode, npts, itemsize=4):
    """(bound_ms, bound_by) of K1 or K1r in ``mode``: the larger of its
    fields moved once (``K1_FIELDS``, ``itemsize`` bytes a value) over the
    card's bandwidth and its operations (``_k1_ops``) over its f32 rate."""
    t_bytes = (K1_FIELDS[mode] * math.prod(npts) * itemsize
               / HBM_BYTES_PER_S * 1e3)
    t_ops = _k1_ops(plan, npts) / F32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def _degree_check(degree, timed):
    """The ``check`` of one headline run: the launches (read first), the
    compiled half-width of every plan; where ``timed``, K5 (the residual
    and A.p) bit-equal to plain on the solver's own operands, K6r and K6u
    against plain on its finest fields, K1 in every mode on the first two
    cycle levels and K7 between them against plain, K5's resources and the
    device time of K5's A.p and of K1's cheb pass on the finest cycle
    level; at degrees 5 and 8, that level cast to bf16: K1 in bf16
    against plain and timed there (``_k1_bf16_times``); the compiled
    instantiations of the degree that the solve leaves to K1r and K5r
    (``_compiled_k5``, ``_compiled_k1``, ``_compiled_k1_bf16``)."""
    P, P_dw = _half_width(degree), _half_width(degree, twofloat.COMPILED_P_DW)

    def check(prob, mg, x):
        launches = counters.snapshot()
        low = _low_levels(mg)
        assert mg._plan_df.P == P_dw, (degree, mg._plan_df.P)
        assert all(lev.A.plan.P == P for lev in low), degree
        missing = [k for k in ("residual_kron_df", "kron_mode.cheb",
                               "transfer") if not launches.get(k, 0)]
        assert not missing, f"degree {degree}: never launched {missing}"
        out = {"launches": launches}
        if not timed:
            return out
        del x
        dev = prob.space.device
        sp = prob.space
        g = torch.Generator(device=dev).manual_seed(22 + degree)
        x64 = torch.randn(sp.npts, generator=g, dtype=torch.float64,
                          device=dev)
        (xh, xl), (bh, bl) = split_f64(x64), split_f64(prob.b.interior)
        _k5_on_solve(mg, mg._plan_df, (bh, bl, xh, xl),
                     f"K5 at degree {degree} (P = {P_dw})")
        if mg._plan_df.runtime and degree in twofloat.INSTANTIATED_P_DW:
            out["compiled_k5"] = _compiled_k5(degree, mg, (bh, bl, xh, xl))
        out["k5_resources"] = twofloat.k5_resources(mg._plan_df)
        out["k5_ms"] = _device_ms(lambda: twofloat.residual_kron_df(
            mg._terms_df, None, None, xh, None, sp.pads, labels=mg._labels,
            periodic=sp.periodic, plan=mg._plan_df, negate=True),
            kernels=rt_kernels(mg._plan_df, "k5r"))
        out["k5_bound_ms"] = _k5_ops(P_dw, sp.npts) / F32_OPS * 1e3
        out["k6r_err"] = _k6_against_plain(f"degree {degree}", xh, xl, bh, bl,
                                           g)
        del x64, xh, xl, bh, bl
        errs = {}
        for l in (0, 1):
            A = low[l].A
            lsp = A.space
            fields = [torch.randn(lsp.npts, generator=g, device=dev)
                      for _ in range(3)]
            e = _k1_against_plain(f"degree {degree} level {l}, ", A.terms,
                                  fields, lsp.npts, lsp.pads, lsp.periodic)
            errs[l] = max(e.values())
            if l == 0:
                xf, b, d = fields
                out["k1_ms"] = _device_ms(lambda: k1.kron_mode(
                    "cheb", A.plan, xf, b=b, d=d, c1=0.3, c2=0.7),
                    kernels=rt_kernels(A.plan, "k1r"))
                out["k1_bound_ms"], out["k1_bound_by"] = _k1_bound(
                    A.plan, "cheb", lsp.npts)
                if (degree in k1.INSTANTIATED_P
                        and degree not in k1.COMPILED_P):
                    out["compiled_k1"] = _compiled_k1(degree, A, fields)
                if degree in DEGREE_BF16_TIMED:
                    out["bf16"] = _k1_bf16_level(A, degree,
                                                 out["k1_ms"])
            del fields
        out["k1_err"] = max(errs.values())
        lev = low[0]
        xf = torch.randn(lev.A.space.npts, generator=g, device=dev)
        xc = torch.randn(low[1].A.space.npts, generator=g, device=dev)
        if not (torch.equal(k7.apply_transfer(lev.restrict, xf),
                            k7.apply_transfer_plain(lev.restrict, xf))
                and torch.equal(
                    k7.apply_transfer(lev.prolong, xc, add=xf),
                    k7.apply_transfer_plain(lev.prolong, xc, add=xf))):
            raise AssertionError(f"K7 is not bit-equal to plain at degree "
                                 f"{degree}")
        res = out["k5_resources"]
        log(f"[degrees] p={degree} (K1 P = {P}, K5 P = {P_dw}) on the "
            f"solve's operands: K5 "
            f"bit-equal (residual, A.p), K6r {out['k6r_err']:.2e} of "
            f"sum|terms|, K6u every mode bit-equal, K1 every mode on levels "
            f"0-1 max|d| {out['k1_err']:.2e}, K7 0<->1 bit-equal; K5 tiles "
            f"{mg._plan_df.tiling}, {res['threads']} threads, "
            f"{res['registers']} registers, {res['local_bytes']} bytes of "
            f"local memory, {res['smem_bytes']} bytes of shared memory, "
            f"{res['blocks_per_sm']} blocks an SM; K5 A.p "
            f"{out['k5_ms']:.4f} ms (operation bound "
            f"{out['k5_bound_ms']:.4f} ms), K1 cheb at {lev.A.space.npts} "
            f"{out['k1_ms']:.4f} ms ({out['k1_bound_by']} bound "
            f"{out['k1_bound_ms']:.4f} ms)")
        return out

    return check


def _k5_on_solve(mg, plan, pairs, what):
    """K5 (or K5r) of ``plan`` on a solve's own operator and fields: the
    residual (b and x_l given) and A.p, bit-equal to plain."""
    bh, bl, xh, xl = pairs
    sp = mg.problem.space
    zero = torch.zeros_like(xh)
    for flags, explicit, neg in (
            ((bh, bl, xh, xl), (bh, bl, xh, xl), False),
            ((None, None, xh, None), (zero, zero, xh, zero), True)):
        got = twofloat.residual_kron_df(
            mg._terms_df, *flags, sp.pads, labels=mg._labels,
            periodic=sp.periodic, plan=plan, negate=neg)
        torch.cuda.synchronize()
        want = twofloat.residual_kron_df_plain(
            mg._terms_df, *explicit, sp.pads, mg._labels, sp.periodic, neg)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{what} is not bit-equal to plain at "
                                 f"{sp.npts}")


def _compiled_k5(degree, mg, pairs):
    """The compiled K5 at the degree's half-width, which the solves leave
    to K5r (``twofloat.COMPILED_P_DW``), asked for by ``half_widths`` on
    the solve's own operator and fields: bit-equal to plain (residual and
    A.p), its A.p device time beside its operation bound, its
    resources."""
    sp = mg.problem.space
    plan = twofloat.build_kron_df_plan(
        mg._terms_df, sp.npts, sp.pads, sp.periodic, mg._labels,
        half_widths=twofloat.INSTANTIATED_P_DW)
    assert not plan.runtime and plan.P == degree, (degree, plan.P)
    _k5_on_solve(mg, plan, pairs, f"compiled K5 at P = {plan.P}")
    xh = pairs[2]
    res = twofloat.k5_resources(plan)
    r = {"P": plan.P, "npts": sp.npts,
         "ms": _device_ms(lambda: twofloat.residual_kron_df(
             mg._terms_df, None, None, xh, None, sp.pads, labels=mg._labels,
             periodic=sp.periodic, plan=plan, negate=True)),
         "bound_ms": _k5_ops(plan.P, sp.npts) / F32_OPS * 1e3,
         **{k: res[k] for k in ("registers", "local_bytes", "smem_bytes",
                                "blocks_per_sm")}}
    log(f"[degrees] compiled K5 at P = {plan.P} (asked for by half_widths) "
        f"on the degree-{degree} solve's operands at {sp.npts}: bit-equal "
        f"to plain (residual, A.p); A.p {r['ms']:.4f} ms (operation bound "
        f"{r['bound_ms']:.4f} ms), {r['registers']} registers, "
        f"{r['local_bytes']} bytes local, {r['smem_bytes']} bytes shared, "
        f"{r['blocks_per_sm']} blocks an SM")
    del plan
    return r


def _compiled_k1(degree, A, fields):
    """The compiled K1 (f32) at the half-width of the cycle level ``A``,
    which the solves leave to K1r (``k1.COMPILED_P``), asked for by
    ``half_widths``: every mode against plain on the level's operator,
    each output beside K1r's (equal or not, logged), its cheb device time
    beside its bound, its resources."""
    sp = A.space
    x, b, d = fields
    errs = _k1_against_plain(f"compiled, degree {degree} level 0, ",
                             A.terms, fields, sp.npts, sp.pads, sp.periodic,
                             half_widths=k1.INSTANTIATED_P)
    plan = k1.build_kron_plan(A.terms, sp.npts, sp.pads, sp.periodic,
                              half_widths=k1.INSTANTIATED_P)
    assert not plan.runtime and plan.P == A.plan.P, (plan.P, A.plan.P)
    equal = True
    for label, mode, kw in _k1_runs(b, d):
        kw_r, kw_c = dict(kw), dict(kw)
        if kw.get("d") is not None:
            kw_r["d"], kw_c["d"] = d.clone(), d.clone()
        got = k1.kron_mode(mode, A.plan, x, **kw_r)
        want = k1.kron_mode(mode, plan, x, **kw_c)
        torch.cuda.synchronize()
        if mode != "cheb":
            got, want = (got,), (want,)
        equal &= all(torch.equal(g_, w) for g_, w in zip(got, want))
    res = k1.k1_resources(plan, "cheb")
    r = {"P": plan.P, "npts": sp.npts, "max_abs_err": max(errs.values()),
         "equal_to_k1r": bool(equal),
         "ms": _device_ms(lambda: k1.kron_mode("cheb", plan, x, b=b, d=d,
                                               c1=0.3, c2=0.7)),
         **{k: res[k] for k in ("registers", "local_bytes", "smem_bytes",
                                "blocks_per_sm")}}
    r["bound_ms"], r["bound_by"] = _k1_bound(plan, "cheb", sp.npts)
    log(f"[degrees] compiled K1 f32 at P = {plan.P} (asked for by "
        f"half_widths) on the degree-{degree} level 0 at {sp.npts}: every "
        f"mode within K1's tolerance of plain (max|d| "
        f"{r['max_abs_err']:.2e}), {'equal' if equal else 'not equal'} to "
        f"the solve's K1r; cheb {r['ms']:.4f} ms ({r['bound_by']} bound "
        f"{r['bound_ms']:.4f} ms), {r['registers']} registers, "
        f"{r['local_bytes']} bytes local, {r['blocks_per_sm']} blocks an SM")
    del plan
    return r


def _dwrr_run(degree, dev, n_el, maxiter=DWRR_MAXITER):
    """The residual-replacement PCG at n_el^3 elements and ``degree``."""
    from poms_tpu_torch.examples import headline_solve

    prob = poisson_problem(3, n_el, degree=degree, dtype=torch.float64,
                           device=dev, operator="kron")
    cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0))
    before = counters.snapshot()
    rr = MGPreconditionedCG(prob, headline_solve.num_levels(n_el), cfg,
                            mixed=True, operator="kron", precision="dwrr")
    x, rn, it = rr.solve_compiled(tol=1e-10, maxiter=maxiter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, rn, it = rr.solve_compiled(tol=1e-10, maxiter=maxiter)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    true = float(torch.linalg.vector_norm(prob.A.residual(x, prob.b)))
    grown = counters.diff(counters.snapshot(), before)
    del rr, x, prob
    return {"iterations": int(it), "rn": float(rn), "true_residual": true,
            "converged": float(rn) <= 1e-10,
            "ms_per_iter": wall / max(int(it), 1) * 1e3, "launches": grown}


def _degree_bf16(degree, dev):
    """bf16 cycles at ``degree``: the defect correction and the dw-PCG at
    64^3 elements (counts logged, not gated; the low hierarchy runs K1 and
    K7 in bf16 only), K1 bf16 against plain in every mode on the solve's
    own first two levels, and the same solves at 8^3 on the card and on
    the CPU (counts beside each other); returns the rows, the launches on
    the card and K1 bf16's largest |d| from plain."""
    from poms_tpu_torch.examples.headline_solve import num_levels

    rows, launches, errs = {}, {}, []
    for n in (DEGREE_BF16_N, DEGREE_BF16_SMALL):
        for where in ((dev, "cpu") if n == DEGREE_BF16_SMALL else (dev,)):
            prob = poisson_problem(3, n, degree=degree, dtype=torch.float64,
                                   device=where, operator="kron")
            for solver in ("dc", "pcg"):
                cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
                    "chebyshev",
                    cheb_fraction=32.0 if solver == "dc" else 16.0))
                if solver == "dc":
                    mg = MixedPrecisionMG(prob, num_levels(n), cfg,
                                          operator="kron",
                                          residual="twofloat", low_dtype=BF16)
                else:
                    mg = MGPreconditionedCG(prob, num_levels(n), cfg,
                                            mixed=True, operator="kron",
                                            precision="dw", low_dtype=BF16)
                before = counters.snapshot()
                t0 = time.perf_counter()
                _, rn, it = mg.solve_compiled(tol=1e-10,
                                              maxiter=DEGREE_BF16_MAXITER)
                wall = time.perf_counter() - t0
                grown = counters.diff(counters.snapshot(), before)
                key = f"{n} {solver} {'cpu' if where == 'cpu' else 'card'}"
                rows[key] = {"iterations": int(it), "rn": float(rn),
                             "s": wall}
                if where != "cpu":
                    _low_is_bf16(f"bf16 degree {degree} {key}", grown,
                                 ("kron_mode", "transfer"))
                    for k, v in grown.items():
                        launches[k] = launches.get(k, 0) + v
                if n == DEGREE_BF16_N and solver == "pcg":
                    low = _low_levels(mg)
                    assert all(lev.A.plan.P == _half_width(degree)
                               for lev in low)
                    for l in (0, 1):
                        A = low[l].A
                        lsp = A.space
                        errs.append(max(_k1_bf16_against_plain(
                            f"bf16 degree {degree} level {l}, ", A.terms,
                            _k1_fields(lsp.npts, BF16, dev, degree + l),
                            lsp.npts, lsp.pads, lsp.periodic).values()))
                del mg
            del prob
            torch.cuda.empty_cache()
    log(f"[degrees bf16] p={degree} (P = {_half_width(degree)}): "
        + ", ".join(f"{k}: {v['iterations']} (|r| {v['rn']:.2e}, "
                    f"{v['s']:.1f} s)" for k, v in rows.items()))
    return rows, launches, max(errs)


def _k1_bf16_level(A, degree, f32_ms):
    """The f32 level ``A`` of a 64^3 cycle cast to bf16 (one cast a
    distinct band): K1 bf16 in every mode against its plain version and
    timed there (``_k1_bf16_times``), beside the f32 cheb pass's
    ``f32_ms`` on the same level."""
    sp = A.space
    A16 = KroneckerSumOperator(sp.with_dtype(BF16), A.terms)
    errs = _k1_bf16_against_plain(
        f"degree {degree} level 0 cast to bf16, ", A16.terms,
        _k1_fields(sp.npts, BF16, sp.device, degree), sp.npts, sp.pads,
        sp.periodic)
    r = _k1_bf16_times(A16, degree)
    r["max_abs_err"] = max(errs.values())
    r["f32_ms"] = f32_ms
    if degree not in k1.COMPILED_P:
        r["compiled"] = _compiled_k1_bf16(A16, degree)
    log(f"[degrees bf16] K1 cheb at {sp.npts} p={degree}: bf16 "
        f"{r['ms']:.4f} ms, f32 {f32_ms:.4f} ms, bf16/f32 "
        f"{r['ms'] / f32_ms:.3f}")
    del A16
    return r


def _compiled_k1_bf16(A, degree):
    """The compiled K1 in bf16 at the half-width of the bf16 level ``A``,
    which the solves leave to K1r (``k1.COMPILED_P``), asked for by
    ``half_widths``: every mode within one bf16 unit of plain, its cheb
    device time beside its bound, its resources."""
    sp = A.space
    x, b, d = _k1_fields(sp.npts, BF16, sp.device, degree)
    errs = _k1_bf16_against_plain(
        f"degree {degree} level 0 cast to bf16, compiled, ", A.terms,
        (x, b, d), sp.npts, sp.pads, sp.periodic,
        half_widths=k1.INSTANTIATED_P)
    plan = k1.build_kron_plan(A.terms, sp.npts, sp.pads, sp.periodic,
                              half_widths=k1.INSTANTIATED_P)
    assert not plan.runtime and plan.P == degree, (plan.P, degree)
    res = k1.k1_resources(plan, "cheb")
    r = {"P": plan.P, "npts": sp.npts, "max_abs_err": max(errs.values()),
         "ms": _device_ms(lambda: k1.kron_mode("cheb", plan, x, b=b, d=d,
                                               c1=0.3, c2=0.7)),
         **{k: res[k] for k in ("registers", "local_bytes", "smem_bytes",
                                "blocks_per_sm")}}
    r["bound_ms"], r["bound_by"] = _k1_bound(plan, "cheb", sp.npts, 2)
    log(f"[degrees bf16] compiled K1 bf16 at P = {plan.P} (asked for by "
        f"half_widths) at {sp.npts}: every mode within one bf16 unit of "
        f"plain; cheb {r['ms']:.4f} ms ({r['bound_by']} bound "
        f"{r['bound_ms']:.4f} ms), {r['registers']} registers, "
        f"{r['local_bytes']} bytes local, {r['blocks_per_sm']} blocks an SM")
    del plan
    return r


def _k1_bf16_times(A, degree):
    """K1's (or K1r's) bf16 cheb pass and apply on the bf16 operator ``A``
    beside its plain version, its bound and the dense bf16 per-axis products
    of ``_apply_interior_matmul`` (the library's computation of the apply,
    never called by the port)."""
    sp = A.space
    x, b, d = _k1_fields(sp.npts, BF16, sp.device, degree)
    terms32, diag32 = A.plan.operands_f32()
    f32 = [f.float() for f in (x, b, d)]
    out = torch.empty_like(x)
    got = k1.kron_mode("apply", A.plan, x)
    lib = A._apply_interior_matmul(x)
    rel = float((got.float() - lib.float()).abs().max()
                / lib.float().abs().max())
    assert rel <= 2 ** -5, rel   # the products round to bf16 per axis
    counted = rt_kernels(A.plan, "k1r")
    r = {"ms": _device_ms(lambda: k1.kron_mode("cheb", A.plan, x, b=b, d=d,
                                               c1=0.3, c2=0.7, out=out),
                          kernels=counted),
         "plain_ms": _device_ms(lambda: k1.kron_mode_plain(
             "cheb", terms32, f32[0], sp.npts, sp.pads, sp.periodic,
             b=f32[1], diag=diag32, d=f32[2], c1=0.3, c2=0.7), 3),
         "apply_ms": _device_ms(lambda: k1.kron_mode("apply", A.plan, x,
                                                     out=out),
                                kernels=counted),
         "library_ms": _device_ms(lambda: A._apply_interior_matmul(x), 5),
         "npts": sp.npts}
    r["bound_ms"], r["bound_by"] = _k1_bound(A.plan, "cheb", sp.npts, 2)
    log(f"[degrees bf16] K1 bf16 at {sp.npts} p={degree} (P = "
        f"{A.plan.P}): cheb {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
        f"{r['bound_by']} bound {r['bound_ms']:.4f} ms); apply "
        f"{r['apply_ms']:.4f} ms "
        f"beside the dense bf16 per-axis products {r['library_ms']:.4f} ms "
        f"(rel {rel:.2e} apart)")
    return r


def _degree_periodic(dev):
    """The periodic dw-PCG at degree 8: K5 with 4 histories at P = 8 (and
    K1r on the plan's three folded terms); counts logged."""
    from poms_tpu_torch.mg.cycles import CycleConfig as _Cycle

    c = DEGREE_PERIODIC
    before = counters.snapshot()
    prob = periodic_problem(3, c["n_el"], degree=c["degree"], device=dev)
    pcg = MGPreconditionedCG(prob, c["levels"], _Cycle(
        nu1=1, nu2=1, smoother=SmootherConfig("chebyshev",
                                              cheb_fraction=16.0)),
        mixed=True, operator="kron", precision="dw")
    sp_ = k1.sharing_plan(pcg._plan_df.labels)
    assert len(sp_["w_src"]) == 4, sp_
    assert pcg._plan_df.P == _half_width(c["degree"],
                                         twofloat.COMPILED_P_DW)
    _, rn, it = pcg.solve_compiled(tol=1e-10, maxiter=c["maxiter"])
    grown = counters.diff(counters.snapshot(), before)
    g = torch.Generator(device=dev).manual_seed(8)
    sp = prob.space
    (xh, xl), (bh, bl) = (split_f64(torch.randn(
        sp.npts, generator=g, dtype=torch.float64, device=dev))
        for _ in range(2))
    got = twofloat.residual_kron_df(pcg._terms_df, bh, bl, xh, xl, sp.pads,
                                    labels=pcg._labels, periodic=sp.periodic,
                                    plan=pcg._plan_df, negate=True)
    want = twofloat.residual_kron_df_plain(pcg._terms_df, bh, bl, xh, xl,
                                           sp.pads, pcg._labels, sp.periodic,
                                           True)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("K5 with 4 histories at P = 8 is not bit-equal "
                             "to plain")
    res = twofloat.k5_resources(pcg._plan_df)
    log(f"[degrees periodic] {c['n_el']}^3 p={c['degree']} sigma=1, "
        f"{c['levels']} levels: dw-PCG {int(it)} iterations, |r| "
        f"{float(rn):.3e}; K5 with 4 histories at P = {pcg._plan_df.P} "
        f"bit-equal to plain "
        f"(negated, b and x_l given), {res['registers']} registers, "
        f"{res['local_bytes']} bytes of local memory, {res['smem_bytes']} "
        f"bytes of shared memory, {res['blocks_per_sm']} blocks an SM; "
        f"launches {_short(grown)}")
    del pcg, prob, got, want
    torch.cuda.empty_cache()
    return grown


def _degree_chain(dev):
    """A 6-term operator with nothing shared (runs of terms: three K5
    launches a call) on the compiled K5 at P = 8 and P = 3: bit-equal to the
    single-pass plain version, with b given and as A.p; the launches
    counted per call."""
    for npts, p in DEGREE_CHAIN_SHAPES:
        terms, (x, b, _) = _k1_operands(npts, (p,) * 3, torch.float64, dev,
                                        p, DEGREE_CHAIN_TERMS)
        split = {id(B): split_f64(B) for t in terms for B in t}
        tdf = [[split[id(B)] for B in t] for t in terms]
        plan = twofloat.build_kron_df_plan(
            tdf, npts, (p,) * 3, half_widths=twofloat.INSTANTIATED_P_DW)
        (xh, xl), (bh, bl) = split_f64(x), split_f64(b)
        zero = torch.zeros_like(xh)
        for flags, explicit, neg in (
                ((bh, bl, xh, xl), (bh, bl, xh, xl), False),
                ((None, None, xh, None), (zero, zero, xh, zero), True)):
            before = twofloat.residual_kron_df.launches
            got = twofloat.residual_kron_df(tdf, *flags, (p,) * 3, plan=plan,
                                            negate=neg)
            torch.cuda.synchronize()
            launched = twofloat.residual_kron_df.launches - before
            assert launched == len(plan.chunks) > 1, (launched, plan.chunks)
            want = twofloat.residual_kron_df_plain(tdf, *explicit, (p,) * 3,
                                                   None, None, neg)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"K5's chained launches at {npts} p={p} "
                                     "are not bit-equal to the single pass")
        log(f"[degrees chain] {DEGREE_CHAIN_TERMS} free terms at {npts} "
            f"p={p} (P = {plan.P}): runs {plan.chunks}, {launched} K5 "
            f"launches a call, bit-equal to the single pass (b given; A.p)")
        del terms, x, b, tdf, split, xh, xl, bh, bl, zero, got, want


def _degree_banded(dev):
    """K2 and K3 in every mode, f32 and f64, against their plain versions
    on degree-5 to degree-8 operands, with K2's runs and K3's tile."""
    for npts, p in DEGREE_BANDED:
        pads = (p,) * len(npts)
        periodic = (False,) * len(npts)
        zero = (0,) * len(npts)
        for name in ("K2", "K3"):
            prepare, kernel_fn, plain_fn = _engine(name)
            for dtype in (torch.float32, torch.float64):
                band, x_pad, b = _k2_operands(npts, pads, periodic, dtype,
                                              dev, seed=p)
                pk = prepare(band, npts, pads)
                if name == "K3":
                    how = f"tile {pk['tile']}"
                else:
                    plan = k2_plan(*k2_lift(npts, pads)[:2], dtype)
                    how = (f"runs of {plan['rl']} ({plan['m2']} a row), "
                           f"{plan['smem']} bytes")
                rels = []
                for mode in MODES:
                    kw = dict(b=None if mode == "spmv" else b,
                              omega=0.8 if mode in ("jacobi", "rbgs")
                              else None, color=0, starts=zero)
                    y = kernel_fn(mode, band, pk, x_pad, npts, pads, **kw)
                    torch.cuda.synchronize()
                    want = plain_fn(mode, band, pk, x_pad, npts, pads, **kw)
                    rel = float((y - want).abs().max() / want.abs().max())
                    if not (math.isfinite(rel) and rel <= K1_TOL[dtype]):
                        raise AssertionError(f"{name} {mode} disagrees at "
                                             f"{npts} p={p} {dtype}: {rel}")
                    rels.append(f"{mode}={rel:.2e}")
                log(f"[degrees banded] {name} {npts} p={p} {dtype} ({how}): "
                    + " ".join(rels))
                del band, x_pad, b, pk
                torch.cuda.empty_cache()


def phase_degrees(dev):
    """Every spline degree 1-8 on the card: the headline at 64^3 (pcg and
    dc through examples/headline_solve.main, and the dwrr PCG), converged
    with a true f64 residual <= 5e-10, the kernels on the solves' own
    operands against plain, K5 and K1 at each degree's half-width (the
    compiled kernels at 1-3, K1r and K5r from 4 on), and beside them the
    compiled instantiations no solve takes any more, asked for by
    ``half_widths`` on the same operands (K5 at 4-8 bit-equal, K1 in f32
    and bf16 at 5 and 8 in every mode), each timed; bf16 cycles at
    degrees 4, 5 and 8; the periodic dw-PCG at degree 8; a 6-term chain on
    the compiled K5; K2/K3 at degrees 5 and 8.  Returns the launches of its
    solves and the per-degree rows.

    The launches go to the rows whose kernel they ran: the generic K5 and
    f32 K1 rows (timed at P = 3) take only the compiled kernels' launches
    at P = 3 (those at 1 and 2 are logged per degree and counted in no
    row), the K1r and K5r pass rows those of the run-time kernels (their
    own counters).  Every other counter (K6r, K6u, K7) is taken whole."""
    from poms_tpu_torch.examples import headline_solve

    launches, rows = {}, {}

    def add(grown, degree):
        P = _half_width(degree)
        P_dw = _half_width(degree, twofloat.COMPILED_P_DW)
        for k, v in grown.items():
            if k == "residual_kron_df" and P_dw != 3:
                continue
            if k.startswith("kron_mode.") and P != 3:
                continue
            launches[k] = launches.get(k, 0) + v

    for degree in DEGREES:
        P = _half_width(degree)
        P_dw = _half_width(degree, twofloat.COMPILED_P_DW)
        for solver in ("pcg", "dc"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            counters.reset()
            t0 = time.perf_counter()
            res = headline_solve.main(
                DEGREE_N, degree, solver, device=dev, out=lambda m: None,
                check=_degree_check(degree, timed=solver == "pcg"),
                maxiter=DEGREE_MAXITER)
            res["run_s"] = time.perf_counter() - t0
            chk = res.pop("check")
            add(chk.pop("launches"), degree)
            res.update(chk)
            log(f"[degrees] {DEGREE_N}^3 p={degree} (K1 P = {P}, K5 P = "
                f"{P_dw}) {solver}: "
                f"{res['iterations']} iterations, |r| {res['rn']:.3e}, true "
                f"f64 |b - Ax| {res['true_residual']:.3e}, L2 error "
                f"{res['l2_error']:.3e}, replayed {res['ms_per_iter']:.3f} "
                f"ms/iteration, setup {res['setup_s']:.3f} s, first solve "
                f"{res['cold_solve_s']:.3f} s, peak "
                f"{res['peak_bytes'] / 2 ** 30:.2f} GiB, {res['run_s']:.1f} s "
                f"in all")
            assert res["converged"] and res["true_residual"] <= 5e-10, res
            rows[f"{degree} {solver}"] = res
        counters.reset()
        rr = _dwrr_run(degree, dev, DEGREE_N)
        add(rr.pop("launches"), degree)
        log(f"[degrees] {DEGREE_N}^3 p={degree} dwrr: {rr['iterations']} "
            f"iterations, |r| {rr['rn']:.3e}, true f64 "
            f"{rr['true_residual']:.3e}, replayed {rr['ms_per_iter']:.3f} "
            f"ms/iteration")
        assert rr["converged"] and rr["true_residual"] <= 5e-10, rr
        rows[f"{degree} dwrr"] = rr
    counters.reset()
    bf16_err = {}
    for degree in DEGREE_BF16:
        bf16_rows, grown, err = _degree_bf16(degree, dev)
        add(grown, degree)
        rows[f"{degree} bf16"] = bf16_rows
        P = _half_width(degree)
        bf16_err[P] = max(bf16_err.get(P, 0.0), err)
    for P in DEGREE_BF16_TIMED:
        r = rows[f"{P} pcg"]["bf16"]
        r["max_abs_err"] = max(r["max_abs_err"], bf16_err[P])
    counters.reset()
    add(_degree_periodic(dev), DEGREE_PERIODIC["degree"])
    _degree_chain(dev)
    _degree_banded(dev)
    log("[degrees] RESULT " + json.dumps(rows))
    return {"launches": launches, "rows": rows}


# phase 23: spline degrees above 8 on the run-time kernels K1r and K5r
WIDE_DEGREES = (9, 10, 12)
WIDE_N = 128            # elements a side: the headline's 128^3
# the solves gated on 1e-10 and a true f64 residual <= 5e-10; the others
# (dwrr at 10, every solver at 12) are logged with the residual they reach
WIDE_GATED = {"pcg": (9, 10), "dc": (9, 10), "dwrr": (9,)}
# K1r and K5r timed at the 128^3-element grid of these half-widths,
# (128 + P - 2)^3 points, on Poisson-shaped random bands
WIDE_TIMED_P = (9, 10, 12, 16)
WIDE_COMPILED_P = (3, 8)       # K1r and K5r held to the compiled kernels
WIDE_PADDED = {4: 5, 6: 8, 7: 8}   # K1r at P against compiled K1 at its pad
WIDE_SMALL = (5, 6, 9)         # the widest half-widths run on this grid
WIDE_ROW_P = 9                 # the kernels line's K1r and K5r rows' P


def _wide_grid(P):
    n = WIDE_N + P - 2
    return (n,) * 3, (P,) * 3, (False,) * 3


def _wide_operands(P, dev, seed):
    """Poisson-shaped f64 bands and fields at the half-width-P grid, the f32
    cast of the bands (one cast a distinct band) and their double-word
    split."""
    npts, pads, _ = _wide_grid(P)
    terms64, fields = _k1_operands(npts, pads, torch.float64, dev, seed)
    cast = {id(B): B.float() for t in terms64 for B in t}
    split = {id(B): split_f64(B) for t in terms64 for B in t}
    return (terms64, [[cast[id(B)] for B in t] for t in terms64],
            [[split[id(B)] for B in t] for t in terms64], fields)


def _k1r_pass_bounds(plan, mode, npts):
    """(bound_ms, bound_by) of each K1r pass of ``plan`` in ``mode`` (f32):
    its own fields once (A: x in, the u partials out; B: u in, the
    pre-summed partials out; C: those in, the mode's fields) against its
    multiply-adds (A: the u's, B: the v's and their sums, C: the axis-0
    contractions), the larger."""
    sp = plan.plans[0]
    nu, nv, ng = len(sp["u_lab"]), len(sp["v_src"]), len(sp["g_lab"])
    W, pts = 2 * plan.P + 1, math.prod(npts)
    words = {"A": 1 + nu, "B": nu + ng, "C": ng + K1_FIELDS[mode] - 1}
    fmas = {"A": nu * W, "B": nv * W + ng * nv, "C": ng * W}
    out = {}
    for p in k1.RT_PASSES:
        t_bytes = words[p] * pts * 4 / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * fmas[p] * pts / F32_FLOPS * 1e3
        out[p] = ((t_ops, "operations") if t_ops > t_bytes
                  else (t_bytes, "bytes"))
    return out


def _k1r_passes(plan, x, b, d):
    """Each K1r pass of ``plan`` (f32, one run) alone on the card against
    its plain version on the same inputs (A from x; B from the u partials
    A left; C in every mode from the pre-summed partials B left): max|d|
    over max|y|, held to K1's tolerance; each pass's device time, its
    plain version's and its bound (``_k1r_pass_bounds``; C per mode)."""
    from poms_tpu_torch.bench.k1_compare import k1r_pass_ms

    assert len(plan.plans) == 1
    sp, x3 = plan.plans[0], x.reshape(plan.n3)
    u, w = k1.k1r_scratch_fields(plan)
    npts = tuple(x.shape)

    def rel(got, want):
        e = float((got - want).abs().max() / want.abs().max())
        assert e <= K1_TOL[torch.float32], e
        return e

    out = {}
    k1.k1r_launch_pass("A", plan, 0, x3)
    want = k1.k1r_pass_plain("A", plan, sp, x)
    out["A"] = {"max_abs_err": max(rel(u[k], want[k])
                                   for k in range(len(want))),
                "plain_ms": _device_ms(lambda: k1.k1r_pass_plain(
                    "A", plan, sp, x), 3)}
    k1.k1r_launch_pass("B", plan, 0, x3)
    src = [t.clone() for t in u]
    want = k1.k1r_pass_plain("B", plan, sp, src)
    out["B"] = {"max_abs_err": max(rel(w[k], want[k])
                                   for k in range(len(want))),
                "plain_ms": _device_ms(lambda: k1.k1r_pass_plain(
                    "B", plan, sp, src), 3)}
    src = [t.clone() for t in w[:len(sp["g_lab"])]]
    diag = plan.diagonal()
    res = torch.empty_like(x)
    d_out = torch.empty_like(x)
    for mode in k1.MODES:
        kw = {"b": b if mode in ("residual", "cheb") else None,
              "d": d if mode == "cheb" else None}
        k1.k1r_launch_pass("C", plan, 0, x3, mode, out=res,
                           d_out=d_out if mode == "cheb" else None, c1=0.3,
                           c2=0.7, **kw)
        want = k1.k1r_pass_plain("C", plan, sp, src, mode, x, c1=0.3,
                                 c2=0.7, diag=diag, **kw)
        torch.cuda.synchronize()
        err = (max(rel(res, want[0]), rel(d_out, want[1]))
               if mode == "cheb" else rel(res, want))
        out[f"C.{mode}"] = {"max_abs_err": err, "plain_ms": _device_ms(
            lambda: k1.k1r_pass_plain("C", plan, sp, src, mode, x, c1=0.3,
                                      c2=0.7, diag=diag, **kw), 3)}
    del src
    for mode in k1.MODES:
        bounds = _k1r_pass_bounds(plan, mode, npts)
        times = k1r_pass_ms(plan, x, mode, b if mode in ("residual", "cheb")
                            else None, d if mode == "cheb" else None)
        for p in ("A", "B") if mode == "cheb" else ():
            out[p].update(ms=times[p], bound_ms=bounds[p][0],
                          bound_by=bounds[p][1])
        out[f"C.{mode}"].update(ms=times["C"], bound_ms=bounds["C"][0],
                                bound_by=bounds["C"][1])
    res_ = k1.k1_resources(plan, "cheb")["passes"]
    for key, r in out.items():
        r.update({k: res_[key[0]][k] for k in ("registers", "local_bytes",
                                                 "smem_bytes",
                                                 "blocks_per_sm", "threads")})
    log(f"[wide] K1r passes P={plan.P} at {npts}: " + ", ".join(
        f"{k} {r['ms']:.4f} ms ({r['bound_by']} bound {r['bound_ms']:.4f}, "
        f"plain {r['plain_ms']:.4f}, {r['max_abs_err']:.1e} of max|y|, "
        f"{r['registers']} registers, {r['blocks_per_sm']} blocks an SM)"
        for k, r in out.items()))
    return out


def _k1r_times(P, terms, fields, compiled=None, passes=False):
    """K1r in every mode against plain at the grid of P (f32), and its
    device times beside its bound (``_k1_bound``); beside them the dense
    per-axis products (the library call of the apply), with ``passes``
    each pass alone (``_k1r_passes``) and, given ``compiled`` half-widths,
    the compiled kernel at the first of them that holds P (equal values
    where that is P itself)."""
    npts, pads, per = _wide_grid(P)
    dev = fields[0].device
    x, b, d = (f.float() for f in fields)
    plan = k1.build_kron_plan(terms, npts, pads, per, half_widths=())
    errs = _k1_against_plain(f"K1r P={P} ", terms, (x, b, d), npts, pads,
                             per)
    out = torch.empty_like(x)
    r = {"tiling": plan.tiling, "resources": k1.k1_resources(plan, "cheb"),
         "max_abs_err": errs, "ms": {}, "bound_ms": {}}
    r["bound_by"] = {}
    for label, mode, kw in _k1_runs(b, d):
        if label == "cheb0":
            continue
        r["ms"][mode] = _device_ms(lambda: k1.kron_mode(mode, plan, x,
                                                        out=out, **kw),
                                   kernels=rt_kernels(plan, "k1r"))
        r["bound_ms"][mode], r["bound_by"][mode] = _k1_bound(plan, mode,
                                                             npts)
    if passes:
        r["passes"] = _k1r_passes(plan, x, b, d)
    diag = plan.diagonal()
    r["plain_ms"] = {mode: _device_ms(lambda: k1.kron_mode_plain(
        mode, terms, x, npts, pads, per, diag=diag, **kw), 2)
        for label, mode, kw in _k1_runs(b, d) if label != "cheb0"}
    op = KroneckerSumOperator(StencilVectorSpace(
        npts=npts, pads=pads, periodic=False, dtype=torch.float32,
        device=dev), terms)
    lib = op._apply_interior_matmul(x, tf32=False)
    rel = float((k1.kron_mode("apply", plan, x) - lib).abs().max()
                / lib.abs().max())
    assert rel <= K1_TOL[torch.float32], rel
    r["library_ms"] = _device_ms(lambda: op._apply_interior_matmul(
        x, tf32=False), 5)
    del op, lib
    if compiled:
        cplan = k1.build_kron_plan(terms, npts, pads, per,
                                   half_widths=compiled)
        equal = cplan.P == P
        for label, mode, kw in _k1_runs(b, d):
            kw_r, kw_c = dict(kw), dict(kw)
            if kw.get("d") is not None:
                kw_r["d"], kw_c["d"] = d.clone(), d.clone()
            got = k1.kron_mode(mode, plan, x, **kw_r)
            want = k1.kron_mode(mode, cplan, x, **kw_c)
            torch.cuda.synchronize()
            if mode != "cheb":
                got, want = (got,), (want,)
            for g_, w in zip(got, want):
                if equal and not torch.equal(g_, w):
                    raise AssertionError(f"K1r at P = {P} differs from the "
                                         f"compiled kernel ({label})")
                rel = float((g_ - w).abs().max() / w.abs().max())
                assert rel <= K1_TOL[torch.float32], (P, label, rel)
        r["compiled_P"] = cplan.P
        r["compiled_ms"] = {m: _device_ms(lambda: k1.kron_mode(
            m, cplan, x, out=out, **kw)) for label, m, kw in _k1_runs(b, d)
            if label in ("apply", "cheb")}
    log(f"[wide] K1r P={P} at {npts} f32, tiles {plan.tiling}, "
        f"{r['resources']['registers']} registers, "
        f"{r['resources']['local_bytes']} bytes local, "
        f"{r['resources']['smem_bytes']} bytes shared, "
        f"{r['resources']['blocks_per_sm']} blocks an SM: "
        + ", ".join(f"{m} {ms:.4f} ms ({100 * r['bound_ms'][m] / ms:.1f}% "
                    f"of the {r['bound_by'][m]} bound "
                    f"{r['bound_ms'][m]:.4f})"
                    for m, ms in r["ms"].items())
        + f"; plain cheb {r['plain_ms']['cheb']:.4f} ms; dense per-axis "
        f"products {r['library_ms']:.4f} ms (apply/products "
        f"{r['ms']['apply'] / r['library_ms']:.3f})"
        + (f"; compiled P = {r['compiled_P']}"
           f"{' (equal values)' if r['compiled_P'] == P else ''}: "
           + ", ".join(f"{m} {ms:.4f} ms"
                       for m, ms in r["compiled_ms"].items())
           if compiled else ""))
    return r


def _k5r_passes(plan, xh):
    """Each K5r pass of ``plan`` (one run) alone on the card as A.p (b = 0,
    no low word of x, negated) against its plain version on the same
    inputs, word for word; each pass's device time, its plain version's,
    its operations bound (29 a tap, none fusing, 20 a term added and for
    b - sum) and its resources."""
    from poms_tpu_torch.bench.k1_compare import k5r_pass_ms

    assert len(plan.plans) == 1
    sp = plan.plans[0]
    u, v = twofloat.k5r_scratch_fields(plan)
    geo, run = twofloat._df_c_args(plan)[:2]
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    bands = [ptr(t) for pair in zip(plan.bands, plan.bands_lo) for t in pair]
    rh, rl = torch.empty_like(xh), torch.empty_like(xh)
    args = (ptr(xh), None, None, None, None, None, *bands, ptr(rh), ptr(rl),
            geo, run, 1, 1)
    stream = torch.cuda.current_stream().cuda_stream
    zero = torch.zeros_like(xh)
    srcs = {"A": (xh, zero)}
    out = {}
    for p in twofloat.RT_PASSES:
        src = srcs[p]
        twofloat.k5r_launch_pass(p, plan, args, stream)
        want = twofloat.k5r_pass_plain(p, plan, sp, src, zero, zero,
                                       negate=True)
        torch.cuda.synchronize()
        got = {"A": u, "B": v, "C": [(rh, rl)]}[p]
        want = [want] if p == "C" else want
        for g_, w_ in zip(got, want):
            if not all(torch.equal(a, b_.reshape(a.shape))
                       for a, b_ in zip(g_, w_)):
                raise AssertionError(f"K5r pass {p} at P = {plan.P} is not "
                                     f"bit-equal to its plain version")
        nxt = {"A": "B", "B": "C"}.get(p)
        if nxt:
            srcs[nxt] = [tuple(t.clone() for t in pair) for pair in got]
        out[p] = {"max_abs_err": 0.0, "plain_ms": _device_ms(
            lambda: twofloat.k5r_pass_plain(p, plan, sp, src, zero, zero,
                                            negate=True), 2)}
    times = k5r_pass_ms(plan, xh)
    W, pts = 2 * plan.P + 1, math.prod(plan.npts)
    taps = W * 9 + (W - 1) * 20
    ops = {"A": len(sp["u_lab"]) * taps, "B": len(sp["v_src"]) * taps,
           "C": len(sp["w_src"]) * taps + 20 * len(sp["term_w"])}
    res = twofloat.k5_resources(plan)["passes"]
    for p in twofloat.RT_PASSES:
        out[p].update(ms=times[p], bound_ms=ops[p] * pts / F32_OPS * 1e3,
                      bound_by="operations",
                      **{k: res[p][k] for k in ("registers", "local_bytes",
                                                "smem_bytes", "blocks_per_sm",
                                                "threads")})
    log(f"[wide] K5r passes P={plan.P} at {plan.npts}, bit-equal to their "
        f"plain versions: " + ", ".join(
            f"{p} {r['ms']:.4f} ms (operations bound {r['bound_ms']:.4f}, "
            f"plain {r['plain_ms']:.4f}, {r['registers']} registers, "
            f"{r['blocks_per_sm']} blocks an SM)" for p, r in out.items()))
    del srcs
    return out


def _k5r_times(P, tdf, fields, compiled=False, passes=False):
    """K5r against plain (bit-equal: b and x_l given, and A.p) at the grid
    of P, its A.p device time beside its operation bound and the plain
    version; with ``passes`` each pass alone (``_k5r_passes``); with
    ``compiled``, the compiled K5 of P (bit-equal) and its time."""
    npts, pads, _ = _wide_grid(P)
    (xh, xl), (bh, bl) = split_f64(fields[0]), split_f64(fields[1])
    zero = torch.zeros_like(xh)
    plans = {"rt": twofloat.build_kron_df_plan(tdf, npts, pads,
                                               half_widths=())}
    if compiled:
        plans["compiled"] = twofloat.build_kron_df_plan(
            tdf, npts, pads, half_widths=twofloat.INSTANTIATED_P_DW)
    r = {"ms": {}}
    for name, plan in plans.items():
        for given, explicit, neg in (
                ((bh, bl, xh, xl), (bh, bl, xh, xl), False),
                ((None, None, xh, None), (zero, zero, xh, zero), True)):
            got = twofloat.residual_kron_df(tdf, *given, pads, plan=plan,
                                            negate=neg)
            torch.cuda.synchronize()
            want = twofloat.residual_kron_df_plain(tdf, *explicit, pads,
                                                   None, None, neg)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"K5 ({name}) at P = {P} is not "
                                     f"bit-equal to plain")
            del got, want
        r["ms"][name] = _device_ms(lambda: twofloat.residual_kron_df(
            tdf, None, None, xh, None, pads, plan=plan, negate=True),
            kernels=rt_kernels(plan, "k5r"))
    plan = plans["rt"]
    r["tiling"], r["resources"] = plan.tiling, twofloat.k5_resources(plan)
    if passes:
        r["passes"] = _k5r_passes(plan, xh)
    r["bound_ms"] = _k5_ops(P, npts) / F32_OPS * 1e3
    r["plain_ms"] = _device_ms(lambda: twofloat.residual_kron_df_plain(
        tdf, zero, zero, xh, zero, pads, None, None, True), 2)
    res = r["resources"]
    log(f"[wide] K5r P={P} at {npts}: bit-equal to plain (b and x_l given; "
        f"A.p), tiles {plan.tiling}, {res['registers']} registers, "
        f"{res['local_bytes']} bytes local, {res['smem_bytes']} bytes "
        f"shared, {res['blocks_per_sm']} blocks an SM; A.p "
        f"{r['ms']['rt']:.4f} ms, operation bound {r['bound_ms']:.4f} ms "
        f"({100 * r['bound_ms'] / r['ms']['rt']:.1f}%), plain "
        f"{r['plain_ms']:.4f} ms"
        + (f"; compiled K5 bit-equal, {r['ms']['compiled']:.4f} ms"
           if compiled else ""))
    return r


def _wide_kernels(dev):
    """K1r and K5r at the 128^3-element grids of WIDE_TIMED_P, at the
    compiled half-widths 3 and 8 beside the compiled kernels (equal
    values, bit-equal words), and K1r at 4, 6 and 7 beside compiled K1 at
    the half-width it pads them to."""
    rows = {}
    for P in WIDE_COMPILED_P + WIDE_TIMED_P:
        terms64, terms, tdf, fields = _wide_operands(P, dev, 23 + P)
        compiled = P in WIDE_COMPILED_P
        rows[P] = {"K1r": _k1r_times(P, terms, fields,
                                     k1.INSTANTIATED_P if compiled else None,
                                     P == WIDE_ROW_P),
                   "K5r": _k5r_times(P, tdf, fields, compiled,
                                     P == WIDE_ROW_P)}
        del terms64, terms, tdf, fields
        torch.cuda.empty_cache()
    for P, padded in WIDE_PADDED.items():
        _, terms, _, fields = _wide_operands(P, dev, 23 + P)
        rows[P] = {"K1r": _k1r_times(P, terms, fields, (padded,))}
        del terms, fields
        torch.cuda.empty_cache()
    return rows


def _wide_limits(dev):
    """The widest half-width of each run-time kernel on a small grid (K1r
    f32 and f64 in the cheb mode within K1's tolerance of plain, K5r with
    3 and 4 histories bit-equal), its time and resources there; one past
    it refused with the bytes."""
    npts, per = WIDE_SMALL, (False,) * 3
    out = {}
    for dtype, itemsize in ((torch.float32, 4), (torch.float64, 8)):
        P = k1.widest_half_width(k1.k1r_smem(itemsize))
        pads = (P,) * 3
        terms, (x, b, d) = _k1_operands(npts, pads, dtype, dev, P)
        plan = k1.build_kron_plan(terms, npts, pads, per)
        got = k1.kron_mode("cheb", plan, x, b=b, d=d.clone(), c1=0.3, c2=0.7)
        torch.cuda.synchronize()
        want = k1.kron_mode_plain("cheb", terms, x, npts, pads, per, b=b,
                                  diag=plan.diagonal(), d=d, c1=0.3, c2=0.7)
        rel = max(float((g_ - w).abs().max() / w.abs().max())
                  for g_, w in zip(got, want))
        assert rel <= K1_TOL[dtype], (P, dtype, rel)
        ms = _device_ms(lambda: k1.kron_mode("cheb", plan, x, b=b, d=d,
                                             c1=0.3, c2=0.7), 3,
                        rt_kernels(plan, "k1r"))
        res = k1.k1_resources(plan, "cheb")
        wide, _ = _k1_operands(npts, (P + 1,) * 3, dtype, dev, P)
        try:
            k1.build_kron_plan(wide, npts, (P + 1,) * 3, per)
        except RuntimeError as exc:
            assert "bytes of shared memory" in str(exc), exc
            refusal = str(exc)
        else:
            raise AssertionError(f"K1r built a plan at P = {P + 1}")
        out[f"K1r {dtype}"] = {"P": P, "ms": ms, "rel": rel, **res}
        log(f"[wide] K1r {dtype} widest P = {P} at {npts}: tiles "
            f"{plan.tiling}, cheb {ms:.4f} ms, {rel:.2e} of max|y| from "
            f"plain, {res['registers']} registers, {res['smem_bytes']} "
            f"bytes shared, {res['blocks_per_sm']} blocks an SM; P = "
            f"{P + 1} refused: {refusal}")
    for histories in (3, 4):
        P = k1.widest_half_width(twofloat.k5r_smem(histories))
        pads = (P,) * 3
        if histories == 4:
            tdf = _periodic_df_pairs(npts, P, dev)
        else:
            terms, _ = _k1_operands(npts, pads, torch.float64, dev, P)
            split = {id(B): split_f64(B) for t in terms for B in t}
            tdf = [[split[id(B)] for B in t] for t in terms]
        g = torch.Generator(device=dev).manual_seed(P)
        (xh, xl), (bh, bl) = (split_f64(torch.randn(
            npts, generator=g, dtype=torch.float64, device=dev))
            for _ in range(2))
        plan = twofloat.build_kron_df_plan(tdf, npts, pads)
        got = twofloat.residual_kron_df(tdf, bh, bl, xh, xl, pads, plan=plan)
        torch.cuda.synchronize()
        want = twofloat.residual_kron_df_plain(tdf, bh, bl, xh, xl, pads)
        assert all(torch.equal(a, b_) for a, b_ in zip(got, want)), P
        ms = _device_ms(lambda: twofloat.residual_kron_df(
            tdf, None, None, xh, None, pads, plan=plan, negate=True), 3,
            rt_kernels(plan, "k5r"))
        res = twofloat.k5_resources(plan)
        if histories == 4:
            wide = _periodic_df_pairs(npts, P + 1, dev)
        else:
            wt, _ = _k1_operands(npts, (P + 1,) * 3, torch.float64, dev, P)
            wide = [[split_f64(B) for B in t] for t in wt]
        try:
            twofloat.build_kron_df_plan(wide, npts, (P + 1,) * 3)
        except RuntimeError as exc:
            assert "bytes of shared memory" in str(exc), exc
            refusal = str(exc)
        else:
            raise AssertionError(f"K5r built a plan at P = {P + 1}")
        out[f"K5r {histories}"] = {"P": P, "ms": ms, **res}
        log(f"[wide] K5r {histories} histories widest P = {P} at {npts}: "
            f"tiles {plan.tiling}, bit-equal to plain, A.p {ms:.4f} ms, "
            f"{res['registers']} registers, {res['smem_bytes']} bytes "
            f"shared, {res['blocks_per_sm']} blocks an SM; P = {P + 1} "
            f"refused: {refusal}")
    return out


def _periodic_df_pairs(npts, p, dev):
    """The periodic shifted shape's double-word terms (S M M, K M M, M K M,
    M M K: 4 histories) from random bands of half-width p."""
    terms, _ = _k1_operands(npts, (p,) * 3, torch.float64, dev, p)
    Ms = [terms[1][0], terms[0][1], terms[0][2]]
    four = [[0.5 * Ms[0], Ms[1], Ms[2]]] + terms
    split = {}
    return [[split.setdefault(id(B), split_f64(B)) for B in t] for t in four]


def phase_wide_degrees(dev):
    """Spline degrees above 8 on the run-time kernels: the headline at
    128^3 at degrees 9, 10 and 12 (pcg and dc through
    examples/headline_solve.main, and the dwrr PCG; gated as WIDE_GATED
    says, the others logged), every plan at the degree's own half-width
    and K1r and K5r launched; on each pcg run's own operands the checks of
    phase 22 (K5r bit-equal, K1r in every mode on levels 0-1, K7, K6r,
    K6u); K1r and K5r timed at P = 9, 10, 12, 16, against the compiled
    kernels at 3 and 8 and K1r at 4, 6, 7; the widest half-widths and the
    refusal one past them.  Returns the launches of its solves (K1r's and
    K5r's apart), the rows of each run and the kernels' numbers."""
    from poms_tpu_torch.examples import headline_solve

    launches, rt, rows = {}, {}, {}

    def add(grown):
        for k, v in grown.items():
            if k.startswith(("kron_mode_rt", "residual_kron_df_rt")):
                rt[k] = rt.get(k, 0) + v
            elif not k.startswith(("kron_mode", "residual_kron_df",
                                   "kron_apply")):
                launches[k] = launches.get(k, 0) + v

    for degree in WIDE_DEGREES:
        for solver in ("pcg", "dc", "dwrr"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            counters.reset()
            t0 = time.perf_counter()
            gated = degree in WIDE_GATED[solver]
            try:
                if solver == "dwrr":
                    res = _dwrr_run(degree, dev, WIDE_N, DEGREE_MAXITER)
                    grown = res.pop("launches")
                else:
                    res = headline_solve.main(
                        WIDE_N, degree, solver, device=dev,
                        out=lambda m: None,
                        check=_degree_check(degree, timed=solver == "pcg"),
                        maxiter=DEGREE_MAXITER)
                    chk = res.pop("check")
                    grown = chk.pop("launches")
                    res.update(chk)
            except torch.linalg.LinAlgError as exc:
                # a logged run whose f32 coarse Cholesky fails (the method's
                # limit at high degree, ROADMAP's "Not a fault") is logged
                if gated:
                    raise
                log(f"[wide] {WIDE_N}^3 p={degree} {solver} (logged): "
                    f"the setup failed: {exc}")
                rows[f"{degree} {solver}"] = {"error": str(exc)}
                continue
            res["run_s"] = time.perf_counter() - t0
            for key in ([f"residual_kron_df_rt.{p}" for p in k1.RT_PASSES]
                        + [f"kron_mode_rt.cheb.{p}" for p in k1.RT_PASSES]):
                assert grown.get(key, 0) > 0, (degree, solver, key, grown)
            add(grown)
            log(f"[wide] {WIDE_N}^3 p={degree} {solver} "
                f"({'gated' if gated else 'logged'}): "
                f"{res['iterations']} iterations, |r| {res['rn']:.3e}, true "
                f"f64 |b - Ax| {res['true_residual']:.3e}, replayed "
                f"{res['ms_per_iter']:.3f} ms/iteration"
                + (f", setup {res['setup_s']:.3f} s, first solve "
                   f"{res['cold_solve_s']:.3f} s, peak "
                   f"{res['peak_bytes'] / 2 ** 30:.2f} GiB, L2 error "
                   f"{res['l2_error']:.3e}" if solver != "dwrr" else "")
                + f", {res['run_s']:.1f} s in all")
            if gated:
                assert res["converged"] and res["true_residual"] <= 5e-10, \
                    res
            rows[f"{degree} {solver}"] = res
    kernels = _wide_kernels(dev)
    limits = _wide_limits(dev)
    log("[wide] RESULT " + json.dumps(
        {P: {k: {n: r[n] for n in ("ms", "plain_ms", "bound_ms",
                                   "library_ms") if n in r}
             for k, r in row.items()} for P, row in kernels.items()}))
    return {"launches": launches, "rt": rt, "rows": rows,
            "kernels": kernels, "limits": limits}


T_START = time.perf_counter()


def _timed_phase(fn, *args):
    """Run one phase, free the cache, and log what it took."""
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    now = time.perf_counter()
    which = "".join(f" {a}" for a in args if isinstance(a, str))
    log(f"[time] {fn.__name__}{which}: "
        f"{now - t0:.1f} s, ending {now - T_START:.1f} s after the start")
    return out


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
    run = _timed_phase
    run(phase_build)
    k1_res = run(phase_k1, dev)
    run(phase_eft, dev)
    k5_res = run(phase_k5, dev)
    k6_res = run(phase_k6, dev)
    k7_res = run(phase_k7, dev)
    solve = run(phase_solve, dev)
    defect, defect_f32 = run(phase_defect, dev)
    run(phase_check, dev, solve["l2"])
    k4 = run(phase_k4, dev)
    k2 = run(phase_stencil, dev, k4["gbps"], "K2")
    torch.cuda.reset_peak_memory_stats()
    pcg_launches, k2_iterations = run(phase_banded_pcg, dev, solve["l2"])
    mg_launches = run(phase_banded_mg, dev)
    run(phase_banded_check, dev)
    k2_launches = {m: pcg_launches[m] + mg_launches[m] for m in MODES}
    missing = [m for m in MODES if not k2_launches[m] > 0]
    assert not missing, f"the banded paths never launched K2 in {missing}"
    k3 = run(phase_stencil, dev, k4["gbps"], "K3")
    times = run(phase_k3_times, dev, k4["gbps"])
    k3_launches = run(phase_v2_banded, dev, solve["l2"], k2_iterations)
    probes = run(phase_probes, dev, k4["gbps"], times)
    banded_bf16 = run(phase_stencil_bf16, dev, k4["gbps"])
    k1_bf16 = run(phase_k1_bf16, dev)
    k7_bf16 = run(phase_k7_bf16, dev)
    k5_four = run(phase_k5_four, dev)
    bf16_paths = run(phase_bf16_solves, dev, defect_f32, solve)
    periodic = run(phase_periodic, dev)
    dist = run(phase_distributed, dev)
    headline, headline_rows = run(phase_headline, dev)
    poisson = run(phase_poisson_examples, dev)
    benches = run(phase_benches, dev, k4)
    dist_examples, _, _ = run(phase_dist_examples, dev,
                              headline_rows["128 dc"]["ms_per_iter"])
    degrees = run(phase_degrees, dev)
    wide = run(phase_wide_degrees, dev)
    later = (headline, poisson, benches["launches"], dist_examples,
             degrees["launches"], wide["launches"])

    def more(key):
        """The launches of phases 19-23 under one counter's key (phase 22's
        compiled K5 and f32 K1 at half-width 3 only: ``phase_degrees``;
        phase 23's K1r and K5r under their own keys, ``wide["rt"]``)."""
        return sum(c.get(key, 0) for c in later)

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
        "launches": solve["launches"][f"kron_mode.{m}"]
        + defect[f"kron_mode.{m}"] + dist.get(f"kron_mode.{m}", 0)
        + more(f"kron_mode.{m}"),
        "max_abs_err": k1_res[m]["max_abs_err"], "ms": k1_res[m]["ms"],
        "plain_ms": k1_res[m]["plain_ms"], "bound_ms": k1_res[m]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": benches["matmul_ms"] if m == "apply" else None}
        for m in k1.MODES]
    kernels.append({
        "name": "residual_kron_df", "route": "cuda",
        "source": "poms_tpu_torch/csrc/kron_apply_dw.cu",
        "replaces": "poms_tpu/ops/twofloat.py:197",
        "launches": solve["launches"]["residual_kron_df"]
        + defect["residual_kron_df"] + dist.get("residual_kron_df", 0)
        + more("residual_kron_df"),
        "max_abs_err": k5_res["max_abs_err"], "ms": k5_res["ms"],
        "plain_ms": k5_res["plain_ms"], "bound_ms": k5_res["bound_ms"],
        "bound_by": "operations", "library_ms": None})
    new_rows = [
        ("dw_reduce", "dw_reduce.cu", "poms_tpu/ops/twofloat.py:282", k6_res),
        ("dw_update", "dw_update.cu", "poms_tpu/mg/mixed.py:507", k6_res),
        ("transfer", "transfer.cu", "poms_tpu/ops/transfer.py:88",
         {"transfer": k7_res})]
    kernels += [{
        "name": name, "route": "cuda",
        "source": f"poms_tpu_torch/csrc/{src}", "replaces": replaces,
        "launches": solve["launches"][name] + defect[name]
        + dist.get(name, 0) + more(name),
        "bound_by": "bytes", "library_ms": None, **res[name]}
        for name, src, replaces, res in new_rows]
    csr_ms = k2["spmv"]["library_ms"]
    kernels += [{
        "name": f"stencil_apply.{m}", "route": "cuda",
        "source": "poms_tpu_torch/csrc/stencil_apply.cu",
        "replaces": f"poms_tpu/ops/pallas/spmv.py:{K2_REPLACES[m]}",
        "launches": k2_launches[m] + dist.get(f"stencil_apply.{m}", 0)
        + more(f"stencil_apply.{m}"),
        "max_abs_err": k2[m]["max_abs_err"],
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
        "launches": k3_launches[m] + dist.get(f"stencil_apply_v2.{m}", 0)
        + more(f"stencil_apply_v2.{m}"),
        "max_abs_err": k3[m]["max_abs_err"],
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
    # the bf16 instantiations, one row a kernel: the launches of phase 16's
    # paths in bf16 (the banded engines' residual, jacobi and rbgs; K1's
    # cheb and residual).  The banded rows carry the spmv mode's time, the
    # function the CSR product in bf16 beside it computes (the residual
    # pass of the paths takes within 1% of it, logged in phase 14); K1's
    # row carries the cheb mode's
    csr_bf16 = banded_bf16["K2"]["spmv"].get("library_ms")
    for name, tag, src, line, path in (
            ("stencil_apply", "K2", "stencil_apply.cu", 314, "K2"),
            ("stencil_apply_v2", "K3", "stencil_apply_v2.cu", 726, "K3")):
        r = banded_bf16[tag]["spmv"]
        kernels.append({
            "name": f"{name}.bf16", "route": "cuda",
            "source": f"poms_tpu_torch/csrc/{src}",
            "replaces": f"poms_tpu/ops/pallas/spmv.py:{line}",
            "launches": sum(v for k, v in bf16_paths[path].items()
                            if k.startswith(name + ".")
                            and k.endswith("@bf16")),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": csr_bf16})
    r = k1_bf16["cheb"]
    kernels.append({
        "name": "kron_apply.bf16", "route": "cuda",
        "source": "poms_tpu_torch/csrc/kron_apply.cu",
        "replaces": "poms_tpu/ops/pallas/kron.py:157",
        "launches": sum(v for k, v in bf16_paths["kron"].items()
                        if k.startswith("kron_mode.")
                        and k.endswith("@bf16")),
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": "bytes", "library_ms": k1_bf16["library_ms"]})
    kernels.append({
        "name": "transfer.bf16", "route": "cuda",
        "source": "poms_tpu_torch/csrc/transfer.cu",
        "replaces": "poms_tpu/ops/transfer.py:88",
        "launches": bf16_paths["kron"]["transfer@bf16"]
        + bf16_paths["K2"]["transfer@bf16"]
        + bf16_paths["K3"]["transfer@bf16"],
        "bound_by": "bytes", **k7_bf16})
    kernels.append({
        "name": "residual_kron_df.4_histories", "route": "cuda",
        "source": "poms_tpu_torch/csrc/kron_apply_dw.cu",
        "replaces": "poms_tpu/ops/twofloat.py:197",
        "launches": periodic["residual_kron_df"], **k5_four,
        "bound_by": "operations", "library_ms": None})
    # the run-time kernels, launched by the solves of phase 22 (degrees
    # 4-8) and 23 (9, 10, 12), one row a pass, the launches of every dtype:
    # K1r's passes A and B (launched in every mode) and its pass C in each
    # mode they ran (the numbers: f32 at P = 9, 135^3, each pass alone),
    # K5r's three passes (A.p at P = 9)
    k1r = wide["kernels"][WIDE_ROW_P]["K1r"]["passes"]
    pass_keys = {"A": [f"kron_mode_rt.{m}.A" for m in k1.MODES],
                 "B": [f"kron_mode_rt.{m}.B" for m in k1.MODES]}
    pass_keys.update({f"C.{m}": [f"kron_mode_rt.{m}.C"] for m in k1.MODES})
    for key, counts in pass_keys.items():
        n = sum(wide["rt"].get(c, 0) + more(c) for c in counts)
        if n:
            r = k1r[key]
            kernels.append({
                "name": f"kron_apply_rt.{key}", "route": "cuda",
                "source": "poms_tpu_torch/csrc/kron_apply.cu",
                "replaces": "poms_tpu/ops/pallas/kron.py:157",
                "launches": n, "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None})
    k5r = wide["kernels"][WIDE_ROW_P]["K5r"]["passes"]
    for p in twofloat.RT_PASSES:
        r = k5r[p]
        kernels.append({
            "name": f"residual_kron_df_rt.{p}", "route": "cuda",
            "source": "poms_tpu_torch/csrc/kron_apply_dw.cu",
            "replaces": "poms_tpu/ops/twofloat.py:197",
            "launches": wide["rt"][f"residual_kron_df_rt.{p}"]
            + more(f"residual_kron_df_rt.{p}"),
            "max_abs_err": 0.0, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "operations",
            "library_ms": None})
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
