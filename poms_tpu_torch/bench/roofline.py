"""Roofline bench of the banded SpMV on the card: achieved GB/s and Gnnz/s
against the card's device-memory bandwidth.

Counterpart of ``poms_tpu/bench/roofline.py`` (``sol_bandwidth``,
``BenchResult``, ``bench_spmv``, ``bench_vcycle``).  A banded stencil SpMV
streams the band once, (2p+1)^d coefficients per grid point, reads x and
writes y, so

    bytes = (terms + 2) · points · itemsize,   nnz = terms · points

(itemsize 4, 8, or 2 for a bf16 band and field).

Times are CUDA-event means over ``iters`` back-to-back applies after a
warm-up (:func:`poms_tpu_torch.bench.kernel_probe.cuda_event_ms`); the band
(2.9 GB at 128³ p3 f32) is far larger than the 50 MB L2, so every apply
reads it from device memory.  Operands are drawn on the card from a seed.
``bench_spmv`` needs a CUDA card; ``bench_vcycle`` also runs on the CPU
(``device="cpu"``, the host clock).

Two plain-PyTorch stream yardsticks keep the JAX package's impl names: the
band-sized multiply-accumulate stream ``xlastream`` (y = tanh(x·Σ_t band[t]),
the band read once, x read and y written: the SpMV's byte count) and the
read + write stream ``xlastreamrw`` (x' = 0.9999·x + 1e-7 over a band-sized
array, 2·terms·points·itemsize bytes); each call reads its operands afresh,
nothing is hoisted.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["sol_bandwidth", "BenchResult", "bench_spmv", "bench_vcycle",
           "IMPLS"]

# published device-memory bandwidth (GB/s) by the card's name; the first
# key the (lower-cased) name contains wins (NVIDIA's data sheets)
_HBM_GBPS = (("h100 pcie", 2000.0), ("h100 80gb hbm3", 3350.0),
             ("h100 sxm", 3350.0))
IMPLS = ("plain", "k2", "k3", "kron", "streamfloor", "xlastream",
         "xlastreamrw")


def sol_bandwidth(name: str | None = None) -> float:
    """The card's published device-memory bandwidth in GB/s, by its name
    (``torch.cuda.get_device_name(0)`` by default).  Raises on a card the
    table does not know: a wrong denominator would pass for a result."""
    if name is None:
        name = torch.cuda.get_device_name(0)
    low = name.lower()
    for key, gbps in _HBM_GBPS:
        if key in low:
            return gbps
    raise ValueError(f"no device-memory bandwidth known for {name!r}; add "
                     "it to poms_tpu_torch/bench/roofline.py::_HBM_GBPS")


@dataclass
class BenchResult:
    name: str
    dtype: str
    grid: tuple
    wall_s: float
    gbytes_per_s: float
    gnnz_per_s: float
    pct_sol: float

    def row(self) -> str:
        return (f"{self.name:28s} {self.dtype:8s} {str(self.grid):>18s} "
                f"{self.wall_s * 1e3:8.3f} ms "
                f"{self.gbytes_per_s:8.1f} GB/s {self.gnnz_per_s:8.2f} Gnnz/s "
                f"{self.pct_sol:6.1f} %SoL")


def _kron_apply_fn(npts, degree, dtype, dev):
    """K1 on random 1D bands of the Poisson Kronecker sum's widths; nnz
    counts the equivalent banded operator (the same matrix action)."""
    from poms_tpu_torch.core.kron import KroneckerSumOperator
    from poms_tpu_torch.core.space import StencilVectorSpace

    d = len(npts)
    space = StencilVectorSpace(npts=npts, pads=(degree,) * d,
                               periodic=(False,) * d, dtype=dtype, device=dev)
    rng = np.random.default_rng(1)
    scale = 1.0 / (2.0 * (2 * degree + 1))
    Ks = [torch.as_tensor(rng.standard_normal((n, 2 * degree + 1)) * scale,
                          dtype=dtype, device=dev) for n in npts]
    Ms = [torch.as_tensor(rng.standard_normal((n, 2 * degree + 1)) * scale,
                          dtype=dtype, device=dev) for n in npts]
    op = KroneckerSumOperator(space, [[Ks[b] if b == a else Ms[b]
                                       for b in range(d)] for a in range(d)])
    x = torch.full(npts, 1e-3, dtype=dtype, device=dev)
    return lambda: op._apply_interior(x)


def bench_spmv(npts, degree: int = 3, dtype=torch.float32, iters: int = 20,
               impl: str = "plain") -> BenchResult:
    """Time one banded SpMV implementation on the card.

    ``impl``: ``plain`` (PyTorch shifted multiply-adds), ``k2``, ``k3``
    (the band packed before timing, as an operator packs it at setup),
    ``kron`` (K1), ``streamfloor`` (K4's contiguous band stream; cubic
    f32 grids only), ``xlastream`` or ``xlastreamrw`` (the plain-PyTorch
    stream yardsticks of the module's docstring)."""
    from poms_tpu_torch.bench.kernel_probe import cuda_event_ms, probe_stream

    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r}: one of {IMPLS}")
    if not torch.cuda.is_available():
        raise RuntimeError("bench_spmv measures the card: no CUDA device")
    dev = torch.device("cuda", 0)
    npts = tuple(npts)
    d = len(npts)
    pads = (degree,) * d
    terms = (2 * degree + 1) ** d
    if impl == "kron":
        ms = cuda_event_ms(_kron_apply_fn(npts, degree, dtype, dev), iters)
    elif impl == "streamfloor":
        if npts != (npts[0],) * 3 or dtype != torch.float32:
            raise ValueError("the streamfloor probe takes cubic f32 grids, "
                             f"got npts={npts} dtype={dtype}")
        ms, _ = probe_stream(npts[0], degree, contiguous=True, iters=iters,
                             device=dev)
    elif impl in ("xlastream", "xlastreamrw"):
        points = math.prod(npts)
        g = torch.Generator(device=dev).manual_seed(0)
        if impl == "xlastreamrw":
            bufs = [torch.full((terms * points,), 0.5, dtype=dtype,
                               device=dev) for _ in range(2)]
            scale = torch.tensor(0.9999, dtype=dtype, device=dev)
            shift = torch.tensor(1e-7, dtype=dtype, device=dev)
            state = {"i": 0}

            def stream():
                i = state["i"]
                state["i"] = 1 - i
                # one elementwise pass: read one buffer, write the other
                return torch.addcmul(shift, bufs[i], scale, out=bufs[1 - i])
        else:
            band_flat = (torch.randn((terms, points), generator=g,
                                     dtype=dtype, device=dev)
                         / (2.0 * math.sqrt(terms)))
            x = torch.full((points,), 1e-3, dtype=dtype, device=dev)

            def stream():
                return torch.tanh(band_flat.sum(0) * x)
        ms = cuda_event_ms(stream, iters)
        wall = ms * 1e-3
        isize = torch.finfo(dtype).bits // 8
        nbytes = (2 * terms if impl == "xlastreamrw" else terms + 2) \
            * points * isize
        gbps = nbytes / wall / 1e9
        return BenchResult(
            name=f"spmv_banded_{impl}_{d}d_p{degree}",
            dtype=str(dtype).replace("torch.", ""), grid=npts, wall_s=wall,
            gbytes_per_s=gbps,
            gnnz_per_s=0.0 if impl == "xlastreamrw"
            else terms * points / wall / 1e9,
            pct_sol=100.0 * gbps / sol_bandwidth())
    else:
        from poms_tpu_torch.ops.stencil import (stencil_apply,
                                                stencil_apply_plain)
        from poms_tpu_torch.ops.stencil_v2 import (pack_band_v2,
                                                   stencil_apply_v2)

        g = torch.Generator(device=dev).manual_seed(0)
        band_t = (torch.randn((2 * degree + 1,) * d + npts, generator=g,
                              dtype=dtype, device=dev)
                  / (2.0 * math.sqrt(terms)))
        x_pad = torch.randn(tuple(n + 2 * degree for n in npts), generator=g,
                            dtype=dtype, device=dev)
        if impl == "k3":
            packed = pack_band_v2(band_t, npts, pads)
            torch.cuda.synchronize()

            def apply():
                return stencil_apply_v2("spmv", band_t, x_pad, npts, pads,
                                        packed=packed)
        elif impl == "k2":
            def apply():
                return stencil_apply("spmv", band_t, x_pad, npts, pads)
        else:
            def apply():
                return stencil_apply_plain("spmv", band_t, x_pad, npts, pads)
        ms = cuda_event_ms(apply, iters)
    points = math.prod(npts)
    isize = torch.finfo(dtype).bits // 8
    wall = ms * 1e-3
    gbps = (terms + 2) * points * isize / wall / 1e9
    return BenchResult(
        name=f"spmv_banded_{impl}_{d}d_p{degree}",
        dtype=str(dtype).replace("torch.", ""), grid=npts, wall_s=wall,
        gbytes_per_s=gbps, gnnz_per_s=terms * points / wall / 1e9,
        pct_sol=100.0 * gbps / sol_bandwidth())


def bench_vcycle(dim: int, n_el: int, degree: int, num_levels: int,
                 dtype=torch.float32, iters: int = 5, device=None):
    """Seconds per V-cycle of the banded hierarchy (Jacobi ω = 0.8, ν1 = ν2
    = 2), ``iters`` cycles chained from x = 0 after one warm-up cycle: CUDA
    events on the card (K2, or K3 under ``POMS_TPU_SPMV=v2``, and K7), the
    host clock on the CPU.  Returns (seconds, problem)."""
    import time

    from poms_tpu_torch.core.vector import StencilVector
    from poms_tpu_torch.mg.cycles import CycleConfig, cycle
    from poms_tpu_torch.mg.hierarchy import build_hierarchy
    from poms_tpu_torch.mg.smoother import SmootherConfig
    from poms_tpu_torch.models.poisson import poisson_problem

    prob = poisson_problem(dim, n_el, degree=degree, dtype=dtype,
                           device=device)
    cfg = CycleConfig(smoother=SmootherConfig("jacobi", 0.8))
    levels = build_hierarchy(prob, num_levels)
    b = prob.b
    x = cycle(levels, 0, StencilVector.zeros(prob.space), b, cfg)
    if prob.space.device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            x = cycle(levels, 0, x, b, cfg)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e-3 / iters, prob
    t0 = time.perf_counter()
    for _ in range(iters):
        x = cycle(levels, 0, x, b, cfg)
    return (time.perf_counter() - t0) / iters, prob
