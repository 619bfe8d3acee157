"""K2: the banded stencil apply in its four modes, and its plain versions.

Counterpart of ``poms_tpu/ops/spmv.py`` (the shifted-multiply-add sums) and
of the v1 Pallas engine ``poms_tpu/ops/pallas/spmv.py::_stencil_call``.
A tensor-product B-spline stencil matrix is a dense band of (2p+1)^d
coefficients per point, stored offset-major (``band_t[k..., i...]``
multiplies ``x[i + k - p]``), and its SpMV is a sum of (2p+1)^d shifted
multiply-adds over the ghost-padded input:

    out[i] = Σ_k band_t[k, i] · x_pad[i + k]          (k in [0, 2p]^d)

:func:`stencil_apply` runs one of the modes ``spmv``, ``residual``
(b − Ax), ``jacobi`` (x + ω(b − Ax)/diag) or ``rbgs`` (one red-black
Gauss–Seidel colour phase).  For a CUDA tensor it launches the hand-written
kernel of ``csrc/stencil_apply.cu`` (f32, f64 or bf16; 1D and 2D lifted to
3D) or raises; for a CPU tensor it runs :func:`stencil_apply_plain`, the JAX
package's jnp expressions (``poms_tpu/ops/dispatch.py``) in PyTorch.
``stencil_apply.launches[mode]`` counts kernel launches per mode and
``stencil_apply.launches_by_dtype[name][mode]`` those of one instantiation.
The kernel's launch geometry (the 3D lift, the runs of points a block owns,
its x window and ring of band copies) is computed here, by :func:`k2_lift`
and :func:`k2_plan`, and passed to it.

In bf16 the kernel reads and writes bf16 and computes in f32 (one rounding,
on the store), and the plain version does the same: operands cast to f32, the
f32 expressions, the result rounded once.  The two then differ by one bf16
unit in the last place at the few points where their f32 sums, added in
another order, fall on either side of a rounding boundary.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Optional, Sequence, Tuple

import torch

from poms_tpu_torch.core.space import resolve_device
from poms_tpu_torch.ops import _build, _count

__all__ = ["MODES", "K2_THREADS", "diagonal_band_index", "spmv_banded_plain",
           "spmv_offdiag_plain", "color_mask", "stencil_apply_plain",
           "k2_lift", "k2_plan", "k2_runs", "stencil_apply"]

MODES = ("spmv", "residual", "jacobi", "rbgs")
_KERNELS = {torch.float32: ("stencil_apply_f32", ctypes.c_float),
            torch.float64: ("stencil_apply_f64", ctypes.c_double),
            torch.bfloat16: ("stencil_apply_bf16", ctypes.c_float)}


def diagonal_band_index(pads: Tuple[int, ...]) -> Tuple[int, ...]:
    """Band index of the matrix diagonal: offset 0 lives at k = p per dim."""
    return tuple(pads)


def _band_offsets(pads):
    """All band index tuples k in [0, 2p]^d, in the JAX package's order."""
    return itertools.product(*[range(2 * p + 1) for p in pads])


def _shifted(x_pad: torch.Tensor, k, npts) -> torch.Tensor:
    return x_pad[tuple(slice(ki, ki + n) for ki, n in zip(k, npts))]


def spmv_banded_plain(band_t: torch.Tensor, x_pad: torch.Tensor, npts,
                      pads) -> torch.Tensor:
    """out[i] = Σ_k band_t[k, i] · x_pad[i + k], summed in offset order."""
    out = None
    for k in _band_offsets(pads):
        term = band_t[k] * _shifted(x_pad, k, npts)
        out = term if out is None else out + term
    return out


def spmv_offdiag_plain(band_t: torch.Tensor, x_pad: torch.Tensor, npts,
                       pads) -> torch.Tensor:
    """Like :func:`spmv_banded_plain` without the diagonal term:
    (A x)_offdiag for the Jacobi and Gauss–Seidel sweeps."""
    diag_k = diagonal_band_index(tuple(pads))
    out = None
    for k in _band_offsets(pads):
        if k == diag_k:
            continue
        term = band_t[k] * _shifted(x_pad, k, npts)
        out = term if out is None else out + term
    if out is None:   # pads all zero: purely diagonal matrix
        out = torch.zeros(tuple(npts), dtype=band_t.dtype,
                          device=band_t.device)
    return out


def color_mask(npts: Tuple[int, ...], color: int,
               starts: Optional[Tuple[int, ...]] = None,
               device=None) -> torch.Tensor:
    """Boolean mask of grid points with (Σ global index) % 2 == color.

    ``starts`` are the global offsets of this block: the colour of a point
    depends on its global index (distributed red-black).  ``device=None``
    is the current CUDA card (an error when there is none)."""
    device = resolve_device(device)
    total = None
    for a, n in enumerate(npts):
        shape = [1] * len(npts)
        shape[a] = n
        idx = torch.arange(n, device=device).reshape(shape)
        if starts is not None:
            idx = idx + starts[a]
        total = idx if total is None else total + idx
    return (total.expand(tuple(npts)) % 2) == color


def _interior(x_pad: torch.Tensor, npts, pads) -> torch.Tensor:
    return x_pad[tuple(slice(p, p + n) for n, p in zip(npts, pads))]


def stencil_apply_plain(mode: str, band_t: torch.Tensor, x_pad: torch.Tensor,
                        npts, pads, b: Optional[torch.Tensor] = None,
                        omega: Optional[float] = None, color: int = 0,
                        starts=None) -> torch.Tensor:
    """Plain PyTorch K2: the jnp branch of ``poms_tpu/ops/dispatch.py``
    (bf16 operands: computed in f32 and rounded once, as the kernel does)."""
    npts, pads = tuple(npts), tuple(pads)
    if x_pad.dtype == torch.bfloat16:
        f32 = torch.float32
        return stencil_apply_plain(
            mode, band_t.to(f32), x_pad.to(f32), npts, pads,
            None if b is None else b.to(f32), omega, color,
            starts).to(torch.bfloat16)
    if mode == "spmv":
        return spmv_banded_plain(band_t, x_pad, npts, pads)
    if mode == "residual":
        return b - spmv_banded_plain(band_t, x_pad, npts, pads)
    diag = band_t[diagonal_band_index(pads)]
    x_int = _interior(x_pad, npts, pads)
    if mode == "jacobi":
        Ax = spmv_banded_plain(band_t, x_pad, npts, pads)
        return x_int + omega * (b - Ax) / diag
    if mode == "rbgs":
        s = spmv_offdiag_plain(band_t, x_pad, npts, pads)
        gs = (b - s) / diag
        mask = color_mask(npts, color, starts, device=x_pad.device)
        return torch.where(mask, (1.0 - omega) * x_int + omega * gs, x_int)
    raise ValueError(f"unknown stencil mode {mode!r}")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load("stencil_apply")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for fn, scalar in _KERNELS.values():
        f = getattr(lib, fn)
        f.argtypes = [ptr] * 4 + [scalar] + [ptr] * 3 + [i32, i32, i64, ptr]
        f.restype = i32
    lib.stencil_apply_error_string.argtypes = [i32]
    lib.stencil_apply_error_string.restype = ctypes.c_char_p
    return lib


def _lift(npts: Sequence[int], pads: Sequence[int]):
    """1D/2D geometry as 3D: (1, 1, n) / (1, n1, n2), zero pads on the
    lifted axes (a lifted axis has index 0, so the parity is unchanged)."""
    lead = 3 - len(npts)
    return (1,) * lead + tuple(npts), (0,) * lead + tuple(pads)


# -- K2's launch plan (csrc/stencil_apply.cu computes none of it) ------------

K2_THREADS = 256          # kThreads: points of a run, one a thread
K2_SMEM = 232448          # shared memory a block may have on an H100
# below this many four-plane blocks, one-plane blocks are faster (65^3 p3:
# 289 blocks; measured on an H100, PERF.md section 6)
K2_FEW_BLOCKS = 600
# (T0 planes a block, ring stages) to try in order, per dtype: the first
# whose shared memory fits a block
_K2_CHOICES = {torch.float32: ((4, 2), (1, 4), (1, 2), (1, 1)),
               torch.bfloat16: ((4, 3), (1, 4), (1, 2), (1, 1)),
               torch.float64: ((1, 3), (1, 2), (1, 1))}


def k2_lift(npts: Sequence[int], pads: Sequence[int]):
    """K2's 3D view of a 1D/2D/3D field: (npts3, pads3, axes), ``axes[a]``
    the field axis behind lifted axis ``a`` (None: a lifted axis of extent
    1 and pad 0).  1D is (1, 1, n).  A 2D field whose rows are at least a
    block long is (n1, 1, n2), so a block owns T0 rows and a run along
    them; shorter rows are (1, n1, n2), runs crossing rows.  The band,
    x_pad and the parity read the same either way."""
    npts, pads = tuple(npts), tuple(pads)
    if len(npts) == 1:
        return (1, 1) + npts, (0, 0) + pads, (None, None, 0)
    if len(npts) == 2:
        if npts[1] >= K2_THREADS:
            return ((npts[0], 1, npts[1]), (pads[0], 0, pads[1]),
                    (0, None, 1))
        return (1,) + npts, (0,) + pads, (None, 0, 1)
    return npts, pads, (0, 1, 2)


def k2_plan(npts3, pads3, dtype: torch.dtype,
            t0: Optional[int] = None) -> dict:
    """K2's launch plan for a lifted grid.

    A block owns ``t0`` axis-0 planes and in each one run of at most ``rl``
    points of the raveled (i1, i2) index: each row cut into ``m2`` runs, or
    (``m2 = 0``) the plane's n1·n2 points cut into ``runs`` runs crossing
    rows; the runs of a row or plane differ in length by one at most.  It
    has ``threads``: ``groups`` of computing warps (two, of two planes each,
    at ``t0 = 4``), each the whole warps of ``rl``, and one copying warp.
    Its x window is ``t0 + 2p0`` planes of ``wj`` rows of ``wc`` values
    (arithmetic type); its ring ``depth`` stages of ``(2p2+1)·t0`` slots of
    ``rp`` values, the kernel's fixed pitch: a run's 16-byte-aligned
    superset at any offset.  ``grid`` is (runs, axis-0 blocks), ``smem`` the
    bytes of shared memory a block takes.  ``t0`` fixes the planes a block
    (the probes take K2's 4).  Where no block fits the card's shared
    memory, runs along rows are cut shorter until one does (a wide band on
    3D grids); raises where even a one-point run does not fit."""
    n0, n1, n2 = npts3
    p0, p1, p2 = pads3
    if dtype not in _K2_CHOICES:
        raise TypeError(f"stencil_apply kernel takes float32, float64 or "
                        f"bfloat16, got {dtype}")
    item = torch.empty((), dtype=dtype).element_size()
    arith = 4 if dtype == torch.bfloat16 else item
    vec = 16 // item
    if n2 >= K2_THREADS:     # runs along rows
        m2 = -(-n2 // K2_THREADS)
        rl = -(-n2 // m2)
        runs = n1 * m2
        wj, wc = 1 + 2 * p1, rl + 2 * p2
    else:                    # runs cross rows
        m2 = 0
        runs = -(-(n1 * n2) // K2_THREADS)
        rl = -(-(n1 * n2) // runs)
        span = min(n1, (n2 - 1 + rl - 1) // n2 + 1)
        wj, wc = span + 2 * p1, n2 + 2 * p2
    # a slot holds a run of up to K2_THREADS at any offset in its granule
    rp = -(-(vec - 1 + K2_THREADS) // vec) * vec
    # few blocks (65^3 and coarser): one plane a block, four times as many
    few = runs * -(-n0 // 4) < K2_FEW_BLOCKS
    choices = [(t, d) for t, d in _K2_CHOICES[dtype]
               if (t == t0 if t0 is not None
                   else t == 1 or not (t > n0 or few))]
    if not choices:
        raise ValueError(f"K2 has no {t0}-plane blocks in {dtype}")

    def fit(wj, wc):
        """(t0, depth, ring, window): the first choice whose block fits, or
        the last (the smallest)."""
        for t0, depth in choices:
            ring = depth * (2 * p2 + 1) * t0 * rp * item
            window = (t0 + 2 * p0) * wj * wc * arith
            if ring + window <= K2_SMEM:
                break
        return t0, depth, ring, window

    t0, depth, ring, window = fit(wj, wc)
    # a band too wide for that window: runs along rows (a window of 1 + 2p1
    # rows), cut shorter until the block fits
    for cut in range(max(m2, 1), n2 + 1):
        if ring + window <= K2_SMEM:
            break
        m2, rl, runs = cut, -(-n2 // cut), n1 * cut
        wj, wc = 1 + 2 * p1, rl + 2 * p2
        t0, depth, ring, window = fit(wj, wc)
    if ring + window > K2_SMEM:
        raise RuntimeError(
            f"K2 cannot stage a block of {npts3} at pads {pads3} in {dtype}: "
            f"its x window and band ring take {ring + window} bytes of shared "
            f"memory at the least, and a block may have {K2_SMEM}")
    return dict(t0=t0, depth=depth, rl=rl, m2=m2, runs=runs, wj=wj, wc=wc,
                rp=rp, vec=vec, ring=ring, window=window, smem=ring + window,
                groups=2 if t0 == 4 else 1,
                threads=(2 if t0 == 4 else 1) * (-(-rl // 32) * 32) + 32,
                grid=(runs, -(-n0 // t0)))


def _split(total: int, parts: int, r: int):
    """(start, length) of part ``r`` of ``total`` cut into ``parts`` runs
    whose lengths differ by at most one, the longer first."""
    base, rem = divmod(total, parts)
    return r * base + min(r, rem), base + (r < rem)


def k2_runs(npts3, plan: dict):
    """Every block's (axis-0 start, planes, raveled start q0, length)."""
    n0, n1, n2 = npts3
    for by in range(plan["grid"][1]):
        i0 = by * plan["t0"]
        rows = min(plan["t0"], n0 - i0)
        for r in range(plan["runs"]):
            if plan["m2"] == 0:
                yield (i0, rows) + _split(n1 * n2, plan["runs"], r)
            else:
                j, c = divmod(r, plan["m2"])
                start, length = _split(n2, plan["m2"], c)
                yield i0, rows, j * n2 + start, length


def _plan_args(n3, p3, plan):
    dims = (ctypes.c_int * 6)(*n3, *p3)
    order = ("t0", "rl", "m2", "wj", "wc", "rp", "depth")
    return dims, (ctypes.c_int * 7)(*(plan[k] for k in order))


def _check(band_t, x_pad, b, npts, pads):
    if x_pad.dtype not in _KERNELS:
        raise TypeError(f"stencil_apply kernel takes float32, float64 or "
                        f"bfloat16, got {x_pad.dtype}")
    if not 1 <= len(npts) <= 3 or len(pads) != len(npts):
        raise NotImplementedError(
            f"stencil_apply covers 1D/2D/3D fields, got npts={npts}")
    want_band = tuple(2 * p + 1 for p in pads) + tuple(npts)
    if tuple(band_t.shape) != want_band:
        raise ValueError(f"band_t has shape {tuple(band_t.shape)}, expected "
                         f"{want_band}")
    want_x = tuple(n + 2 * p for n, p in zip(npts, pads))
    if tuple(x_pad.shape) != want_x:
        raise ValueError(f"x_pad has shape {tuple(x_pad.shape)}, expected "
                         f"{want_x}")
    if not band_t.is_contiguous():
        raise ValueError("band_t must be contiguous (StencilMatrix stores "
                         "it so); a copy per apply would double its traffic")
    for t in (band_t, b):
        if t is not None and (t.device != x_pad.device
                              or t.dtype != x_pad.dtype):
            raise ValueError("band_t, x_pad and b must share device and dtype")
    if b is not None and tuple(b.shape) != tuple(npts):
        raise ValueError(f"b has shape {tuple(b.shape)}, expected {npts}")


def stencil_apply(mode: str, band_t: torch.Tensor, x_pad: torch.Tensor,
                  npts, pads, b: Optional[torch.Tensor] = None,
                  omega: Optional[float] = None, color: int = 0,
                  starts=None) -> torch.Tensor:
    """One K2 pass in ``mode`` (see the module docstring).

    ``band_t``: (2p+1 per dim) + npts, offset-major; ``x_pad``: npts + 2p
    per dim with ghosts filled; ``b``: interior-shaped (may be a strided
    view), needed by every mode but ``spmv``; ``omega``: jacobi/rbgs
    damping; ``color``/``starts``: the rbgs colour and the field's global
    index offsets.  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise.
    """
    npts, pads = tuple(npts), tuple(pads)
    if mode not in MODES:
        raise ValueError(f"unknown stencil mode {mode!r}")
    if (mode != "spmv") != (b is not None):
        raise ValueError(f"mode {mode!r} {'needs' if b is None else 'takes no'}"
                         " b")
    if mode in ("jacobi", "rbgs") and omega is None:
        raise ValueError(f"mode {mode!r} needs omega")
    if x_pad.device.type == "cpu":
        return stencil_apply_plain(mode, band_t, x_pad, npts, pads, b, omega,
                                   color, starts)
    if x_pad.device.type != "cuda":
        raise NotImplementedError(
            f"stencil_apply on {x_pad.device.type} tensors")
    _check(band_t, x_pad, b, npts, pads)
    out = _launch(mode, band_t, x_pad.contiguous(), npts, pads, b, omega,
                  color, starts)
    _count.count(stencil_apply, x_pad.dtype, mode)
    return out


def _launch(mode, band_t, x_pad, npts, pads, b, omega, color, starts,
            plan=None):
    """One K2 launch (checked operands, contiguous x_pad) in ``plan``, by
    default :func:`k2_plan`'s."""
    n3, p3, axes = k2_lift(npts, pads)
    if plan is None:
        plan = k2_plan(n3, p3, x_pad.dtype)
    dims, plan_c = _plan_args(n3, p3, plan)
    strides = (ctypes.c_int64 * 3)(*(
        0 if b is None or a is None else b.stride(a) for a in axes))
    out = torch.empty(npts, dtype=x_pad.dtype, device=x_pad.device)
    pbase = sum(starts) if starts is not None else 0
    fn, scalar = _KERNELS[x_pad.dtype]
    lib = _library()
    with torch.cuda.device(x_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(
            band_t.data_ptr(), x_pad.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(),
            scalar(0.0 if omega is None else float(omega)), dims, plan_c,
            strides, MODES.index(mode), int(color), int(pbase), stream)
    if err != 0:
        raise RuntimeError(f"stencil_apply kernel launch failed ({mode}): "
                           + lib.stencil_apply_error_string(err).decode())
    return out


_count.attach(stencil_apply, MODES)
