"""Kernel-limit probes: what caps the banded SpMV on the card?

Counterpart of ``poms_tpu/bench/kernel_probe.py``.  Each probe is a
hand-written kernel with a plain PyTorch version beside it (taken for CPU
tensors; a CUDA tensor launches the kernel or raises), a launch counter,
and a timing function that prints one ``RESULT`` row with the card's name:

- ``stream`` / ``streamc`` (K4, ``csrc/stream_probe.cu``): a band-sized f32
  buffer reduced plane by plane (out = Σ_planes band + 1e-6·x), in the
  library layout (w, w, w, n, n, n) or the contiguous layout
  (w, n, w, w, n, n): the device-memory ceiling, in GB/s with the
  reference's byte count (w³ + 2)·n³·4.  :func:`stream_probe`.
- ``compute`` (K4c) and ``ablate`` (K4a): K2's own kernel template
  (``csrc/stencil_apply.cu``, spmv, f32, 3D, K2's launch plan
  :func:`~poms_tpu_torch.ops.stencil.k2_plan`) with one part of its inner
  loop changed at compile time (:func:`stencil_probe`): ``compute`` copies
  the band runs of block (0, 0) in every block (no band stream from device
  memory; :func:`k2_pinned`); ``noshift`` holds the axis-1 x offset at 0,
  ``nolane`` the axis-2 offset, ``nomul`` copies and reads no band
  (acc += x), ``full`` is K2.  Only ``full`` is the SpMV.
- ``v15`` (K4v, ``csrc/probe_v15.cu``): a real SpMV in which each x value
  read from shared memory serves every output plane it reaches
  (:func:`v15_apply`).

    python -m poms_tpu_torch.bench.kernel_probe [probe] [n] [p] [...]

``probe`` is ``stream`` (default), ``streamc``, ``compute``, ``v15``
(then ``[t0] [t2]``, default 8 8) or ``ablate`` (then ``[variant] [t2]``,
default ``full`` 0); ``n`` (default 128) and ``p`` (default 3) give the
n³ grid and the degree.  Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import functools
import sys

import torch

from poms_tpu_torch.ops import _build
from poms_tpu_torch.ops.stencil import (_band_offsets, _plan_args, _shifted,
                                        k2_plan, k2_runs,
                                        spmv_banded_plain)

__all__ = ["stream_probe", "stream_probe_plain", "make_band", "probe_stream",
           "cuda_event_ms", "K2_PROBE_T0", "k2_pinned", "PROBE_VARIANTS",
           "stencil_probe",
           "stream_edge",
           "stencil_probe_plain", "v15_apply", "probe_operands",
           "probe_compute", "probe_v15", "probe_ablate", "PROBES"]

# the axis-0 planes of K2's f32 3D blocks (ops/stencil.py::k2_plan), which
# the probes need: the compute probe pins block (0, 0)
K2_PROBE_T0 = 4
# stencil_probe's variants, in the order of csrc/stencil_apply.cu's Variant
PROBE_VARIANTS = ("full", "compute", "noshift", "nolane", "nomul")
ABLATE_VARIANTS = ("full", "noshift", "nolane", "nomul")
PROBES = ("stream", "streamc", "compute", "v15", "ablate")


def stream_probe_plain(band: torch.Tensor, x: torch.Tensor,
                       contiguous: bool) -> torch.Tensor:
    """Plain K4: the plane sum with ``torch.sum``, plus 1e-6·x."""
    n = x.shape[0]
    if contiguous:   # (w, n, w, w, n, n): sum over k1, k2, k3
        acc = band.sum(dim=(0, 2, 3))
    else:            # (w, w, w, n, n, n)
        acc = band.reshape(-1, n, n, n).sum(dim=0)
    return acc + 1e-6 * x


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("stream_probe")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.stream_probe_f32.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
    lib.stream_probe_f32.restype = i32
    lib.stream_probe_error_string.argtypes = [i32]
    lib.stream_probe_error_string.restype = ctypes.c_char_p
    return lib


def _shape(n: int, w: int, contiguous: bool):
    return (w, n, w, w, n, n) if contiguous else (w, w, w, n, n, n)


def stream_probe(band: torch.Tensor, x: torch.Tensor,
                 contiguous: bool) -> torch.Tensor:
    """out[i] = Σ over the w³ planes of band + 1e-6·x[i]; x is (n, n, n)."""
    if x.device.type == "cpu":
        return stream_probe_plain(band, x, contiguous)
    if x.device.type != "cuda":
        raise NotImplementedError(f"stream_probe on {x.device.type} tensors")
    n, w = x.shape[0], band.shape[0]
    if band.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("the stream probe is float32")
    if tuple(x.shape) != (n, n, n) or n % 4:
        raise ValueError(f"x must be (n, n, n) with n % 4 == 0, got "
                         f"{tuple(x.shape)}")
    if tuple(band.shape) != _shape(n, w, contiguous):
        raise ValueError(f"band has shape {tuple(band.shape)}, expected "
                         f"{_shape(n, w, contiguous)}")
    if not (band.is_contiguous() and x.is_contiguous()):
        raise ValueError("band and x must be contiguous")
    out = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stream_probe_f32(band.data_ptr(), x.data_ptr(),
                                   out.data_ptr(), n, w, int(contiguous),
                                   stream)
    if err != 0:
        raise RuntimeError("stream_probe kernel launch failed: "
                           + lib.stream_probe_error_string(err).decode())
    stream_probe.launches += 1
    return out


stream_probe.launches = 0


def cuda_event_ms(fn, reps: int = 20) -> float:
    """Mean time per call on the current stream, by CUDA events around
    ``reps`` back-to-back calls after one warm-up call (includes the gaps
    in which the host is still enqueuing: wrapper and launch overhead)."""
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


def make_band(n: int, p: int, contiguous: bool, device,
              seed: int = 0) -> torch.Tensor:
    """A band-sized f32 buffer of the probe's layout, drawn on the card."""
    w = 2 * p + 1
    g = torch.Generator(device=device).manual_seed(seed)
    band = torch.randn(_shape(n, w, contiguous), generator=g,
                       dtype=torch.float32, device=device)
    return band.mul_(1.0 / (2 * (w ** 3) ** 0.5))


def probe_stream(n: int, p: int, contiguous: bool, iters: int = 20,
                 device="cuda"):
    """Time K4 at (n, p) on the card: returns (ms per pass, GB/s), GB/s
    counted as (w³ + 2)·n³·4 bytes per pass."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("probe_stream measures the card: give a CUDA "
                           "device")
    band = make_band(n, p, contiguous, device)
    x = torch.zeros((n, n, n), dtype=torch.float32, device=device)
    ms = cuda_event_ms(lambda: stream_probe(band, x, contiguous), iters)
    w = 2 * p + 1
    gbps = (w ** 3 + 2) * n ** 3 * 4 / (ms * 1e-3) / 1e9
    return ms, gbps


# -- K4c and K4a: K2's template with one part changed ----------------------

def _probe_plan(npts):
    """K2's f32 plan at ``npts`` over its first axis-0 block only (the runs
    do not depend on the pads)."""
    return dict(k2_plan(tuple(npts), (0, 0, 0), torch.float32,
                        t0=K2_PROBE_T0), grid=(0, 1))


def k2_pinned(npts):
    """Where the compute probe reads the band for each point of an
    (n0, n1, n2) grid: (axis-0 index per i0, raveled (i1, i2) index per
    raveled q), i.e. the same place in block (0, 0) of K2's plan as the
    point has in its own block: i0 mod T0 and its position in its run."""
    n0 = npts[0]
    i0 = torch.arange(n0) % K2_PROBE_T0
    pos = torch.empty(npts[1] * npts[2], dtype=torch.long)
    for _, _, q0, length in k2_runs(npts, _probe_plan(npts)):
        pos[q0:q0 + length] = torch.arange(length)
    return i0, pos


def stencil_probe_plain(variant: str, band_t: torch.Tensor,
                        x_pad: torch.Tensor, npts, pads) -> torch.Tensor:
    """Plain K4c/K4a: ``full`` is the SpMV; ``compute`` is
    out[i] = Σ_k band_t[k, pinned(i)]·x_pad[i + k] (:func:`k2_pinned`);
    ``noshift``,
    ``nolane`` and ``nomul`` sum band_t[k, i]·x_pad[i + k] with k1 := 0,
    with k2 := 0, or without the band."""
    npts, pads = tuple(npts), tuple(pads)
    if variant not in PROBE_VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}")
    if variant == "compute":
        i0, q = k2_pinned(npts)
        w3 = band_t.shape[:3]
        flat = band_t.reshape(w3 + (npts[0], npts[1] * npts[2]))
        band_t = flat[:, :, :, i0][..., q].reshape(band_t.shape)
    if variant in ("full", "compute"):
        return spmv_banded_plain(band_t, x_pad, npts, pads)
    out = None
    for k in _band_offsets(pads):
        s = list(k)
        if variant == "noshift":
            s[1] = 0
        elif variant == "nolane":
            s[2] = 0
        xs = _shifted(x_pad, s, npts)
        term = xs if variant == "nomul" else band_t[k] * xs
        out = term if out is None else out + term
    return out


@functools.cache
def _probe_library() -> ctypes.CDLL:
    lib = _build.load("stencil_apply")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.stencil_probe_f32.argtypes = [i32] + [ptr] * 6
    lib.stencil_probe_f32.restype = i32
    lib.stencil_apply_error_string.argtypes = [i32]
    lib.stencil_apply_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _v15_library() -> ctypes.CDLL:
    lib = _build.load("probe_v15")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.probe_v15_f32.argtypes = [ptr] * 3 + [i32] * 8 + [ptr]
    lib.probe_v15_f32.restype = i32
    lib.probe_v15_error_string.argtypes = [i32]
    lib.probe_v15_error_string.restype = ctypes.c_char_p
    return lib


def _check_probe(band_t, x_pad, npts, pads, least=(1, 1, 1)):
    if band_t.dtype != torch.float32 or x_pad.dtype != torch.float32:
        raise TypeError("the probes are float32")
    if len(npts) != 3 or any(n < m for n, m in zip(npts, least)):
        raise ValueError(f"the probes take 3D grids of at least {least}, "
                         f"got {npts}")
    want_band = tuple(2 * p + 1 for p in pads) + tuple(npts)
    want_x = tuple(n + 2 * p for n, p in zip(npts, pads))
    if tuple(band_t.shape) != want_band or tuple(x_pad.shape) != want_x:
        raise ValueError(f"band_t {tuple(band_t.shape)} / x_pad "
                         f"{tuple(x_pad.shape)}: expected {want_band} / "
                         f"{want_x}")
    if band_t.device != x_pad.device:
        raise ValueError("band_t and x_pad must share a device")
    if not (band_t.is_contiguous() and x_pad.is_contiguous()):
        raise ValueError("band_t and x_pad must be contiguous")


def stencil_probe(variant: str, band_t: torch.Tensor, x_pad: torch.Tensor,
                  npts, pads) -> torch.Tensor:
    """One pass of K2's template in ``variant`` (see
    :func:`stencil_probe_plain`): the kernel for CUDA tensors (f32, 3D,
    n0 at least K2's 4 planes a block), the plain version for CPU
    tensors."""
    npts, pads = tuple(npts), tuple(pads)
    if variant not in PROBE_VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}")
    if x_pad.device.type == "cpu":
        return stencil_probe_plain(variant, band_t, x_pad, npts, pads)
    if x_pad.device.type != "cuda":
        raise NotImplementedError(f"stencil_probe on {x_pad.device.type} "
                                  "tensors")
    _check_probe(band_t, x_pad, npts, pads, least=(K2_PROBE_T0, 1, 1))
    plan = k2_plan(npts, pads, torch.float32, t0=K2_PROBE_T0)
    out = torch.empty(npts, dtype=x_pad.dtype, device=x_pad.device)
    lib = _probe_library()
    dims, plan_c = _plan_args(npts, pads, plan)
    with torch.cuda.device(x_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stencil_probe_f32(PROBE_VARIANTS.index(variant),
                                    band_t.data_ptr(), x_pad.data_ptr(),
                                    out.data_ptr(), dims, plan_c, stream)
    if err != 0:
        raise RuntimeError(f"stencil_probe kernel launch failed ({variant}): "
                           + lib.stencil_apply_error_string(err).decode())
    stencil_probe.launches[variant] += 1
    return out


stencil_probe.launches = dict.fromkeys(PROBE_VARIANTS, 0)


# -- K4v: plane reuse -------------------------------------------------------

def v15_apply(band_t: torch.Tensor, x_pad: torch.Tensor, npts, pads,
              t0: int = 8, t2: int = 8) -> torch.Tensor:
    """The banded SpMV by K4v (``t0`` points a thread along axis 0, ``t2``
    rows a block) for CUDA tensors, by :func:`spmv_banded_plain` for CPU
    tensors."""
    npts, pads = tuple(npts), tuple(pads)
    if x_pad.device.type == "cpu":
        return spmv_banded_plain(band_t, x_pad, npts, pads)
    if x_pad.device.type != "cuda":
        raise NotImplementedError(f"v15_apply on {x_pad.device.type} tensors")
    _check_probe(band_t, x_pad, npts, pads)
    out = torch.empty(npts, dtype=x_pad.dtype, device=x_pad.device)
    lib = _v15_library()
    with torch.cuda.device(x_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.probe_v15_f32(band_t.data_ptr(), x_pad.data_ptr(),
                                out.data_ptr(), *npts, *pads, int(t0),
                                int(t2), stream)
    if err != 0:
        raise RuntimeError(f"probe_v15 kernel launch failed (t0={t0}, "
                           f"t2={t2}): "
                           + lib.probe_v15_error_string(err).decode())
    v15_apply.launches += 1
    return out


v15_apply.launches = 0


# -- timing on the card -----------------------------------------------------

def probe_operands(n: int, p: int, device, seed: int = 0):
    """A random f32 (w, w, w, n, n, n) band, scaled by 1/(2·sqrt(w³)), and a
    random ghost-padded x, drawn on ``device``."""
    w = 2 * p + 1
    g = torch.Generator(device=device).manual_seed(seed)
    band = torch.randn((w,) * 3 + (n,) * 3, generator=g, device=device)
    band.mul_(1.0 / (2 * (w ** 3) ** 0.5))
    x_pad = torch.randn((n + 2 * p,) * 3, generator=g, device=device)
    return band, x_pad


def _card(device):
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("the probes measure the card: give a CUDA device")
    return device


def stream_edge(n: int) -> int:
    """The cube edge at which K4 is measured for an n³ probe: n rounded up
    to K4's multiple of 4 (GB/s is a rate; the byte count stays n's)."""
    return -(-n // 4) * 4


def probe_compute(n: int, p: int, iters: int = 20, device="cuda") -> dict:
    """Time K4c at n³, p and the band-stream floor w³·n³·4 / K4's GB/s
    (K4 measured here, library layout, at :func:`stream_edge` (n))."""
    device = _card(device)
    band, x_pad = probe_operands(n, p, device)
    args = (band, x_pad, (n,) * 3, (p,) * 3)
    ms = cuda_event_ms(lambda: stencil_probe("compute", *args), iters)
    del band, x_pad, args
    torch.cuda.empty_cache()
    _, gbps = probe_stream(stream_edge(n), p, False, iters, device)
    floor_ms = (2 * p + 1) ** 3 * n ** 3 * 4 / (gbps * 1e9) * 1e3
    print(f"RESULT compute: {ms:.4f} ms (vs band-stream floor "
          f"{floor_ms:.4f} ms at K4's {gbps:.1f} GB/s) "
          f"({torch.cuda.get_device_name(device)})", flush=True)
    return {"ms": ms, "floor_ms": floor_ms, "stream_gbps": gbps}


def probe_v15(n: int, p: int, t0: int = 8, t2: int = 8, iters: int = 20,
              device="cuda") -> dict:
    """Check K4v against :func:`spmv_banded_plain` at n³, p, then time it;
    GB/s counted as (w³ + 2)·n³·4 bytes per pass."""
    from poms_tpu_torch.bench.roofline import sol_bandwidth

    device = _card(device)
    band, x_pad = probe_operands(n, p, device)
    args = (band, x_pad, (n,) * 3, (p,) * 3)
    y = v15_apply(*args, t0=t0, t2=t2)
    torch.cuda.synchronize()
    ref = spmv_banded_plain(*args)
    err = float((y - ref).abs().max())
    rel = err / float(ref.abs().max())
    del y, ref
    print(f"v15 correctness: max err {err:.3e} (relative {rel:.3e})",
          flush=True)
    ms = cuda_event_ms(lambda: v15_apply(*args, t0=t0, t2=t2), iters)
    gbps = ((2 * p + 1) ** 3 + 2) * n ** 3 * 4 / (ms * 1e-3) / 1e9
    name = torch.cuda.get_device_name(device)
    print(f"RESULT v15(t0={t0},t2={t2}): {ms:.4f} ms  {gbps:.1f} GB/s  "
          f"{100 * gbps / sol_bandwidth(name):.1f}% SoL ({name})",
          flush=True)
    return {"ms": ms, "gbps": gbps, "max_abs_err": err, "rel_err": rel}


def probe_ablate(n: int, p: int, variant: str, t2: int = 0,
                 iters: int = 20, device="cuda") -> dict:
    """Time K4a ``variant`` (``full``, ``noshift``, ``nolane``, ``nomul``)
    at n³, p, in K2's launch plan (:func:`~poms_tpu_torch.ops.stencil.
    k2_plan`).  ``t2`` is kept for the command line: 0 only, since the
    template runs at K2's plan alone."""
    if variant not in ABLATE_VARIANTS:
        raise ValueError(f"ablate variant {variant!r}: one of "
                         f"{ABLATE_VARIANTS}")
    if t2 != 0:
        raise ValueError(f"t2={t2}: the ablations run at K2's launch plan "
                         f"only (t2 = 0)")
    device = _card(device)
    band, x_pad = probe_operands(n, p, device)
    args = (band, x_pad, (n,) * 3, (p,) * 3)
    ms = cuda_event_ms(lambda: stencil_probe(variant, *args), iters)
    print(f"RESULT ablate[{variant}]: {ms:.4f} ms "
          f"({torch.cuda.get_device_name(device)})", flush=True)
    return {"ms": ms}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    probe = argv[0] if argv else "stream"
    if probe not in PROBES:
        raise SystemExit(f"unknown probe {probe!r}: one of {PROBES}")
    n = int(argv[1]) if len(argv) > 1 else 128
    p = int(argv[2]) if len(argv) > 2 else 3
    if not torch.cuda.is_available():
        raise SystemExit("the probes measure the card: no CUDA device")
    if probe in ("stream", "streamc"):
        ms, gbps = probe_stream(n, p, probe == "streamc")
        print(f"RESULT {probe}: {ms:.4f} ms  {gbps:.1f} GB/s "
              f"({torch.cuda.get_device_name(0)})", flush=True)
    elif probe == "compute":
        probe_compute(n, p)
    elif probe == "v15":
        t0 = int(argv[3]) if len(argv) > 3 else 8
        t2 = int(argv[4]) if len(argv) > 4 else 8
        probe_v15(n, p, t0, t2)
    else:
        variant = argv[3] if len(argv) > 3 else "full"
        t2 = int(argv[4]) if len(argv) > 4 else 0
        probe_ablate(n, p, variant, t2)


if __name__ == "__main__":
    main()
