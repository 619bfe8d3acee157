"""Stream probe (K4): the device-memory ceiling a banded SpMV is read
against.

Counterpart of ``poms_tpu/bench/kernel_probe.py::probe_stream``.
:func:`stream_probe` reduces a band-sized f32 buffer plane by plane
(out = Σ_planes band + 1e-6·x) in one pass, in the library layout
(w, w, w, n, n, n) or the contiguous layout (w, n, w, w, n, n): for a CUDA
tensor with the hand-written kernel of ``csrc/stream_probe.cu`` (or it
raises), for a CPU tensor with :func:`stream_probe_plain` (``torch.sum``).
``stream_probe.launches`` counts kernel launches.  :func:`probe_stream`
times it on the card and reports GB/s with the reference's byte count
(w³ + 2)·n³·4.

    python -m poms_tpu_torch.bench.kernel_probe [n] [p]
"""
from __future__ import annotations

import ctypes
import functools
import sys

import torch

from poms_tpu_torch.ops import _build

__all__ = ["stream_probe", "stream_probe_plain", "make_band", "probe_stream",
           "cuda_event_ms"]


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


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    p = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    if not torch.cuda.is_available():
        raise SystemExit("the stream probe measures the card: no CUDA device")
    for contiguous in (False, True):
        ms, gbps = probe_stream(n, p, contiguous)
        name = "streamc" if contiguous else "stream"
        print(f"RESULT {name}: {ms:.4f} ms  {gbps:.1f} GB/s "
              f"({torch.cuda.get_device_name(0)})", flush=True)


if __name__ == "__main__":
    main()
