"""Banded SpMV bench on the card: K2 or its plain version, one process.

    python -m poms_tpu_torch.bench.one_impl <impl> <d> <n> <degree> [iters]
        [dtype]

``impl`` is ``k2`` (the CUDA kernel) or ``plain`` (the PyTorch version);
``n`` is a cube edge or an explicit grid ("64x32x128"); ``dtype`` is
``f32`` (default) or ``f64``.  The band and x are random, drawn on the card
from a seed.  Times are CUDA-event means over ``iters`` back-to-back applies
after a warm-up.  Bytes and nnz are counted as the reference's roofline
does: (terms + 2)·points·itemsize and terms·points, terms = (2p+1)^d.
``pct_of_stream`` divides the GB/s by K4's ceiling measured in the same
process (f32 stream probe at 128³ and the same degree, library layout).

Prints one ``RESULT {...}`` line.  Needs a CUDA card: there is no CPU
fallback.
"""
import json
import math
import sys


def main():
    impl = sys.argv[1]
    d = int(sys.argv[2])
    n_s = sys.argv[3]
    degree = int(sys.argv[4])
    iters = int(sys.argv[5]) if len(sys.argv) > 5 else 20
    dtype_s = sys.argv[6] if len(sys.argv) > 6 else "f32"

    import torch

    from poms_tpu_torch.bench.device import nvidia_smi_name_power
    from poms_tpu_torch.bench.kernel_probe import cuda_event_ms, probe_stream
    from poms_tpu_torch.ops.stencil import spmv_banded_plain, stencil_apply

    if impl not in ("k2", "plain"):
        raise SystemExit(f"impl {impl!r}: 'k2' or 'plain'")
    if not torch.cuda.is_available():
        raise SystemExit("one_impl measures the card: no CUDA device found")
    dev = torch.device("cuda", 0)
    dtype = {"f32": torch.float32, "f64": torch.float64}[dtype_s]
    npts = (tuple(int(s) for s in n_s.split("x")) if "x" in n_s
            else (int(n_s),) * d)
    pads = (degree,) * len(npts)
    terms = (2 * degree + 1) ** len(npts)
    g = torch.Generator(device=dev).manual_seed(0)
    band_t = torch.randn(tuple(2 * p + 1 for p in pads) + npts, generator=g,
                         dtype=dtype, device=dev) / (2.0 * math.sqrt(terms))
    x_pad = torch.randn(tuple(n + 2 * p for n, p in zip(npts, pads)),
                        generator=g, dtype=dtype, device=dev)
    if impl == "k2":
        def apply():
            return stencil_apply("spmv", band_t, x_pad, npts, pads)
    else:
        def apply():
            return spmv_banded_plain(band_t, x_pad, npts, pads)
    ms = cuda_event_ms(apply, iters)
    del band_t, x_pad
    torch.cuda.empty_cache()
    _, stream_gbps = probe_stream(128, degree, contiguous=False, iters=iters)
    points = math.prod(npts)
    isize = torch.finfo(dtype).bits // 8
    wall = ms * 1e-3
    gbps = (terms + 2) * points * isize / wall / 1e9
    print("RESULT " + json.dumps({
        "name": f"spmv_banded_{impl}_{len(npts)}d_p{degree}",
        "wall_s": wall, "gbytes_per_s": gbps,
        "gnnz_per_s": terms * points / wall / 1e9,
        "pct_of_stream": 100.0 * gbps / stream_gbps,
        "stream_gbytes_per_s": stream_gbps,
        "grid": list(npts), "dtype": str(dtype).replace("torch.", ""),
        "device": torch.cuda.get_device_name(0),
        "power_limit": nvidia_smi_name_power().rsplit(",", 1)[-1].strip()}),
        flush=True)


if __name__ == "__main__":
    main()
