"""Banded SpMV bench on the card, one implementation in one process.

    python -m poms_tpu_torch.bench.one_impl <impl> <d> <n> <degree> [iters]
        [dtype]

``impl`` is ``k2``, ``k3`` (the CUDA kernels; K3's band packed before
timing), ``plain`` (the PyTorch version), ``kron`` (K1) or ``streamfloor``
(K4); ``n`` is a cube edge or an explicit grid ("64x32x128"); ``dtype`` is
``f32`` (default) or ``f64``.  Timing and byte counts are
:func:`poms_tpu_torch.bench.roofline.bench_spmv`'s.

Prints one ``RESULT {...}`` line with the JAX package's keys (``name``,
``wall_s``, ``gbytes_per_s``, ``gnnz_per_s``, ``pct_sol`` against
``roofline.sol_bandwidth()`` of the card, ``grid``, ``dtype``) and the
port's: ``pct_of_stream`` and ``stream_gbytes_per_s`` (K4's ceiling
measured in the same process: f32 stream probe at 128³ and the same
degree, library layout), ``device`` and ``power_limit``.  Needs a CUDA
card: there is no CPU fallback.
"""
import json
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
    from poms_tpu_torch.bench.kernel_probe import probe_stream
    from poms_tpu_torch.bench.roofline import IMPLS, bench_spmv

    if impl not in IMPLS:
        raise SystemExit(f"impl {impl!r}: one of {IMPLS}")
    if not torch.cuda.is_available():
        raise SystemExit("one_impl measures the card: no CUDA device found")
    dtype = {"f32": torch.float32, "f64": torch.float64}[dtype_s]
    npts = (tuple(int(s) for s in n_s.split("x")) if "x" in n_s
            else (int(n_s),) * d)
    r = bench_spmv(npts, degree=degree, dtype=dtype, iters=iters, impl=impl)
    torch.cuda.empty_cache()
    _, stream_gbps = probe_stream(128, degree, contiguous=False, iters=iters)
    print("RESULT " + json.dumps({
        "name": r.name, "wall_s": r.wall_s, "gbytes_per_s": r.gbytes_per_s,
        "gnnz_per_s": r.gnnz_per_s, "pct_sol": r.pct_sol,
        "grid": list(r.grid), "dtype": r.dtype,
        "pct_of_stream": 100.0 * r.gbytes_per_s / stream_gbps,
        "stream_gbytes_per_s": stream_gbps,
        "device": torch.cuda.get_device_name(0),
        "power_limit": nvidia_smi_name_power().rsplit(",", 1)[-1].strip()}),
        flush=True)


if __name__ == "__main__":
    main()
