"""K2 at every level shape and dtype, and K6r's three calls, on the card,
beside their bounds and (optionally) the sources they had before.

    python -m poms_tpu_torch.bench.k2_compare [--old-k2 SRC.cu]
        [--old-k6r SRC.cu] [--sizes 129,65,33,17,128] [--dtypes f32,bf16,f64]

For each n in ``--sizes`` (n³ points, p = 3) and dtype it prints K2's device
time (``torch.profiler``, mean of 20) in ``spmv`` and ``residual`` mode
beside the byte bound (the band, x, the output and b once, over the card's
published bandwidth).  ``--old-k2`` also builds that source (K2 before its
redesign: one block per 4 × 8 × 32 tile, band loads from each thread) behind
the signature it had and times its ``spmv`` in turns with the new one: old,
new, new, old, after checking the two agree.  K6r is timed at 129³ in the three calls of a dw-PCG iteration (the stacked pair, the norm, p·Ap) beside
its byte bound and a yardstick that reads the same bytes (``torch.dot`` of
two f64 vectors of the same n; ``torch.linalg.vector_norm`` of one), which
the port never calls; ``--old-k6r`` times the earlier two-launch source in
turns the same way.  One ``RESULT {...}`` line per measurement.  Needs a
CUDA card.
"""
import ctypes
import json
import sys

from poms_tpu_torch.bench.k1_compare import build_old

SIZES = (129, 65, 33, 17, 128)
DTYPES = ("f32", "bf16", "f64")


def _old_k2(source):
    """The earlier K2 (spmv mode) built from ``source``."""
    import torch

    lib = build_old(source, "stencil_apply")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    names = {torch.float32: ("stencil_apply_f32", ctypes.c_float),
             torch.float64: ("stencil_apply_f64", ctypes.c_double),
             torch.bfloat16: ("stencil_apply_bf16", ctypes.c_float)}
    for fn, scalar in names.values():
        f = getattr(lib, fn)
        f.argtypes = ([ptr] * 4 + [scalar] + [i32] * 6 + [i64] * 3
                      + [i32, i32, i64, ptr])
        f.restype = i32

    def spmv(band, x_pad, npts, pads):
        out = torch.empty(npts, dtype=x_pad.dtype, device=x_pad.device)
        fn, scalar = names[x_pad.dtype]
        err = getattr(lib, fn)(band.data_ptr(), x_pad.data_ptr(), None,
                               out.data_ptr(), scalar(0.0), *npts, *pads,
                               0, 0, 0, 0, 0, 0,
                               torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the earlier K2 refused the launch: {err}")
        return out

    return spmv


def _old_k6r(source):
    """The earlier two-launch K6r built from ``source``, on flat fields."""
    import torch

    lib = build_old(source, "dw_reduce")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dw_reduce.argtypes = [ptr, i32, i64, ptr, ptr, i32, ptr]
    lib.dw_reduce.restype = i32
    blocks = lib.dw_reduce_max_blocks()

    def reduce(pairs, sqrt=False):
        first = pairs[0][0]
        ptrs = [None if t is None else t.data_ptr()
                for quad in pairs for t in quad]
        part = torch.empty(2 * len(pairs) * blocks, dtype=torch.float32,
                           device=first.device)
        out = torch.empty(len(pairs), dtype=torch.float64,
                          device=first.device)
        err = lib.dw_reduce((ctypes.c_void_p * len(ptrs))(*ptrs), len(pairs),
                            first.numel(), part.data_ptr(), out.data_ptr(),
                            int(sqrt),
                            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the earlier K6r refused the launch: {err}")
        return out

    return reduce


def _arg(args, flag, default=None):
    return args[args.index(flag) + 1] if flag in args else default


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    old_k2, old_k6r = _arg(args, "--old-k2"), _arg(args, "--old-k6r")
    sizes = tuple(int(n) for n in _arg(args, "--sizes", ",".join(
        map(str, SIZES))).split(","))
    dtypes = tuple(_arg(args, "--dtypes", ",".join(DTYPES)).split(","))

    import torch

    from poms_tpu_torch.bench.device import device_ms, nvidia_smi_name_power
    from poms_tpu_torch.bench.roofline import sol_bandwidth
    from poms_tpu_torch.core.vector import ghost_pad
    from poms_tpu_torch.ops import twofloat
    from poms_tpu_torch.ops.stencil import stencil_apply, stencil_apply_plain

    if not torch.cuda.is_available():
        raise SystemExit("k2_compare measures the card: no CUDA device found")
    dev = torch.device("cuda", 0)
    card = nvidia_smi_name_power()
    bw = sol_bandwidth(torch.cuda.get_device_name(0)) * 1e9
    print(f"card: {card}; bound at {bw / 1e12:.2f} TB/s", flush=True)
    types = {"f32": torch.float32, "bf16": torch.bfloat16,
             "f64": torch.float64}

    def result(**kw):
        print("RESULT " + json.dumps({**kw, "card": card}), flush=True)

    old = _old_k2(old_k2) if old_k2 else None
    for name in dtypes:
        dtype = types[name]
        item = torch.empty((), dtype=dtype).element_size()
        for n in sizes:
            npts, pads = (n,) * 3, (3,) * 3
            g = torch.Generator(device=dev).manual_seed(n)
            work = torch.float64 if dtype == torch.float64 else torch.float32
            band = torch.randn((7,) * 3 + npts, generator=g, dtype=work,
                               device=dev).div_(8)
            band[3, 3, 3] += 4.0
            x = torch.randn(npts, generator=g, dtype=work, device=dev)
            b = torch.randn(npts, generator=g, dtype=work, device=dev)
            band, x, b = band.to(dtype), x.to(dtype), b.to(dtype)
            x_pad = ghost_pad(x, pads, (False,) * 3).contiguous()
            for mode in ("spmv", "residual"):
                kw = {} if mode == "spmv" else {"b": b}
                fields = 343 + 2 + (mode != "spmv")
                bound = fields * n ** 3 * item / bw * 1e3
                ms = device_ms(lambda: stencil_apply(mode, band, x_pad, npts,
                                                     pads, **kw))
                result(kernel=f"K2.{mode}", dtype=name, n=n, ms=ms,
                       bound_ms=bound, share_of_bound=bound / ms)
            if old is not None:
                new = lambda: stencil_apply("spmv", band, x_pad,  # noqa: E731
                                            npts, pads)
                before = lambda: old(band, x_pad, npts, pads)  # noqa: E731
                want = stencil_apply_plain("spmv", band, x_pad, npts, pads)
                scale = want.float().abs().max()
                for who, fn in (("old", before), ("new", new)):
                    rel = float((fn().float() - want.float()).abs().max()
                                / scale)
                    assert rel <= (2e-2 if name == "bf16" else 1e-5), \
                        (who, rel)
                del want
                for who, fn in (("old", before), ("new", new), ("new", new),
                                ("old", before)):
                    result(kernel="K2.spmv", turn=who, dtype=name, n=n,
                           ms=device_ms(fn))
            del band, x, b, x_pad
            torch.cuda.empty_cache()

    # K6r: the three calls of a dw-PCG iteration at 129^3
    n = 129 ** 3
    g = torch.Generator().manual_seed(6)
    xh, xl = twofloat.split_f64(torch.randn(n, generator=g,
                                            dtype=torch.float64).to(dev))
    z, p = (torch.randn(n, generator=g).to(dev) for _ in range(2))
    dh, dl = twofloat.split_f64(torch.randn(n, generator=g,
                                            dtype=torch.float64).to(dev))
    calls = {"stacked pair": ([(z, None, xh, xl), (z, None, dh, dl)], False,
                              5),
             "norm": ([(xh, xl, xh, xl)], True, 2),
             "p.Ap": ([(p, None, xh, xl)], False, 3)}
    yard = {"stacked pair": None, "norm": None, "p.Ap": None}
    v1 = torch.randn(n, generator=g, dtype=torch.float64).to(dev)
    v2 = torch.randn(n, generator=g, dtype=torch.float64).to(dev)
    # the yardsticks read as many bytes as the call: two f64 vectors (16 n
    # bytes) beside the pair's 20 n and p.Ap's 12 n; one (8 n) beside the
    # norm's 8 n
    yard["norm"] = device_ms(lambda: torch.linalg.vector_norm(v1))
    yard["p.Ap"] = yard["stacked pair"] = device_ms(lambda: torch.dot(v1, v2))
    old6 = _old_k6r(old_k6r) if old_k6r else None
    for label, (pairs, sq, fields) in calls.items():
        fn = (lambda pairs=pairs, sq=sq: twofloat._launch_reduce(pairs, sq))
        bound = fields * n * 4 / bw * 1e3
        ms = device_ms(fn)
        result(kernel=f"K6r.{label}", n=n, ms=ms, bound_ms=bound,
               share_of_bound=bound / ms, library_ms=yard[label],
               library=("torch.linalg.vector_norm" if label == "norm"
                        else "torch.dot") + " (f64)")
        if old6 is not None:
            got, before = fn(), old6(pairs, sq)
            assert float((got - before).abs().max()) <= 1e-13 * float(
                before.abs().max()) + 1e-300, (got, before)
            for who, f in (("old", lambda: old6(pairs, sq)), ("new", fn),
                           ("new", fn), ("old", lambda: old6(pairs, sq))):
                result(kernel=f"K6r.{label}", turn=who, n=n,
                       ms=device_ms(f))


if __name__ == "__main__":
    main()
