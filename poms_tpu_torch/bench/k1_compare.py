"""K1's modes and K5 on the card, beside their bounds, their plain versions
and (optionally) an earlier K1 source.

    python -m poms_tpu_torch.bench.k1_compare [--old SOURCE.cu] [--sweep]

For each level shape of the headline solve (129³, 65³, 33³, 17³; p = 3,
f32, Poisson-shaped terms) and each mode it prints the kernel's device time
(``torch.profiler``, mean of 20) and stream time (CUDA events, host overhead
included), the bound (bytes each read or written once over the card's
published bandwidth) and the plain version's device time at 129³.  K5 is
timed at 129³ as the headline step calls it (A·p: b and the low word of x
omitted) beside its plain version and both of its bounds.

``--old SOURCE.cu`` also builds that source (the K1 of this package before
its redesign: padded input, one block per 4×8×32 tile, every term's three
passes through shared memory) with the wrapper it had (ghost padding and
band stacking per call) and times it in turns with the new ``apply``:
old, new, new, old.  ``--sweep`` times ``apply`` and ``cheb`` at every shape
(device time, mean of 20) over a set of tilings (T1, T2, chunk): tile widths
``SWEEP_T2``, blocks of up to 256, 128 and 64 threads, and the run counts
``SWEEP_RUNS``; the cost model of ``ops/kron.py::k1_step_cost`` was fitted to
such a sweep.

One ``RESULT {...}`` line per measurement.  Needs a CUDA card.
"""
import ctypes
import json
import subprocess
import sys

SHAPES = (129, 65, 33, 17)
FIELDS = {"apply": 2, "residual": 3, "dinv": 2, "cheb": 5}   # moved once
SWEEP_T2 = (12, 16, 18, 22, 26, 34, 44)            # tile widths of --sweep
SWEEP_RUNS = {129: (3, 4, 5, 6, 8, 11), 65: (2, 3, 4, 6, 8, 11),
              33: (3, 6, 11, 17, 33), 17: (3, 6, 9, 17)}   # runs of planes


def _old_kernel(source):
    """The earlier K1 built from ``source``, behind the wrapper it had."""
    import torch

    from poms_tpu_torch.core.vector import ghost_pad
    from poms_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "libkron_apply_old.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    source], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.kron_apply_f32.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                                   + [ctypes.c_void_p])
    lib.kron_apply_f32.restype = ctypes.c_int

    def apply(terms, x, npts, pads, periodic):
        x_pad = ghost_pad(x, pads, periodic).contiguous()
        bands = [torch.stack([term[a] for term in terms]).contiguous()
                 for a in range(3)]
        y = torch.empty(npts, dtype=x.dtype, device=x.device)
        err = lib.kron_apply_f32(
            x_pad.data_ptr(), bands[0].data_ptr(), bands[1].data_ptr(),
            bands[2].data_ptr(), y.data_ptr(), len(terms), *npts, *pads,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the earlier kernel refused the launch: {err}")
        return y

    return apply


def main():
    args = sys.argv[1:]
    old_src = args[args.index("--old") + 1] if "--old" in args else None
    sweep = "--sweep" in args

    import numpy as np
    import torch

    from poms_tpu_torch.bench.device import device_ms, nvidia_smi_name_power
    from poms_tpu_torch.bench.kernel_probe import cuda_event_ms
    from poms_tpu_torch.bench.roofline import sol_bandwidth
    from poms_tpu_torch.ops.kron import (MODES, build_kron_plan, kron_mode,
                                         kron_mode_plain)
    from poms_tpu_torch.ops.twofloat import (build_kron_df_plan,
                                             residual_kron_df,
                                             residual_kron_df_plain,
                                             split_f64)

    if not torch.cuda.is_available():
        raise SystemExit("k1_compare measures the card: no CUDA device found")
    dev = torch.device("cuda", 0)
    card = nvidia_smi_name_power()
    bw = sol_bandwidth(torch.cuda.get_device_name(0)) * 1e9
    print(f"card: {card}; bound at {bw / 1e12:.2f} TB/s", flush=True)
    old = _old_kernel(old_src) if old_src else None

    def operands(n, dtype=torch.float32):
        rng = np.random.default_rng(n)
        mk = lambda: torch.as_tensor(   # noqa: E731
            rng.standard_normal((n, 7)) / 4 + 2.0 * (np.arange(7) == 3),
            dtype=dtype, device=dev)
        Ks, Ms = [mk() for _ in range(3)], [mk() for _ in range(3)]
        terms = [[Ks[b] if b == a else Ms[b] for b in range(3)]
                 for a in range(3)]
        fields = [torch.as_tensor(rng.standard_normal((n,) * 3), dtype=dtype,
                                  device=dev) for _ in range(3)]
        return terms, fields

    def result(**kw):
        print("RESULT " + json.dumps({**kw, "card": card}), flush=True)

    for n in SHAPES:
        npts, pads, per = (n,) * 3, (3,) * 3, (False,) * 3
        terms, (x, b, d) = operands(n)
        plan = build_kron_plan(terms, npts, pads, per)
        out = torch.empty_like(x)

        def run(mode, tiling=None):
            kw = {"b": b} if mode in ("residual", "cheb") else {}
            if mode == "cheb":
                kw.update(d=d, c1=0.3, c2=0.7)
            return kron_mode(mode, plan, x, out=out, tiling=tiling, **kw)

        for mode in MODES:
            bound = FIELDS[mode] * n ** 3 * 4 / bw * 1e3
            ms = device_ms(lambda: run(mode))
            row = dict(kernel=f"K1.{mode}", n=n, tiling=plan.tiling, ms=ms,
                       events_ms=cuda_event_ms(lambda: run(mode)),
                       bound_ms=bound, share_of_bound=bound / ms)
            if n == SHAPES[0]:
                diag = plan.diagonal()
                kw = {"b": b} if mode in ("residual", "cheb") else {}
                if mode == "cheb":
                    kw.update(d=d, c1=0.3, c2=0.7)
                row["plain_ms"] = device_ms(lambda: kron_mode_plain(
                    mode, terms, x, npts, pads, per, diag=diag, **kw), 5)
            result(**row)
        if old is not None:
            turns = [("old", lambda: old(terms, x, npts, pads, per)),
                     ("new", lambda: run("apply"))]
            for who, fn in (turns[0], turns[1], turns[1], turns[0]):
                result(kernel=f"K1.apply.{who}", n=n, ms=device_ms(fn),
                       events_ms=cuda_event_ms(fn))
        if sweep:
            seen = set()
            for T2 in SWEEP_T2:
                for threads in (256, 128, 64):
                    per_row = -(-min(T2, n) // plan.tcols)
                    k1 = -(-n // max(1, threads // per_row))
                    T1 = -(-n // k1)
                    for nchunks in SWEEP_RUNS[n]:
                        tiling = (T1, per_row * plan.tcols, -(-n // nchunks))
                        if tiling in seen or T1 * per_row > 256:
                            continue
                        seen.add(tiling)
                        result(kernel="K1.sweep", n=n, tiling=tiling,
                               blocks=(k1 * -(-n // tiling[1])
                                       * -(-n // tiling[2])),
                               apply_ms=device_ms(
                                   lambda: run("apply", tiling)),
                               cheb_ms=device_ms(
                                   lambda: run("cheb", tiling)))
        del plan, terms, x, b, d, out
        torch.cuda.empty_cache()

    # K5 at 129^3 as the headline step calls it: A p in double-word
    n = SHAPES[0]
    npts, pads, per = (n,) * 3, (3,) * 3, (False,) * 3
    terms, (x, _, _) = operands(n, torch.float64)
    split = {id(B): split_f64(B) for term in terms for B in term}
    tdf = [[split[id(B)] for B in term] for term in terms]
    plan = build_kron_df_plan(tdf, npts, pads, per)
    ph = x.to(torch.float32)
    zero = torch.zeros_like(ph)
    kernel = lambda: residual_kron_df(tdf, None, None, ph, None, pads,   # noqa: E731
                                      periodic=per, plan=plan)
    plain = lambda: residual_kron_df_plain(tdf, zero, zero, ph, zero,    # noqa: E731
                                           pads, None, per)
    ms = device_ms(kernel)
    # f32 operations of the kernel per point: 8 contractions of 7 taps, each
    # a dw_mul (9) and all but the first a dw_add (20), 2 term adds, b - Ax
    ops = (8 * (7 * 9 + 6 * 20) + 3 * 20) * n ** 3
    result(kernel="K5", n=n, tiling=plan.tiling, ms=ms,
           events_ms=cuda_event_ms(kernel),
           plain_ms=device_ms(plain, 2),
           bound_bytes_ms=3 * n ** 3 * 4 / bw * 1e3,
           bound_ops_ms=ops / 33.5e12 * 1e3, ops_per_point=ops / n ** 3)


if __name__ == "__main__":
    main()
