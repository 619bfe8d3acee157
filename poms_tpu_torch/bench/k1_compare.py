"""K1's modes and K5 on the card, beside their bounds, their plain versions
and (optionally) an earlier K1 source.

    python -m poms_tpu_torch.bench.k1_compare [--old SOURCE.cu] [--sweep]
        [--shapes 129,65]

For each level shape of the headline solve (513³, 257³, 129³, 65³, 33³,
17³, 9³, or those of ``--shapes``; p = 3, f32, Poisson-shaped terms) and
each mode it prints the kernel's
device time (``torch.profiler``, mean of 20) and stream time (CUDA events,
host overhead included), the bound (bytes each read or written once over
the card's published bandwidth), what the launch gets (registers, spills,
shared memory, blocks an SM) and, from 129³ up, the plain version's device
time.  K5 is timed at 129³ as the headline step calls it (A·p: b and the
low word of x omitted) beside its plain version and both of its bounds.

``--old SOURCE.cu`` also builds that source (the K1 of this package before
its redesign: padded input, one block per 4×8×32 tile, every term's three
passes through shared memory) with the wrapper it had (ghost padding and
band stacking per call) and times it in turns with the new ``apply``:
old, new, new, old.  ``--sweep`` times ``apply`` and ``cheb`` at every shape
(device time, mean of 20) at each micro-tile height (rows a thread,
``ops/kron.py::rows_options``) over a set of tilings (T1, T2, chunk):
``sweep_tilings``; the model (``k1_step_cost``, one set of constants a
height) was fitted to such a sweep.

``--k1-ab OLD_DIR [--dtype f32|bf16|f64]`` is the one-call A/B of the
compiled K1: it builds an earlier commit's ``kron_apply.cu`` and imports
its ``ops/kron.py`` (both copied into ``OLD_DIR`` as for ``--rt-ab``, with
any header of ``csrc/`` that changed since: a source's own directory is
searched first), and at every shape of ``SHAPES`` (or ``--shapes``)
times the earlier and
the current kernel in every mode in turns (old, new, new, old), each at
its own plan's tiling, on fields and bands of the dtype (default f32), and
checks that their outputs are ``torch.equal``.

``--rt-ab OLD_DIR`` is the one-call A/B of the run-time kernels: it builds
an earlier commit's ``kron_apply.cu`` and ``kron_apply_dw.cu`` and imports
its ``ops/kron.py`` and ``ops/twofloat.py``, all four copied into
``OLD_DIR`` first, since the card's copy of the repository has no git::

    mkdir -p _checkout/old && for f in csrc/kron_apply.cu \
        csrc/kron_apply_dw.cu ops/kron.py ops/twofloat.py; do \
      git show HEAD:poms_tpu_torch/$f > _checkout/old/$(basename $f); done
    python -m poms_tpu_torch.bench.k1_compare --rt-ab _checkout/old \
        [--sweep-rt]

and then, at P = 9, 10, 12, 16 on ``chip_smoke.py``'s grids ((126 + P)³
points, Poisson-shaped f32 bands), times the earlier and the current K1r in
every mode and K5r's A·p in turns (old, new, new, old), checks that their
outputs are ``torch.equal``, and times each new pass alone (a call of
several kernels is timed only from a profile that holds every one of
them, ``device_ms``'s ``kernels``); ``--sweep-rt`` times each pass at
every block size of ``RT_WARPS`` (the cost models' data).

``--k5-ab OLD_DIR [--sweep-k5]`` is the one-call A/B of the compiled K5:
it builds an earlier commit's ``kron_apply_dw.cu`` and imports its
``ops/kron.py`` and ``ops/twofloat.py`` (copied into ``OLD_DIR`` as for
``--rt-ab``; only that source is built), and at ``K5_CASES`` (513³ as the
PCG's A·p and as the defect correction's b − A·x with b and the low word,
512³ periodic with 4 histories, 129³) times the earlier and the current K5
in turns (old, new, new, old), each at its own plan's tiling, checks that
both words are ``torch.equal``, and reports each one's registers, spills
and blocks an SM (``k5_resources``) beside the share of 33.5 T f32
operations a second (``k5_ops``).  ``--sweep-k5`` times the current K5's
A·p on ``SWEEP_K5``'s grids (513³ and 512³ with 3 and 4 histories, the
headline's coarse levels 257³ to 9³ with 3) at each micro-tile height
(``twofloat.K5_ROWS``) over a set of tilings (``sweep_k5_tilings``): the
data ``twofloat.K5_COST`` is fitted to.

One ``RESULT {...}`` line per measurement.  Needs a CUDA card.
"""
import ctypes
import json
import subprocess
import sys

SHAPES = (513, 257, 129, 65, 33, 17, 9)
PLAIN_FROM = 129       # the plain version is timed at this shape and above
FIELDS = {"apply": 2, "residual": 3, "dinv": 2, "cheb": 5}   # moved once
SWEEP_T2 = (16, 18, 22, 26, 34, 44, 58, 64)        # tile widths of --sweep
SWEEP_RUNS = {513: (1, 2, 3, 4, 6, 9), 257: (1, 2, 3, 4, 6),
              129: (2, 3, 4, 6, 8, 13), 65: (1, 2, 3, 4, 8, 13),
              33: (1, 3, 6, 11, 17, 33), 17: (1, 3, 6, 9, 17),
              9: (1, 3, 9)}   # runs
SWEEP_TOP = 12         # the model's first candidates, also swept


def build_old(source, name):
    """An earlier kernel source built by ``nvcc`` into the build directory
    as ``lib{name}_old.so`` (the package's headers on its include path)."""
    from poms_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"lib{name}_old.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(out), source], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(out))


def _old_kernel(source):
    """The earlier K1 built from ``source``, behind the wrapper it had."""
    import torch

    from poms_tpu_torch.core.vector import ghost_pad

    lib = build_old(source, "kron_apply")
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


RT_P = (9, 10, 12, 16)       # the A/B's half-widths (chip_smoke.WIDE_TIMED_P)


def wide_grid(P):
    """chip_smoke.py's grid for half-width P: 128³ elements, (126 + P)³
    points."""
    n = 126 + P
    return (n,) * 3, (P,) * 3, (False,) * 3


def _import_old(old_dir, k5=True):
    """An earlier commit's ``ops/kron.py`` and ``ops/twofloat.py`` (copied
    into ``old_dir``) as the modules ``kron_old`` and ``twofloat_old``,
    each loading that commit's kernels built from ``old_dir``'s sources at
    their first launch (``k5=False``: ``kron_old`` alone, and None for
    ``twofloat_old``)."""
    import functools
    import importlib.util
    import types
    from pathlib import Path

    libs = functools.cache(
        lambda name: build_old(str(Path(old_dir) / f"{name}.cu"), name))
    mods = {"twofloat_old": None}
    for name, src in (("kron_old", "kron.py"),
                      ("twofloat_old", "twofloat.py"))[:2 if k5 else 1]:
        text = (Path(old_dir) / src).read_text().replace(
            "from poms_tpu_torch.ops.kron import", "from kron_old import")
        spec = importlib.util.spec_from_loader(name, loader=None)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        exec(compile(text, str(Path(old_dir) / src), "exec"), mod.__dict__)
        mod._build = types.SimpleNamespace(load=libs)
        mods[name] = mod
    return mods["kron_old"], mods["twofloat_old"]


def rt_kernels(plan, family):
    """``device_ms``'s ``kernels`` for one call of ``plan`` (``family``
    "k1r" or "k5r"): a run-time plan launches its three passes once a run
    of terms, a compiled one a kernel a run (None: nothing to count)."""
    return (f"{family}_pass_", 3 * len(plan.plans)) if plan.runtime else None


def k1r_pass_ms(plan, x, mode, b=None, d=None, c1=0.3, c2=0.7):
    """Device ms of each K1r pass of ``plan``'s first run alone (the
    scratch filled by a whole call first), as {pass: ms}."""
    import torch

    from poms_tpu_torch.bench.device import device_ms
    from poms_tpu_torch.ops import kron

    kron.kron_mode(mode, plan, x, b=b, d=None if d is None else d.clone(),
                   c1=c1, c2=c2)
    x3 = x.reshape(plan.n3)
    out, d_out = torch.empty_like(x), torch.empty_like(x)
    kw = {"b": b, "d": d, "d_out": d_out if mode == "cheb" else None,
          "out": out, "c1": c1, "c2": c2}
    return {p: device_ms(lambda: kron.k1r_launch_pass(p, plan, 0, x3, mode,
                                                      **kw),
                         kernels=("k1r_pass_", 1))
            for p in kron.RT_PASSES}


def k5r_pass_ms(plan, xh):
    """Device ms of each K5r pass of ``plan``'s first run alone as A·p
    (b = 0, no low word of x, negated), as {pass: ms}."""
    import torch

    from poms_tpu_torch.bench.device import device_ms
    from poms_tpu_torch.ops import twofloat

    geo, run = twofloat._df_c_args(plan)[:2]
    rh, rl = torch.empty_like(xh), torch.empty_like(xh)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    bands = [ptr(t) for pair in zip(plan.bands, plan.bands_lo) for t in pair]
    args = (ptr(xh), None, None, None, None, None, *bands, ptr(rh), ptr(rl),
            geo, run, 1, int(len(plan.plans) == 1))
    stream = torch.cuda.current_stream().cuda_stream
    for p in twofloat.RT_PASSES:
        twofloat.k5r_launch_pass(p, plan, args, stream)
    return {p: device_ms(lambda: twofloat.k5r_launch_pass(p, plan, args,
                                                          stream),
                         kernels=("k5r_pass_", 1))
            for p in twofloat.RT_PASSES}


def rt_ab(old_dir, sweep=False, result=print):
    """The one-call A/B of K1r and K5r against an earlier commit's (see the
    module docstring); returns the rows it printed."""
    import numpy as np
    import torch

    from poms_tpu_torch.bench.device import device_ms
    from poms_tpu_torch.ops import kron, twofloat

    kron_old, tf_old = _import_old(old_dir)
    dev = torch.device("cuda", 0)
    rows = []

    def emit(**kw):
        rows.append(kw)
        result(**kw)

    for P in RT_P:
        npts, pads, per = wide_grid(P)
        rng = np.random.default_rng(23 + P)
        band = lambda n: torch.as_tensor(   # noqa: E731
            rng.standard_normal((n, 2 * P + 1)) / 4
            + 2.0 * (np.arange(2 * P + 1) == P), device=dev)
        Ks, Ms = [band(n) for n in npts], [band(n) for n in npts]
        t64 = [[Ks[b] if b == a else Ms[b] for b in range(3)]
               for a in range(3)]
        cast = {id(B): B.float() for t in t64 for B in t}
        split = {id(B): twofloat.split_f64(B) for t in t64 for B in t}
        terms = [[cast[id(B)] for B in t] for t in t64]
        tdf = [[split[id(B)] for B in t] for t in t64]
        x, b, d = (torch.as_tensor(rng.standard_normal(npts),
                                   dtype=torch.float32, device=dev)
                   for _ in range(3))
        new = kron.build_kron_plan(terms, npts, pads, per)
        old = kron_old.build_kron_plan(terms, npts, pads, per)
        out = torch.empty_like(x)
        for mode in kron.MODES:
            kw = {"b": b} if mode in ("residual", "cheb") else {}
            if mode == "cheb":
                kw.update(c1=0.3, c2=0.7)
            got = [m.kron_mode(mode, pl, x, **kw, **(
                {"d": d.clone()} if mode == "cheb" else {}))
                for m, pl in ((kron, new), (kron_old, old))]
            torch.cuda.synchronize()
            if mode != "cheb":
                got = [(g,) for g in got]
            equal = all(torch.equal(g, o) for g, o in zip(*got))
            del got
            fns = {"old": lambda: kron_old.kron_mode(mode, old, x, out=out,
                                                     **kw, **({"d": d} if
                                                     mode == "cheb" else {})),
                   "new": lambda: kron.kron_mode(mode, new, x, out=out, **kw,
                                                 **({"d": d} if mode ==
                                                    "cheb" else {}))}
            ms = {"old": [], "new": []}
            counted = {"old": ("kron_march_rt_kernel", len(old.plans)),
                       "new": rt_kernels(new, "k1r")}
            for who in ("old", "new", "new", "old"):
                ms[who].append(device_ms(fns[who], kernels=counted[who]))
            emit(kernel=f"K1r.{mode}", P=P, npts=npts[0], equal=equal,
                 old_ms=ms["old"], new_ms=ms["new"],
                 ratio=min(ms["new"]) / min(ms["old"]),
                 new_tiling=new.tiling, old_tiling=old.tiling,
                 passes_ms=k1r_pass_ms(new, x, mode, kw.get("b"),
                                       d if mode == "cheb" else None))
        (xh, xl), (bh, bl) = (twofloat.split_f64(t.double()) for t in (x, b))
        new5 = twofloat.build_kron_df_plan(tdf, npts, pads)
        old5 = tf_old.build_kron_df_plan(tdf, npts, pads)
        equal = True
        for given in ((bh, bl, xh, xl), (None, None, xh, None)):
            g = twofloat.residual_kron_df(tdf, *given, pads, plan=new5,
                                          negate=given[0] is None)
            o = tf_old.residual_kron_df(tdf, *given, pads, plan=old5,
                                        negate=given[0] is None)
            torch.cuda.synchronize()
            equal &= all(torch.equal(a_, b_) for a_, b_ in zip(g, o))
        fns = {"old": lambda: tf_old.residual_kron_df(
                   tdf, None, None, xh, None, pads, plan=old5, negate=True),
               "new": lambda: twofloat.residual_kron_df(
                   tdf, None, None, xh, None, pads, plan=new5, negate=True)}
        ms = {"old": [], "new": []}
        counted = {"old": ("kron_march_dw_rt_kernel", len(old5.plans)),
                   "new": rt_kernels(new5, "k5r")}
        for who in ("old", "new", "new", "old"):
            ms[who].append(device_ms(fns[who], kernels=counted[who]))
        emit(kernel="K5r.Ap", P=P, npts=npts[0], equal=bool(equal),
             old_ms=ms["old"], new_ms=ms["new"],
             ratio=min(ms["new"]) / min(ms["old"]), new_tiling=new5.tiling,
             old_tiling=old5.tiling, passes_ms=k5r_pass_ms(new5, xh))
        if sweep:
            for warps in kron.RT_WARPS:
                for plan, fn in ((new, k1r_pass_ms), (new5, k5r_pass_ms)):
                    keep = plan.tiling
                    plan.tiling = (keep[0], warps, warps, warps)
                    plan._cargs = []
                    times = (fn(plan, x, "cheb", b, d) if plan is new
                             else fn(plan, xh))
                    emit(kernel=f"{'K1r' if plan is new else 'K5r'}.sweep",
                         P=P, warps=warps, TL=keep[0], passes_ms=times)
                    plan.tiling, plan._cargs = keep, []
        del new, old, new5, old5, x, b, d, xh, xl, bh, bl
        torch.cuda.empty_cache()
    return rows


def sweep_tilings(n, plan, sms):
    """``--sweep``'s tilings of K1 at n³ for ``plan``'s rows and columns a
    thread: tile widths ``SWEEP_T2``, the tallest tile for blocks of up to
    256, 128 and 64 threads, the run counts ``SWEEP_RUNS``, then the
    ``SWEEP_TOP`` candidates the cost model ranks first."""
    from poms_tpu_torch.ops import kron

    R, C = plan.trows, plan.tcols
    seen, tilings = set(), []
    for T2 in SWEEP_T2:
        for threads in (256, 128, 64):
            per_row = -(-min(T2, n) // C)
            k1 = -(-n // max(R, threads // per_row * R))
            T1 = R * -(-(-(-n // k1)) // R)
            for nchunks in SWEEP_RUNS[n]:
                tiling = (T1, per_row * C, -(-n // nchunks))
                if tiling in seen or T1 // R * per_row > 256:
                    continue
                seen.add(tiling)
                tilings.append(tiling)
    cost = kron.k1_step_cost(4, 3, R)
    ranked = sorted(
        (cost(T1, T2, 32 * -(-(T1 // R) * (T2 // C) // 32), ch, bl, sms),
         (T1, T2, ch))
        for T1, T2, ch, bl in kron._tiles((n,) * 3, kron.MAX_THREADS, C, R,
                                          kron.warp_widths(C, R)))
    return tilings + [t for _, t in ranked[:SWEEP_TOP] if t not in seen]


def k1_operands(n, dev, dtype=None):
    """Poisson-shaped terms (p = 3) and three fields at n³, from seed n."""
    import numpy as np
    import torch

    dtype = dtype or torch.float32
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


def k1_mode_kwargs(mode, b, d):
    """``kron_mode``'s operands of ``mode`` (``d`` as given)."""
    kw = {"b": b} if mode in ("residual", "cheb") else {}
    if mode == "cheb":
        kw.update(d=d, c1=0.3, c2=0.7)
    return kw


def k1_ab(old_dir, result=print, shapes=SHAPES, dtype=None):
    """The one-call A/B of the compiled K1 against an earlier commit's (see
    the module docstring), on operands of ``dtype`` (default f32); returns
    the rows it printed."""
    import torch

    from poms_tpu_torch.bench.device import device_ms
    from poms_tpu_torch.ops import kron

    kron_old, _ = _import_old(old_dir, k5=False)
    dev = torch.device("cuda", 0)
    rows = []
    for n in shapes:
        npts, pads, per = (n,) * 3, (3,) * 3, (False,) * 3
        terms, (x, b, d) = k1_operands(n, dev, dtype)
        new = kron.build_kron_plan(terms, npts, pads, per)
        old = kron_old.build_kron_plan(terms, npts, pads, per)
        out = torch.empty_like(x)
        for mode in kron.MODES:
            got = []
            for m, pl in ((kron, new), (kron_old, old)):
                kw = k1_mode_kwargs(mode, b, d.clone())
                res = m.kron_mode(mode, pl, x, **kw)
                got.append(res if mode == "cheb" else (res,))
            torch.cuda.synchronize()
            equal = all(torch.equal(g, o) for g, o in zip(*got))
            del got
            kw = k1_mode_kwargs(mode, b, d)
            fns = {"old": lambda: kron_old.kron_mode(mode, old, x, out=out,
                                                     **kw),
                   "new": lambda: kron.kron_mode(mode, new, x, out=out,
                                                 **kw)}
            ms = {"old": [], "new": []}
            for who in ("old", "new", "new", "old"):
                ms[who].append(device_ms(fns[who]))
            row = dict(kernel=f"K1.ab.{mode}", n=n, dtype=str(x.dtype),
                       equal=equal,
                       old_ms=ms["old"], new_ms=ms["new"],
                       ratio=min(ms["new"]) / min(ms["old"]),
                       new_tiling=new.tiling, old_tiling=old.tiling,
                       new_resources=kron.k1_resources(new, mode))
            rows.append(row)
            result(**row)
        del new, old, terms, x, b, d, out
        torch.cuda.empty_cache()
    return rows


# the A/B's cases: (name, n, histories, periodic, call), call "Ap" (b = 0,
# no low word, negated: the PCG step's) or "residual" (b and the low word:
# the defect correction's)
K5_CASES = (("513.Ap", 513, 3, False, "Ap"),
            ("513.residual", 513, 3, False, "residual"),
            ("512.periodic.Ap", 512, 4, True, "Ap"),
            ("129.Ap", 129, 3, False, "Ap"))


def k5_operands(n, histories, periodic, dev):
    """Double-word terms at n³, p = 3 (seed n): Poisson-shaped (3
    histories) or the periodic shifted shape (S M M, K M M, M K M, M M K:
    4), and x, b as f64 fields split into pairs."""
    import numpy as np
    import torch

    from poms_tpu_torch.ops.twofloat import split_f64

    rng = np.random.default_rng(n + histories)
    mk = lambda: split_f64(torch.as_tensor(   # noqa: E731
        rng.standard_normal((n, 7)) / 4 + 2.0 * (np.arange(7) == 3),
        device=dev))
    Ks, Ms = [mk() for _ in range(3)], [mk() for _ in range(3)]
    tdf = [[Ks[b] if b == a else Ms[b] for b in range(3)] for a in range(3)]
    if histories == 4:
        tdf = [[mk(), Ms[1], Ms[2]]] + tdf
    x, b = (torch.as_tensor(rng.standard_normal((n,) * 3), device=dev)
            for _ in range(2))
    return tdf, split_f64(x), split_f64(b), (periodic,) * 3


def k5_ops(n, histories):
    """f32 operations of a K5 call at n³ (p = 3): each distinct 1D
    contraction (2 u, 3 v, one per history) of 7 taps, a dw_mul (9) each
    and a dw_add (20) each but the first, then the terms' adds and b − sum
    (20 each)."""
    return ((2 + 3 + histories) * (7 * 9 + 6 * 20)
            + 20 * (1 + histories)) * n ** 3


def k5_ab(old_dir, result=print, sweep=False):
    """The one-call A/B of the compiled K5 against an earlier commit's, and
    ``--sweep-k5`` (see the module docstring); returns the rows it
    printed."""
    import torch

    from poms_tpu_torch.bench.device import device_ms
    from poms_tpu_torch.ops import twofloat

    _, tf_old = _import_old(old_dir)
    dev = torch.device("cuda", 0)
    rows = []

    def emit(**kw):
        rows.append(kw)
        result(**kw)

    for name, n, histories, periodic, call in K5_CASES:
        tdf, (xh, xl), (bh, bl), per = k5_operands(n, histories, periodic,
                                                   dev)
        given = ((None, None, xh, None) if call == "Ap"
                 else (bh, bl, xh, xl))
        negate = call == "Ap"
        pads = (3,) * 3
        plans = {"new": twofloat.build_kron_df_plan(tdf, (n,) * 3, pads,
                                                    per),
                 "old": tf_old.build_kron_df_plan(tdf, (n,) * 3, pads, per)}
        mods = {"new": twofloat, "old": tf_old}
        fns = {who: (lambda who=who: mods[who].residual_kron_df(
            tdf, *given, pads, periodic=per, plan=plans[who],
            negate=negate)) for who in mods}
        got = {who: fns[who]() for who in mods}
        torch.cuda.synchronize()
        equal = all(torch.equal(g, o) for g, o in zip(got["new"],
                                                      got["old"]))
        del got
        ms = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            ms[who].append(device_ms(fns[who]))
        ops = k5_ops(n, histories)
        emit(kernel=f"K5.ab.{name}", n=n, histories=histories,
             periodic=periodic, call=call, equal=equal, old_ms=ms["old"],
             new_ms=ms["new"], ratio=min(ms["new"]) / min(ms["old"]),
             new_tiling=plans["new"].tiling, new_rows=plans["new"].trows,
             old_tiling=plans["old"].tiling,
             new_resources=twofloat.k5_resources(plans["new"]),
             old_resources=tf_old.k5_resources(plans["old"]),
             share_33T_new=ops / 33.5e12 * 1e3 / min(ms["new"]),
             share_33T_old=ops / 33.5e12 * 1e3 / min(ms["old"]))
        del plans, fns, tdf, xh, xl, bh, bl
        torch.cuda.empty_cache()
    if sweep:
        k5_sweep(emit)
    return rows


def sweep_k5_tilings(n, rows, histories, sms):
    """``--sweep-k5``'s tilings of K5 at n³ and ``rows`` rows a thread:
    tile widths 16, 22, 32, 43 and 64 (those not wider than n), the
    tallest tile for blocks of up to 256 and 128 threads, 1, 3 and 9 runs
    of planes, then the 8 candidates the cost model ranks first."""
    from poms_tpu_torch.ops import kron, twofloat

    seen, tilings = set(), []
    for T2 in (16, 22, 32, 43, 64):
        for threads in (256, 128):
            T2 = min(T2, n)
            k1 = -(-n // max(rows, threads // T2 * rows))
            T1 = rows * -(-(-(-n // k1)) // rows)
            for runs in (1, 3, 9):
                tiling = (T1, T2, -(-n // runs))
                if tiling not in seen and T1 // rows * T2 <= 256:
                    seen.add(tiling)
                    tilings.append(tiling)
    cost = twofloat.k5_step_cost(3, histories, rows=rows)
    ranked = sorted(
        (cost(T1, T2, 32 * -(-(T1 // rows) * T2 // 32), ch, bl, sms),
         (T1, T2, ch))
        for T1, T2, ch, bl in kron._tiles((n,) * 3, twofloat.MAX_THREADS_DW,
                                          1, rows))
    top = []
    for _, t in ranked:
        if len(top) < 8 and t not in seen:
            seen.add(t)
            top.append(t)
    return tilings + top


# the sweep's grids: (n, histories, periodic); from SWEEP_K5_SMALL down the
# coarse grids, timed around a replayed graph
SWEEP_K5 = ((513, 3, False), (512, 4, True), (513, 4, False), (512, 3, True),
            (257, 3, False), (129, 3, False), (65, 3, False), (33, 3, False),
            (17, 3, False), (9, 3, False))
SWEEP_K5_SMALL = 257


def k5_sweep(emit, grids=SWEEP_K5):
    """K5's A·p on ``grids`` (n, histories, periodic) at each micro-tile
    height over ``sweep_k5_tilings``: CUDA events around 5 calls at 512³
    and 513³, around a replayed graph of 20 calls on the coarser grids (a
    profile late in a process loses kernels)."""
    import torch

    from poms_tpu_torch.bench.device import graph_event_ms, stream_event_ms
    from poms_tpu_torch.ops import twofloat

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, histories, periodic in grids:
        tdf, (xh, _), _, per = k5_operands(n, histories, periodic, dev)
        pads = (3,) * 3
        plan = twofloat.build_kron_df_plan(tdf, (n,) * 3, pads, per)
        chosen = (plan.trows, plan.tiling)
        for R in twofloat.K5_ROWS:
            for tiling in sweep_k5_tilings(n, R, histories, sms):
                plan.trows, plan.tiling, plan._cargs = R, tiling, []

                def call():
                    return twofloat.residual_kron_df(
                        tdf, None, None, xh, None, pads, periodic=per,
                        plan=plan, negate=True)

                try:
                    ms = (stream_event_ms(call, 5) if n > SWEEP_K5_SMALL
                          else graph_event_ms(call, 20))
                except RuntimeError as exc:   # the block does not fit
                    ms = str(exc)[-80:]
                T1, T2, chunk = tiling
                emit(kernel="K5.sweep", n=n, histories=histories, rows=R,
                     tiling=tiling, chosen=chosen == (R, tiling),
                     blocks=(-(-n // T1) * -(-n // T2) * -(-n // chunk)),
                     ms=ms)
        del plan, tdf, xh
        torch.cuda.empty_cache()


def main():
    args = sys.argv[1:]
    old_src = args[args.index("--old") + 1] if "--old" in args else None
    sweep = "--sweep" in args
    shapes = (tuple(int(v) for v in args[args.index("--shapes") + 1]
                    .split(",")) if "--shapes" in args else SHAPES)

    import torch

    from poms_tpu_torch.bench.device import device_ms, nvidia_smi_name_power
    from poms_tpu_torch.bench.kernel_probe import cuda_event_ms
    from poms_tpu_torch.bench.roofline import sol_bandwidth
    from poms_tpu_torch.ops.kron import (MODES, build_kron_plan,
                                         k1_resources, kron_mode,
                                         kron_mode_plain, rows_options)
    from poms_tpu_torch.ops.twofloat import (build_kron_df_plan,
                                             residual_kron_df,
                                             residual_kron_df_plain,
                                             split_f64)

    if not torch.cuda.is_available():
        raise SystemExit("k1_compare measures the card: no CUDA device found")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = nvidia_smi_name_power()
    if "--rt-ab" in args or "--k1-ab" in args or "--k5-ab" in args:
        def printed(**kw):
            print("RESULT " + json.dumps({**kw, "card": card}), flush=True)

        if "--k1-ab" in args:
            dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
                     "f64": torch.float64}[
                args[args.index("--dtype") + 1] if "--dtype" in args
                else "f32"]
            k1_ab(args[args.index("--k1-ab") + 1], printed, shapes, dtype)
        if "--rt-ab" in args:
            rt_ab(args[args.index("--rt-ab") + 1], "--sweep-rt" in args,
                  printed)
        if "--k5-ab" in args:
            k5_ab(args[args.index("--k5-ab") + 1], printed,
                  "--sweep-k5" in args)
        return
    bw = sol_bandwidth(torch.cuda.get_device_name(0)) * 1e9
    print(f"card: {card}; bound at {bw / 1e12:.2f} TB/s", flush=True)
    old = _old_kernel(old_src) if old_src else None

    def result(**kw):
        print("RESULT " + json.dumps({**kw, "card": card}), flush=True)

    for n in shapes:
        npts, pads, per = (n,) * 3, (3,) * 3, (False,) * 3
        terms, (x, b, d) = k1_operands(n, dev)
        plan = build_kron_plan(terms, npts, pads, per)
        out = torch.empty_like(x)

        def run(mode, tiling=None):
            return kron_mode(mode, plan, x, out=out, tiling=tiling,
                             **k1_mode_kwargs(mode, b, d))

        for mode in MODES:
            bound = FIELDS[mode] * n ** 3 * 4 / bw * 1e3
            ms = device_ms(lambda: run(mode))
            row = dict(kernel=f"K1.{mode}", n=n, tiling=plan.tiling, ms=ms,
                       events_ms=cuda_event_ms(lambda: run(mode)),
                       bound_ms=bound, share_of_bound=bound / ms,
                       resources=k1_resources(plan, mode))
            if n >= PLAIN_FROM:
                diag = plan.diagonal()
                row["plain_ms"] = device_ms(lambda: kron_mode_plain(
                    mode, terms, x, npts, pads, per, diag=diag,
                    **k1_mode_kwargs(mode, b, d)), 5)
            result(**row)
        if old is not None:
            turns = [("old", lambda: old(terms, x, npts, pads, per)),
                     ("new", lambda: run("apply"))]
            for who, fn in (turns[0], turns[1], turns[1], turns[0]):
                result(kernel=f"K1.apply.{who}", n=n, ms=device_ms(fn),
                       events_ms=cuda_event_ms(fn))
        if sweep:
            for R in rows_options():
                rplan = build_kron_plan(terms, npts, pads, per, trows=(R,))
                for tiling in sweep_tilings(n, rplan, sms):
                    def swept(mode):
                        return device_ms(lambda: kron_mode(
                            mode, rplan, x, out=out, tiling=tiling,
                            **k1_mode_kwargs(mode, b, d)))

                    result(kernel="K1.sweep", n=n, rows=R, tiling=tiling,
                           blocks=(-(-n // tiling[0]) * -(-n // tiling[1])
                                   * -(-n // tiling[2])),
                           apply_ms=swept("apply"), cheb_ms=swept("cheb"))
                del rplan
        del plan, terms, x, b, d, out
        torch.cuda.empty_cache()

    # K5 at 129^3 as the headline step calls it: A p in double-word
    n = 129
    npts, pads, per = (n,) * 3, (3,) * 3, (False,) * 3
    terms, (x, _, _) = k1_operands(n, dev, torch.float64)
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
