"""The work counts against hand counts, and the trace readers and metric
readers on a recorded trace."""
import math

import pytest

from h100bench_util import ROOT  # noqa: F401  (puts the repo on the path)

from benchmark import harness, trace, work

POISSON = [[0, 1, 1], [0, 1, 0], [0, 0, 1]]   # labels[axis][term]


def test_contractions():
    assert work.contractions(POISSON) == 7      # 2 + 3 + 2
    assert work.contractions([[0], [0], [0]]) == 3
    assert work.contractions([[0, 1], [0, 1], [0, 1]]) == 6


@pytest.mark.parametrize("mode,fields,extra", [
    ("apply", 2, 0), ("residual", 3, 1), ("dinv", 2, 1), ("cheb", 5, 6)])
def test_kron(mode, fields, extra):
    npts, p, n = (10, 11, 12), 3, 1320
    bands = 2 * (10 + 11 + 12) * 7 * 4           # K and M on every axis
    nbytes, flops = work.kron(mode, npts, p, POISSON, 4)
    assert nbytes == fields * n * 4 + bands
    assert flops == (7 * 2 * 7 + extra) * n
    if mode == "cheb":
        assert work.kron(mode, npts, p, POISSON, 4, first_cheb=True)[0] \
            == nbytes - n * 4


def test_kron_dw():
    n = 1000
    per = 7 * (7 * 9 + 6 * 20)                   # 7 contractions of 7 taps
    nb, fl = work.kron_dw((10, 10, 10), 3, POISSON, low_word=True, rhs=True)
    assert fl == (per + 3 * 20) * n               # 2 term sums, b − A x
    assert nb == 6 * n * 4 + 2 * 2 * 30 * 7 * 4
    nb, fl = work.kron_dw((10, 10, 10), 3, POISSON, low_word=False,
                          rhs=False)
    assert fl == (per + 2 * 20) * n and nb == 3 * n * 4 + 2 * 2 * 30 * 7 * 4


def test_stencil():
    n = 8 ** 3
    nb, fl = work.stencil("residual", (8, 8, 8), 343, 343 * n, 14 ** 3, 4,
                          rhs=True)
    assert nb == (343 * n + 14 ** 3 + 2 * n) * 4
    assert fl == (2 * 343 + 1) * n
    assert work.stencil("rbgs", (8, 8, 8), 343, 343 * n, 14 ** 3, 4,
                        True)[1] == (2 * 343 + 3) * n // 2


def test_transfer():
    # restriction 9³ → 5³ with 4 taps an output: the cheapest order
    # contracts one axis after another, 5·9·9, 5·5·9, 5·5·5 outputs
    nb, fl = work.transfer((9, 9, 9), (5, 5, 5), (4, 4, 4), 4, add=False)
    assert fl == 2 * 4 * (405 + 225 + 125)
    assert nb == (729 + 125 + 3 * 5 * 4) * 4
    nb, fl = work.transfer((5, 5, 5), (9, 9, 9), (3, 3, 3), 8, add=True)
    assert fl == 2 * 3 * (225 + 405 + 729) + 729
    assert nb == (125 + 2 * 729 + 3 * 9 * 3) * 8


def test_least_s():
    assert work.least_s(3.35e12, 0, "f32") == pytest.approx(1.0)
    assert work.least_s(0, 67e12, "f32") == pytest.approx(1.0)
    assert work.least_s(0, 34e12, "f64") == pytest.approx(1.0)


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def recorded():
    """A trace as torch.profiler writes it: two ranges on the host, the
    launches inside them, their kernels on the device, one launch outside
    any range, a memcpy and a gap."""
    return [
        _ev("user_annotation", "bench.window", 0, 200),
        _ev("user_annotation", "bench.kron#0", 10, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 2, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 2, corr=2),
        _ev("user_annotation", "bench.dw#1", 40, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 41, 2, corr=3),
        _ev("cuda_runtime", "cudaMemcpyAsync", 60, 2, corr=4),
        _ev("cpu_op", "aten::item", 100, 80),
        _ev("kernel", "k1", 15, 30, tid=7, corr=1),
        _ev("kernel", "k1", 45, 10, tid=7, corr=2),
        _ev("kernel", "k5", 55, 40, tid=7, corr=3),
        _ev("gpu_memcpy", "Memcpy DtoH", 96, 4, tid=7, corr=4),
    ]


def test_trace_readers():
    ev = recorded()
    assert trace.kernel_count(ev) == 3
    assert trace.busy_us(ev, 0, 200) == 84         # 15–95, 96–100
    assert trace.busy_us(ev, 50, 60) == 10
    rng = trace.by_range(ev)
    assert rng == {"bench.kron#0": (40, 2), "bench.dw#1": (40, 1),
                   "bench.window": (4, 0)}       # the memcpy, no kernel
    bd = trace.breakdown(ev, 0, 200)
    assert bd["device_ops"][0] == ["k1", pytest.approx(40e-6)]
    assert [k for k, _ in bd["device_ops"]] == ["k1", "k5", "Memcpy DtoH"]
    # gaps: 0–15 and 95–96 under bench.window alone, 100–200 under
    # aten::item (its middle, 150, is inside it)
    idle = dict(bd["idle_gaps"])
    assert idle["aten::item"] == pytest.approx(100e-6)
    assert idle["bench.window"] == pytest.approx(16e-6)


def test_metric_readers_on_the_recorded_trace():
    ev = recorded()
    ctx = harness.Context()
    ctx.solves = [(0.5, 8, True), (0.7, 9, True)]
    ctx.window_s = 1.25
    ctx.window_counters = {"kron_mode.cheb": 70, "kron_mode.cheb@f32": 70,
                           "kron_apply": 3, "kron_mode.apply": 3,
                           "residual_kron_df": 17, "dw_update": 10}
    ctx.setup = {"total": 9.0, "problem": 1.0, "solver": 2.0,
                 "capture": 0.5}
    ctx.peak_bytes = 3 * 2 ** 30
    per = trace.by_range(ev)
    ctx.layers = {"kron": (20e-6, per["bench.kron#0"][0] * 1e-6),
                  "dw": (4e-6, per["bench.dw#1"][0] * 1e-6)}
    ctx.replay = {"busy_s": trace.busy_us(ev, 0, 200) * 1e-6,
                  "window_s": 200e-6}
    r = {n: harness.reader(n).read(ctx) for n in (
        "solve_ms", "solve_p95_ms", "peak_mem_gib", "setup_s", "iterations",
        "iter_ms", "kernels_per_iter", "idle_share", "kron_roofline",
        "dw_roofline", "stencil_roofline", "setup.problem_s")}
    assert r["solve_ms"] == pytest.approx(625.0)
    assert r["solve_p95_ms"] == pytest.approx(690.0)
    assert r["peak_mem_gib"] == 3.0 and r["setup_s"] == 9.0
    assert r["iterations"] == 8.5
    assert r["iter_ms"] == pytest.approx(1250 / 17)
    assert r["kernels_per_iter"] == pytest.approx(100 / 17)
    assert r["idle_share"] == pytest.approx(58.0)
    assert r["kron_roofline"] == pytest.approx(50.0)
    assert r["dw_roofline"] == pytest.approx(10.0)
    assert r["stencil_roofline"] is None        # no call: no number, not 0
    assert r["setup.problem_s"] == 1.0
    assert not math.isnan(r["iter_ms"])
