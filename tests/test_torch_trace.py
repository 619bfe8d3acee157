"""The port's spans (poms_tpu_torch/utils/trace.py), its byte counters
(ops/counters.py) and the benchmark's readers of both, on the CPU."""
import importlib
import os
import sys
import types

import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark import spans as bspans  # noqa: E402
from benchmark import trace as btrace  # noqa: E402
from benchmark.harness import Context, hand_kernels, reader  # noqa: E402
from benchmark.work import k6  # noqa: E402
from poms_tpu_torch.mg import graph  # noqa: E402
from poms_tpu_torch.mg.cycles import CycleConfig  # noqa: E402
from poms_tpu_torch.mg.mixed import MGPreconditionedCG  # noqa: E402
from poms_tpu_torch.mg.smoother import SmootherConfig  # noqa: E402
from poms_tpu_torch.models.poisson import poisson_problem  # noqa: E402
from poms_tpu_torch.ops import counters  # noqa: E402
from poms_tpu_torch.ops.kron import build_kron_plan  # noqa: E402
from poms_tpu_torch.ops.kron import plan_scratch  # noqa: E402
from poms_tpu_torch.utils import trace  # noqa: E402
from poms_tpu_torch.utils.trace import Record  # noqa: E402

torch.set_num_threads(1)


def _solver(n_el=8):
    prob = poisson_problem(3, n_el, degree=3, operator="kron", device="cpu")
    cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
        "chebyshev", cheb_fraction=16.0))
    return prob, MGPreconditionedCG(prob, 2, cfg, mixed=True,
                                    operator="kron", precision="dw")


# -- the spans ------------------------------------------------------------------

def test_the_null_path_records_nothing_and_enters_no_range(monkeypatch):
    """Without a recording a span is one shared null context: no record,
    no clock read, no record_function, through a whole CPU solve."""
    entered, clock = [], []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: clock.append(1) or 0))
    assert trace.span("poms.a") is trace.span("poms.b", sync=True, n=3)
    with trace.span("poms.solve"):
        pass
    prob, pcg = _solver()
    _, rn, it = pcg.solve_compiled(prob.b, tol=1e-10, maxiter=40)
    assert float(rn) <= 1e-10 and it > 0
    assert entered == [] and clock == []


def test_records_nest_with_parent_and_solve_ids():
    """On a CPU dw-PCG at 8^3: set-up spans outside any solve, each solve a
    root whose id every span inside it carries, parents along the cycle's
    recursion, ends after starts; the card-only spans absent."""
    with trace.recording() as records:
        prob, pcg = _solver()
        _, _, it1 = pcg.solve_compiled(prob.b, tol=1e-10, maxiter=40)
        _, _, it2 = pcg.solve_compiled(prob.b, tol=1e-10, maxiter=40)
    by_id = {r.id: r for r in records}
    assert [r.id for r in records] == list(range(len(records)))
    assert all(r.end_ns >= r.start_ns for r in records)
    names = {r.name for r in records}
    assert names == {"poms.setup.hierarchy", "poms.setup.lambda",
                     "poms.solve", "poms.solve.start", "poms.cycle.L0",
                     "poms.cycle.L1", "poms.cycle.coarse"}
    for r in records:
        if r.name.startswith("poms.setup."):
            assert r.parent is None and r.solve is None
            assert r.seconds > 0
    solves = [r for r in records if r.name == "poms.solve"]
    assert len(solves) == 2
    for s in solves:
        assert s.parent is None and s.solve == s.id
    inside = [r for r in records if r.solve is not None]
    assert {r.solve for r in inside} == {s.id for s in solves}
    parent_of = {"poms.solve.start": {"poms.solve"},
                 "poms.cycle.L0": {"poms.solve", "poms.solve.start"},
                 "poms.cycle.L1": {"poms.cycle.L0"},
                 "poms.cycle.coarse": {"poms.cycle.L1"}}
    for r in inside:
        if r.name != "poms.solve":
            p = by_id[r.parent]
            assert p.name in parent_of[r.name] and p.solve == r.solve
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    # one L0 a preconditioner cycle: the start's and one an iteration
    assert sum(r.name == "poms.cycle.L0" for r in records) == it1 + it2 + 2
    assert not trace._active


def test_range_names_are_stable_and_join_by_occurrence(tmp_path):
    """Each span is a profiler range under its own name (no per-call id);
    the k-th range of a name joins the k-th record; a trace that lost a
    range is refused."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.recording() as records:
            for i in range(3):
                with trace.span("poms.outer", i=i):
                    with trace.span("poms.inner", x=torch.zeros(2, 3)):
                        torch.ones(8).sum()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = btrace.load(path)
    ours = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(ours) == ["poms.inner"] * 3 + ["poms.outer"] * 3
    assert [r.attrs for r in records if r.name == "poms.outer"] == \
        [{"i": 0}, {"i": 1}, {"i": 2}]
    assert records[1].attrs == {"x": (2, 3)}
    joined = bspans.join(events, records)
    starts = [rng[0] for r, rng in joined if r.name == "poms.outer"]
    assert starts == sorted(starts)
    rng = {r.id: g for r, g in joined}
    for r, (s, e, thread) in joined:
        if r.parent is not None:
            ps, pe, pthread = rng[r.parent]
            assert ps <= s and e <= pe and thread == pthread
    lost = [e for e in events if not (e.get("cat") == "user_annotation"
                                      and e["name"] == "poms.inner")]
    with pytest.raises(bspans.IncompleteTrace, match="poms.inner"):
        bspans.join(lost + [e for e in events
                            if e.get("name") == "poms.inner"][:2], records)


def _card_stubs(monkeypatch, capturing):
    synced = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: synced.append(a))
    return synced


@pytest.mark.parametrize("capturing", [True, False])
def test_sync_never_while_capturing(monkeypatch, capturing):
    """``sync=True`` synchronizes at close only while recording and never
    while the current stream captures; plain spans never."""
    synced = _card_stubs(monkeypatch, capturing)
    with trace.span("poms.setup.x", sync=True):
        pass
    assert synced == []                          # not recording
    with trace.recording():
        with trace.span("poms.setup.x", sync=True):
            pass
        with trace.span("poms.cycle.L0"):
            pass
    assert len(synced) == (0 if capturing else 1)


def test_recordings_do_not_nest_and_always_end():
    with trace.recording():
        with pytest.raises(RuntimeError, match="already active"):
            with trace.recording():
                pass
    with pytest.raises(ValueError):
        with trace.recording():
            raise ValueError
    assert trace.span("poms.x") is trace.span("poms.y")


# -- the counters ---------------------------------------------------------------

def test_copy_bytes_reads_and_writes_each_new_buffer_once():
    """Every state buffer given a new tensor: read once, written once; a
    tensor that is its own buffer is skipped, as copy_ skips it."""
    a = torch.zeros(5, 6, dtype=torch.float32)
    b = torch.zeros(7, dtype=torch.float64)
    rz = torch.zeros((), dtype=torch.float64)
    state = [a, b, rz]
    assert graph.copy_bytes(state, [a.clone(), b.clone(), rz.clone()]) \
        == 2 * (30 * 4 + 7 * 8 + 8)
    assert graph.copy_bytes(state, [a, b.clone(), rz]) == 2 * 7 * 8
    assert graph.copy_bytes(state, state) == 0


def test_scratch_bytes_count_each_plan_scratch():
    """plan_scratch counts its bytes once; a CPU plan holds no scratch and
    counts none."""
    before = counters.snapshot()
    s32 = plan_scratch(4 * 10, torch.float32, torch.device("cpu"))
    s64 = plan_scratch(4 * 10, torch.float64, torch.device("cpu"))
    assert s32.numel() == s64.numel() == 40
    assert counters.diff(counters.snapshot(), before) == {
        "kron.scratch_bytes": 40 * 4 + 40 * 8}
    before = counters.snapshot()
    bands = [torch.rand(20, 19, dtype=torch.float64) for _ in range(3)]
    plan = build_kron_plan([bands], (20, 20, 20), (9, 9, 9),
                           (False, False, False))
    assert plan.runtime and plan.scratch is None
    assert counters.diff(counters.snapshot(), before) == {}
    counters.add({"kron.scratch_bytes": -(40 * 4 + 40 * 8)})


def test_byte_counters_add_and_hand_kernels_ignores_them():
    """The two byte keys are in the registry, advance and go back like the
    launch counters, and count no launched kernel."""
    before = counters.snapshot()
    assert before["graph.copy_bytes"] >= 0
    assert before["kron.scratch_bytes"] >= 0
    delta = {"graph.copy_bytes": 6 * 10 ** 9, "kron.scratch_bytes": 1 << 30,
             "dw_reduce": 3, "kron_mode.cheb": 32}
    counters.add(delta)
    grown = counters.diff(counters.snapshot(), before)
    assert grown == delta
    assert hand_kernels(grown) == 35
    assert hand_kernels({"graph.copy_bytes": 7, "graph.inplace_bytes": 5,
                         "kron.scratch_bytes": 9}) == 0
    counters.add({k: -v for k, v in delta.items()})
    assert counters.snapshot() == before


# -- the readers ----------------------------------------------------------------

def _ev(name, cat, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _synthetic():
    """A solve of three replays after an eager start whose cycle has a
    level 1 and a coarse solve, as the profiler and a recording give it.

    Host: solve [0, 1000]; start [5, 300] ⊃ L0 [10, 290] ⊃ L1 [100, 200] ⊃
    coarse [120, 180]; replays [400, 410], [600, 610], [800, 810].
    Device: the start's ops at 20–60 (L0), 110–130 (L1), 130–170
    (coarse); each replay's two kernels 420–500, 505–540; 620–700,
    700–730; 820–900, 900–950."""
    rec = [Record("poms.solve", 0, None, 0, 0, 1),
           Record("poms.solve.start", 1, 0, 0, 0, 1),
           Record("poms.cycle.L0", 2, 1, 0, 0, 1),
           Record("poms.cycle.L1", 3, 2, 0, 0, 1),
           Record("poms.cycle.coarse", 4, 3, 0, 0, 1)] + \
        [Record("poms.graph.replay", 5 + i, 0, 0, 0, 1) for i in range(3)]
    ua = "user_annotation"
    ev = [_ev("poms.solve", ua, 0, 1000), _ev("poms.solve.start", ua, 5, 295),
          _ev("poms.cycle.L0", ua, 10, 280), _ev("poms.cycle.L1", ua, 100, 100),
          _ev("poms.cycle.coarse", ua, 120, 60)]
    launches = [(15, 20, 40), (105, 110, 20), (125, 130, 40)]
    for i, at in enumerate((400, 600, 800)):
        ev.append(_ev("poms.graph.replay", ua, at, 10))
        ev.append(_ev("cudaGraphLaunch", "cuda_runtime", at + 2, 5,
                      corr=100 + i))
    for k, (host, dev, dur) in enumerate(launches):
        ev.append(_ev("cudaLaunchKernel", "cuda_runtime", host, 2, corr=k))
        ev.append(_ev(f"k{k}", "kernel", dev, dur, corr=k, tid=7))
    for i, kernels in enumerate((((420, 80), (505, 35)),
                                 ((620, 80), (700, 30)),
                                 ((820, 80), (900, 50)))):
        for k, (at, dur) in enumerate(kernels):
            ev.append(_ev(f"g{k}", "kernel", at, dur, corr=100 + i, tid=7))
    ev.append(_ev("cudaStreamSynchronize", "cuda_runtime", 550, 40))
    return ev, rec


def test_replay_gaps_and_starts_on_a_synthetic_trace():
    events, records = _synthetic()
    joined = bspans.join(events, records)
    ops = bspans.owned(events, joined)
    assert [len(ops[i]) for i in range(5, 8)] == [2, 2, 2]
    assert len(ops[0]) == 9 and len(ops[1]) == 3
    assert bspans.replay_gaps(joined, ops) == [620 - 540, 820 - 730]
    assert bspans.start_intervals(joined, ops) == [420 - 0]


def test_level_shares_on_a_synthetic_trace():
    events, records = _synthetic()
    joined = bspans.join(events, records)
    ops = bspans.owned(events, joined)
    levels = bspans.level_device_us(joined, ops)
    assert levels == {"poms.cycle.L0": (100, 1), "poms.cycle.L1": (60, 1),
                      "poms.cycle.coarse": (40, 1)}
    assert bspans.coarse_share(joined, ops) == pytest.approx(60.0)
    assert bspans.coarse_share([], {}) is None


def test_idle_split_adds_up_and_names_the_rest():
    """Idle time splits into the gaps between replays, the idle part of
    the start, the window's edges and the rest by the innermost host
    event."""
    events, records = _synthetic()
    joined = bspans.join(events, records)
    ops = bspans.owned(events, joined)
    split = bspans.idle_split(events, joined, ops, 0, 1000)
    busy = btrace.busy_us(events, 0, 1000)
    assert split["idle_us"] == pytest.approx(1000 - busy)
    assert split["replay_gaps_us"] == pytest.approx(80 + 90)
    # the start [0, 420] less its busy 20–60 and 110–170
    assert split["starts_us"] == pytest.approx(420 - 40 - 60)
    rest = split["rest_us"]
    assert sum(rest.values()) + split["replay_gaps_us"] \
        + split["starts_us"] + split["edges_us"] \
        == pytest.approx(split["idle_us"])
    # inside the first replay, between its kernels; after the last one
    assert rest == {"poms.solve": pytest.approx(505 - 500)}
    assert split["edges_us"] == pytest.approx(1000 - 950)
    wider = bspans.idle_split(events, joined, ops, 0, 1100)
    assert wider["edges_us"] == pytest.approx(1100 - 950)
    assert wider["idle_us"] == pytest.approx(split["idle_us"] + 100)


def test_readers_refuse_a_replay_without_operations():
    events, records = _synthetic()
    events = [e for e in events if e.get("args", {}).get("correlation")
              != 101]
    joined = bspans.join(events, records)
    ops = bspans.owned(events, joined)
    with pytest.raises(bspans.IncompleteTrace, match="owns no device"):
        bspans.replay_gaps(joined, ops)


def test_setup_seconds_sum_the_records():
    recs = [Record("poms.setup.hierarchy", 0, None, None, 0, 2 * 10 ** 9),
            Record("poms.setup.lambda", 1, None, None, 0, 5 * 10 ** 8),
            Record("poms.setup.hierarchy", 2, None, None, 0, 10 ** 9)]
    assert bspans.setup_seconds(recs, "poms.setup.hierarchy") == 3.0
    assert bspans.setup_seconds(recs, "poms.setup.lambda") == 0.5


def test_counter_metric_readers():
    """copy_gb_per_iter: the window's copy-back bytes over its iterations;
    scratch_gib: the plans' scratch; both None where the program has no
    such counter (a parent without it) or nothing was counted."""
    copy = reader("copy_gb_per_iter")
    ctx = Context()
    ctx.solves = [(0.1, 9, True), (0.1, 11, True)]
    ctx.window_counters = {"graph.copy_bytes": 20 * 6.5e9, "dw_reduce": 60}
    assert copy.read(ctx) == pytest.approx(6.5)
    ctx.window_counters = {"dw_reduce": 60}
    assert copy.read(ctx) is None
    scratch = reader("scratch_gib")
    before = counters.snapshot()["kron.scratch_bytes"]
    counters.add({"kron.scratch_bytes": 3 << 29})
    try:
        assert scratch.read(Context()) == pytest.approx(
            before / 2 ** 30 + 1.5)
    finally:
        counters.add({"kron.scratch_bytes": -(3 << 29)})


@pytest.mark.parametrize("name,layer", [("reduce_roofline", "k6r"),
                                        ("update_roofline", "k6u")])
def test_k6_rooflines_wrap_entries_the_program_has(name, layer):
    """Each roofline's range goes around an entry of the program whose
    launches the named counter counts."""
    span = reader(name).SPANS[layer]
    mod = importlib.import_module(span["module"])
    assert callable(getattr(mod, span["entry"]))
    assert all(c in counters.snapshot() for c in span["counters"])
    ctx = Context()
    assert reader(name).read(ctx) is None
    ctx.layers[layer] = (1.0, 4.0)
    assert reader(name).read(ctx) == 25.0


def test_k6_work_reads_each_operand_once():
    n = 1000
    xh, xl, yh = (torch.zeros(10, 10, 10) for _ in range(3))
    # a norm passes its pair twice; a None low word is not read
    assert k6.reduce(([(xh, xl, xh, xl)], None), {"sqrt": True}) \
        == (2 * 4 * n + 8, 0, "f32")
    assert k6.reduce(([(xh, None, yh, None), (xh, None, xl, None)], None),
                     {}) == (3 * 4 * n + 16, 0, "f32")
    s = torch.zeros((), dtype=torch.float64)
    f = [torch.zeros(10, 10, 10) for _ in range(7)]
    assert k6.update(("cg", *f, s, s.clone()), {}) \
        == ((7 + 6) * 4 * n + 16, 0, "f32")
    assert k6.update(("dwrr", f[0], f[1], f[2], None, None, s, s.clone()),
                     {}) == ((3 + 2) * 4 * n + 16, 0, "f32")
    assert k6.update(("div", f[0], s), {}) == (2 * 4 * n + 8, 0, "f32")
