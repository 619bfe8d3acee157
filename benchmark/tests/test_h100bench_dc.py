"""The dc kind: the headline example's default solver, twofloat defect
correction (``MixedPrecisionMG``), as the configuration builds it, and a
tiny dc cell run through the harness on the CPU: correct, its control
failed, its corrections the same on every seed, and a planted fault under
the timed path caught."""
import json
import time

import pytest
import torch

from h100bench_util import ROOT, tiny_root

from benchmark import harness
from benchmark.reference import rhs

CELL = "kron_dc_p3_n512"
TINY_DC = "tiny_dc"
SOURCES = json.loads((ROOT / "benchmark/traffic/smooth4.json")
                     .read_text())["sources"]


def dc_root(tmp):
    """A checkout-shaped copy of the benchmark (``tiny_root``'s) with one
    more cell: the dc configuration at 8³ elements, 2 levels."""
    root = tiny_root(tmp)
    config = json.loads((ROOT / "benchmark/configs/"
                         "poisson3d_kron_dc_p3_n512.json").read_text())
    config["name"] = "tiny_dc"
    config["problem"]["n_el"] = 8
    config["solver"]["levels"] = 2
    (root / "benchmark/configs/tiny_dc.json").write_text(json.dumps(config))
    man = harness.manifest(root)
    man["configs"].append({"name": "tiny_dc", "source": "test",
                           "file": "benchmark/configs/tiny_dc.json",
                           "reduced": ["n_el"], "why": "test"})
    man["workloads"].append({"name": TINY_DC, "config": "tiny_dc",
                             "traffic": "smooth4", "chips": 1,
                             "why": "test"})
    # the tiny cell reports what the dc cell reports
    for m in man["end_to_end"] + man["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY_DC)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


def _run(root, seed, seconds, control=False, hook=None):
    return harness.run(harness.manifest(root), TINY_DC, seed, seconds,
                       False, torch.device("cpu"), time.perf_counter(),
                       root=root, control=control, solve_hook=hook)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """A tiny solve (46 corrections at 8³, about 1.2 s) is bound by the
    host's work a call: one thread keeps parallel test workers from
    contending for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return dc_root(tmp_path_factory.mktemp("dc"))


@pytest.fixture(scope="module")
def window(root):
    """Seconds in which a window solves every source of the pool: twice
    the pool's solves at the pace of one timed solve (a window of 0 s
    times exactly one)."""
    out = _run(root, 3, seconds=0.0)
    return 2 * len(SOURCES) * out["metrics"]["solve_ms"]["value"] / 1e3


@pytest.fixture(scope="module")
def first(root, window):
    return _run(root, 2 ** 31 + 99, seconds=window)


def test_the_cell_is_the_dc_kind(root):
    man = harness.manifest(root)
    config = harness.cell(man, CELL, root)[1]
    found = {k: m.__file__ for k, m in harness.kinds(config, root).items()}
    assert found == {
        "problem": str(root / "benchmark/problems/poisson.py"),
        "solver": str(root / "benchmark/solvers/dc.py"),
        "reference": str(root / "benchmark/reference/kinds/poisson.py")}
    assert config["problem"]["operator"] == "kron"
    assert config["problem"]["dtype"] == "f64"
    assert config["reduced"] == []


def test_the_kind_builds_the_headline_dc(root):
    """``MixedPrecisionMG`` with twofloat residuals, the configuration's
    window (λmax/32) and one cycle a correction, as the headline example's
    ``build(..., solver="dc")``; its control is the pcg kind in f32."""
    from poms_tpu_torch.mg.mixed import MixedPrecisionMG
    man = harness.manifest(root)
    config = harness.cell(man, TINY_DC, root)[1]
    _, solver, pool = harness.build(config, harness.kinds(config, root),
                                    {"sources": SOURCES}, 1,
                                    torch.device("cpu"), {})
    assert type(solver) is MixedPrecisionMG
    assert solver.residual_mode == "twofloat"
    assert solver.inner_cycles == 1
    assert solver.cfg.smoother.cheb_fraction == 32.0
    assert solver.cfg.smoother.cheb_degree == 4
    assert len(solver.levels32) == 2
    assert solver.levels32[0].A.space.dtype == torch.float32
    assert len(pool) == len(SOURCES)
    control = harness._merge(config, config["control"])
    assert control["solver"]["kind"] == "pcg"
    assert control["problem"]["dtype"] == "f32"


def test_a_tiny_dc_cell_is_correct(first):
    assert first["correct"] is True and first["failed"] == 0
    assert 0 < first["checks"]["true_residual_max"]["value"] <= 1e-10
    assert first["attempted"] >= len(SOURCES)
    assert first["metrics"]["solve_ms"]["value"] > 0


def test_the_readers_range_every_call_of_a_correction(root):
    """The ranges of the traced run see every kernel call of the dc step,
    each with its work: the entries the cell's rooflines name are the ones
    defect correction calls."""
    man = harness.manifest(root)
    _, config, traffic = harness.cell(man, TINY_DC, root)
    spans = {}
    for m in harness.metric_names(man, TINY_DC, True):
        spans.update(getattr(harness.reader(m["name"], root), "SPANS", {}))
    assert set(spans) == {"kron", "dw", "transfer", "k6r", "k6u"}
    _, solver, pool = harness.build(config, harness.kinds(config, root),
                                    traffic, 1, torch.device("cpu"), {})
    ranges = harness.Spans(spans)
    with ranges.installed():
        solver.solve(pool[0], tol=1e-10, maxiter=2)
    layers = [c[0] for c in ranges.calls.values()]
    # 2 corrections: a cycle each of 2 smoothed levels (8 `cheb` passes and
    # a residual before the restriction), a restriction and a prolongation;
    # one double-word residual b − A·x (K5); K6r: ‖b‖ at the start and ‖r‖
    # a correction; K6u: `div` into the cycle and `defect` out of it
    assert layers.count("kron") == 2 * (8 + 1)
    assert layers.count("dw") == 2
    assert layers.count("transfer") == 2 * 2
    assert layers.count("k6r") == 1 + 2
    assert layers.count("k6u") == 2 * 2
    assert all(c[1] > 0 and (c[2] > 0) == (c[0] not in ("k6r", "k6u"))
               for c in ranges.calls.values())


def test_the_control_fails(root):
    """The program one precision lower (f32 throughout: the pcg kind on the
    f32 problem, as MixedPrecisionMG refuses one) reaches 1e-10 by its own
    recurrence, and its solutions miss it by orders."""
    out = _run(root, 5, seconds=0.3, control=True)
    assert out["correct"] is False
    assert out["checks"]["true_residual_max"]["value"] > 100 * 1e-10


def _by_source(out, seed):
    slots = rhs.draw(SOURCES, seed)
    return {slots[k]["source"]: its
            for k, its in enumerate(out["iterations_by_slot"])}


def test_corrections_are_the_same_on_every_seed(root, first, window):
    """Each source takes the same corrections, within one, on two seeds
    (the operator commutes with the symmetries the seed draws)."""
    other = _run(root, 7, seconds=window)
    a, b = _by_source(first, 2 ** 31 + 99), _by_source(other, 7)
    for k in range(len(SOURCES)):
        assert a[k] and b[k], "every source solved at least once"
        assert max(a[k] + b[k]) - min(a[k] + b[k]) <= 1


def _drop_low_word(solver):
    """The timed solve's answer without the low word xl of its double-word
    solution: x = xh, an f32 solution in f64 clothing."""
    orig = solver.solve_compiled

    def solve_compiled(b, tol, maxiter, return_x):
        solver._x_interior = lambda state: state[0].to(torch.float64)
        return orig(b, tol=tol, maxiter=maxiter, return_x=return_x)
    solver.solve_compiled = solve_compiled


def test_a_dropped_low_word_fails(root):
    out = _run(root, 2 ** 31 + 99, seconds=1.0, hook=_drop_low_word)
    assert out["failed"] == 0            # its own residual still says 1e-10
    assert out["correct"] is False
    assert out["checks"]["true_residual_max"]["value"] > 10 * 1e-10
