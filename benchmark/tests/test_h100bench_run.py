"""A run of a cell without the card: its result line, what it loads, that
it refuses to run without a card, and that the check fails the control and
every fault a cell of one card can have."""
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from h100bench_util import ROOT, TINY, tiny_root

from benchmark import harness


def _run(root, traced=False, hook=None, control=False, seconds=0.2,
         seed=2 ** 31 + 99):
    man = harness.manifest(root)
    return harness.run(man, TINY, seed, seconds, traced,
                       torch.device("cpu"), time.perf_counter(),
                       solve_hook=hook, root=root, control=control)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line(root, traced):
    out = _run(root, traced)
    line = json.dumps(out)
    assert json.loads(line) == out
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["checks"]) == {"true_residual_max", "failed_solves"}
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    wanted = {m["name"] for m in harness.metric_names(
        harness.manifest(root), TINY, traced)}
    if traced:
        assert "breakdown" in out
        # the CPU has no device trace and launches no kernel: no idle share
        # and no roofline (K1, K5, K7, K6r, K6u), no hand-written kernel a
        # step; its solve_compiled is the eager loop, which replays no graph
        # and so copies nothing back; and the run-time plans get their
        # scratch on the card only: only the clocks and the iteration
        # counts read
        assert set(out["metrics"]) == wanted - {
            "idle_share", "kron_roofline", "dw_roofline", "transfer_roofline",
            "reduce_roofline", "update_roofline", "kernels_per_iter",
            "copy_gb_per_iter", "scratch_gib"}
    else:
        assert set(out["metrics"]) == wanted - {"peak_mem_gib"}
    for m in out["metrics"].values():
        assert m["value"] > 0


def test_the_traced_run_counts_every_call(root):
    """The ranges of the traced run see every kernel call the rooflines
    count, each with its work."""
    man = harness.manifest(root)
    wl, config, traffic = harness.cell(man, TINY, root)
    from benchmark.work import calls
    spans = {}
    for m in harness.metric_names(man, TINY, True):
        spans.update(getattr(harness.reader(m["name"], root), "SPANS", {}))
    assert set(spans) == {"kron", "dw", "transfer", "k6r", "k6u"}
    _, solver, pool = harness.build(config, harness.kinds(config, root),
                                    traffic, 1, torch.device("cpu"), {})
    ranges = harness.Spans(spans)
    with ranges.installed():
        solver.solve(pool[0], tol=1e-10, maxiter=2)
    layers = [c[0] for c in ranges.calls.values()]
    # the start and 2 steps: 3 cycles of 2 smoothed levels (ν1 + ν2 = 2
    # Chebyshev(4) steps each: 8 `cheb` passes) and a residual a level
    # before the restriction; 2 double-word A·p; a restriction and a
    # prolongation a cycle; K6r: ‖b‖ and z·b at the start, then a step's
    # p·Ap, ‖r‖ and the stacked pair of dots; K6u: each cycle's scaling
    # in and out, and a step's `cg` and `direction` updates
    assert layers.count("kron") == 3 * (8 + 1)
    assert layers.count("dw") == 2
    assert layers.count("transfer") == 3 * 2
    assert layers.count("k6r") == 2 + 2 * 3
    assert layers.count("k6u") == 3 * 2 + 2 * 2
    # each call has its bytes and operations; K6r and K6u are held to their
    # bytes alone (benchmark/work/k6.py)
    assert all(c[1] > 0 and (c[2] > 0) == (c[0] not in ("k6r", "k6u"))
               for c in ranges.calls.values())
    assert calls.dtype_name(torch.zeros(1)) == "f32"


def test_nothing_of_jax_is_loaded(root):
    code = ("import sys, time, torch; sys.path.insert(0, %r); "
            "sys.path.insert(0, %r); from benchmark import harness; "
            "import h100bench_util as u; from pathlib import Path; "
            "import tempfile; d = Path(tempfile.mkdtemp()); "
            "r = u.tiny_root(d); "
            "harness.run(harness.manifest(r), u.TINY, 3, 0.1, True, "
            "torch.device('cpu'), time.perf_counter(), root=r); "
            "print(harness.forbidden_modules())"
            % (str(ROOT), str(ROOT / "benchmark/tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names():
    saved = dict(sys.modules)
    try:
        sys.modules["poms_tpu_torch_x"] = sys
        sys.modules.pop("poms_tpu", None)
        assert "poms_tpu" not in harness.forbidden_modules()
        sys.modules["poms_tpu.core"] = sys
        assert "poms_tpu" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "kron_pcg_p3_n512",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=600,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             **(env or {})})


def test_the_runner_refuses_without_a_card():
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_the_runner_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


# -- the control and the faults: the timed path broken underneath ------------

def test_the_control_fails(root):
    """The program one precision lower (f32 throughout) reaches 1e-10 by its
    own recurrence, and its solutions miss it by orders."""
    out = _run(root, control=True)
    assert out["correct"] is False
    assert out["checks"]["true_residual_max"]["value"] > 100 * 1e-10


def _unchanged(solver):
    """A step that returns its state unchanged: x stays at its start, 0."""
    def solve_compiled(b, tol, maxiter, return_x):
        return torch.zeros_like(b.interior), torch.tensor(tol / 2), 1
    solver.solve_compiled = solve_compiled


def _half(solver):
    """Half of the work left out: every other right-hand side is answered
    with the solution of the one before it."""
    orig, last = solver.solve_compiled, {}

    def solve_compiled(b, tol, maxiter, return_x, _n=[0]):
        _n[0] += 1
        if _n[0] % 2 == 0 and "x" in last:
            return last["x"].clone(), last["rn"], last["it"]
        x, rn, it = orig(b, tol=tol, maxiter=maxiter, return_x=return_x)
        last.update(x=x, rn=rn, it=it)
        return x, rn, it
    solver.solve_compiled = solve_compiled


def _altered(solver):
    """An answer altered where it is produced: one value of x moved."""
    orig = solver.solve_compiled

    def solve_compiled(b, tol, maxiter, return_x):
        x, rn, it = orig(b, tol=tol, maxiter=maxiter, return_x=return_x)
        x = x.clone()
        x[1, 2, 3] += 1e-6
        return x, rn, it
    solver.solve_compiled = solve_compiled


def _unconverged(solver):
    """A solve that stops early and says so."""
    orig = solver.solve_compiled

    def solve_compiled(b, tol, maxiter, return_x):
        return orig(b, tol=tol, maxiter=2, return_x=return_x)
    solver.solve_compiled = solve_compiled


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered,
                                   _unconverged])
def test_every_fault_fails(root, fault):
    out = _run(root, hook=fault, seconds=1.0)
    assert out["correct"] is False


@pytest.mark.cuda
def test_the_control_fails_on_the_card(tmp_path):
    """On the card at a test size: the program passes, its control fails
    (the same check as the cells', which the benchmark's runs never make
    with the control)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tiny_root(tmp_path, n_el=32)
    dev = torch.device("cuda", 0)
    man = harness.manifest(root)
    good = harness.run(man, TINY, 5, 0.5, True, dev, time.perf_counter(),
                       root=root)
    bad = harness.run(man, TINY, 5, 0.5, False, dev, time.perf_counter(),
                      root=root, control=True)
    assert good["correct"] is True and bad["correct"] is False
    for name in ("kron_roofline", "dw_roofline", "transfer_roofline",
                 "idle_share"):
        assert 0 < good["metrics"][name]["value"] <= 105
