"""The kinds a configuration names: a new problem and reference kind is files
alone, the residual is taken with the kind's own operator, a kind with no
module is refused before set-up, and the ``poisson`` and ``pcg`` kinds give
the bits and the solver that the harness gave before it found them by kind
(its earlier code kept below, frozen)."""
import json
import math
import re
import shutil
import time

import pytest
import torch

from h100bench_util import ROOT, TINY, reference_kind, tiny_root

from benchmark import harness
from benchmark.reference import check, rhs
from benchmark.reference.bspline import load
from benchmark.reference.operator import KronSum

SOURCES = json.loads(
    (ROOT / "benchmark/traffic/smooth4.json").read_text())["sources"]
POISSON = reference_kind()


# -- the right-hand sides, the residual and the build before kinds (frozen) --

def _old_terms(source, slot):
    out = []
    for term in source:
        modes = [term["modes"][a] for a in slot["axes"]]
        c = term["coef"] * slot["sign"]
        for a in range(3):
            if slot["mirror"][a] and modes[a] % 2 == 0:
                c = -c
        out.append((c, modes))
    return out


def _old_make(n_el, degree, terms, device):
    vec = {}
    total = None
    for c, modes in terms:
        v = []
        for m in modes:
            if m not in vec:
                vec[m] = torch.as_tensor(load(n_el, degree, m),
                                         dtype=torch.float64, device=device)
            v.append(vec[m])
        t = (c * v[0])[:, None, None] * v[1][None, :, None] \
            * v[2][None, None, :]
        if total is None:
            total = t
        else:
            total += t
            del t
    return total


def _old_target(n_el, degree):
    s = float(torch.linalg.vector_norm(torch.as_tensor(load(n_el, degree, 1))))
    return 3 * math.pi ** 2 * s ** 3


def _old_one(n_el, degree, sources, seed, k, device):
    slot = rhs.draw(sources, seed)[k]
    b = _old_make(n_el, degree, _old_terms(sources[slot["source"]], slot),
                  device)
    b *= _old_target(n_el, degree) / float(torch.linalg.vector_norm(b))
    return b


def _old_residuals(n_el, degree, sources, seed, solutions, device):
    A = KronSum(n_el, degree, device)
    out = []
    for slot, x in solutions:
        b = _old_one(n_el, degree, sources, seed, slot, device)
        r = b - A.apply(x.to(device=device, dtype=torch.float64))
        out.append(float(torch.linalg.vector_norm(r)))
    return out


def _old_build(config, device):
    from poms_tpu_torch.mg.cycles import CycleConfig
    from poms_tpu_torch.mg.mixed import MGPreconditionedCG
    from poms_tpu_torch.mg.smoother import SmootherConfig
    from poms_tpu_torch.models.poisson import poisson_problem

    dtypes = {"f64": torch.float64, "f32": torch.float32,
              "bf16": torch.bfloat16}
    pr, so = config["problem"], config["solver"]
    prob = poisson_problem(3, pr["n_el"], degree=pr["degree"],
                           operator=pr["operator"],
                           dtype=dtypes[pr["dtype"]], device=device)
    cyc = so["cycle"]
    cfg = CycleConfig(nu1=cyc["nu1"], nu2=cyc["nu2"],
                      smoother=SmootherConfig(
                          cyc["smoother"], cheb_degree=cyc["cheb_degree"],
                          cheb_fraction=cyc["cheb_fraction"]))
    solver = MGPreconditionedCG(prob, num_levels=so["levels"], cfg=cfg,
                                mixed=so["mixed"],
                                low_dtype=dtypes[so["low_dtype"]],
                                operator=pr["operator"],
                                precision=so["precision"])
    prob.b = None
    return prob, solver


# -- the poisson kind gives the same bits -----------------------------------

@pytest.mark.parametrize("seed", [7, 2 ** 33 + 5])
@pytest.mark.parametrize("degree", [3, 5])
@pytest.mark.parametrize("n_el", [8, 16])
def test_poisson_kind_gives_the_same_bits(n_el, degree, seed):
    pr = {"n_el": n_el, "degree": degree}
    new = rhs.pool(POISSON, pr, SOURCES, seed, "cpu")
    for k, b in enumerate(new):
        old = _old_one(n_el, degree, SOURCES, seed, k, "cpu")
        assert torch.equal(b, old)
        assert torch.equal(rhs.one(POISSON, pr, SOURCES, seed, k, "cpu"), old)
    g = torch.Generator().manual_seed(seed % 2 ** 31)
    solutions = [(k, torch.randn(b.shape, generator=g, dtype=torch.float64)
                  * 10.0 ** -k) for k, b in enumerate(new)]
    assert check.residuals(POISSON, pr, SOURCES, seed, solutions, "cpu") \
        == _old_residuals(n_el, degree, SOURCES, seed, solutions, "cpu")


def test_build_gives_the_same_solver(tmp_path):
    """The ``poisson`` problem and ``pcg`` solver kinds build the tiny cell's
    solver as the harness built it before: as many levels, and the same
    iterations for each slot of the pool (whose bits are the same)."""
    root = tiny_root(tmp_path)
    man = harness.manifest(root)
    _, config, traffic = harness.cell(man, TINY, root)
    cpu = torch.device("cpu")
    times = {}
    _, solver, pool = harness.build(config, harness.kinds(config, root),
                                    traffic, 11, cpu, times)
    assert set(times) == {"problem", "solver", "rhs"}
    old_prob, old_solver = _old_build(config, cpu)
    from poms_tpu_torch.core.vector import StencilVector
    pr = config["problem"]
    old_pool = [StencilVector.from_interior(old_prob.space, _old_one(
        pr["n_el"], pr["degree"], traffic["sources"], 11, k, cpu).to(
            old_prob.space.dtype)) for k in range(len(pool))]
    assert len(solver.levels) == len(old_solver.levels) == 2
    tol, maxiter = config["tol"], config["maxiter"]
    for b, old_b in zip(pool, old_pool):
        assert torch.equal(b.interior, old_b.interior)
        its = [s.solve_compiled(v, tol=tol, maxiter=maxiter,
                                return_x=False)[2]
               for s, v in ((solver, b), (old_solver, old_b))]
        assert its[0] == its[1] > 0


# -- a kind is its files ---------------------------------------------------

def _add_cell(root, name, problem_kind=None, solver_kind=None):
    """A configuration and a cell beside the tiny ones, its problem and
    solver of the kinds named: new files and new manifest entries only."""
    config = json.loads((root / "benchmark/configs/tiny.json").read_text())
    config["name"] = name
    if problem_kind is not None:
        config["problem"]["kind"] = problem_kind
    if solver_kind is not None:
        config["solver"]["kind"] = solver_kind
    (root / f"benchmark/configs/{name}.json").write_text(json.dumps(config))
    man = harness.manifest(root)
    man["configs"].append({"name": name, "source": "test",
                           "file": f"benchmark/configs/{name}.json",
                           "reduced": ["n_el"], "why": "test"})
    man["workloads"].append({"name": name, "config": name,
                             "traffic": "smooth4", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return man


def _run(man, name, root):
    return harness.run(man, name, 2 ** 32 + 3, 0.2, False,
                       torch.device("cpu"), time.perf_counter(), root=root)


def test_a_new_kind_is_its_files(tmp_path):
    """A problem kind and a reference kind written into the checkout alone
    (here a copy of ``poisson`` under another name) run a cell correct: no
    file of the benchmark is edited."""
    root = tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    for d in ("problems", "reference/kinds"):
        shutil.copy(root / f"benchmark/{d}/poisson.py",
                    root / f"benchmark/{d}/poisson_copy.py")
    man = _add_cell(root, "copied", problem_kind="poisson_copy")
    for p, data in before.items():
        assert p.read_bytes() == data
    config = harness.cell(man, "copied", root)[1]
    assert {k: m.__file__ for k, m in harness.kinds(config, root).items()} \
        == {"problem": str(root / "benchmark/problems/poisson_copy.py"),
            "solver": str(root / "benchmark/solvers/pcg.py"),
            "reference": str(root / "benchmark/reference/kinds/"
                             "poisson_copy.py")}
    out = _run(man, "copied", root)
    assert out["correct"] is True
    assert out["checks"]["true_residual_max"]["value"] <= 1e-10


# appended to a copy of the poisson reference kind: its operator, doubled
DOUBLED = """

class _Doubled(KronSum):
    def apply(self, x):
        return 2 * super().apply(x)


def operator(problem, device):
    return _Doubled(problem["n_el"], problem["degree"], device)
"""


def test_the_residual_is_taken_with_the_kinds_operator(tmp_path):
    """The program's ``poisson`` problem paired with a reference kind whose
    operator is 2·A: its solutions fail the check."""
    root = tiny_root(tmp_path)
    shutil.copy(root / "benchmark/problems/poisson.py",
                root / "benchmark/problems/doubled.py")
    ref = (root / "benchmark/reference/kinds/poisson.py").read_text()
    (root / "benchmark/reference/kinds/doubled.py").write_text(ref + DOUBLED)
    man = _add_cell(root, "doubled", problem_kind="doubled")
    out = _run(man, "doubled", root)
    # the solutions meet A·x = b, so ‖b − 2·A·x‖₂ is ‖b‖₂, the target norm
    assert out["correct"] is False and out["failed"] == 0
    config = harness.cell(man, "doubled", root)[1]
    assert out["checks"]["true_residual_max"]["value"] == pytest.approx(
        POISSON.target_norm(config["problem"]), rel=1e-6)


MARKED = '''def make(problem, dtype, device):
    raise RuntimeError("set-up began")
'''


@pytest.mark.parametrize("missing", ["problem", "solver", "reference"])
def test_a_kind_without_a_module_is_refused_before_set_up(tmp_path, missing):
    """The error names the path looked for, and no problem was made: the
    problem kind that is there raises as soon as it is asked to make one."""
    root = tiny_root(tmp_path)
    (root / "benchmark/problems/marked.py").write_text(MARKED)
    if missing != "reference":
        shutil.copy(root / "benchmark/reference/kinds/poisson.py",
                    root / "benchmark/reference/kinds/marked.py")
    problem, solver = {"problem": ("absent", "pcg"),
                       "solver": ("marked", "absent"),
                       "reference": ("marked", "pcg")}[missing]
    man = _add_cell(root, "refused", problem, solver)
    named = solver if missing == "solver" else problem
    looked = root / harness.KIND_DIRS[missing] / f"{named}.py"
    with pytest.raises(FileNotFoundError, match=re.escape(str(looked))):
        _run(man, "refused", root)
