"""Problems of one, two or three axes: the right-hand sides, the reference
operators and the K1/K5 work counts take the configuration's ``dim``.  On
every 3D cell they give the bits and counts the 3D-only code gave (frozen in
``h100bench_frozen.py``); in 1D and 2D the pools are plain outer products,
the counts are of the operation on its own axes, and a tiny cell of each
runs through the harness, correct, with its control and a dropped low word
failing."""
import json
import math
import time

import pytest
import torch

import h100bench_frozen as frozen
from h100bench_util import ROOT, reference_kind, tiny_root

from benchmark import harness, work
from benchmark.reference import check, rhs
from benchmark.work import calls

MAN = harness.manifest()
SEEDS = (0, 7, 123456789, 2 ** 31 + 99, 2 ** 33 + 5)
MODES = ("apply", "residual", "dinv", "cheb")
DTYPES = (torch.float32, torch.float64, torch.bfloat16)


def _cell(name):
    return harness.cell(MAN, name)


# -- every 3D cell reads what it read -----------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_3d_pools_are_the_frozen_bits(name, seed):
    """The cell's configuration and traffic at 8 elements an axis (the
    draw does not depend on the size): every slot bit-equal."""
    _, config, traffic = _cell(name)
    pr = dict(config["problem"], n_el=8)
    kind_name = pr.get("kind", "poisson")
    kind = reference_kind(kind_name)
    sources = traffic["sources"]
    assert rhs.draw(sources, seed) == frozen.draw(sources, seed)
    assert rhs.draw(sources, seed, 3) == frozen.draw(sources, seed)
    pool = rhs.pool(kind, pr, sources, seed, "cpu")
    for k, b in enumerate(pool):
        old = frozen.one(kind, kind_name, pr, sources, seed, k, "cpu")
        assert b.shape == (old.shape[0],) * 3
        assert torch.equal(b, old)
        assert torch.equal(rhs.one(kind, pr, sources, seed, k, "cpu"), old)
    assert kind.target_norm(pr) == frozen.target_norm(kind_name, pr)


@pytest.mark.parametrize("kind_name,problem", [
    ("poisson", {"n_el": 8, "degree": 3}),
    ("poisson", {"n_el": 9, "degree": 5, "dim": 3}),
    ("periodic", {"n_el": 8, "degree": 3, "shift": 1.0, "dim": 3})])
def test_3d_reference_operators_are_the_frozen_bits(kind_name, problem):
    kind = reference_kind(kind_name)
    A = kind.operator(problem, "cpu")
    n = A.K.shape[0]
    g = torch.Generator().manual_seed(n)
    x = torch.randn((n, n, 4 + n), generator=g, dtype=torch.float64)[..., :n]
    shift = problem.get("shift")
    assert torch.equal(A.apply(x), frozen.apply(A.K, A.M, x, shift))


def _levels(config):
    """The Kronecker-sum operator of each level of the cell's hierarchy, as
    the port builds it (1D bands of that level, the terms sharing them), in
    f32, on the CPU: only their plans and labels are read."""
    from poms_tpu_torch.core.space import StencilVectorSpace
    from poms_tpu_torch.mg.hierarchy import _kron_operator_from_1d
    from poms_tpu_torch.models.bspline import assemble_spline_1d
    from poms_tpu_torch.models.periodic import (_kron_periodic,
                                                assemble_periodic_1d)
    pr = config["problem"]
    p, out = pr["degree"], []
    for level in range(config["solver"]["levels"]):
        n_el = pr["n_el"] >> level
        if pr.get("kind") == "periodic":
            bands = [assemble_periodic_1d(n_el, p) for _ in range(3)]
            space = StencilVectorSpace(npts=(n_el,) * 3, pads=p,
                                       periodic=True, dtype=torch.float32,
                                       device="cpu")
            out.append(_kron_periodic(bands, pr["shift"], space))
        else:
            s = assemble_spline_1d(n_el, p)
            space = StencilVectorSpace(npts=(s.n,) * 3, pads=p,
                                       periodic=False, dtype=torch.float32,
                                       device="cpu")
            out.append(_kron_operator_from_1d([(s.K, s.M)] * 3, space))
    return out


def _field(shape, dtype=torch.float32):
    """A field of ``shape`` that holds one value: the counts read its
    shape and dtype alone."""
    return torch.zeros(1, dtype=dtype).expand(*shape)


@pytest.mark.parametrize("name,sizes", [
    ("kron_pcg_p3_n512", (513, 257, 129, 65, 33, 17, 9)),
    ("kron_dc_p3_n512", (513, 257, 129, 65, 33, 17, 9)),
    ("kron_pcg_periodic_p3_n512", (512, 256, 128, 64, 32, 16, 8)),
    ("kron_pcg_p5_n256", (259, 131, 67, 35, 19, 11))])
def test_3d_work_counts_are_the_frozen_counts(name, sizes):
    """Every K1 / K1r call (each mode, the first Chebyshev step, each
    dtype) and every K5 / K5r call (with and without b and x's low word) on
    each level of the cell, to the byte and the operation."""
    config = _cell(name)[1]
    ops = _levels(config)
    assert tuple(A.plan.npts[0] for A in ops) == sizes
    for A in ops:
        plan = A.plan
        assert plan.ndim == 3 and plan.n3 == plan.npts
        assert plan.runtime == (config["problem"]["degree"] == 5)
        if config["problem"].get("kind") == "periodic":
            assert plan.n_terms == 3           # the shift term folded
        for mode in MODES:
            for dtype in DTYPES:
                x = torch.zeros(1, dtype=dtype)
                b = x if mode in ("residual", "cheb") else None
                for d in ((None, x) if mode == "cheb" else (None,)):
                    args = (mode, plan, x, b, d)
                    assert calls.kron_mode(args, {}) \
                        == frozen.call_kron_mode(args, {})
        labels = A._band_labels()
        xh = _field(A.space.npts)
        for bh in (None, xh):
            for xl in (None, xh):
                args = (None, bh, bh, xh, xl, A.space.pads)
                kw = {"labels": labels}
                assert calls.residual_kron_df(args, kw) \
                    == frozen.call_residual_kron_df(args, kw)


def test_the_frozen_counts_are_the_hand_counts():
    poisson = [[0, 1, 1], [0, 1, 0], [0, 0, 1]]
    assert frozen.contractions(poisson) == work.contractions(poisson) == 7
    assert frozen.kron("cheb", (10, 11, 12), 3, poisson, 4) \
        == work.kron("cheb", (10, 11, 12), 3, poisson, 4)


# -- 1D and 2D ----------------------------------------------------------------

@pytest.mark.parametrize("labels,count", [
    ([[0, 1], [0, 1]], 4), ([[0, 1], [1, 0]], 4), ([[0]], 1),
    ([[0, 1]], 2), ([[0, 0], [0, 1]], 3), ([[0, 1, 2], [0, 0, 1]], 5)])
def test_contractions_on_the_own_axes(labels, count):
    """2D Poisson: 2 axis-1 bands, 2 axis-0 bands; the unfolded 2D
    periodic operator σM⊗M + K⊗M + M⊗K: 2 and 3; 1D: one a band."""
    assert work.contractions(labels) == count


@pytest.mark.parametrize("n_el", [6, 512])
def test_a_lifted_2d_plan_counts_the_2d_operation(n_el):
    """The port runs a 2D field as (1, n, n) with an identity band on the
    lifted axis; K1's count is of the 2D operation (4 contractions, the
    bands of the two own axes), not of the lift (5), and K5's of the 2D
    field as mg/mixed.py passes it."""
    from poms_tpu_torch.core.space import StencilVectorSpace
    from poms_tpu_torch.mg.hierarchy import _kron_operator_from_1d
    from poms_tpu_torch.models.bspline import assemble_spline_1d
    s = assemble_spline_1d(n_el, 3)
    space = StencilVectorSpace(npts=(s.n, s.n), pads=3, periodic=False,
                               dtype=torch.float32, device="cpu")
    A = _kron_operator_from_1d([(s.K, s.M)] * 2, space)
    plan, labels = A.plan, A._band_labels()
    assert plan.n3 == (1, s.n, s.n) and len(plan.labels) == 3
    assert work.contractions(labels) == 4
    assert frozen.contractions(plan.labels) == 5
    for mode in MODES:
        x = torch.zeros(1)
        b = x if mode in ("residual", "cheb") else None
        got = calls.kron_mode((mode, plan, x, b, None), {})
        assert got == (*work.kron(mode, (s.n, s.n), 3, labels, 4,
                                  first_cheb=True), "f32")
        assert got[1] == (2 * 7 * 4 + work._KRON_EPILOGUE[mode]) * s.n ** 2
    xh = _field((s.n, s.n))
    got = calls.residual_kron_df((None, xh, xh, xh, xh, (3, 3)),
                                 {"labels": labels})
    assert got == (*work.kron_dw((s.n, s.n), 3, labels, True, True), "f32")
    assert got[0] == 6 * s.n ** 2 * 4 + 2 * 2 * 2 * s.n * 7 * 4


SOURCES = {1: [[{"coef": math.pi ** 2, "modes": [1]}],
               [{"coef": 1.0, "modes": [2]}],
               [{"coef": 1.0, "modes": [3]}, {"coef": 0.5, "modes": [1]}],
               [{"coef": 1.0, "modes": [4]}]],
           2: [[{"coef": 2 * math.pi ** 2, "modes": [1, 1]}],
               [{"coef": 1.0, "modes": [1, 2]}],
               [{"coef": 1.0, "modes": [1, 3]},
                {"coef": 0.5, "modes": [3, 1]}],
               [{"coef": 1.0, "modes": [2, 2]}, {"coef": 0.7, "modes": [1, 3]},
                {"coef": 0.4, "modes": [4, 1]}]]}
PROBLEMS = {"poisson": {"n_el": 10, "degree": 3},
            "periodic": {"n_el": 12, "degree": 3, "shift": 1.0}}


def _einsum_pool(kind, problem, sources, seed, dim):
    """Each slot by its source's terms with the slot's permutation, mirrors
    and sign applied to the modes, as one einsum over the 1D loads, scaled to
    d·π²·s^d (poisson) or (σ + 4dπ²)·s^d (periodic), s = ‖load of mode 1‖."""
    load = {m: torch.as_tensor(kind.load(problem, m), dtype=torch.float64)
            for m in range(1, 6)}
    s = float(torch.linalg.vector_norm(load[1]))
    target = (dim * math.pi ** 2 if "shift" not in problem
              else problem["shift"] + 4 * dim * math.pi ** 2) * s ** dim
    spec = ",".join("ijk"[:dim]) + "->" + "ijk"[:dim]
    out = []
    for slot in rhs.draw(sources, seed, dim):
        b = 0
        for term in sources[slot["source"]]:
            modes = [term["modes"][a] for a in slot["axes"]]
            c = term["coef"] * slot["sign"] * math.prod(
                kind.mirror_sign(m) for m, f in zip(modes, slot["mirror"])
                if f)
            b = b + c * torch.einsum(spec, *(load[m] for m in modes))
        out.append(b * (target / float(torch.linalg.vector_norm(b))))
    return out


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("kind_name", ["poisson", "periodic"])
@pytest.mark.parametrize("dim", [1, 2])
def test_1d_and_2d_pools_are_plain_outer_products(dim, kind_name, seed):
    kind = reference_kind(kind_name)
    pr = dict(PROBLEMS[kind_name], dim=dim)
    got = rhs.pool(kind, pr, SOURCES[dim], seed, "cpu")
    want = _einsum_pool(kind, pr, SOURCES[dim], seed, dim)
    n = got[0].shape[0]
    for b, w in zip(got, want):
        assert b.shape == (n,) * dim
        assert torch.allclose(b, w, rtol=1e-13, atol=1e-15 * w.abs().max())
    slots = rhs.draw(SOURCES[dim], seed, dim)
    assert sorted(s["source"] for s in slots) == list(range(4))
    assert all(sorted(s["axes"]) == list(range(dim)) for s in slots)


def test_a_2d_slot_is_the_source_under_its_symmetry():
    """Independent of the mode signs: a poisson 2D slot is its source's
    load, its axes permuted and the mirrored axes reversed, times the sign."""
    kind = reference_kind("poisson")
    pr = {"n_el": 10, "degree": 3, "dim": 2}
    for seed in SEEDS:
        for slot, b in zip(rhs.draw(SOURCES[2], seed, 2),
                           rhs.pool(kind, pr, SOURCES[2], seed, "cpu")):
            base = rhs.make(kind, pr, [(t["coef"], t["modes"])
                                       for t in SOURCES[2][slot["source"]]],
                            "cpu")
            want = slot["sign"] * base.permute(slot["axes"]).flip(
                [a for a in range(2) if slot["mirror"][a]])
            want *= float(torch.linalg.vector_norm(b)) \
                / float(torch.linalg.vector_norm(want))
            assert torch.allclose(b, want, rtol=1e-12,
                                  atol=1e-13 * want.abs().max())


@pytest.mark.parametrize("dim,sources", [
    (2, SOURCES[1]), (2, [[{"coef": 1.0, "modes": [1, 1, 1]}]]),
    (3, SOURCES[2]), (1, SOURCES[2]), (2, [SOURCES[2][0],
                                           [{"coef": 1.0, "modes": [2]}]])])
def test_a_source_with_the_wrong_number_of_modes_is_refused(dim, sources):
    kind = reference_kind()
    pr = {"n_el": 8, "degree": 3, "dim": dim}
    bad = next(k for k, s in enumerate(sources)
               if any(len(t["modes"]) != dim for t in s))
    with pytest.raises(ValueError, match=f"source {bad} of the traffic"):
        rhs.pool(kind, pr, sources, 1, "cpu")
    with pytest.raises(ValueError, match=f"problem has {dim} axes"):
        rhs.one(kind, pr, sources, 1, 0, "cpu")


@pytest.mark.parametrize("kind_name", ["poisson", "periodic"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_the_reference_operator_is_the_ports(dim, kind_name):
    """A·x of the reference kind on a field of ``dim`` axes against the
    port's Kronecker-sum operator of that problem (the port is imported by
    the test alone)."""
    from poms_tpu_torch.core.vector import StencilVector
    problem = dict(PROBLEMS[kind_name], dim=dim, operator="kron")
    prob = harness._module(ROOT / f"benchmark/problems/{kind_name}.py",
                           "test_problem_" + kind_name).make(
        problem, torch.float64, "cpu")
    assert prob.space.ndim == dim
    g = torch.Generator().manual_seed(dim)
    x = torch.randn(prob.space.shape, generator=g, dtype=torch.float64)
    ours = reference_kind(kind_name).operator(problem, "cpu").apply(x)
    theirs = prob.A.dot(StencilVector.from_interior(prob.space, x)).interior
    assert ours.shape == x.shape
    assert torch.allclose(ours, theirs, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind_name", ["poisson", "periodic"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_the_target_norm_is_the_manufactured_sources(dim, kind_name):
    kind = reference_kind(kind_name)
    pr = dict(PROBLEMS[kind_name], dim=dim)
    s = float(torch.linalg.vector_norm(torch.as_tensor(kind.load(pr, 1))))
    lap = (1 if kind_name == "poisson" else 4) * dim * math.pi ** 2
    want = (lap + pr.get("shift", 0.0)) * s ** dim
    assert kind.target_norm(pr) == pytest.approx(want, rel=1e-15)


def test_a_solution_of_another_shape_is_refused():
    kind = reference_kind()
    pr = {"n_el": 8, "degree": 3, "dim": 2}
    n = rhs.one(kind, pr, SOURCES[2], 1, 0, "cpu").shape[0]
    with pytest.raises(ValueError, match="shape"):
        check.residuals(kind, pr, SOURCES[2], 1,
                        [(0, torch.zeros(n))], "cpu")
    with pytest.raises(ValueError, match="shape"):
        check.residuals(kind, pr, SOURCES[2], 1,
                        [(0, torch.zeros(n, n, 1))], "cpu")
    assert check.residuals(kind, pr, SOURCES[2], 1,
                           [(0, torch.zeros(n, n))], "cpu")[0] > 0


# -- a tiny 1D and 2D cell through the harness --------------------------------

TINY_DIM = {1: ("tiny_1d", 64, 3), 2: ("tiny_2d", 16, 2)}


def dim_root(tmp, dim):
    """A checkout-shaped copy of the benchmark (``tiny_root``'s) with one
    more cell: the headline configuration (dw-PCG, ``kron``) in ``dim``
    axes, on a traffic file of ``dim``-mode sources; no file of the
    benchmark edited."""
    root = tiny_root(tmp)
    name, n_el, levels = TINY_DIM[dim]
    config = json.loads((ROOT / "benchmark/configs/"
                         "poisson3d_kron_p3_n512.json").read_text())
    config["name"] = name
    config["problem"].update(dim=dim, n_el=n_el)
    config["solver"]["levels"] = levels
    config["check"]["solutions"] = 3
    (root / f"benchmark/configs/{name}.json").write_text(json.dumps(config))
    (root / f"benchmark/traffic/smooth4_{dim}d.json").write_text(
        json.dumps({"name": f"smooth4_{dim}d", "loop": "closed",
                    "clients": 1, "sources": SOURCES[dim]}))
    man = harness.manifest(root)
    man["configs"].append({"name": name, "source": "test",
                           "file": f"benchmark/configs/{name}.json",
                           "reduced": ["n_el"], "why": "test"})
    man["workloads"].append({"name": name, "config": name,
                             "traffic": f"smooth4_{dim}d", "chips": 1,
                             "why": "test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "kron_pcg_p3_n512" in m.get("workloads", ()):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


@pytest.fixture(scope="module", params=[1, 2], ids=["1d", "2d"])
def dim_cell(request, tmp_path_factory):
    dim = request.param
    return dim, dim_root(tmp_path_factory.mktemp(f"dim{dim}"), dim)


def _run(dim_cell, seed, traced=False, control=False, hook=None):
    dim, root = dim_cell
    return harness.run(harness.manifest(root), TINY_DIM[dim][0], seed, 0.3,
                       traced, torch.device("cpu"), time.perf_counter(),
                       root=root, control=control, solve_hook=hook)


def test_a_tiny_cell_of_fewer_axes_is_correct(dim_cell):
    root = dim_cell[1]
    for path in (ROOT / "benchmark").rglob("*"):    # only files added
        rel = path.relative_to(ROOT)
        if path.is_file() and "tests" not in rel.parts \
                and "__pycache__" not in rel.parts:
            assert (root / rel).read_bytes() == path.read_bytes(), rel
    out = _run(dim_cell, 2 ** 31 + 99, traced=True)
    assert out["correct"] is True and out["failed"] == 0
    assert 0 < out["checks"]["true_residual_max"]["value"] <= 1e-10
    assert out["metrics"]["iterations"]["value"] > 0
    # each source the same iterations, within one, on another seed
    other = _run(dim_cell, 5)
    assert other["correct"] is True
    its = {}
    for out_, seed in ((out, 2 ** 31 + 99), (other, 5)):
        slots = rhs.draw(SOURCES[dim_cell[0]], seed, dim_cell[0])
        for k, counts in enumerate(out_["iterations_by_slot"]):
            its.setdefault(slots[k]["source"], []).extend(counts)
    assert all(max(v) - min(v) <= 1 for v in its.values())


def test_its_control_fails(dim_cell):
    """The program one precision lower (f32 throughout)."""
    out = _run(dim_cell, 5, control=True)
    assert out["correct"] is False
    assert out["checks"]["true_residual_max"]["value"] > 100 * 1e-10


def _drop_low_word(solver):
    """The timed solve's answer without the low word of its double-word
    solution: x = xh."""
    orig = solver.solve_compiled

    def solve_compiled(b, tol, maxiter, return_x):
        solver._x_interior = lambda state: state[0].to(torch.float64)
        return orig(b, tol=tol, maxiter=maxiter, return_x=return_x)
    solver.solve_compiled = solve_compiled


def test_a_dropped_low_word_fails(dim_cell):
    out = _run(dim_cell, 2 ** 31 + 7, hook=_drop_low_word)
    assert out["failed"] == 0            # its own residual still says 1e-10
    assert out["correct"] is False
    assert out["checks"]["true_residual_max"]["value"] > 10 * 1e-10


@pytest.mark.cuda
def test_a_2d_cell_on_the_card(tmp_path):
    """On the card at a test size: the 2D dw-PCG cell is correct, its
    control is not, and K1's and K5's shares of their 2D work lie in
    (0, 105]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = dim_root(tmp_path, 2)
    config = json.loads((root / "benchmark/configs/tiny_2d.json").read_text())
    config["problem"]["n_el"] = 256
    config["solver"]["levels"] = 4
    (root / "benchmark/configs/tiny_2d.json").write_text(json.dumps(config))
    dev = torch.device("cuda", 0)
    man = harness.manifest(root)
    good = harness.run(man, "tiny_2d", 5, 0.5, True, dev, time.perf_counter(),
                       root=root)
    bad = harness.run(man, "tiny_2d", 5, 0.5, False, dev,
                      time.perf_counter(), root=root, control=True)
    assert good["correct"] is True and bad["correct"] is False
    for name in ("kron_roofline", "dw_roofline", "idle_share"):
        assert 0 < good["metrics"][name]["value"] <= 105
