"""The periodic kind: the plain reference's circulant bands, loads and
operator (against the port's, imported by the test alone), and a tiny
periodic cell run through the harness on the CPU: correct, its control
failed, its iterations the same on every seed."""
import json
import math
import time

import numpy as np
import pytest
import torch

from h100bench_util import ROOT, reference_kind, tiny_root

from benchmark import harness
from benchmark.reference import periodic_bspline as pb
from benchmark.reference import rhs

PERIODIC = reference_kind("periodic")
CELL = "kron_pcg_periodic_p3_n512"
TINY_PERIODIC = "tiny_periodic"
SOURCES = json.loads((ROOT / "benchmark/traffic/periodic_smooth4.json")
                     .read_text())["sources"]


def _problem(n_el, degree, shift=1.0):
    return {"n_el": n_el, "degree": degree, "shift": shift}


# -- the reference ------------------------------------------------------------

@pytest.mark.parametrize("shift,p", [(1.0, 3), (0.5, 3), (1.0, 2)])
def test_operator_is_the_ports(shift, p):
    """16³: the reference's A·x is the port's periodic Kronecker-sum apply
    on seeded random x."""
    from poms_tpu_torch.core.vector import StencilVector
    from poms_tpu_torch.models.periodic import periodic_problem
    prob = periodic_problem(3, 16, degree=p, shift=shift, operator="kron",
                            device="cpu")
    g = torch.Generator().manual_seed(p)
    x = torch.randn(prob.space.shape, generator=g, dtype=torch.float64)
    ours = PERIODIC.operator(_problem(16, p, shift), "cpu").apply(x)
    theirs = prob.A.dot(StencilVector.from_interior(prob.space, x)).interior
    rel = float((ours - theirs).abs().max() / theirs.abs().max())
    assert rel <= 1e-12


@pytest.mark.parametrize("n_el,p", [(7, 1), (9, 2), (16, 3), (13, 5),
                                    (64, 3)])
def test_bands_are_circulant(n_el, p):
    """K and M symmetric and constant along every wrapped diagonal; the rows
    of M sum to h (the basis a partition of unity, each function of
    integral h), those of K to 0; nothing beyond the 2p+1 band."""
    K, M = pb.stiffness_mass(n_el, p)
    h = 1.0 / n_el
    for B in (K, M):
        scale = np.abs(B).max()
        assert np.abs(B - B.T).max() <= 1e-13 * scale
        shifted = np.roll(np.roll(B, 1, axis=0), 1, axis=1)
        assert np.abs(B - shifted).max() <= 1e-13 * scale
        off = (np.arange(n_el)[None, :] - np.arange(n_el)[:, None]) % n_el
        far = np.minimum(off, n_el - off) > p
        assert not B[far].any()
    assert np.abs(M.sum(axis=1) - h).max() <= 1e-15
    assert np.abs(K.sum(axis=1)).max() <= 1e-13 * np.abs(K).max()
    assert (np.diag(M) > 0).all() and (np.diag(K) > 0).all()


@pytest.mark.parametrize("n_el,p,mode", [(16, 3, 1), (12, 2, 3),
                                         (20, 5, 2)])
def test_load_is_an_independent_quadrature(n_el, p, mode):
    """∫ sin(2π·m·x) B_i(x) dx, B_i the cardinal B-spline on the knots
    i·h … (i+p+1)·h (SciPy's, not the reference's recursion), integrated
    over its support unwrapped (the sine is 1-periodic) by 24 Gauss points
    a span; and the mirror x → 1 − x maps B_i to B_(n−i−p−1) and the load
    to ``mirror_sign`` times itself."""
    from scipy.interpolate import BSpline
    h = 1.0 / n_el
    g, w = np.polynomial.legendre.leggauss(24)
    want = np.zeros(n_el)
    for i in range(n_el):
        B = BSpline.basis_element(h * np.arange(i, i + p + 2),
                                  extrapolate=False)
        for s in range(p + 1):
            a = h * (i + s)
            x = a + 0.5 * h * (g + 1.0)
            want[i] += 0.5 * h * np.sum(
                w * np.sin(2 * np.pi * mode * x) * np.nan_to_num(B(x)))
    got = pb.load(n_el, p, mode)
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    assert np.allclose(got, PERIODIC.load(_problem(n_el, p), mode),
                       rtol=0, atol=0)
    mirrored = got[(n_el - np.arange(n_el) - p - 1) % n_el]
    np.testing.assert_allclose(mirrored, PERIODIC.mirror_sign(mode) * got,
                               rtol=0, atol=1e-15)


def test_the_first_source_is_the_manufactured_one():
    """Every seed's slot of the first source is ± the load of
    (σ + 12π²)·sin(2πx)·sin(2πy)·sin(2πz), whose ‖·‖₂ is the kind's
    ``target_norm``; every slot is scaled to it."""
    pr = _problem(12, 3, shift=0.5)
    s = torch.as_tensor(pb.load(12, 3, 1))
    manufactured = (0.5 + 12 * math.pi ** 2) * (
        s[:, None, None] * s[None, :, None] * s[None, None, :])
    target = PERIODIC.target_norm(pr)
    assert float(torch.linalg.vector_norm(manufactured)) == \
        pytest.approx(target, rel=1e-14)
    for seed in (3, 2 ** 31 + 11):
        pool = rhs.pool(PERIODIC, pr, SOURCES, seed, "cpu")
        k = [d["source"] for d in rhs.draw(SOURCES, seed)].index(0)
        b = pool[k]
        assert torch.allclose(b.abs(), manufactured.abs(), rtol=1e-13,
                              atol=0)
        for x in pool:
            assert float(torch.linalg.vector_norm(x)) == \
                pytest.approx(target, rel=1e-13)


# -- a tiny periodic cell through the harness ---------------------------------

def periodic_root(tmp):
    """A checkout-shaped copy of the benchmark (``tiny_root``'s) with one
    more cell: the periodic configuration at 16³ elements, 2 levels."""
    root = tiny_root(tmp)
    config = json.loads(
        (ROOT / "benchmark/configs/periodic3d_kron_p3_n512.json").read_text())
    config["name"] = "tiny_periodic"
    config["problem"]["n_el"] = 16
    config["solver"]["levels"] = 2
    (root / "benchmark/configs/tiny_periodic.json").write_text(
        json.dumps(config))
    man = harness.manifest(root)
    man["configs"].append({"name": "tiny_periodic", "source": "test",
                           "file": "benchmark/configs/tiny_periodic.json",
                           "reduced": ["n_el"], "why": "test"})
    man["workloads"].append({"name": TINY_PERIODIC,
                             "config": "tiny_periodic",
                             "traffic": "periodic_smooth4", "chips": 1,
                             "why": "test"})
    # the tiny cell reports what the periodic cell reports
    for m in man["end_to_end"] + man["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY_PERIODIC)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


def _run(root, seed, control=False, seconds=1.5, traced=False):
    return harness.run(harness.manifest(root), TINY_PERIODIC, seed, seconds,
                       traced, torch.device("cpu"), time.perf_counter(),
                       root=root, control=control)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return periodic_root(tmp_path_factory.mktemp("periodic"))


@pytest.fixture(scope="module")
def first(root):
    return _run(root, 2 ** 31 + 99, traced=True)


def test_the_cell_is_the_periodic_kind(root):
    man = harness.manifest(root)
    config = harness.cell(man, CELL, root)[1]
    found = {k: m.__file__ for k, m in harness.kinds(config, root).items()}
    assert found == {
        "problem": str(root / "benchmark/problems/periodic.py"),
        "solver": str(root / "benchmark/solvers/pcg.py"),
        "reference": str(root / "benchmark/reference/kinds/periodic.py")}
    assert config["problem"]["operator"] == "kron"
    assert config["reduced"] == []


def test_a_tiny_periodic_cell_is_correct(first):
    assert first["correct"] is True and first["failed"] == 0
    assert 0 < first["checks"]["true_residual_max"]["value"] <= 1e-10
    assert first["attempted"] >= len(SOURCES)
    # traced: the per-layer metrics that the CPU can read
    assert first["metrics"]["iterations"]["value"] > 0


def test_the_control_fails(root):
    """The program one precision lower (f32 throughout) reaches 1e-10 by its
    own recurrence, and its solutions miss it by orders."""
    out = _run(root, 5, control=True, seconds=0.3)
    assert out["correct"] is False
    assert out["checks"]["true_residual_max"]["value"] > 100 * 1e-10


def _by_source(out, seed):
    slots = rhs.draw(SOURCES, seed)
    return {slots[k]["source"]: its
            for k, its in enumerate(out["iterations_by_slot"])}


def test_iterations_are_the_same_on_every_seed(root, first):
    """Each source takes the same iterations, within one, on two seeds (the
    operator commutes with the symmetries the seed draws)."""
    other = _run(root, 7)
    a, b = _by_source(first, 2 ** 31 + 99), _by_source(other, 7)
    for k in range(len(SOURCES)):
        assert a[k] and b[k], "every source solved at least once"
        assert max(a[k] + b[k]) - min(a[k] + b[k]) <= 1

