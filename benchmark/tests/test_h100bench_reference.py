"""The plain reference: its operator is the port's, at small sizes on the
CPU (the port is imported here, by the test alone), and the right-hand sides
change their numbers and not their work with the seed."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from h100bench_util import ROOT, reference_kind

from benchmark.reference import bspline, rhs
from benchmark.reference.operator import KronSum

POISSON = reference_kind()

SOURCES = __import__("json").loads(
    (ROOT / "benchmark/traffic/smooth4.json").read_text())["sources"]


@pytest.mark.parametrize("n_el,p", [(6, 1), (7, 2), (8, 3), (12, 5), (9, 8)])
def test_1d_bands_are_the_ports(n_el, p):
    from poms_tpu_torch.models.bspline import (assemble_spline_1d,
                                               sin_moment_1d)
    s = assemble_spline_1d(n_el, p)
    K, M = bspline.stiffness_mass(n_el, p)
    for dense, band in ((K, s.K), (M, s.M)):
        for i in range(s.n):
            for o in range(2 * p + 1):
                j = i + o - p
                if 0 <= j < s.n:
                    assert dense[i, j] == pytest.approx(band[i, o], abs=1e-13)
    # both integrate a sine by Gauss points, the port with p+3 an element,
    # the reference with p+6: at p = 1 they part at 1e-11
    assert np.allclose(bspline.load(n_el, p, 1), sin_moment_1d(s, 1),
                       rtol=0, atol=1e-10)


@pytest.mark.parametrize("operator", ["kron", "banded"])
@pytest.mark.parametrize("n_el,p", [(8, 3), (10, 2), (12, 5)])
def test_operator_is_the_ports(operator, n_el, p):
    from poms_tpu_torch.core.vector import StencilVector
    from poms_tpu_torch.models.poisson import poisson_problem
    prob = poisson_problem(3, n_el, degree=p, operator=operator,
                           device="cpu")
    g = torch.Generator().manual_seed(n_el)
    x = torch.randn(prob.space.shape, generator=g, dtype=torch.float64)
    ours = KronSum(n_el, p, "cpu").apply(x)
    theirs = prob.A.dot(StencilVector.from_interior(prob.space, x)).interior
    assert torch.allclose(ours, theirs, rtol=1e-12, atol=1e-12)


def _problem(n_el, degree):
    return {"n_el": n_el, "degree": degree}


def test_rhs_is_made_from_the_seed():
    pr = _problem(8, 3)
    a = rhs.pool(POISSON, pr, SOURCES, 2 ** 33 + 7, "cpu")
    b = rhs.pool(POISSON, pr, SOURCES, 2 ** 33 + 7, "cpu")
    c = rhs.pool(POISSON, pr, SOURCES, 11, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert any(not torch.equal(x, y) for x, y in zip(a, c))
    target = 3 * np.pi ** 2 * np.linalg.norm(bspline.load(8, 3, 1)) ** 3
    for x in a + c:
        assert float(torch.linalg.vector_norm(x)) == pytest.approx(target)
    assert torch.equal(rhs.one(POISSON, pr, SOURCES, 11, 2, "cpu"), c[2])


def test_every_seed_takes_every_source_under_a_symmetry():
    """The slots of any seed are the sources mapped by symmetries of the
    cube, so a solver's work does not depend on the seed."""
    def canon(t):
        t = t.abs()
        cands = []
        for perm in ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
                     (2, 1, 0)):
            u = t.permute(perm)
            for flips in range(8):
                dims = [d for d in range(3) if flips >> d & 1]
                cands.append(tuple(u.flip(dims).reshape(-1)[:64].tolist()))
        return min(cands)
    pr = _problem(6, 2)
    ref = sorted(canon(x) for x in rhs.pool(POISSON, pr, SOURCES, 1, "cpu"))
    for seed in (2, 3, 2 ** 31 + 5):
        got = sorted(canon(x)
                     for x in rhs.pool(POISSON, pr, SOURCES, seed, "cpu"))
        assert np.allclose(np.array(got), np.array(ref), rtol=1e-12,
                           atol=1e-15)


def test_the_reference_loads_nothing_of_the_program():
    """The reference's modules and every reference kind, each kind loaded
    from its file as the harness loads it."""
    code = ("import sys, importlib.util, pathlib; sys.path.insert(0, %r); "
            "import benchmark.reference.check, benchmark.reference.rhs; "
            "kinds = pathlib.Path(%r).glob('*.py'); "
            "specs = [importlib.util.spec_from_file_location(p.stem, p) "
            "for p in kinds]; "
            "[s.loader.exec_module(importlib.util.module_from_spec(s)) "
            "for s in specs]; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'poms_tpu', 'poms_tpu_torch'}; "
            "print(len(specs), sorted(bad))"
            % (str(ROOT), str(ROOT / "benchmark/reference/kinds")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out.endswith(" []") and int(out.split()[0]) >= 1
