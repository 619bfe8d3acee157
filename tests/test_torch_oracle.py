"""The port's copy of the scipy/numpy multigrid oracle
(``poms_tpu_torch/oracle/mg_oracle.py``) against the JAX package's, each on
its own package's problem: the histories agree to roundoff (1e-12 of each
entry plus 1e-15·‖b‖: the two problems' operators are assembled by
different code to the same f64 values, and the oracle's arithmetic is the
same numpy/scipy in both), and the port's solvers agree with the port's
oracle as the JAX package's agree with its own (``tests/test_mg.py``).
"""
import numpy as np
import pytest
import torch

from poms_tpu.models.poisson import poisson_problem as ref_problem
from poms_tpu.oracle.mg_oracle import OracleMG as RefOracle
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.mg.solver import MultigridSolver
from poms_tpu_torch.models.poisson import poisson_problem
from poms_tpu_torch.oracle.mg_oracle import OracleMG

torch.set_num_threads(1)

CASES = {   # name: (dim, n_el, degree, levels, oracle keywords, solve kw)
    "jacobi-1d": (1, 64, 3, 2, dict(smoother="jacobi", omega=2 / 3), {}),
    "jacobi-2d-4lev": (2, 32, 3, 4, dict(smoother="jacobi", omega=0.8), {}),
    "rbgs-2d": (2, (12, 16), 2, 2, dict(smoother="rbgs", omega=1.0), {}),
    "chebyshev-2d": (2, 32, 3, 3, dict(smoother="chebyshev", nu1=1, nu2=1,
                                      cheb_fraction=16.0), {}),
    "wcycle-2d": (2, 16, 2, 3, dict(smoother="jacobi", omega=0.8, gamma=2),
                  {}),
    "fmg-2d": (2, 32, 2, 3, dict(smoother="jacobi", omega=0.8),
               dict(use_fmg=True)),
    "gs_lex-1d": (1, 32, 2, 2, dict(smoother="gs_lex", omega=1.0), {}),
    "rbgs-3d": (3, 8, 2, 2, dict(smoother="rbgs", omega=1.0), {}),
}


def _both(name):
    dim, n_el, p, levels, kw, solve = CASES[name]
    rp = ref_problem(dim, n_el, degree=p)
    pp = poisson_problem(dim, n_el, degree=p, device="cpu")
    ref = RefOracle(rp, num_levels=levels, **kw)
    port = OracleMG(pp, num_levels=levels, **kw)
    b = pp.b.interior.numpy().ravel()
    np.testing.assert_array_equal(b, np.asarray(rp.b.interior).ravel())
    solve = dict(tol=1e-10, maxiter=40, **solve)
    return pp, port, ref, b, port.solve(b, **solve), ref.solve(b, **solve)


@pytest.mark.parametrize("name", list(CASES))
def test_oracle_history_matches_jax_oracle(name):
    _, port, ref, b, (x, hist), (x_ref, hist_ref) = _both(name)
    b_norm = float(np.linalg.norm(b))
    assert len(hist) == len(hist_ref)
    np.testing.assert_allclose(hist, hist_ref, rtol=1e-12,
                               atol=1e-15 * b_norm)
    np.testing.assert_allclose(x, x_ref, rtol=0,
                               atol=1e-12 * np.abs(x_ref).max())
    for lev, lev_ref in zip(port.levels, ref.levels):
        assert lev.npts == lev_ref.npts
        assert abs(lev.A - lev_ref.A).max() <= 1e-13 * abs(lev_ref.A).max()
    if CASES[name][4]["smoother"] == "chebyshev":
        np.testing.assert_allclose(
            [lam for lam in port.lams if lam is not None],
            [lam for lam in ref.lams if lam is not None], rtol=1e-12)


@pytest.mark.parametrize("name", ["jacobi-1d", "rbgs-2d", "wcycle-2d"])
def test_port_solver_matches_port_oracle(name):
    """``MultigridSolver`` (banded, f64) against the port's oracle: each
    entry within 1e-6 plus 1e-13 (``tests/test_mg.py`` holds the JAX
    solvers to their oracle at 1e-4)."""
    dim, n_el, p, levels, kw, _ = CASES[name]
    pp, _, _, _, (_, hist), _ = _both(name)
    cfg = CycleConfig(nu1=kw.get("nu1", 2), nu2=kw.get("nu2", 2),
                      gamma=kw.get("gamma", 1),
                      smoother=SmootherConfig(kind=kw["smoother"],
                                              omega=kw["omega"]))
    res = MultigridSolver(pp, levels, cfg).solve(tol=1e-10, maxiter=40)
    assert res.iterations == len(hist) - 1
    np.testing.assert_allclose(res.residuals, hist, rtol=1e-6, atol=1e-13)


def test_oracle_imports_neither_torch_nor_jax():
    """The oracle's own module stands on numpy and scipy."""
    import ast
    import inspect

    from poms_tpu_torch.oracle import mg_oracle

    tree = ast.parse(inspect.getsource(mg_oracle))
    mods = {n.module if isinstance(n, ast.ImportFrom) else a.name
            for n in ast.walk(tree) if isinstance(n, (ast.Import,
                                                      ast.ImportFrom))
            for a in (n.names if isinstance(n, ast.Import) else [n])}
    assert not any(m.split(".")[0] in ("torch", "jax", "poms_tpu")
                   for m in mods), mods
