"""The port's examples (``poms_tpu_torch/examples/``) against the JAX
package's (``examples/``), on the CPU at small sizes.

- ``poisson_1d`` and ``poisson_2d`` at the JAX examples' default sizes: the
  JAX example's printed lines against the port's, line by line (the same
  text, each printed number within one unit of its last printed digit
  plus the histories' floor), and the histories
  of the same JAX calls to 1e-9 of each entry plus 1e-14·‖b‖ (the
  tolerance of ``tests/test_torch_banded_mg.py``).
- ``headline_solve`` (n_el = 8, two levels, ``pcg`` and ``dc``) and
  ``poisson_3d`` (n_el = 8, two levels) against the same JAX calls as the
  JAX examples make, with the JAX solvers' λ estimates passed in (the JAX
  package draws its power-iteration start vector from ``jax.random``): equal
  counts, the final ‖r‖ within 5e-2 of the reference's and the L2 errors
  within 1e-9 (``tests/test_torch_pcg.py``'s tolerances), the RB-GS leg's
  history to 1e-9 of each entry plus 1e-14·‖b‖.

The JAX double-word PCG runs under ``jax.disable_jit`` (XLA:CPU takes
longer to compile its graph than to run it eagerly); the defect correction
runs compiled.
"""
import contextlib
import importlib.util
import io
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from poms_tpu_torch import convert
from poms_tpu_torch.examples import (cli_device, dist_cli, headline_solve,
                                     int_args, poisson_1d, poisson_2d,
                                     poisson_3d)

torch.set_num_threads(1)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
N_EL = 8          # the double-word examples' size here: two levels


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_lines(name, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _jax_example(name).main(*args)
    return buf.getvalue().splitlines()


_NUM = re.compile(r"-?\d+\.(\d+)e[-+]\d+")


def _same_lines(got, want, floor):
    """The same text, and each printed number within one unit of its last
    printed digit plus ``floor`` (the histories' absolute floor)."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert _NUM.sub("#", g) == _NUM.sub("#", w), (g, w)
        for mg, mw in zip(_NUM.finditer(g), _NUM.finditer(w)):
            a, b = float(mg.group()), float(mw.group())
            assert abs(a - b) <= (1.01 * 10.0 ** -len(mw.group(1)) * abs(b)
                                  + floor), (g, w)


def _history_close(got, want, b_norm):
    assert len(got) == len(want), (len(got), len(want))
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) <= 1e-9 * b + 1e-14 * b_norm, (i, a, b)


def _jax_banded(dim, n_el, degree, levels, smoother, omega, **solve):
    from poms_tpu.mg.cycles import CycleConfig
    from poms_tpu.mg.smoother import SmootherConfig
    from poms_tpu.mg.solver import MultigridSolver
    from poms_tpu.models.poisson import poisson_problem

    prob = poisson_problem(dim, n_el, degree=degree)
    cfg = CycleConfig(**({"nu1": 2, "nu2": 2} if smoother == "rbgs" else {}),
                      smoother=SmootherConfig(kind=smoother, omega=omega))
    res = MultigridSolver(prob, num_levels=levels, cfg=cfg).solve(**solve)
    return prob, res


@pytest.mark.parametrize("name,dim,jax_args,port_args,count", [
    ("poisson_1d", 1, (), {}, 6),
    ("poisson_2d", 2, (), {}, 18),
])
def test_banded_examples_print_the_jax_lines(name, dim, jax_args, port_args,
                                             count):
    """The JAX example's stdout against the port example's lines, and the
    histories of the same calls; the counts of the JAX record (ROADMAP
    Q1.4): 1D in 6 cycles, 2D in 18."""
    want = _jax_lines(name, *jax_args)
    got = []
    mod = {"poisson_1d": poisson_1d, "poisson_2d": poisson_2d}[name]
    res = mod.main(device="cpu", out=got.append, **port_args)
    assert res["iterations"] == count and res["converged"]
    if dim == 1:
        prob, ref = _jax_banded(1, 64, 3, 2, "jacobi", 2 / 3, tol=1e-10,
                                maxiter=60)
    else:
        prob, ref = _jax_banded(2, 64, 3, 4, "jacobi", 0.8, tol=1e-10,
                                maxiter=100)
    b_norm = float(prob.b.norm())
    _history_close(res["residuals"], ref.residuals, b_norm)
    _same_lines(got, want, 1e-14 * b_norm)


@pytest.fixture(scope="module")
def jax_dw():
    """The JAX headline solves at n_el = 8 (the example's calls), their λ
    estimates, and their true residual and L2 errors."""
    import jax.numpy as jnp

    from poms_tpu.mg.cycles import CycleConfig
    from poms_tpu.mg.mixed import MGPreconditionedCG, MixedPrecisionMG
    from poms_tpu.mg.smoother import SmootherConfig, attach_spectral_estimates
    from poms_tpu.models.poisson import (l2_error_manufactured,
                                         poisson_problem)

    out = {}
    for solver in ("pcg", "dc"):
        # the PCG eagerly (its jit takes longer than its eager run), the
        # defect correction compiled (the other way round)
        with (jax.disable_jit() if solver == "pcg"
              else contextlib.nullcontext()):
            prob = poisson_problem(3, N_EL, degree=3, operator="kron",
                                   dtype=jnp.float64)
            cfg = CycleConfig(nu1=1, nu2=1, smoother=SmootherConfig(
                "chebyshev",
                cheb_fraction=16.0 if solver == "pcg" else 32.0))
            if solver == "pcg":
                mg = MGPreconditionedCG(prob, num_levels=2, cfg=cfg,
                                        mixed=True, operator="kron",
                                        precision="dw")
                lams = attach_spectral_estimates(mg.levels, cfg.smoother)
            else:
                mg = MixedPrecisionMG(prob, num_levels=2, cfg=cfg,
                                      operator="kron", residual="twofloat")
                lams = attach_spectral_estimates(mg.levels64, cfg.smoother)
            x, rn, it = mg.solve_compiled(tol=1e-10, maxiter=100)
            r = prob.b.interior - prob.A.dot(x).interior
            out[solver] = {
                "iterations": int(it), "rn": float(rn),
                "true_residual": float(jnp.linalg.norm(r)),
                "l2_error": l2_error_manufactured(prob, x),
                "l2_error_32": l2_error_manufactured(prob, x,
                                                     pts_per_dim=32),
                "lams": convert.lams(lams)}
    return out


@pytest.mark.parametrize("solver", ["pcg", "dc"])
def test_headline_solve_matches_jax(jax_dw, solver):
    want = jax_dw[solver]
    lines = []
    got = headline_solve.main(N_EL, 3, solver, device="cpu",
                              lams=want["lams"], out=lines.append)
    assert got["levels"] == 2
    assert got["iterations"] == want["iterations"], (got["iterations"],
                                                     want["iterations"])
    assert got["converged"] and got["rn"] <= 1e-10
    assert got["true_residual"] <= 5e-10
    assert abs(got["rn"] - want["rn"]) <= 5e-2 * want["rn"]
    assert abs(got["l2_error"] - want["l2_error"]) <= 1e-9
    assert lines[0] == (f"3D Poisson n_el={N_EL}^3 degree=3 levels=2 "
                        f"solver={solver}")
    assert lines[1].startswith(f"converged in {want['iterations']} "
                               "iterations, wall ")
    assert lines[2].startswith("‖r‖₂ = ") and "(true: " in lines[2]
    assert lines[3] == ("L2 error vs manufactured solution: "
                        f"{want['l2_error']:.3e}")
    assert set(got) >= {"setup_s", "cold_solve_s", "wall_s", "ms_per_iter"}


def test_poisson_3d_matches_jax(jax_dw):
    """The RB-GS leg's history against the JAX calls' (it stalls at
    ρ ≈ 0.95), then the dw-PCG leg against the JAX headline PCG at the
    same configuration (the example's)."""
    lines = []
    got = poisson_3d.main(N_EL, 3, 2, device="cpu",
                          pcg_lams=jax_dw["pcg"]["lams"],
                          log_stream=io.StringIO(), out=lines.append)
    prob, ref = _jax_banded(3, N_EL, 3, 2, "rbgs", 1.0, tol=1e-6,
                            maxiter=60)
    _history_close(got["rbgs"]["residuals"], ref.residuals,
                   float(prob.b.norm()))
    assert got["rbgs"]["iterations"] == ref.iterations == 60
    assert 0.9 < got["rbgs"]["rho_median"] < 0.97
    want = jax_dw["pcg"]
    assert got["pcg_iterations"] == want["iterations"] == 13
    assert got["converged"]
    assert abs(got["pcg_rn"] - want["rn"]) <= 5e-2 * want["rn"]
    assert abs(got["l2_error"] - want["l2_error_32"]) <= 1e-9
    assert lines[0] == (f"3D Poisson: n_el={N_EL}^3, degree=3, 2 levels, "
                        "RB-GS smoother")


def test_headline_levels_and_arguments():
    """The example's depth rule at the sizes the card runs (7 levels at
    512³), and the command-line helpers."""
    assert [headline_solve.num_levels(n) for n in (8, 64, 128, 256, 512)] \
        == [2, 4, 5, 6, 7]
    with pytest.raises(ValueError):
        headline_solve.build(8, 3, "cg", device="cpu")
    assert cli_device(["64", "--cpu"]) == "cpu"
    assert cli_device(["64"]) is None
    assert int_args(["512", "3", "pcg", "--cpu"]) == [512, 3, "pcg"]
    assert int_args(["--backend", "gloo", "32", "--ranks", "2"]) == [32]
    assert dist_cli(["--cpu"]) == ("gloo", 2, "cpu")
    assert dist_cli(["--backend", "nccl", "--ranks", "1"]) == ("nccl", 1,
                                                               None)
    with pytest.raises(SystemExit):
        dist_cli([])                  # the backend is the caller's to name
    with pytest.raises(SystemExit):
        dist_cli(["--cpu", "--backend", "nccl"])
