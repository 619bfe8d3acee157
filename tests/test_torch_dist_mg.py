"""Port parity: ``DistributedMG`` on the banded operator, on 4 gloo ranks.

Each case is one distributed solve of ``poms_tpu_torch`` (every rank runs
``bench/one_dist.py::solve_case``; the ranks are spawned once for the
module) beside the JAX package's ``DistributedMG`` at the same mesh and
configuration, run here on the 8-device CPU mesh of ``tests/conftest.py``.
The port takes the reference's λ estimates and resolved ω
(``convert.dist_state``), so the two differ only by rounding: the halo
messages are exact, the per-point arithmetic follows the reference's order,
and the norms are a local sum and one all_reduce, which may add in another
order than ``psum`` (4 ranks).  The port's distributed solves are also held
against the port's serial solvers (sharded ≡ serial), and the automatic
depth against the reference's, in this process.  This module's top level
imports no JAX: the spawned ranks import it to find their worker.
"""
import numpy as np
import pytest

WORLD = 4
# name: the spec of one solve (problem, cycle, solver options)
CASES = {
    "jacobi-1d-p3": dict(dim=1, n_el=64, degree=3, levels=2, mesh=(4,),
                         cfg=dict(kind="jacobi", omega=2 / 3), tol=1e-10,
                         maxiter=60, compiled=True),
    "rbgs-2d-p3": dict(dim=2, n_el=16, degree=3, levels=2, mesh=(2, 2),
                       cfg=dict(kind="rbgs", omega=1.0), tol=1e-10,
                       maxiter=60, compiled=True),
    "jacobi-3d-3lev": dict(dim=3, n_el=8, degree=2, levels=3,
                           mesh=(2, 2, 1), cfg=dict(kind="jacobi",
                                                    omega=0.7),
                           tol=1e-8, maxiter=60),
    "transfers-1d": dict(dim=1, n_el=128, degree=2, levels=3, mesh=(4,),
                         cfg=dict(kind="jacobi", omega=0.7), tol=1e-9),
    "transfers-2d-rbgs": dict(dim=2, n_el=32, degree=2, levels=3,
                              mesh=(2, 2), cfg=dict(kind="rbgs", omega=1.0),
                              tol=1e-9, maxiter=60),
    "cheb-wcycle": dict(dim=2, n_el=32, degree=3, levels=3, mesh=(2, 2),
                        cfg=dict(kind="chebyshev", cheb_fraction=16.0,
                                 nu1=1, nu2=1, gamma=2), tol=1e-9,
                        maxiter=40),
    "mixed-jacobi": dict(dim=2, n_el=32, degree=2, levels=3, mesh=(2, 2),
                         cfg=dict(kind="jacobi", omega=0.7), tol=1e-10,
                         maxiter=80, options=dict(mixed=True,
                                                  overlap=False)),
    "mixed-rbgs-3d": dict(dim=3, n_el=8, degree=2, levels=2,
                          mesh=(2, 2, 1), cfg=dict(kind="rbgs", omega=1.0),
                          tol=1e-10, maxiter=80,
                          options=dict(mixed=True, overlap=False)),
    "periodic": dict(problem="periodic", dim=2, n_el=16, degree=2, levels=2,
                     mesh=(2, 2), cfg=dict(kind="jacobi", omega=0.8, nu1=1,
                                           nu2=1), tol=1e-10, maxiter=60),
    "fmg": dict(dim=2, n_el=32, degree=2, levels=3, mesh=(2, 2),
                cfg=dict(kind="jacobi", omega=0.8, nu1=1, nu2=1), tol=1e-10,
                maxiter=40, use_fmg=True),
}
# the same solves again in the port only, with the other overlap form
PLAIN_TWINS = {"cheb-wcycle": dict(overlap=False),
               "mixed-jacobi": dict(overlap=True)}


def _mg_case(spec):
    from poms_tpu_torch.bench.one_dist import solve_case

    return solve_case(spec)


def _worker(cases):
    """On every rank: each case's solve."""
    return {name: _mg_case(spec) for name, _, spec in cases}


# -- the pytest process ------------------------------------------------------
def jax_setup(spec):
    """The JAX package's DistributedMG for a spec (built, not solved) and
    what the port takes from it."""
    from poms_tpu.mg.cycles import CycleConfig
    from poms_tpu.mg.smoother import SmootherConfig
    from poms_tpu.models.periodic import periodic_problem
    from poms_tpu.models.poisson import poisson_problem
    from poms_tpu.parallel.dist import DistributedMG
    from poms_tpu_torch import convert

    op = spec.get("operator", "banded")
    if spec.get("problem") == "periodic":
        prob = periodic_problem(spec["dim"], spec["n_el"], spec["degree"],
                                shift=1.0)
    else:
        prob = poisson_problem(spec["dim"], spec["n_el"],
                               degree=spec["degree"], operator=op)
    c = spec["cfg"]
    cfg = CycleConfig(nu1=c.get("nu1", 2), nu2=c.get("nu2", 2),
                      gamma=c.get("gamma", 1),
                      smoother=SmootherConfig(
                          kind=c["kind"], omega=c.get("omega"),
                          cheb_fraction=c.get("cheb_fraction", 4.0)))
    mg = DistributedMG(prob, spec["levels"], spec["mesh"], cfg,
                       operator=op, **spec.get("options", {}))
    return prob, mg, convert.dist_state(mg)


def jax_solve(prob, mg, spec):
    res = mg.solve(tol=spec.get("tol", 1e-10), maxiter=spec.get("maxiter",
                                                                 50),
                   use_fmg=spec.get("use_fmg", False))
    r = prob.b - prob.A.dot(res.x)
    return {"iterations": res.iterations, "converged": res.converged,
            "residuals": np.asarray(res.residuals),
            "x": np.asarray(res.x.interior), "true_residual": float(r.norm())}


def run_cases(cases, worker, twins=None, extra=()):
    """Set up the JAX side, start the port's ranks on every case (with the
    reference's λ and ω; ``extra``: more (name, function, arguments) cases
    for the worker), solve the JAX side meanwhile, and return (port results
    per rank, JAX results, JAX states)."""
    from poms_tpu_torch.parallel.launch import start

    jax_side, states, port_cases = {}, {}, list(extra)
    for name, spec in cases.items():
        prob, mg, state = jax_setup(spec)
        states[name] = state
        jax_side[name] = (prob, mg)
        port = dict(spec, lams=state["lams"], device="cpu")
        port["cfg"] = dict(spec["cfg"], omega=state["cfg"].smoother.omega)
        port_cases.append((name, "solve", port))
        if twins and name in twins:
            port_cases.append((name + "-twin", "solve", dict(
                port, options=dict(port.get("options", {}),
                                   **twins[name]))))
    job = start(worker, WORLD, "gloo", args=(port_cases,),
                timeout=900)
    ref = {name: jax_solve(prob, mg, cases[name])
           for name, (prob, mg) in jax_side.items()}
    return job.results(), ref, states


@pytest.fixture(scope="module")
def run():
    return run_cases(CASES, _worker, PLAIN_TWINS)


def check_history(got, want, rtol, floor=0.0):
    """Same count; each entry within ``rtol`` of the reference's plus
    ``floor`` times ‖b‖."""
    assert got["iterations"] == want["iterations"]
    assert got["converged"] == want["converged"]
    np.testing.assert_allclose(got["residuals"], want["residuals"],
                               rtol=rtol, atol=floor * got["b_norm"])


# f64 cycles: 1e-9 of each entry, plus 1e-14·‖b‖.  The reference's XLA
# program and the port's PyTorch ops round some of the same expressions
# apart (XLA's fused loops, the norms' order of addition), so the iterates
# differ by ~1e-16·‖b‖; an entry near 1e-10 carries that as an
# absolute error of its own, far above 1e-9 of it
F64_RTOL, F64_FLOOR = 1e-9, 1e-14
# f32 cycles (mixed=True): past the first correction each f64 entry carries
# the f32 cycles' rounding, which XLA and PyTorch (and the overlap and plain
# forms) make differently, and which every correction adds to the next
# entry.  Per case: the same count and each entry within a tolerance just
# above the largest relative difference read here (a 4-rank run on the CPU):
# mixed-jacobi 6.27e-2 (it grows by ~0.8% a correction from 7.6e-3 at entry
# 2 to entry 8, the last), its overlap twin against the plain form 1.05e-2,
# mixed-rbgs-3d 4.1e-7
MIXED_RTOL = {"mixed-jacobi": 0.08, "mixed-jacobi-twin": 0.02,
              "mixed-rbgs-3d": 1e-6}


@pytest.mark.parametrize("name", list(CASES))
def test_dist_history_matches_jax(run, name):
    """Iteration count and residual history of every case against the JAX
    package's DistributedMG; every rank has the same history."""
    results, ref, states = run
    got = results[0][name]
    assert got["L_dist"] == states[name]["L_dist"]
    mixed = CASES[name].get("options", {}).get("mixed", False)
    if mixed:
        check_history(got, ref[name], MIXED_RTOL[name])
    else:
        check_history(got, ref[name], F64_RTOL, F64_FLOOR)
    for r in range(1, WORLD):
        assert results[r][name]["residuals"] == got["residuals"]


@pytest.mark.parametrize("name", list(CASES))
def test_dist_solution_matches_jax(run, name):
    """The gathered iterate against the reference's, and its true f64
    residual."""
    results, ref, _ = run
    got, want = results[0][name], ref[name]
    scale = np.abs(want["x"]).max()
    mixed = CASES[name].get("options", {}).get("mixed", False)
    np.testing.assert_allclose(got["x"], want["x"], rtol=0,
                               atol=(1e-8 if mixed else 1e-11) * scale)
    if got["converged"]:
        assert got["true_residual"] <= 2 * CASES[name].get("tol", 1e-10)


@pytest.mark.parametrize("name", list(PLAIN_TWINS))
def test_overlap_form_matches_plain(run, name):
    """The overlap form of dist_spmv (interior with zero ghosts, then the
    faces) against the plain exchanged SpMV: the same count, histories to
    f64 roundoff (f32 cycles: the f32 sums reorder)."""
    results, _, _ = run
    a, b = results[0][name], results[0][name + "-twin"]
    mixed = CASES[name].get("options", {}).get("mixed", False)
    if mixed:
        check_history(b, a, MIXED_RTOL[name + "-twin"])
    else:
        check_history(b, a, F64_RTOL, F64_FLOOR)


@pytest.mark.parametrize("name", ["jacobi-1d-p3", "rbgs-2d-p3"])
def test_solve_compiled_matches_solve(run, name):
    """solve_compiled (the eager loop on CPU tensors) ≡ solve: the same
    count and the same bits."""
    results, _, _ = run
    got = results[0][name]
    assert got["compiled"]["iterations"] == got["iterations"]
    assert got["compiled"]["same_bits"]


SERIAL = ["jacobi-1d-p3", "rbgs-2d-p3", "jacobi-3d-3lev", "transfers-1d",
          "transfers-2d-rbgs", "mixed-jacobi", "periodic", "fmg"]


@pytest.mark.parametrize("name", SERIAL)
def test_sharded_matches_serial_port(run, name):
    """The port's DistributedMG ≡ the port's serial MultigridSolver (or
    MixedPrecisionMG) on the same problem, with the same ω: the same count,
    histories to roundoff (f32-cycle level with mixed=True)."""
    import torch

    from poms_tpu_torch.bench.one_dist import make_cycle, make_problem
    from poms_tpu_torch.mg.mixed import MixedPrecisionMG
    from poms_tpu_torch.mg.solver import MultigridSolver

    results, _, states = run
    spec = CASES[name]
    got = results[0][name]
    prob = make_problem(spec, "cpu")
    cfg = make_cycle(dict(spec["cfg"],
                          omega=states[name]["cfg"].smoother.omega))
    mixed = spec.get("options", {}).get("mixed", False)
    if mixed:
        ser = MixedPrecisionMG(prob, spec["levels"], cfg)
    else:
        ser = MultigridSolver(prob, spec["levels"], cfg)
    ser.lams = tuple(got["lams"])
    res = ser.solve(tol=spec.get("tol", 1e-10),
                    maxiter=spec.get("maxiter", 50),
                    use_fmg=spec.get("use_fmg", False)) if not mixed else \
        ser.solve(tol=spec["tol"], maxiter=spec["maxiter"])
    assert res.iterations == got["iterations"]
    np.testing.assert_allclose(got["residuals"], res.residuals,
                               rtol=2e-4 if mixed else 1e-6, atol=1e-13)
    x = res.x.interior.to(torch.float64).numpy()
    np.testing.assert_allclose(got["x"], x, rtol=0,
                               atol=1e-8 * np.abs(x).max())


# -- the automatic depth, in this process (host arithmetic only) -------------
@pytest.mark.parametrize("n_el,mesh_shape,expect", [
    (32, (8,), 1),
    (32, (4,), 2),
    (32, (2,), 3),
    (40, (4,), 2),
])
def test_auto_depth_matches_jax(n_el, mesh_shape, expect):
    """1D p2, 4 levels: the port's dist_depth gives the reference's
    L_dist (tests/test_dist.py's hand-derived depths) and its Ns."""
    from poms_tpu.models.poisson import poisson_problem
    from poms_tpu.parallel.dist import DistributedMG
    from poms_tpu_torch.parallel.dist import dist_depth

    ref = DistributedMG(poisson_problem(1, n_el, degree=2), num_levels=4,
                        mesh_shape=mesh_shape)
    npts = [(n_el // (1 << l) + 2 - 2,) for l in range(4)]
    L, Ns = dist_depth(npts, mesh_shape, 2)
    assert L == ref.L_dist == expect
    assert Ns[0] == tuple(ref.N)
    assert all(N[0] % mesh_shape[0] == 0 for N in Ns)


def test_explicit_depth_is_clamped_by_guard():
    from poms_tpu_torch.parallel.dist import dist_depth

    npts = [(32 // (1 << l),) for l in range(4)]
    assert dist_depth(npts, (8,), 2, dist_levels=3)[0] == 1
    assert dist_depth(npts, (2,), 2, dist_levels=2)[0] == 2


def test_depth_of_the_chip_configuration():
    """3D p3 n_el 128, 5 levels, mesh (2, 1, 1): 4 distributed levels on
    grids padded to N_l = 2 N_{l+1} (the chip check's configuration)."""
    from poms_tpu_torch.parallel.dist import dist_depth

    npts = [(128 // (1 << l) + 1,) * 3 for l in range(5)]
    L, Ns = dist_depth(npts, (2, 1, 1), 3)
    assert L == 4
    assert Ns == [(144, 136, 136), (72, 68, 68), (36, 34, 34), (18, 17, 17)]


def test_dist_rejects_gs_lex():
    from poms_tpu_torch.mg.cycles import CycleConfig
    from poms_tpu_torch.mg.smoother import SmootherConfig
    from poms_tpu_torch.models.poisson import poisson_problem
    from poms_tpu_torch.parallel.dist import DistributedMG

    prob = poisson_problem(1, 16, degree=2, device="cpu")
    with pytest.raises(ValueError, match="not distributed"):
        DistributedMG(prob, num_levels=2, mesh_shape=(4,),
                      cfg=CycleConfig(smoother=SmootherConfig("gs_lex")))


def test_dist_needs_a_process_group():
    from poms_tpu_torch.models.poisson import poisson_problem
    from poms_tpu_torch.parallel.dist import DistributedMG

    prob = poisson_problem(1, 16, degree=2, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        DistributedMG(prob, num_levels=2, mesh_shape=(4,))


def test_pad_band_identity_block_matches_global():
    """A rank's block of the identity-padded band, made on its own, equals
    the block of the padded global band (the reference's
    _pad_band_identity), bit for bit."""
    import torch

    from poms_tpu.parallel.dist import _pad_band_identity as jax_pad
    from poms_tpu_torch.parallel.dist import _pad_band_identity

    band = np.random.default_rng(2).standard_normal((5, 3, 7, 4))
    npts, N, pads = (7, 4), (10, 6), (2, 1)
    full = jax_pad(band, npts, N, pads)
    np.testing.assert_array_equal(
        _pad_band_identity(torch.as_tensor(band), npts, N, pads).numpy(),
        full)
    for starts in ((0, 0), (5, 3), (5, 0)):
        blk = _pad_band_identity(torch.as_tensor(band), npts, N, pads,
                                 starts, (5, 3))
        np.testing.assert_array_equal(
            blk.numpy(), full[:, :, starts[0]:starts[0] + 5,
                              starts[1]:starts[1] + 3])


# -- the multichip record's configuration, 8 ranks (slow) --------------------
DRYRUN = dict(dim=3, n_el=16, degree=2, levels=3, mesh=(2, 2, 2),
              cfg=dict(kind="rbgs", omega=1.0), tol=1e-10, maxiter=100,
              return_x=False)
DRYRUN_CASES = {
    "banded-mixed": dict(DRYRUN, options=dict(mixed=True)),
    "kron-twofloat": dict(DRYRUN, operator="kron",
                          options=dict(mixed=True,
                                       mixed_residual="twofloat")),
}


@pytest.mark.slow
@pytest.mark.parametrize("name", list(DRYRUN_CASES))
def test_dryrun_multichip_on_8_ranks(name):
    """``__graft_entry__.py::dryrun_multichip``'s solves on 8 gloo ranks,
    mesh (2, 2, 2): 16³ elements, p2, 3 levels, RB-GS ω = 1, ν = 2, banded
    ``mixed=True`` and kron twofloat, beside the JAX package's on the
    8-device CPU mesh.  Each converges to 1e-10 with a true residual ≤ 2e-10
    and ≥ 2 distributed levels, in the reference's count of cycles (the
    multichip record, MULTICHIP_r05.json: 42 for kron + twofloat).  Slow:
    8 processes on a shared machine, and about a minute of the reference's
    XLA compilation."""
    from poms_tpu_torch.parallel.launch import start

    spec = DRYRUN_CASES[name]
    prob, mg, state = jax_setup(spec)
    job = start(_worker, 8, "gloo",
                args=([(name, "solve", dict(spec, device="cpu"))],),
                timeout=1800)
    ref = jax_solve(prob, mg, spec)
    results = job.results()
    got = results[0][name]
    assert got["converged"] and ref["converged"]
    assert got["true_residual"] <= 2e-10
    assert got["L_dist"] == state["L_dist"] >= 2
    assert got["iterations"] == ref["iterations"]
    if name == "kron-twofloat":
        assert got["iterations"] == 42
    for r in range(1, 8):
        assert results[r][name]["residuals"] == got["residuals"]
