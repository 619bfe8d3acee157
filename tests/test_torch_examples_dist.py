"""The port's distributed examples on 2 gloo ranks against the JAX package's
``DistributedMG`` at the same rank grid, run here on the 8-device CPU mesh.

- ``distributed_2d`` (n_el = 32, p = 3, two levels, Jacobi ω = 0.8, mesh
  (2, 1)): the history of ``DistributedMG.solve`` against the JAX solver's
  at mesh (2, 1); the drift from the serial ``MultigridSolver`` the example
  prints.
- ``multihost_2d`` (mesh (1, 2), p = 2, Chebyshev(4)) and the V-cycle leg
  of ``multihost_3d`` (mesh (2, 1, 1)) stepped cycle by cycle against the
  JAX solvers' ``step`` from the same start, with the JAX solvers' λ
  estimates passed in; ``multihost_3d``'s W-cycle and FMG + V legs against
  the JAX package's serial ``MultigridSolver`` and the port's, stepped the
  same way with the same λ.
- ``multihost_2d`` in f32, the JAX example's precision on an accelerator,
  against the JAX ``DistributedMG`` in f32 with x64 off.

In f64 each entry lies within 1e-9 of the JAX solver's plus 1e-14·‖b‖ (the
f64 tolerance of ``tests/test_torch_dist_mg.py``; against a serial solver
that file's 1e-6 plus 1e-13).  In f32 the three cycles before the
stall lie within 1e-4 of the JAX solver's plus 1e-6·‖b‖ (f32 sums in another
order: the roundoff of b − A·x that both stall on), and both stall between
1e-6·‖b‖ and 1e-5·‖b‖.  The module's
top level imports no JAX: the spawned ranks import the examples, not this
file.
"""
import numpy as np
import pytest

F64_RTOL, F64_FLOOR = 1e-9, 1e-14


def _jax_dist(dim, n_el, degree, levels, mesh, cfg):
    from poms_tpu.models.poisson import poisson_problem
    from poms_tpu.parallel.dist import DistributedMG

    prob = poisson_problem(dim, n_el, degree=degree)
    return prob, DistributedMG(prob, num_levels=levels, mesh_shape=mesh,
                               cfg=cfg)


def _close(got, want, b_norm):
    assert len(got) == len(want), (got, want)
    np.testing.assert_allclose(got, want, rtol=F64_RTOL,
                               atol=F64_FLOOR * b_norm)


def _jax_steps(prob, mg, cycles, fmg=False):
    import jax.numpy as jnp

    b = mg._pad_global(prob.b.interior)
    start = None
    if fmg:
        x, rn = mg.fmg_step(b)
        start = float(rn)
    else:
        x = jnp.zeros_like(b)
    rns = []
    for _ in range(cycles):
        x, rn = mg.step(x, b)
        rns.append(float(rn))
    return start, rns


def test_distributed_2d_matches_jax():
    from poms_tpu.mg.cycles import CycleConfig
    from poms_tpu.mg.smoother import SmootherConfig
    from poms_tpu_torch.examples import distributed_2d

    lines = []
    got = distributed_2d.main(32, backend="gloo", ranks=2, device="cpu",
                              out=lines.append)
    assert got["mesh"] == [2, 1]
    prob, mg = _jax_dist(2, 32, 3, 2, (2, 1), CycleConfig(
        smoother=SmootherConfig(kind="jacobi", omega=0.8)))
    ref = mg.solve(tol=1e-10, maxiter=60)
    b_norm = float(prob.b.norm())
    assert got["iterations"] == ref.iterations and got["converged"]
    _close(got["residuals"], ref.residuals, b_norm)
    assert got["drift"] <= F64_FLOOR * b_norm + F64_RTOL * got["serial"][0]
    assert lines[0] == "ranks: 2 (gloo); mesh = (2, 1)"
    assert lines[-1].startswith("max |distributed - serial| residual drift")


def test_multihost_2d_matches_jax():
    from poms_tpu.mg.cycles import CycleConfig
    from poms_tpu.mg.smoother import SmootherConfig
    from poms_tpu_torch import convert
    from poms_tpu_torch.examples import multihost_2d

    mesh = multihost_2d.mesh_of(2)
    assert mesh == (1, 2)
    prob, mg = _jax_dist(2, (16, 32), 2, 2, mesh, CycleConfig(
        nu1=1, nu2=1, smoother=SmootherConfig("chebyshev",
                                              cheb_fraction=16.0)))
    _, want = _jax_steps(prob, mg, multihost_2d.CYCLES)
    lams = convert.dist_state(mg)["lams"]
    lines = []
    got = multihost_2d.main(backend="gloo", ranks=2, device="cpu",
                            lams=lams, out=lines.append)
    _close(got["residuals"], want, float(prob.b.norm()))
    assert got["ok"] and lines[-1] == "OK"


def _jax_serial_steps(prob, gamma, lams, cycles, use_fmg):
    """The JAX package's serial ``MultigridSolver`` at the examples' cycle
    (3 levels, Chebyshev(4) over [λmax/16, λmax], ν1 = ν2 = 1, γ), its
    cycle run with ``lams``: the FMG start's norm (or None) and the
    history, as the distributed legs step."""
    import jax
    import jax.numpy as jnp

    from poms_tpu.core.vector import StencilVector
    from poms_tpu.mg.cycles import CycleConfig, cycle, fmg
    from poms_tpu.mg.smoother import SmootherConfig
    from poms_tpu.mg.solver import MultigridSolver

    ser = MultigridSolver(prob, 3, CycleConfig(
        nu1=1, nu2=1, gamma=gamma,
        smoother=SmootherConfig("chebyshev", cheb_fraction=16.0)))
    cfg, A = ser.cfg, ser.levels[0].A

    @jax.jit
    def step(levels, x, b):
        x = cycle(levels, 0, x, b, cfg, lams)
        return x, (b - levels[0].A.dot(x)).norm()

    start = None
    if use_fmg:
        x = jax.jit(lambda lv, b: fmg(lv, b, cfg, lams=lams))(ser.levels,
                                                               prob.b)
        start = float((prob.b - A.dot(x)).norm())
    else:
        x = StencilVector.zeros(A.space)
    rns = []
    for _ in range(cycles):
        x, rn = step(ser.levels, x, prob.b)
        rns.append(float(rn))
    assert jnp.isfinite(x.interior).all()
    return start, rns


def test_multihost_3d_legs_match_jax():
    """The V-cycle leg against the JAX solver's steps; the W-cycle and
    FMG + V legs (whose JAX ``DistributedMG`` compiles take about 45 s each
    here) against the JAX package's serial ``MultigridSolver`` and the
    port's, each stepped the same way with the same λ (sharded ≡ serial:
    1e-6 of each entry plus 1e-13, the tolerance of
    ``tests/test_torch_dist_mg.py``'s serial check)."""
    from poms_tpu.mg.cycles import CycleConfig
    from poms_tpu.mg.smoother import SmootherConfig
    from poms_tpu_torch import convert
    from poms_tpu_torch.examples import multihost_3d
    from poms_tpu_torch.mg import cycles as port_cycles
    from poms_tpu_torch.mg.solver import MultigridSolver
    from poms_tpu_torch.models.poisson import poisson_problem

    mesh = multihost_3d.mesh_of(2)
    assert mesh == (2, 1, 1) and multihost_3d.mesh_of(8) == (2, 2, 2)
    legs = multihost_3d.legs_of(True, True)
    prob, mg = _jax_dist(3, (16, 8, 8), 2, 3, mesh, CycleConfig(
        nu1=1, nu2=1, smoother=SmootherConfig("chebyshev",
                                              cheb_fraction=16.0)))
    _, want_v = _jax_steps(prob, mg, legs[0][3])
    lams = convert.dist_state(mg)["lams"]   # the same for every leg
    b_norm = float(prob.b.norm())
    lines = []
    got = multihost_3d.main(True, True, backend="gloo", ranks=2,
                            device="cpu", out=lines.append,
                            lams={tag: lams for tag, *_ in legs})
    assert list(got["legs"]) == ["vcycle", "wcycle", "fmg+v"]
    _close(got["legs"]["vcycle"]["residuals"], want_v, b_norm)
    assert got["legs"]["vcycle"]["fmg_start"] is None
    pp = poisson_problem(3, (16, 8, 8), degree=2, device="cpu")
    for tag, gamma, use_fmg, cycles in legs[1:]:
        start, rns = _jax_serial_steps(prob, gamma, mg.lams, cycles,
                                       use_fmg)
        assert (got["legs"][tag]["fmg_start"] is None) == (start is None)
        if use_fmg:
            np.testing.assert_allclose(got["legs"][tag]["fmg_start"], start,
                                       rtol=1e-6, atol=1e-13)
        np.testing.assert_allclose(got["legs"][tag]["residuals"], rns,
                                   rtol=1e-6, atol=1e-13)
        ser = MultigridSolver(pp, 3, port_cycles.CycleConfig(
            nu1=1, nu2=1, gamma=gamma, smoother=convert.cycle_config(
                mg.cfg).smoother))
        ser.lams = lams
        if use_fmg:
            x = port_cycles.fmg(ser.levels, pp.b, ser.cfg, lams=lams)
            start = float(ser._residual_norm(x, pp.b))
            np.testing.assert_allclose(got["legs"][tag]["fmg_start"], start,
                                       rtol=1e-6, atol=1e-13)
        else:
            x = port_cycles.StencilVector.zeros(pp.space)
            assert got["legs"][tag]["fmg_start"] is None
        rns = []
        for _ in range(cycles):
            x, rn = ser._step(x, pp.b)
            rns.append(float(rn))
        np.testing.assert_allclose(got["legs"][tag]["residuals"], rns,
                                   rtol=1e-6, atol=1e-13)
    assert all(leg["ok"] for leg in got["legs"].values())
    assert got["all_ok"] and lines[-1] == "ALL LEGS OK"


def test_multihost_2d_f32_stalls_as_jax():
    """In f32 (the JAX example's precision on an accelerator) the port's
    multihost_2d stalls where the JAX example does: both reach 1e-6·‖b‖
    only short of it, from the same cycle on (x64 off on the JAX side, as
    on an accelerator)."""
    import jax
    import jax.numpy as jnp

    from poms_tpu.mg.cycles import CycleConfig
    from poms_tpu.mg.smoother import SmootherConfig
    from poms_tpu.models.poisson import poisson_problem
    from poms_tpu.parallel.dist import DistributedMG
    import torch

    from poms_tpu_torch import convert
    from poms_tpu_torch.examples import multihost_2d

    mesh = multihost_2d.mesh_of(2)
    with jax.enable_x64(False):
        prob = poisson_problem(2, (16, 32), degree=2, dtype=jnp.float32)
        mg = DistributedMG(prob, num_levels=2, mesh_shape=mesh,
                           cfg=CycleConfig(nu1=1, nu2=1,
                                           smoother=SmootherConfig(
                                               "chebyshev",
                                               cheb_fraction=16.0)))
        _, want = _jax_steps(prob, mg, multihost_2d.CYCLES)
        b_norm = float(jnp.linalg.norm(prob.b.interior))
        lams = convert.lams(mg.lams)
    lines = []
    got = multihost_2d.main("gloo", ranks=2, device="cpu", lams=lams,
                            dtype=torch.float32, out=lines.append)
    print("JAX f32 |r|:", " ".join(f"{r:.3e}" for r in want))
    print("port f32 |r|:", " ".join(f"{r:.3e}" for r in got["residuals"]))
    np.testing.assert_allclose(got["residuals"][:3], want[:3], rtol=1e-4,
                               atol=1e-6 * b_norm)
    for rns in (got["residuals"], want):
        assert all(1e-6 * b_norm < r < 1e-5 * b_norm for r in rns[3:]), rns
    assert not got["ok"] and lines[-1] == "NOT CONVERGED (increase cycles)"


def test_examples_need_a_named_backend():
    """Every entry that starts ranks takes the backend from its caller:
    none has a default, and only 'gloo' and 'nccl' are taken."""
    from poms_tpu_torch.bench import overlap_trace, scaling, scaling_model
    from poms_tpu_torch.examples import (distributed_2d, multihost_2d,
                                         multihost_3d)

    with pytest.raises(ValueError):
        distributed_2d.main(16, backend="mpi", ranks=2, device="cpu")
    for fn in (distributed_2d.main, multihost_2d.main, multihost_3d.main,
               scaling_model.census, scaling.run_weak_scaling,
               scaling.run_strong_scaling, overlap_trace.run_overlap_check,
               overlap_trace.run_overlap_ab):
        with pytest.raises(TypeError, match="backend"):
            fn(device="cpu")
