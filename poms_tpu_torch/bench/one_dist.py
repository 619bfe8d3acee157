"""One distributed solve (``parallel/dist.py::DistributedMG``), reported.

:func:`solve_case` is what every rank of a distributed run calls on the same
spec (``parallel/launch.py`` spawns them): the tests on the CPU
(``device="cpu"``) and ``chip_smoke.py`` phase 18 on the card.  It returns
the count, the history, the true f64 residual, ms a cycle (with and without
the overlap form on request), the halo bytes staged through host memory a
cycle, the rank's kernel launches and, on the card, its device memory.
"""
import gc
import os
import time

import torch

__all__ = ["solve_case", "make_problem", "make_cycle"]


def make_problem(spec: dict, device):
    """The spec's problem: ``problem`` is ``poisson`` (Dirichlet, the
    manufactured right-hand side) or ``periodic`` (shift σ, seeded white
    noise)."""
    from poms_tpu_torch.models.periodic import periodic_problem
    from poms_tpu_torch.models.poisson import poisson_problem

    if spec.get("problem", "poisson") == "periodic":
        return periodic_problem(spec["dim"], spec["n_el"], spec["degree"],
                                shift=spec.get("shift", 1.0),
                                device=device)
    return poisson_problem(spec["dim"], spec["n_el"], degree=spec["degree"],
                           operator=spec.get("operator", "banded"),
                           device=device)


def make_cycle(c: dict):
    from poms_tpu_torch.mg.cycles import CycleConfig
    from poms_tpu_torch.mg.smoother import SmootherConfig

    sm = SmootherConfig(kind=c["kind"], omega=c.get("omega"),
                        cheb_degree=c.get("cheb_degree", 4),
                        cheb_fraction=c.get("cheb_fraction", 4.0))
    return CycleConfig(nu1=c.get("nu1", 2), nu2=c.get("nu2", 2),
                       gamma=c.get("gamma", 1), smoother=sm)


def solve_case(spec: dict, check=None) -> dict:
    """Build the spec's problem and ``DistributedMG`` on this rank, drop
    the problem (the solver keeps the rank's blocks), solve, and report (the
    same on every rank but ``launches``, ``staged_bytes``, the memory and
    ``check``, which are the rank's own).  ``true_residual`` is
    :meth:`DistributedMG.residual_norm` of the iterate; ``check``, a
    function of the solved ``DistributedMG`` called after the launches are
    read (its launches are not reported), gives ``out["check"]``.

    Keys of ``spec``: the problem's (:func:`make_problem`), ``levels``,
    ``mesh``, ``cfg`` (``kind``, ``omega``, ``nu1``, ``nu2``, ``gamma``,
    ``cheb_degree``, ``cheb_fraction``), ``options`` (DistributedMG's
    keywords), ``lams`` (λ estimates to use instead of the rank's own),
    ``tol``, ``maxiter``, ``use_fmg``, ``device`` (default ``"cuda"``:
    this process's current card; ``"cpu"``), ``engine`` (``"v2"``: K3),
    ``compiled``
    (also run ``solve_compiled``, twice: the second is timed),
    ``return_x`` (the global iterate),
    ``time_cycles`` (time that many more cycles with and without
    ``overlap``)."""
    from poms_tpu_torch.ops import counters
    from poms_tpu_torch.parallel.dist import DistributedMG

    if spec.get("engine") == "v2":
        os.environ["POMS_TPU_SPMV"] = "v2"
    else:
        os.environ.pop("POMS_TPU_SPMV", None)
    device = torch.device(spec.get("device", "cuda"))
    cuda = device.type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: solve_case runs on the card "
                               "unless the spec says device='cpu'")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    prob = make_problem(spec, device)
    mg = DistributedMG(prob, spec["levels"], spec["mesh"],
                       make_cycle(spec["cfg"]),
                       operator=spec.get("operator", "banded"),
                       **spec.get("options", {}))
    if spec.get("lams") is not None:
        mg.lams = tuple(spec["lams"])
    b_norm = float(prob.b.norm())
    del prob
    gc.collect()
    out = {"L_dist": mg.L_dist, "N": list(mg.N), "lams": list(mg.lams),
           "b_norm": b_norm, "omega": mg.cfg.smoother.omega}
    if cuda:
        torch.cuda.synchronize()
        out["peak_setup_bytes"] = torch.cuda.max_memory_allocated(device)
        out["held_bytes"] = torch.cuda.memory_allocated(device)
    out["setup_s"] = time.perf_counter() - t0
    counters.reset()
    mg.grid.staged_bytes = 0
    t0 = time.perf_counter()
    res = mg.solve(tol=spec.get("tol", 1e-10),
                   maxiter=spec.get("maxiter", 50),
                   use_fmg=spec.get("use_fmg", False))
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cycles = max(res.iterations, 1)
    out.update(iterations=res.iterations, converged=res.converged,
               residuals=list(res.residuals), solve_s=wall,
               ms_per_cycle=1e3 * wall / cycles,
               staged_bytes_per_cycle=mg.grid.staged_bytes / cycles)
    if spec.get("compiled"):
        kw = dict(tol=spec.get("tol", 1e-10), maxiter=spec.get("maxiter", 50))
        x_c, rn_c, it_c = mg.solve_compiled(**kw)
        out["compiled"] = {"iterations": it_c, "rn": float(rn_c),
                           "same_bits": bool(torch.equal(x_c, res.x))}
        t0 = time.perf_counter()   # again, the step captured: replays only
        mg.solve_compiled(**kw)
        if cuda:
            torch.cuda.synchronize()
        out["compiled"]["ms_per_cycle"] = \
            1e3 * (time.perf_counter() - t0) / max(it_c, 1)
    if spec.get("time_cycles"):
        out["timed"] = _time_cycles(mg, spec["time_cycles"], cuda)
    # the launches of the solves and timed cycles, not of the checks below
    out["launches"] = {k: v for k, v in counters.snapshot().items() if v}
    if cuda:
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    out["true_residual"] = mg.residual_norm(res.x)
    if check is not None:
        out["check"] = check(mg)
    if spec.get("return_x", True):
        out["x"] = mg.gather(res.x).cpu().numpy()
    return out


def _time_cycles(mg, n: int, cuda: bool) -> dict:
    """ms per cycle over ``n`` cycles from x = 0, with ``overlap`` as built
    and flipped (the flag is read at every apply)."""
    state, consts, step, _ = mg._start(mg.b)
    times = {}
    for overlap in (mg.overlap, not mg.overlap):
        mg.overlap = overlap
        st = list(state)
        step(*st, *consts)   # warm: faces, plans, buffers
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            *st, rn = step(*st, *consts)
        float(rn)
        times["overlap" if overlap else "plain"] = \
            1e3 * (time.perf_counter() - t0) / n
    mg.overlap = not mg.overlap
    return times
