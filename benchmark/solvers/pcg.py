"""Solver kind ``pcg``: the port's MG-preconditioned CG
(``mg/mixed.py::MGPreconditionedCG``) with one V-cycle a step, in the
precision and with the cycle that the configuration's ``solver`` entry
names."""
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.mixed import MGPreconditionedCG
from poms_tpu_torch.mg.smoother import SmootherConfig


def make(prob, solver: dict, problem: dict, dtypes: dict):
    """The solver of ``prob``; ``dtypes`` maps the configuration's dtype
    names to torch dtypes."""
    cyc = solver["cycle"]
    cfg = CycleConfig(nu1=cyc["nu1"], nu2=cyc["nu2"],
                      smoother=SmootherConfig(
                          cyc["smoother"], cheb_degree=cyc["cheb_degree"],
                          cheb_fraction=cyc["cheb_fraction"]))
    return MGPreconditionedCG(prob, num_levels=solver["levels"], cfg=cfg,
                              mixed=solver["mixed"],
                              low_dtype=dtypes[solver["low_dtype"]],
                              operator=problem["operator"],
                              precision=solver["precision"])
