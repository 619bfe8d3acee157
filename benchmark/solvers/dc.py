"""Solver kind ``dc``: the port's defect correction
(``mg/mixed.py::MixedPrecisionMG``), x ← x + E(b − A·x) with E one (or
``inner_cycles``) low-precision cycle(s) a correction, the residual in the
precision that the configuration's ``solver.residual`` names ("twofloat":
double-word f32 pairs through K5), with the cycle built as the ``pcg`` kind
builds it."""
from poms_tpu_torch.mg.cycles import CycleConfig
from poms_tpu_torch.mg.mixed import MixedPrecisionMG
from poms_tpu_torch.mg.smoother import SmootherConfig


def make(prob, solver: dict, problem: dict, dtypes: dict):
    """The solver of ``prob``; ``dtypes`` maps the configuration's dtype
    names to torch dtypes."""
    cyc = solver["cycle"]
    cfg = CycleConfig(nu1=cyc["nu1"], nu2=cyc["nu2"],
                      smoother=SmootherConfig(
                          cyc["smoother"], cheb_degree=cyc["cheb_degree"],
                          cheb_fraction=cyc["cheb_fraction"]))
    return MixedPrecisionMG(prob, num_levels=solver["levels"], cfg=cfg,
                            low_dtype=dtypes[solver["low_dtype"]],
                            operator=problem["operator"],
                            residual=solver["residual"],
                            inner_cycles=solver.get("inner_cycles", 1))
