"""Problem kind ``poisson``: the port's 3D Poisson problem on the unit cube
with homogeneous Dirichlet conditions (``models/poisson.py``), on the
Kronecker-sum or the banded operator that the configuration names.  A
configuration whose ``problem`` names no ``kind`` is of this kind."""
from poms_tpu_torch.models.poisson import poisson_problem


def make(problem: dict, dtype, device):
    """The problem of the configuration's ``problem`` entry, in ``dtype``
    on ``device``."""
    return poisson_problem(3, problem["n_el"], degree=problem["degree"],
                           operator=problem["operator"], dtype=dtype,
                           device=device)
