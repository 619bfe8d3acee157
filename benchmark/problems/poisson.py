"""Problem kind ``poisson``: the port's Poisson problem on the unit box of
the configuration's ``dim`` axes (3 where it names none) with homogeneous
Dirichlet conditions (``models/poisson.py``), on the Kronecker-sum or the
banded operator that the configuration names.  A configuration whose
``problem`` names no ``kind`` is of this kind."""
from poms_tpu_torch.models.poisson import poisson_problem


def make(problem: dict, dtype, device):
    """The problem of the configuration's ``problem`` entry, in ``dtype``
    on ``device``."""
    return poisson_problem(problem.get("dim", 3), problem["n_el"],
                           degree=problem["degree"],
                           operator=problem["operator"], dtype=dtype,
                           device=device)
