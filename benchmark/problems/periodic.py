"""Problem kind ``periodic``: the port's shifted Helmholtz problem on the
periodic unit box of the configuration's ``dim`` axes (3 where it names
none; ``models/periodic.py``), in 3D σ·M⊗M⊗M + K⊗M⊗M + M⊗K⊗M + M⊗M⊗K with
the configuration's shift σ, on the Kronecker-sum or the banded operator
that the configuration names."""
from poms_tpu_torch.models.periodic import periodic_problem


def make(problem: dict, dtype, device):
    """The problem of the configuration's ``problem`` entry, in ``dtype``
    on ``device``."""
    return periodic_problem(problem.get("dim", 3), problem["n_el"],
                            degree=problem["degree"], shift=problem["shift"],
                            operator=problem["operator"], dtype=dtype,
                            device=device)
