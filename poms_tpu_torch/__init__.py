"""poms_tpu_torch — the PyTorch/CUDA port of ``poms_tpu``.

Sparse linear algebra and geometric multigrid for tensor-product B-spline
problems, on PyTorch tensors, with hand-written CUDA kernels for NVIDIA
Hopper where the JAX package had Pallas kernels for the TPU.  The layout
follows the JAX package (``core/``, ``ops/``, ``mg/``, ``models/``), so each
module's counterpart is found under the same name.  The package imports
``torch`` and numpy only; kernels are built with ``nvcc`` at first use
(``ops/_build.py``).

Ported so far: the headline solve (3D Poisson with cubic B-splines on the
Kronecker-sum operator, double-word MG-preconditioned CG; kernel K1) and
the banded path (``StencilMatrix`` operators, their hierarchy, the Jacobi,
red-black and lexicographic Gauss–Seidel and Chebyshev smoothers,
``MultigridSolver`` and f64 MG-preconditioned CG; kernels K2 and K4), the
defect-correction solver, bf16 cycles (``low_dtype=torch.bfloat16``),
periodic problems (``periodic_problem``) and distribution over
``torch.distributed`` (``parallel/``: ``DistributedMG``).
"""

__version__ = "0.1.0"

from poms_tpu_torch.core.space import StencilVectorSpace
from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.core.kron import KroneckerSumOperator
from poms_tpu_torch.core.matrix import StencilMatrix
from poms_tpu_torch.mg.smoother import SmootherConfig
from poms_tpu_torch.mg.hierarchy import Level, build_hierarchy
from poms_tpu_torch.mg.cycles import CycleConfig, cycle
from poms_tpu_torch.mg.mixed import MGPreconditionedCG, MixedPrecisionMG
from poms_tpu_torch.mg.solver import MultigridSolver, SolveResult
from poms_tpu_torch.models.poisson import poisson_problem, PoissonProblem
from poms_tpu_torch.models.periodic import periodic_problem, PeriodicProblem
