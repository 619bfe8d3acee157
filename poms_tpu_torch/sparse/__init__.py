"""Host-side sparse formats and SpGEMM: numpy copies of ``poms_tpu.sparse``."""
from poms_tpu_torch.sparse.bsr import BsrMatrix
from poms_tpu_torch.sparse.csr import CsrMatrix
from poms_tpu_torch.sparse.spgemm import csr_spgemm
