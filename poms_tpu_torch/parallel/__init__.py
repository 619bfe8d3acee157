"""Distribution over ``torch.distributed``: halo exchange, distributed
operators and transfers, and the distributed multigrid solver."""
from poms_tpu_torch.parallel.halo import (HaloSpec, halo_exchange, dist_spmv,
                                          dist_norm2)
from poms_tpu_torch.parallel.dist import DistributedMG
