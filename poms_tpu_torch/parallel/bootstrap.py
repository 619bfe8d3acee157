"""Process bootstrap: join this process to the job's process group.

Counterpart of ``poms_tpu/parallel/bootstrap.py``.  The JAX package is one
controller per host over a global device list; here every rank is its own
process (``torch.distributed``), and :func:`initialize` is what each rank
calls once before it touches the distributed modules.  The caller names the
backend and it is never switched on its own:

- ``"nccl"``: one rank per card, rank ``r`` on ``cuda:{local_rank}``
  (``torch.cuda.set_device``); halos and reductions move card to card.
- ``"gloo"``: the CPU test tier (tensors on the CPU), or several ranks
  sharing one card (NCCL refuses two ranks on one GPU); gloo's send and
  receive take host tensors, so the halos of CUDA fields are staged through
  host memory by :mod:`poms_tpu_torch.parallel.halo`, explicitly.

Launch recipes::

    # one rank per card on one host; solve.py calls
    # initialize(backend="nccl")
    torchrun --nproc-per-node 4 solve.py

    # ranks spawned by a script or a test (parallel/launch.py::spawn):
    initialize("file://" + path, world_size=2, rank=r, backend="gloo")

Without ``init_method``, ``world_size`` and ``rank`` the environment of
``torchrun`` is read (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``).
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_initialized", "process_info", "BACKENDS"]

BACKENDS = ("gloo", "nccl")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               local_rank: Optional[int] = None) -> None:
    """Join the process group (once; a second call is a no-op).

    ``backend`` is required: ``"gloo"`` or ``"nccl"``.  Under NCCL the rank
    takes ``cuda:{local_rank}`` (``LOCAL_RANK``, else the rank) and raises
    when there is no such card."""
    if is_initialized():
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: name 'gloo' or 'nccl'")
    if init_method is None:
        init_method = "env://"
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    kwargs = {}
    if backend == "nccl":
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", rank or 0))
        if not torch.cuda.is_available() \
                or local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"backend='nccl' needs cuda:{local_rank}; "
                               "this process sees no such card")
        torch.cuda.set_device(local_rank)
        kwargs["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank, **kwargs)


def process_info() -> dict:
    """The rank, world size and backend of the default group, and the card
    a NCCL rank took (None under gloo: the caller places its tensors)."""
    backend = dist.get_backend()
    return {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
            "backend": backend,
            "device": (f"cuda:{torch.cuda.current_device()}"
                       if backend == "nccl" else None)}
