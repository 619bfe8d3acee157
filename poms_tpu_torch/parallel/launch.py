"""Spawn the ranks of a job on this host and collect what each returns.

    results = spawn(fn, 4, "gloo", args=(spec,))
    job = start(fn, 4, "gloo", args=(spec,)); ...; results = job.results()

starts ``world_size`` processes (start method ``spawn``), each of which
joins the process group (:func:`poms_tpu_torch.parallel.bootstrap.initialize`
with a ``file://`` rendezvous in a fresh directory, so concurrent jobs never
share a port) with one thread, runs ``fn(*args)`` and sends back its
result; ``spawn``
returns the results in rank order (:func:`start` returns at once, and
``Job.results`` waits).  ``fn`` must be importable by path (a
module-level function) and return picklable data (numpy arrays, numbers).
A rank that raises makes ``spawn`` stop every rank and raise its traceback.
On a card, several gloo ranks may share it; under NCCL each rank takes the
card of its number.
"""
from __future__ import annotations

import os
import queue
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from poms_tpu_torch.parallel import bootstrap

__all__ = ["Job", "start", "spawn"]


def _rank_main(rank, world_size, backend, init_method, fn, args, results):
    torch.set_num_threads(1)   # ranks share the host's cores
    # the ranks of one host talk over loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        bootstrap.initialize(init_method, world_size, rank, backend,
                             local_rank=rank)
        out = fn(*args)
        dist.barrier()
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _next_result(results, procs, timeout: float):
    """The next rank's (rank, ok, value); raises when ``timeout`` seconds
    pass without one or a rank died without reporting."""
    waited = 0.0
    while waited < timeout:
        try:
            return results.get(timeout=1.0)
        except queue.Empty:
            waited += 1.0
        dead = [r for r, p in enumerate(procs)
                if p.exitcode not in (None, 0)]
        if dead:
            raise RuntimeError(f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode} and no result")
    raise TimeoutError(f"no rank reported within {timeout} s")


class Job:
    """Ranks started by :func:`start`; :meth:`results` waits for them."""

    def __init__(self, fn, world_size, args, backend, timeout):
        if backend not in bootstrap.BACKENDS:
            raise ValueError(f"backend={backend!r}: name 'gloo' or 'nccl'")
        self.timeout = timeout
        self._tmp = tempfile.TemporaryDirectory()
        init_method = "file://" + os.path.join(self._tmp.name, "rendezvous")
        ctx = mp.get_context("spawn")
        self._queue = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, world_size, backend, init_method,
                                         fn, args, self._queue))
                       for r in range(world_size)]
        for p in self._procs:
            p.start()

    def results(self) -> list:
        """Every rank's result in rank order (raises what a rank raised);
        every rank has ended when this returns or raises."""
        out = [None] * len(self._procs)
        try:
            for _ in self._procs:
                rank, ok, value = _next_result(self._queue, self._procs,
                                               self.timeout)
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
            for p in self._procs:
                p.join(self.timeout)
        finally:
            for p in self._procs:
                if p.is_alive():
                    p.terminate()
                p.join()
            self._tmp.cleanup()
        return out


def start(fn, world_size: int, backend: str, args=(),
          timeout: float = 900.0) -> Job:
    """Start ``fn(*args)`` on ``world_size`` ranks and return at once.
    ``backend``: ``"gloo"`` or ``"nccl"``, the caller's choice;
    ``timeout``: seconds to wait for the next rank's result."""
    return Job(fn, world_size, args, backend, timeout)


def spawn(fn, world_size: int, backend: str, args=(),
          timeout: float = 900.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` ranks; their results in rank
    order."""
    return start(fn, world_size, backend, args, timeout).results()
