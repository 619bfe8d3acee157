"""The JAX package's ``examples/`` as modules of the port.

Each example is ``python -m poms_tpu_torch.examples.<name> [arguments]
[--cpu]``: it runs on the current CUDA card unless ``--cpu`` is given.
``build(...)`` returns what the example solves (problem and solver);
``main(...)`` solves, prints the lines of the JAX package's example, and
returns the numbers it printed as a dict.  The distributed examples take
``--backend gloo|nccl`` and start their ranks through
:mod:`poms_tpu_torch.parallel.launch`.
"""
import sys

__all__ = ["cli_device", "int_args", "flag", "dist_cli", "rank_device",
           "launches", "VALUE_FLAGS"]


def cli_device(argv=None):
    """``"cpu"`` when ``--cpu`` is among the arguments, else None (the
    current CUDA card)."""
    argv = sys.argv[1:] if argv is None else argv
    return "cpu" if "--cpu" in argv else None


# the flags that take a value (``--name value``) on the command lines of
# the examples and benches
VALUE_FLAGS = ("--backend", "--ranks", "--dim", "--n-el", "--block",
               "--t-comp-ms")


def flag(argv, name: str, cast=int, default=None):
    """The value after ``name`` on the command line, cast; ``default`` when
    absent."""
    argv = list(argv)
    for i, a in enumerate(argv[:-1]):
        if a == name:
            return cast(argv[i + 1])
    return default


def int_args(argv=None, n=None):
    """The positional arguments (not the ``--`` flags and the values of
    :data:`VALUE_FLAGS`), as ints where they parse as ints, at most ``n``
    of them."""
    argv = sys.argv[1:] if argv is None else argv
    out = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in VALUE_FLAGS:
            skip = True
            continue
        if a.startswith("--"):
            continue
        try:
            out.append(int(a))
        except ValueError:
            out.append(a)
    return out[:n]


def dist_cli(argv=None):
    """(backend, ranks, device) of a distributed example's command line:
    ``--backend gloo|nccl`` (required unless ``--cpu``, which means gloo on
    the CPU), ``--ranks N`` (default 2)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    backend = flag(argv, "--backend", str)
    ranks = flag(argv, "--ranks", int, 2)
    device = cli_device(argv)
    if device == "cpu":
        if backend not in (None, "gloo"):
            raise SystemExit("--cpu runs gloo ranks on the CPU; drop "
                             f"--backend {backend}")
        backend = "gloo"
    if backend not in ("gloo", "nccl"):
        raise SystemExit("name the backend: --backend gloo|nccl (or --cpu)")
    return backend, ranks, device


def rank_device(device):
    """The device of this rank's fields: the CPU for ``"cpu"``, else the
    process's current card (a NCCL rank's own; gloo ranks share card 0)."""
    import torch

    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the example runs on the card "
                           "unless given --cpu (device='cpu')")
    return torch.device("cuda", torch.cuda.current_device())


def launches(rank_results=None) -> dict:
    """The kernel launches this process counted (``ops/counters.py``), or,
    given the ranks' results, the sum of theirs."""
    if rank_results is None:
        from poms_tpu_torch.ops import counters

        return {k: v for k, v in counters.snapshot().items() if v}
    total = {}
    for r in rank_results:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    return total
