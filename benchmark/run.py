#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card this process finds.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Builds the cell's problem and solver (``poms_tpu_torch``), makes the
right-hand sides from the seed, solves once to warm up and capture, then
solves in a closed loop for ``--seconds`` and checks a sample of the
window's solutions, drawn from the seed, against the plain reference.  With
``--trace 1`` it also profiles a few eager steps (the rooflines) and a few
whole replayed solves (the device's idle share and the breakdown).  The last
line of the standard output is the result as one JSON object; the last lines
of the standard error give each number compared beside its limit.

Exits with 2, printing no result, without a CUDA card (or with fewer than the
cell asks for), and with 1 if a module of JAX or of the JAX package was
loaded.  Kernel caches stay inside the checkout.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"


def main(argv=None) -> int:
    args = _args(argv)
    cache = ROOT / "_bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    man = harness.manifest(ROOT)
    wl = harness.cell(man, args.workload, ROOT)[0]
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < wl["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); found "
              f"{found}", file=sys.stderr)
        return 2
    result = harness.run(man, args.workload, args.seed, args.seconds,
                         bool(args.trace), torch.device("cuda", 0),
                         T_PROCESS, root=ROOT)
    print(f"card: {_power_limit()}", flush=True)   # after set-up: not timed
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark "
              "runs the PyTorch port alone", file=sys.stderr)
        return 1
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
