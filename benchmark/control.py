#!/usr/bin/env python3
"""The control of a cell: the program one precision lower than the
configuration states, in the program's place, through the rest of a run.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
        --seconds <s>

The configuration's ``control`` entry says what changes (for these cells:
the problem and every recurrence in f32, the program's own f32 path).  Each
seed is one run of the harness in this process, with the same right-hand
sides, window and check as the benchmark's own runs; each prints its result
line.  A control that the check does not fail means the check cannot tell
the configuration's precision from the one below it.  The benchmark's own
runs never run this.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    man = harness.manifest(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run(man, args.workload, seed, args.seconds, False,
                          torch.device("cuda", 0), t0, root=ROOT,
                          control=True)
        out["seed"] = seed
        print(json.dumps(out), flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
