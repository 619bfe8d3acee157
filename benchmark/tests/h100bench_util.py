"""Shared by the benchmark's tests: a copy of the benchmark with a tiny cell
that runs on the CPU in seconds."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

TINY = "tiny_kron"


def reference_kind(name: str = "poisson", root: Path = ROOT):
    """The module of the reference kind ``name``, loaded from its file as
    :func:`benchmark.harness.kinds` loads it (and nothing of the program)."""
    return harness._module(
        root / harness.KIND_DIRS["reference"] / f"{name}.py",
        "test_reference_" + name)


def tiny_root(tmp: Path, operator: str = "kron", n_el: int = 8,
              degree: int = 3, precision: str = "dw") -> Path:
    """A checkout-shaped directory holding the benchmark and one more cell,
    ``tiny_kron`` (a small grid of the headline configuration), whose run
    takes a fraction of a second on the CPU."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads(
        (ROOT / "benchmark/configs/poisson3d_kron_p3_n512.json").read_text())
    base["name"] = "tiny"
    base["problem"].update(n_el=n_el, degree=degree, operator=operator)
    base["solver"].update(levels=2, precision=precision)
    base["check"]["solutions"] = 3
    (tmp / "benchmark/configs/tiny.json").write_text(json.dumps(base))
    man["configs"].append({"name": "tiny", "source": "test",
                           "file": "benchmark/configs/tiny.json",
                           "reduced": ["n_el"], "why": "test"})
    man["workloads"].append({"name": TINY, "config": "tiny",
                             "traffic": "smooth4", "chips": 1, "why": "test"})
    # the tiny cell reports what the degree-5 kron cell reports
    for m in man["end_to_end"] + man["per_layer"]:
        if "kron_pcg_p5_n256" in m.get("workloads", ()):
            m["workloads"].append(TINY)
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp
