"""Kernel loader: ``nvcc`` the package's CUDA sources into plain-C shared
libraries at first use and load them with ``ctypes``.

Each library is built from the sources in ``poms_tpu_torch/csrc`` only, into
``poms_tpu_torch/_build/``, under a file name keyed by a hash of the sources
and the compiler flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  The compiler's report (``-Xptxas -v``: registers, shared
memory, spills) is kept beside each library as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "build", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)"
                           "; the CUDA kernels are built on the GPU host")
    return found


def _sources(name: str):
    srcs = sorted(CSRC.glob(f"{name}.cu")) + sorted(CSRC.glob("*.cuh"))
    if not srcs or srcs[0].suffix != ".cu":
        raise FileNotFoundError(f"no source {name}.cu in {CSRC}")
    return srcs


def _library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of these sources exists."""
    out = _library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / f"{name}.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu:\n{proc.stderr[-4000:]}")
    # atomic rename: a concurrent process never loads a half-written file
    os.replace(tmp, out)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, once per process."""
    return ctypes.CDLL(str(build(name)))
