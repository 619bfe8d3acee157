"""ctypes loader/builder for the native C++ SpGEMM kernel (host code).

Counterpart of ``poms_tpu.sparse.native``.  Builds ``cpp/spgemm.cpp`` with
``g++`` on first use into ``poms_tpu_torch/_build/`` under a name keyed by a
hash of the source and flags (the package directory is never written).  When
no compiler is available, :func:`native_available` is False and
:func:`poms_tpu_torch.sparse.spgemm.csr_spgemm` takes its numpy path.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["native_available", "csr_spgemm_native"]

_SRC = Path(__file__).resolve().parent / "cpp" / "spgemm.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# the JAX package's flags: the same compiler contracts the same FMAs
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def _build() -> Optional[Path]:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    out = _BUILD_DIR / f"libspgemm-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)   # atomic: no process loads a half-written file
    return out


@functools.cache
def _lib() -> Optional[ctypes.CDLL]:
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.spgemm_pass1.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                 i64p, i64p, i64p, i64p, i64p]
    lib.spgemm_pass1.restype = None
    lib.spgemm_pass2.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                 i64p, i64p, f64p, i64p, i64p, f64p,
                                 i64p, i64p, f64p]
    lib.spgemm_pass2.restype = None
    return lib


def native_available() -> bool:
    return _lib() is not None


def _p64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _pf64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def csr_spgemm_native(Ap, Aj, Ax, Bp, Bj, Bx, n_rows, n_cols_B):
    """C = A @ B; returns (Cp, Cj, Cx) with rows sorted by column."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native spgemm unavailable (no g++)")
    Ap = np.ascontiguousarray(Ap, np.int64)
    Aj = np.ascontiguousarray(Aj, np.int64)
    Ax = np.ascontiguousarray(Ax, np.float64)
    Bp = np.ascontiguousarray(Bp, np.int64)
    Bj = np.ascontiguousarray(Bj, np.int64)
    Bx = np.ascontiguousarray(Bx, np.float64)
    Cp = np.zeros(n_rows + 1, np.int64)
    lib.spgemm_pass1(n_rows, n_cols_B, _p64(Ap), _p64(Aj), _p64(Bp),
                     _p64(Bj), _p64(Cp))
    nnz = int(Cp[-1])
    Cj = np.zeros(nnz, np.int64)
    Cx = np.zeros(nnz, np.float64)
    lib.spgemm_pass2(n_rows, n_cols_B, _p64(Ap), _p64(Aj), _pf64(Ax),
                     _p64(Bp), _p64(Bj), _pf64(Bx), _p64(Cp), _p64(Cj),
                     _pf64(Cx))
    # canonicalize: sort each row by column (key = row * n_cols + col)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(Cp))
    key = rows * np.int64(n_cols_B) + Cj
    order = np.argsort(key, kind="stable")
    return Cp, Cj[order], Cx[order]
