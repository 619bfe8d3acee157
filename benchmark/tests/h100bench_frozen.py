"""The right-hand sides and the K1/K5 work counts as the benchmark made them
when it took 3D problems alone, kept frozen: the tests hold the code of any
number of axes to these bits and counts on every 3D cell."""
from __future__ import annotations

import math
import random

import torch

from benchmark import work

_SALT = 0x5EED_0F_B5


# -- reference/rhs.py ---------------------------------------------------------

def draw(sources, seed):
    rng = random.Random(seed ^ _SALT)
    order = list(range(len(sources)))
    rng.shuffle(order)
    slots = []
    for k in order:
        axes = [0, 1, 2]
        rng.shuffle(axes)
        slots.append({"source": k, "axes": axes,
                      "mirror": [rng.random() < 0.5 for _ in range(3)],
                      "sign": rng.choice((-1.0, 1.0))})
    return slots


def _terms(kind, source, slot):
    out = []
    for term in source:
        modes = [term["modes"][a] for a in slot["axes"]]
        c = term["coef"] * slot["sign"]
        for a in range(3):
            if slot["mirror"][a]:
                c *= kind.mirror_sign(modes[a])
        out.append((c, modes))
    return out


def make(kind, problem, terms, device):
    vec = {}
    total = None
    for c, modes in terms:
        v = []
        for m in modes:
            if m not in vec:
                vec[m] = torch.as_tensor(kind.load(problem, m),
                                         dtype=torch.float64, device=device)
            v.append(vec[m])
        t = (c * v[0])[:, None, None] * v[1][None, :, None] \
            * v[2][None, None, :]
        if total is None:
            total = t
        else:
            total += t
            del t
    return total


def target_norm(kind_name, problem):
    """The kinds' 3D ``target_norm``; the 1D loads are the kind's."""
    from h100bench_util import reference_kind
    s = float(torch.linalg.vector_norm(torch.as_tensor(
        reference_kind(kind_name).load(problem, 1))))
    if kind_name == "periodic":
        return (problem["shift"] + 12 * math.pi ** 2) * s ** 3
    return 3 * math.pi ** 2 * s ** 3


def one(kind, kind_name, problem, sources, seed, k, device):
    slot = draw(sources, seed)[k]
    b = make(kind, problem, _terms(kind, sources[slot["source"]], slot),
             device)
    b *= target_norm(kind_name, problem) / float(torch.linalg.vector_norm(b))
    return b


# -- work/__init__.py and work/calls.py ---------------------------------------

def contractions(labels):
    terms = range(len(labels[0]))
    return (len({labels[2][r] for r in terms})
            + len({(labels[1][r], labels[2][r]) for r in terms})
            + len({labels[0][r] for r in terms}))


def _bands_bytes(npts, labels, p, itemsize):
    return sum(len(set(labels[a])) * npts[a] * (2 * p + 1) * itemsize
               for a in range(3))


_KRON_FIELDS = {"apply": 2, "residual": 3, "dinv": 2, "cheb": 5}
_KRON_EPILOGUE = {"apply": 0, "residual": 1, "dinv": 1, "cheb": 6}


def kron(mode, npts, p, labels, itemsize, first_cheb=False):
    n = math.prod(npts)
    fields = _KRON_FIELDS[mode] - (1 if mode == "cheb" and first_cheb else 0)
    nbytes = fields * n * itemsize + _bands_bytes(npts, labels, p, itemsize)
    flops = (2 * (2 * p + 1) * contractions(labels)
             + _KRON_EPILOGUE[mode]) * n
    return nbytes, flops


def kron_dw(npts, p, labels, low_word, rhs):
    n = math.prod(npts)
    W = 2 * p + 1
    fields = (2 if low_word else 1) + (2 if rhs else 0) + 2
    nbytes = fields * n * 4 + 2 * _bands_bytes(npts, labels, p, 4)
    per_point = (contractions(labels) * (W * work.DW_MUL
                                         + (W - 1) * work.DW_ADD)
                 + (len(labels[0]) - 1 + (1 if rhs else 0)) * work.DW_ADD)
    return nbytes, per_point * n


def _arg(args, kwargs, i, name, default=None):
    return args[i] if len(args) > i else kwargs.get(name, default)


def call_kron_mode(args, kwargs):
    mode, plan, x = args[0], args[1], args[2]
    d = _arg(args, kwargs, 4, "d")
    nbytes, flops = kron(mode, plan.n3, max(plan.pads), plan.labels,
                         x.element_size(), first_cheb=d is None)
    return nbytes, flops, {"torch.float32": "f32", "torch.float64": "f64",
                           "torch.bfloat16": "bf16"}[str(x.dtype)]


def call_residual_kron_df(args, kwargs):
    bh, xh, xl = args[1], args[3], args[4]
    pads = _arg(args, kwargs, 5, "pads")
    nbytes, flops = kron_dw(tuple(xh.shape), max(pads), kwargs["labels"],
                            low_word=xl is not None, rhs=bh is not None)
    return nbytes, flops, "f32"


# -- reference/operator.py and reference/kinds/periodic.py --------------------

def _axis(B, x, axis):
    n0, n1, n2 = x.shape
    if axis == 0:
        return (B @ x.reshape(n0, n1 * n2)).reshape(n0, n1, n2)
    if axis == 1:
        return torch.matmul(B, x)
    return (x.reshape(n0 * n1, n2) @ B.T).reshape(n0, n1, n2)


def apply(K, M, x, shift=None):
    """KronSum.apply, and with ``shift`` ShiftedKronSum.apply."""
    mx = _axis(M, x, 2)
    kx = _axis(K, x, 2)
    mm = _axis(M, mx, 1)
    inner = _axis(K, mx, 1)
    del mx
    inner += _axis(M, kx, 1)
    del kx
    if shift is not None:
        inner += shift * mm
    out = _axis(K, mm, 0)
    del mm
    out += _axis(M, inner, 0)
    return out
