"""The right-hand sides of a cell, made from the seed.

A traffic file names a few smooth sources, each a sum of separable products
c·f_m0(x0)·…·f_m(d−1)(x(d−1)) of 1D modes, one mode an axis of the
configuration's ``problem["dim"]`` axes (3 where it names none).  The load
vector of such a source is a sum of outer products of 1D load vectors, so it
is cheap to make at any grid.  What a mode is, the sign a mirror x → 1 − x
puts on it, and the ‖b‖₂ every source is scaled to (so that the absolute
tolerance means the same accuracy for all) are the reference kind's
(``benchmark/reference/kinds/<kind>.py``, ``load``, ``mirror_sign`` and
``target_norm``); for ``poisson`` in 3D the modes are sin(mπx) and the first
source is the manufactured 3π²·sin(πx)·sin(πy)·sin(πz).

The seed changes the numbers and not the work: each slot of the pool takes
one of the sources (every source once, in an order drawn from the seed)
under a symmetry of the box drawn from the seed (a permutation of the axes,
a mirror on each axis, a sign), drawn alike for every kind.  The operator
commutes with these, so a solver takes the same iterations on every seed, up
to rounding.
"""
from __future__ import annotations

import random
from typing import List, Sequence

import torch

__all__ = ["draw", "make", "one", "pool"]

_SALT = 0x5EED_0F_B5


def draw(sources: Sequence, seed: int, dim: int = 3) -> List[dict]:
    """The pool's slots for ``seed``: per slot the source's index, the
    permutation of the ``dim`` axes, the mirrors and the sign."""
    rng = random.Random(seed ^ _SALT)
    order = list(range(len(sources)))
    rng.shuffle(order)
    slots = []
    for k in order:
        axes = list(range(dim))
        rng.shuffle(axes)
        slots.append({"source": k, "axes": axes,
                      "mirror": [rng.random() < 0.5 for _ in range(dim)],
                      "sign": rng.choice((-1.0, 1.0))})
    return slots


def _dim(problem: dict, sources: Sequence) -> int:
    """The problem's number of axes; a source whose terms have another
    number of modes is refused, naming it."""
    dim = problem.get("dim", 3)
    for k, source in enumerate(sources):
        for term in source:
            if len(term["modes"]) != dim:
                raise ValueError(
                    f"source {k} of the traffic, {source}, has a term of "
                    f"{len(term['modes'])} modes; the problem has {dim} "
                    "axes, one mode an axis")
    return dim


def _terms(kind, source, slot):
    """The source's separable terms after the slot's symmetry: axis a of
    the result carries mode ``modes[axes[a]]``; a mirror on an axis of mode
    m multiplies the term by the kind's ``mirror_sign(m)``."""
    out = []
    for term in source:
        modes = [term["modes"][a] for a in slot["axes"]]
        c = term["coef"] * slot["sign"]
        for a in range(len(modes)):
            if slot["mirror"][a]:
                c *= kind.mirror_sign(modes[a])
        out.append((c, modes))
    return out


def make(kind, problem: dict, terms, device) -> torch.Tensor:
    """Σ c·(s_m0 ⊗ … ⊗ s_m(d−1)), the 1D load vectors made once per mode,
    each product formed from the first axis on: ((c·s_m0) ⊗ s_m1) ⊗ …"""
    vec = {}
    total = None
    for c, modes in terms:
        t = None
        for m in modes:
            if m not in vec:
                vec[m] = torch.as_tensor(kind.load(problem, m),
                                         dtype=torch.float64, device=device)
            t = c * vec[m] if t is None else t[..., None] * vec[m]
        if total is None:
            total = t
        else:
            total += t
            del t
    return total


def one(kind, problem: dict, sources: Sequence, seed: int, k: int,
        device) -> torch.Tensor:
    """Slot ``k`` of the pool of :func:`pool`."""
    slot = draw(sources, seed, _dim(problem, sources))[k]
    b = make(kind, problem, _terms(kind, sources[slot["source"]], slot),
             device)
    b *= kind.target_norm(problem) / float(torch.linalg.vector_norm(b))
    return b


def pool(kind, problem: dict, sources: Sequence, seed: int,
         device) -> List[torch.Tensor]:
    """The pool's right-hand sides of the reference kind ``kind`` (its
    module) for the configuration's ``problem`` entry, in the order of
    :func:`draw`, each an (n,)·d f64 tensor on ``device`` scaled to the
    kind's ``target_norm``."""
    return [one(kind, problem, sources, seed, k, device)
            for k in range(len(sources))]
