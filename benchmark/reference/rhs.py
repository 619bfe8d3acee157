"""The right-hand sides of a cell, made from the seed.

A traffic file names a few smooth sources, each a sum of separable sine
products c·sin(m0·π·x)·sin(m1·π·y)·sin(m2·π·z); the first is the
configuration's manufactured source 3π²·sin(πx)·sin(πy)·sin(πz).  The load
vector of such a source is a sum of outer products of 1D load vectors, so it
is cheap to make at any grid.  Each is scaled to the manufactured source's
‖b‖₂, so that the absolute tolerance means the same accuracy for all.

The seed changes the numbers and not the work: each slot of the pool takes
one of the sources (every source once, in an order drawn from the seed)
under a symmetry of the cube drawn from the seed (a permutation of the axes,
a mirror on each axis, a sign).  The operator commutes with these, so a
solver takes the same iterations on every seed, up to rounding.
"""
from __future__ import annotations

import math
import random
from typing import List, Sequence

import torch

from benchmark.reference.bspline import load

__all__ = ["draw", "make", "one", "pool"]

_SALT = 0x5EED_0F_B5


def draw(sources: Sequence, seed: int) -> List[dict]:
    """The pool's slots for ``seed``: per slot the source's index, the
    permutation of axes, the mirrors and the sign."""
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


def _terms(source, slot):
    """The source's separable terms after the slot's symmetry: axis a of
    the result carries mode ``modes[axes[a]]``; a mirror on an axis of mode
    m multiplies the term by (-1)^(m+1), since sin(mπ(1-x)) does so."""
    out = []
    for term in source:
        modes = [term["modes"][a] for a in slot["axes"]]
        c = term["coef"] * slot["sign"]
        for a in range(3):
            if slot["mirror"][a] and modes[a] % 2 == 0:
                c = -c
        out.append((c, modes))
    return out


def make(n_el: int, degree: int, terms, device) -> torch.Tensor:
    """Σ c·(s_m0 ⊗ s_m1 ⊗ s_m2), the 1D load vectors made once per mode."""
    vec = {}
    total = None
    for c, modes in terms:
        v = []
        for m in modes:
            if m not in vec:
                vec[m] = torch.as_tensor(load(n_el, degree, m),
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


def _target(n_el: int, degree: int) -> float:
    """‖b‖₂ of the manufactured source 3π²·sin(πx)·sin(πy)·sin(πz)."""
    s = float(torch.linalg.vector_norm(torch.as_tensor(load(n_el, degree, 1))))
    return 3 * math.pi ** 2 * s ** 3


def one(n_el: int, degree: int, sources: Sequence, seed: int, k: int,
        device) -> torch.Tensor:
    """Slot ``k`` of the pool of :func:`pool`."""
    slot = draw(sources, seed)[k]
    b = make(n_el, degree, _terms(sources[slot["source"]], slot), device)
    b *= _target(n_el, degree) / float(torch.linalg.vector_norm(b))
    return b


def pool(n_el: int, degree: int, sources: Sequence, seed: int,
         device) -> List[torch.Tensor]:
    """The pool's right-hand sides, in the order of :func:`draw`, each an
    (n, n, n) f64 tensor on ``device`` scaled to the manufactured ‖b‖₂."""
    return [one(n_el, degree, sources, seed, k, device)
            for k in range(len(sources))]
