"""1D uniform B-splines on the periodic unit interval: ``n_el`` basis
functions, each a translate of the cardinal B-spline of degree p, B_i
supported on [i·h, (i + p + 1)·h] wrapped around the interval (h = 1/n_el).

They are built on their own knots, the uniform knot vector extended p spans
beyond each end of [0, 1], by the Cox–de Boor recursion of
:func:`benchmark.reference.bspline.basis`; on element e the nonzero
functions are e − p … e, taken modulo ``n_el``.  Bands are dense
``(n_el, n_el)`` circulant matrices: the reference applies them as such.
"""
from __future__ import annotations

import numpy as np

from benchmark.reference.bspline import basis

__all__ = ["knots", "stiffness_mass", "load"]


def knots(n_el: int, p: int) -> np.ndarray:
    """T_k = (k − p)·h, k = 0 … n_el + 2p."""
    return (np.arange(n_el + 2 * p + 1) - p) / n_el


def _quadrature(n_el: int, p: int, nq: int):
    """(knots, span, x, weight, first function) of every Gauss point of
    every element of [0, 1]."""
    T = knots(n_el, p)
    g, w = np.polynomial.legendre.leggauss(nq)
    e = np.arange(n_el)
    a, b = T[p + e], T[p + e + 1]
    x = (a[:, None] + 0.5 * (b - a)[:, None] * (g[None, :] + 1.0)).ravel()
    wt = (0.5 * (b - a)[:, None] * w[None, :]).ravel()
    span = np.repeat(p + e, nq)
    return T, span, x, wt, np.repeat(e - p, nq)


def stiffness_mass(n_el: int, p: int):
    """Dense circulant K_ij = ∫ B_i' B_j' and M_ij = ∫ B_i B_j over the
    periodic interval, by p+1 Gauss points an element (exact)."""
    T, span, x, wt, first = _quadrature(n_el, p, p + 1)
    N, dN = basis(T, p, span, x)
    K = np.zeros((n_el, n_el))
    M = np.zeros((n_el, n_el))
    for i in range(p + 1):
        for j in range(p + 1):
            rows, cols = (first + i) % n_el, (first + j) % n_el
            np.add.at(K, (rows, cols), wt * dN[:, i] * dN[:, j])
            np.add.at(M, (rows, cols), wt * N[:, i] * N[:, j])
    return K, M


def load(n_el: int, p: int, mode: int) -> np.ndarray:
    """The load vector ∫ sin(2π·mode·x) B_i(x) dx, by p+6 Gauss points an
    element."""
    T, span, x, wt, first = _quadrature(n_el, p, p + 6)
    N, _ = basis(T, p, span, x)
    out = np.zeros(n_el)
    f = wt * np.sin(2 * np.pi * mode * x)
    for j in range(p + 1):
        np.add.at(out, (first + j) % n_el, f * N[:, j])
    return out
