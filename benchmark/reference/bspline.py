"""1D B-splines on an open uniform knot vector of [0, 1], with homogeneous
Dirichlet conditions: the first and last basis functions are dropped, which
leaves ``n_el + p - 2`` unknowns.

Everything is evaluated at once for all quadrature points (Cox–de Boor
recursion along the points), so a 512-element line assembles in
milliseconds.  Bands are dense ``(n, n)`` matrices here: the reference
applies them as such.
"""
from __future__ import annotations

import numpy as np

__all__ = ["knots", "basis", "stiffness_mass", "load"]


def knots(n_el: int, p: int) -> np.ndarray:
    return np.concatenate([np.zeros(p), np.linspace(0.0, 1.0, n_el + 1),
                           np.ones(p)])


def basis(T: np.ndarray, p: int, span: np.ndarray, x: np.ndarray):
    """Values and first derivatives of the p+1 basis functions that are
    nonzero on knot span ``span[q]`` at the point ``x[q]``: two arrays of
    shape (len(x), p+1), column j for function ``span - p + j``."""
    q = len(x)
    N = np.ones((q, 1))
    lower = None
    for d in range(1, p + 1):
        if d == p:
            lower = N.copy()            # degree p-1, for the derivatives
        left = np.stack([x - T[span + 1 - j] for j in range(1, d + 1)], 1)
        right = np.stack([T[span + j] - x for j in range(1, d + 1)], 1)
        new = np.zeros((q, d + 1))
        saved = np.zeros(q)
        for r in range(d):
            tmp = N[:, r] / (right[:, r] + left[:, d - r - 1])
            new[:, r] = saved + right[:, r] * tmp
            saved = left[:, d - r - 1] * tmp
        new[:, d] = saved
        N = new
    if p == 0:
        return N, np.zeros_like(N)
    # N'_{i,p} = p (N_{i,p-1} / (T[i+p] - T[i])
    #              - N_{i+1,p-1} / (T[i+p+1] - T[i+1]))
    dN = np.zeros((q, p + 1))
    for j in range(p + 1):
        i = span - p + j
        if j >= 1:                      # N_{i,p-1} is column j-1 of lower
            den = T[i + p] - T[i]
            dN[:, j] += p * lower[:, j - 1] / den
        if j <= p - 1:                  # N_{i+1,p-1} is column j
            den = T[i + p + 1] - T[i + 1]
            dN[:, j] -= p * lower[:, j] / den
    return N, dN


def _quadrature(n_el: int, p: int, nq: int):
    """(span, x, weight) of every Gauss point of every element."""
    T = knots(n_el, p)
    g, w = np.polynomial.legendre.leggauss(nq)
    e = np.arange(n_el)
    a, b = T[p + e], T[p + e + 1]
    x = (a[:, None] + 0.5 * (b - a)[:, None] * (g[None, :] + 1.0)).ravel()
    wt = (0.5 * (b - a)[:, None] * w[None, :]).ravel()
    span = np.repeat(p + e, nq)
    return T, span, x, wt


def stiffness_mass(n_el: int, p: int):
    """Dense interior stiffness K_ij = ∫ B_i' B_j' and mass M_ij = ∫ B_i B_j,
    each (n_el + p - 2) square, by p+1 Gauss points an element (exact)."""
    T, span, x, wt = _quadrature(n_el, p, p + 1)
    N, dN = basis(T, p, span, x)
    nb = n_el + p
    K = np.zeros((nb, nb))
    M = np.zeros((nb, nb))
    first = span - p
    for i in range(p + 1):
        for j in range(p + 1):
            np.add.at(K, (first + i, first + j), wt * dN[:, i] * dN[:, j])
            np.add.at(M, (first + i, first + j), wt * N[:, i] * N[:, j])
    return K[1:-1, 1:-1], M[1:-1, 1:-1]


def load(n_el: int, p: int, mode: int) -> np.ndarray:
    """The interior load vector ∫ sin(mode·π·x) B_i(x) dx, by p+6 Gauss
    points an element."""
    T, span, x, wt = _quadrature(n_el, p, p + 6)
    N, _ = basis(T, p, span, x)
    out = np.zeros(n_el + p)
    f = wt * np.sin(mode * np.pi * x)
    for j in range(p + 1):
        np.add.at(out, span - p + j, f * N[:, j])
    return out[1:-1]
