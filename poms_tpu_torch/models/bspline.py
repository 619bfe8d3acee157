"""B-spline basis, quadrature assembly and dyadic knot-insertion transfers.

Host-side (numpy, setup-time) machinery behind the reference's Poisson test
problems (SURVEY.md §2 C13 — "stiffness/mass via Gauss quadrature over knot
spans" [recall:med]) and transfer operators (C8 — "banded matrices from
knot-insertion/refinement relations").  All algorithms are the textbook ones
(Cox–de Boor recursion, NURBS-book basis/derivative evaluation, single-knot
insertion); nothing here is device code — the outputs are banded numpy arrays
that the jnp/Pallas layers consume.

Spaces use **open uniform knot vectors on [0, 1]** with ``n_el`` elements and
degree ``p``; the basis has ``nb = n_el + p`` functions, and homogeneous
Dirichlet conditions eliminate the first and last (interpolatory) functions,
leaving ``n = n_el + p - 2`` interior unknowns.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "open_uniform_knots", "find_span", "basis_funs", "ders_basis_funs",
    "eval_spline", "Spline1D", "assemble_spline_1d", "interior_band",
    "prolongation_full_1d", "prolongation_interior_1d", "sin_moment_1d",
]


# ---------------------------------------------------------------------------
# knots and basis evaluation
# ---------------------------------------------------------------------------

def open_uniform_knots(n_el: int, p: int) -> np.ndarray:
    """Open (clamped) uniform knot vector on [0,1] with ``n_el`` elements."""
    interior = np.linspace(0.0, 1.0, n_el + 1)
    return np.concatenate([np.zeros(p), interior, np.ones(p)])


def find_span(T: np.ndarray, p: int, x: float) -> int:
    """Knot span index k such that T[k] <= x < T[k+1] (clamped at the end)."""
    nb = len(T) - p - 1
    if x >= T[nb]:
        return nb - 1
    return int(np.searchsorted(T, x, side="right") - 1)


def basis_funs(T: np.ndarray, p: int, k: int, x: float) -> np.ndarray:
    """Values of the p+1 nonzero basis functions (ids k-p..k) at x."""
    N = np.zeros(p + 1)
    left = np.zeros(p + 1)
    right = np.zeros(p + 1)
    N[0] = 1.0
    for j in range(1, p + 1):
        left[j] = x - T[k + 1 - j]
        right[j] = T[k + j] - x
        saved = 0.0
        for r in range(j):
            tmp = N[r] / (right[r + 1] + left[j - r])
            N[r] = saved + right[r + 1] * tmp
            saved = left[j - r] * tmp
        N[j] = saved
    return N


def ders_basis_funs(T: np.ndarray, p: int, k: int, x: float, nder: int) -> np.ndarray:
    """Derivatives 0..nder of the p+1 nonzero basis functions at x.

    Returns array ``ders[d, i]`` = d-th derivative of basis ``k-p+i``.
    """
    ndu = np.zeros((p + 1, p + 1))
    a = np.zeros((2, p + 1))
    ders = np.zeros((nder + 1, p + 1))
    left = np.zeros(p + 1)
    right = np.zeros(p + 1)
    ndu[0, 0] = 1.0
    for j in range(1, p + 1):
        left[j] = x - T[k + 1 - j]
        right[j] = T[k + j] - x
        saved = 0.0
        for r in range(j):
            ndu[j, r] = right[r + 1] + left[j - r]
            tmp = ndu[r, j - 1] / ndu[j, r]
            ndu[r, j] = saved + right[r + 1] * tmp
            saved = left[j - r] * tmp
        ndu[j, j] = saved
    ders[0, :] = ndu[:, p]
    for r in range(p + 1):
        s1, s2 = 0, 1
        a[0, 0] = 1.0
        for d in range(1, nder + 1):
            der = 0.0
            rk, pk = r - d, p - d
            if r >= d:
                a[s2, 0] = a[s1, 0] / ndu[pk + 1, rk]
                der = a[s2, 0] * ndu[rk, pk]
            j1 = 1 if rk >= -1 else -rk
            j2 = d - 1 if r - 1 <= pk else p - r
            for j in range(j1, j2 + 1):
                a[s2, j] = (a[s1, j] - a[s1, j - 1]) / ndu[pk + 1, rk + j]
                der += a[s2, j] * ndu[rk + j, pk]
            if r <= pk:
                a[s2, d] = -a[s1, d - 1] / ndu[pk + 1, r]
                der += a[s2, d] * ndu[r, pk]
            ders[d, r] = der
            s1, s2 = s2, s1
    fac = float(p)
    for d in range(1, nder + 1):
        ders[d, :] *= fac
        fac *= p - d
    return ders


def eval_spline(T: np.ndarray, p: int, coeffs: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Evaluate the spline with control coefficients ``coeffs`` at points xs."""
    out = np.zeros(len(xs))
    for m, x in enumerate(np.asarray(xs, float)):
        k = find_span(T, p, x)
        N = basis_funs(T, p, k, x)
        out[m] = float(N @ coeffs[k - p:k + 1])
    return out


# ---------------------------------------------------------------------------
# 1D assembly (Gauss quadrature over knot spans)
# ---------------------------------------------------------------------------

@dataclass
class Spline1D:
    """1D discretization data for one coordinate direction.

    Bands are in stencil format: ``band[i, off]`` multiplies coefficient
    ``i + off - p``.  ``K``/``M`` are the *interior* (Dirichlet-eliminated)
    stiffness/mass bands of shape ``(n, 2p+1)``; the ``*_full`` variants keep
    boundary functions (shape ``(nb, 2p+1)``).
    """
    n_el: int
    degree: int
    knots: np.ndarray
    nb: int          # number of basis functions incl. boundary
    n: int           # interior unknowns = nb - 2
    K: np.ndarray
    M: np.ndarray
    K_full: np.ndarray
    M_full: np.ndarray


def assemble_spline_1d(n_el: int, p: int) -> Spline1D:
    """Assemble 1D B-spline stiffness K (∫B'B') and mass M (∫BB) bands."""
    if n_el < 1 or p < 1:
        raise ValueError("need n_el >= 1, degree >= 1")
    T = open_uniform_knots(n_el, p)
    nb = n_el + p
    q = p + 1  # Gauss points: exact for degree 2p integrands
    xg, wg = np.polynomial.legendre.leggauss(q)
    Kf = np.zeros((nb, 2 * p + 1))
    Mf = np.zeros((nb, 2 * p + 1))
    for e in range(n_el):
        k = p + e                      # span index
        a, b = T[k], T[k + 1]
        if b <= a:
            continue
        jac = 0.5 * (b - a)
        for xq, wq in zip(xg, wg):
            x = a + jac * (xq + 1.0)
            ders = ders_basis_funs(T, p, k, x, 1)
            N, dN = ders[0], ders[1]
            w = wq * jac
            # local stiffness/mass outer products into the bands
            for i in range(p + 1):
                gi = k - p + i
                for j in range(p + 1):
                    off = (j - i) + p   # global col - row + p
                    Kf[gi, off] += w * dN[i] * dN[j]
                    Mf[gi, off] += w * N[i] * N[j]
    K = interior_band(Kf, p)
    M = interior_band(Mf, p)
    return Spline1D(n_el=n_el, degree=p, knots=T, nb=nb, n=nb - 2,
                    K=K, M=M, K_full=Kf, M_full=Mf)


def interior_band(B_full: np.ndarray, p: int) -> np.ndarray:
    """Restrict a full band matrix to interior rows/cols (Dirichlet).

    Interior index i corresponds to full index i+1; entries whose column
    leaves [1, nb-2] are zeroed, so the interior band never references the
    eliminated boundary functions — this is what guarantees zero ghosts are
    the correct Dirichlet boundary treatment (core/vector.py).
    """
    nb = B_full.shape[0]
    n = nb - 2
    Bi = B_full[1:nb - 1].copy()
    i_idx = np.arange(n)[:, None]
    offs = np.arange(2 * p + 1)[None, :]
    col_full = (i_idx + 1) + (offs - p)
    Bi[(col_full < 1) | (col_full > nb - 2)] = 0.0
    return Bi


# ---------------------------------------------------------------------------
# dyadic refinement: knot-insertion prolongation
# ---------------------------------------------------------------------------

def _insert_knot(T: np.ndarray, p: int, u: float):
    """Single-knot-insertion matrix A: coeffs_new = A @ coeffs_old."""
    nb = len(T) - p - 1
    k = find_span(T, p, u)
    A = np.zeros((nb + 1, nb))
    for i in range(nb + 1):
        if i <= k - p:
            A[i, i] = 1.0
        elif i <= k:
            alpha = (u - T[i]) / (T[i + p] - T[i])
            A[i, i] = alpha
            A[i, i - 1] = 1.0 - alpha
        else:
            A[i, i - 1] = 1.0
    T_new = np.insert(T, k + 1, u)
    return T_new, A


def prolongation_full_1d(n_el_coarse: int, p: int) -> np.ndarray:
    """Exact embedding of the coarse spline space into the dyadically refined
    fine space (midpoint knots inserted), as a dense (nb_f, nb_c) matrix.

    Because the spaces are nested, ``eval(fine, P @ c) == eval(coarse, c)``
    exactly — tested in tests/test_transfer.py.  This mirrors the reference's
    knot-insertion transfer construction (SURVEY.md §2 C8).
    """
    T = open_uniform_knots(n_el_coarse, p)
    nb_c = n_el_coarse + p
    P = np.eye(nb_c)
    mids = (np.arange(n_el_coarse) + 0.5) / n_el_coarse
    for u in mids:
        T, A = _insert_knot(T, p, u)
        P = A @ P
    # sanity: resulting knot vector equals the fine open-uniform one
    Tf = open_uniform_knots(2 * n_el_coarse, p)
    assert np.allclose(T, Tf), "knot insertion did not produce the fine knots"
    return P


def prolongation_interior_1d(n_el_coarse: int, p: int) -> np.ndarray:
    """Interior (Dirichlet) prolongation: drop boundary rows and columns.

    Valid because coarse interior functions vanish at the endpoints, hence
    have zero coefficients on the (endpoint-interpolatory) fine boundary
    functions.
    """
    P = prolongation_full_1d(n_el_coarse, p)
    assert np.abs(P[0, 1:]).max() < 1e-13 and np.abs(P[-1, :-1]).max() < 1e-13
    return P[1:-1, 1:-1].copy()


# ---------------------------------------------------------------------------
# right-hand sides
# ---------------------------------------------------------------------------

def sin_moment_1d(sp: Spline1D, m: int = 1, interior: bool = True) -> np.ndarray:
    """Moments s_i = ∫ sin(m π x) B_i(x) dx (for manufactured solutions)."""
    T, p, n_el = sp.knots, sp.degree, sp.n_el
    q = p + 3  # a little extra accuracy for the sine
    xg, wg = np.polynomial.legendre.leggauss(q)
    s = np.zeros(sp.nb)
    for e in range(n_el):
        k = p + e
        a, b = T[k], T[k + 1]
        jac = 0.5 * (b - a)
        for xq, wq in zip(xg, wg):
            x = a + jac * (xq + 1.0)
            N = basis_funs(T, p, k, x)
            s[k - p:k + 1] += wq * jac * np.sin(m * np.pi * x) * N
    return s[1:-1] if interior else s


# ---------------------------------------------------------------------------
# periodic (circulant) spaces
# ---------------------------------------------------------------------------

def assemble_periodic_1d(n_el: int, p: int):
    """Periodic uniform B-spline stiffness/mass bands (circulant rows).

    On the periodic uniform grid every basis function is a shift of one
    cardinal B-spline, so K and M are circulant: band[i, off] = k[off] for
    all i.  The per-offset values are computed by quadrature of the cardinal
    spline against its shifts (supported reference: SURVEY.md §2 C1/C13
    lists periodicity as a reference capability).  Returns (K_band, M_band)
    of shape (n_el, 2p+1) — n_el basis functions, no boundary elimination.
    """
    if n_el <= 2 * p:
        raise ValueError(f"periodic space needs n_el > 2p (got {n_el}, p={p})")
    # compute overlap integrals on a line long enough that the central
    # function AND all its ±p neighbors are cardinal (uniform-knot)
    # translates: functions i ∈ [p, nb-1-p] are cardinal, so we need
    # c ± p inside that range → m_el = 4p+3, c = 2p+1
    m_el = 4 * p + 3
    T = open_uniform_knots(m_el, p)  # scaled domain [0,1] with m_el elements
    c = 2 * p + 1
    q = p + 1
    xg, wg = np.polynomial.legendre.leggauss(q)
    k_off = np.zeros(2 * p + 1)
    m_off = np.zeros(2 * p + 1)
    h_ref = 1.0 / m_el            # reference element width
    for e in range(m_el):
        kspan = p + e
        a, b = T[kspan], T[kspan + 1]
        jac = 0.5 * (b - a)
        for xq, wq in zip(xg, wg):
            x = a + jac * (xq + 1.0)
            ders = ders_basis_funs(T, p, kspan, x, 1)
            N, dN = ders[0], ders[1]
            ids = np.arange(kspan - p, kspan + 1)
            wquad = wq * jac
            if c in ids:
                ic = int(np.where(ids == c)[0][0])
                for j, gj in enumerate(ids):
                    off = gj - c
                    if -p <= off <= p:
                        k_off[off + p] += wquad * dN[ic] * dN[j]
                        m_off[off + p] += wquad * N[ic] * N[j]
    # rescale from the reference element width h_ref to h = 1/n_el:
    # stiffness ~ 1/h, mass ~ h
    h = 1.0 / n_el
    k_off *= h_ref / h
    m_off *= h / h_ref
    K = np.tile(k_off, (n_el, 1))
    M = np.tile(m_off, (n_el, 1))
    return K, M


def prolongation_periodic_1d(n_el_coarse: int, p: int) -> np.ndarray:
    """Dense periodic dyadic prolongation from the two-scale relation:
    B(x) = 2^{-p} Σ_k C(p+1, k) B(2x − k)."""
    from math import comb

    n_c = n_el_coarse
    n_f = 2 * n_el_coarse
    P = np.zeros((n_f, n_c))
    w = np.array([comb(p + 1, k) for k in range(p + 2)]) * 2.0 ** (-p)
    for j in range(n_c):
        for k in range(p + 2):
            P[(2 * j + k) % n_f, j] += w[k]
    return P
