"""CPU scipy reference multigrid: the convergence-history oracle.

Counterpart of ``poms_tpu/oracle/mg_oracle.py``, kept in the port so that it
stands alone.  It deliberately shares nothing with the device path except
the problem: the operator comes from the port's problem as a scipy CSR
matrix (``problem.A.tocsr()``), smoothers are textbook numpy loops and
masks, the coarse solve is scipy's ``splu``, transfers are explicit sparse
matrices.  The smoother update rules mirror ``mg/smoother.py`` (same order,
same masks), so f64 histories agree with the solvers' to roundoff.  Its own
path runs numpy and scipy only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla

from poms_tpu_torch.models.bspline import prolongation_interior_1d

__all__ = ["OracleMG"]


@dataclass
class _OLevel:
    A: sps.csr_matrix
    diag: np.ndarray
    P: Optional[sps.csr_matrix]      # coarse -> this level
    R: Optional[sps.csr_matrix]      # this level -> coarse
    lu: Optional[object]             # splu on coarsest
    npts: tuple


class OracleMG:
    """Mirror of ``MultigridSolver`` with scipy/numpy semantics, on a
    problem with ``A.tocsr()``, ``degree``, ``n_el`` and ``space.npts`` (a
    port ``PoissonProblem``)."""

    def __init__(self, problem, num_levels: int,
                 nu1: int = 2, nu2: int = 2, gamma: int = 1,
                 smoother: str = "jacobi", omega: float = 2.0 / 3.0,
                 cheb_degree: int = 4, cheb_fraction: float = 4.0):
        self.nu1, self.nu2, self.gamma = nu1, nu2, gamma
        self.smoother, self.omega = smoother, omega
        self.cheb_degree, self.cheb_fraction = cheb_degree, cheb_fraction
        p = problem.degree
        n_el = problem.n_el
        A = problem.A.tocsr()
        npts = problem.space.npts
        self.levels: List[_OLevel] = []
        for _ in range(num_levels - 1):
            n_el_c = tuple(ne // 2 for ne in n_el)
            P = None
            for nec in n_el_c:
                m = sps.csr_matrix(prolongation_interior_1d(nec, p))
                P = m if P is None else sps.kron(P, m, format="csr")
            R = P.T.tocsr()
            self.levels.append(_OLevel(A=A, diag=A.diagonal(), P=P, R=R,
                                       lu=None, npts=npts))
            A = (R @ A @ P).tocsr()
            n_el = n_el_c
            npts = tuple(nec + p - 2 for nec in n_el_c)
        self.levels.append(_OLevel(A=A, diag=A.diagonal(), P=None, R=None,
                                   lu=spla.splu(A.tocsc()), npts=npts))
        # per-level Chebyshev spectral bounds mirroring
        # mg.smoother.estimate_dinv_a_lambda_max (same seed/iters/margin)
        self.lams = []
        if smoother == "chebyshev":
            for lev in self.levels:
                if lev.lu is not None:
                    self.lams.append(None)
                else:
                    self.lams.append(self._lam_max(lev) * 1.02)

    # -- smoothers (mirror mg/smoother.py) ---------------------------------
    def _color_mask(self, npts, color):
        total = np.zeros(npts, np.int64)
        for a, n in enumerate(npts):
            shape = [1] * len(npts)
            shape[a] = n
            total = total + np.arange(n).reshape(shape)
        return ((total % 2) == color).ravel()

    def _lam_max(self, lev: _OLevel, iters: int = 30, seed: int = 0):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal(lev.npts).ravel()
        x = x / np.linalg.norm(x)
        for _ in range(iters):
            y = (lev.A @ x) / lev.diag
            x = y / np.linalg.norm(y)
        y = (lev.A @ x) / lev.diag
        return float(np.vdot(x, y) / np.vdot(x, x))

    def _smooth(self, lev: _OLevel, x, b, lam=None):
        A, d, w = lev.A, lev.diag, self.omega
        if self.smoother == "chebyshev":
            lam_max = lam
            lam_min = lam_max / self.cheb_fraction
            theta = 0.5 * (lam_max + lam_min)
            delta = 0.5 * (lam_max - lam_min)
            z = (b - A @ x) / d
            dd = z / theta
            x = x + dd
            sigma = theta / delta
            rho = 1.0 / sigma
            for _ in range(self.cheb_degree - 1):
                z = (b - A @ x) / d
                rho_new = 1.0 / (2.0 * sigma - rho)
                dd = rho_new * rho * dd + (2.0 * rho_new / delta) * z
                x = x + dd
                rho = rho_new
            return x
        if self.smoother == "jacobi":
            return x + w * (b - A @ x) / d
        if self.smoother == "rbgs":
            for color in (0, 1):
                mask = self._color_mask(lev.npts, color)
                s = A @ x - d * x          # offdiagonal part
                gs = (b - s) / d
                x = np.where(mask, (1 - w) * x + w * gs, x)
            return x
        if self.smoother == "gs_lex":
            x = x.copy()
            indptr, indices, data = A.indptr, A.indices, A.data
            for i in range(A.shape[0]):
                lo, hi = indptr[i], indptr[i + 1]
                cols = indices[lo:hi]
                vals = data[lo:hi]
                s = vals @ x[cols] - d[i] * x[i]
                x[i] = (1 - w) * x[i] + w * (b[i] - s) / d[i]
            return x
        raise ValueError(self.smoother)

    # -- cycles ------------------------------------------------------------
    def cycle(self, l, x, b):
        lev = self.levels[l]
        if lev.lu is not None:
            return lev.lu.solve(b)
        lam = self.lams[l] if self.smoother == "chebyshev" else None
        for _ in range(self.nu1):
            x = self._smooth(lev, x, b, lam)
        r = b - lev.A @ x
        bc = lev.R @ r
        xc = np.zeros(self.levels[l + 1].A.shape[0])
        for _ in range(self.gamma):
            xc = self.cycle(l + 1, xc, bc)
        x = x + lev.P @ xc
        for _ in range(self.nu2):
            x = self._smooth(lev, x, b, lam)
        return x

    def fmg(self, b, cycles_per_level: int = 1):
        n = len(self.levels)
        bs = [b]
        for l in range(n - 1):
            bs.append(self.levels[l].R @ bs[-1])
        x = self.levels[-1].lu.solve(bs[-1])
        for l in range(n - 2, -1, -1):
            x = self.levels[l].P @ x
            for _ in range(cycles_per_level):
                x = self.cycle(l, x, bs[l])
        return x

    def solve(self, b=None, tol: float = 1e-10, maxiter: int = 50,
              use_fmg: bool = False):
        if b is None:
            raise ValueError("pass the flat RHS")
        b = np.asarray(b, np.float64).ravel()
        A = self.levels[0].A
        x = self.fmg(b) if use_fmg else np.zeros_like(b)
        residuals = [float(np.linalg.norm(b - A @ x))]
        it = 0
        while residuals[-1] > tol and it < maxiter:
            x = self.cycle(0, x, b)
            residuals.append(float(np.linalg.norm(b - A @ x)))
            it += 1
        return x, residuals
