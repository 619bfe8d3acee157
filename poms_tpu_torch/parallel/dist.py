"""Distributed multigrid over the ranks of a ``torch.distributed`` group.

Counterpart of ``poms_tpu/parallel/dist.py``, with the JAX package's
arguments, checks and arithmetic; where the JAX package runs one
``shard_map`` program over a device mesh, every rank here runs the same
Python on its own block:

- Levels ``0 .. L_dist-1`` are block-partitioned over the rank grid
  (``mesh_shape``, row-major over the group's ranks): smoothing sweeps and
  residuals run on the rank's block with halo exchanges
  (:mod:`~poms_tpu_torch.parallel.halo`: K2, or K3 under
  ``POMS_TPU_SPMV=v2``, on banded levels; plain per-axis contractions on
  Kronecker-sum levels, :mod:`~poms_tpu_torch.parallel.kron`), norms are
  ``all_reduce`` s, and transfers between distributed levels are one K7
  launch on the exchanged block (:mod:`~poms_tpu_torch.parallel.transfers`).
- Levels below ``L_dist`` are agglomerated: the residual is gathered
  (``all_gather``) and every rank runs the serial port's cycle on the tail
  (``mg/cycles.py::cycle``: K1 or K2/K3 and K7 as the operator says), then
  keeps its block of the correction.

Padded global sizes satisfy ``N_l = 2 · N_{l+1}`` per dim across the
distributed range (:func:`dist_depth`), so every rank owns nested blocks and
transfers read a ±W halo.  Grid padding uses decoupled identity rows
(diagonal 1, no coupling, zero right-hand side and transfer weights): padded
entries stay zero through every sweep, residual, transfer and norm.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from poms_tpu_torch.core.vector import StencilVector
from poms_tpu_torch.mg.cycles import CycleConfig, cycle, fmg
from poms_tpu_torch.mg.mixed import _cast_levels, _graph_loop
from poms_tpu_torch.mg.smoother import (attach_spectral_estimates,
                                        color_mask, resolve_omega)
from poms_tpu_torch.mg.solver import LamsOwner, SolveResult, build_levels
from poms_tpu_torch.models.bspline import (prolongation_interior_1d,
                                           prolongation_periodic_1d)
from poms_tpu_torch.ops import dispatch
from poms_tpu_torch.ops.stencil_v2 import pack_band_v2, stencil_apply_v2
from poms_tpu_torch.ops.transfer import apply_transfer
from poms_tpu_torch.ops.twofloat import dw_update, merge_f64, split_f64
from poms_tpu_torch.parallel.halo import (HaloSpec, RankGrid, dist_norm2,
                                          dist_spmv, face_bands,
                                          gather_blocks, local_starts,
                                          pad_and_exchange)
from poms_tpu_torch.parallel.kron import (dist_dw_norm2, dist_kron_apply,
                                          dist_kron_diag,
                                          dist_kron_residual_df,
                                          pad_band_1d_identity)
from poms_tpu_torch.parallel.transfers import (build_dist_transfer,
                                               dist_apply_transfer)

__all__ = ["DistributedMG", "dist_depth"]

_AXIS_NAMES = ("ax0", "ax1", "ax2", "ax3")


def dist_depth(npts_per_level: Sequence[Sequence[int]],
               mesh_shape: Sequence[int], degree: int,
               dist_levels="auto") -> Tuple[int, List[Tuple[int, ...]]]:
    """(L_dist, Ns): how many levels are distributed and their padded
    global sizes (host arithmetic, no process group).

    ``npts_per_level``: interior points per dim of every level, finest
    first; ``dist_levels``: ``"auto"`` (as deep as the guard allows) or the
    most levels wanted.  A level chain may distribute while its coarsest
    block keeps at least p + 2 points per dim (the smoother's pads and the
    transfers' halos); ``Ns[l] = base · 2^(L_dist-1-l)`` with ``base`` the
    smallest mesh multiple holding every level's points."""
    npts_l = [tuple(n) for n in npts_per_level]
    num_levels = len(npts_l)
    d = len(npts_l[0])
    mesh_shape = tuple(mesh_shape) + (1,) * (d - len(mesh_shape))
    max_dist = num_levels - 1 if dist_levels == "auto" else int(dist_levels)
    max_dist = max(1, min(max_dist, num_levels - 1))

    def base(a, L):
        m = mesh_shape[a]
        b = max(-(-npts_l[l][a] // (1 << (L - 1 - l))) for l in range(L))
        return -(-b // m) * m

    L = 1
    while L < max_dist and all(base(a, L + 1) // mesh_shape[a]
                               >= max(degree, 1) + 2 for a in range(d)):
        L += 1
    base_N = [base(a, L) for a in range(d)]
    return L, [tuple(b * (1 << (L - 1 - l)) for b in base_N)
               for l in range(L)]


def _pad_band_identity(band_t: torch.Tensor, npts, N, pads, starts=None,
                       n_loc=None) -> torch.Tensor:
    """The offset-major band padded to the grid ``N`` with decoupled
    identity rows; with ``starts``/``n_loc`` only that block of it (made
    without the padded global band)."""
    d = len(npts)
    if starts is None:
        starts, n_loc = (0,) * d, tuple(N)
    win = tuple(band_t.shape[:d])
    out = torch.zeros(win + tuple(n_loc), dtype=band_t.dtype,
                      device=band_t.device)
    stops = [min(s + n, m) for s, n, m in zip(starts, n_loc, npts)]
    if all(e > s for s, e in zip(starts, stops)):
        src = tuple(slice(s, e) for s, e in zip(starts, stops))
        dst = tuple(slice(0, e - s) for s, e in zip(starts, stops))
        out[(slice(None),) * d + dst] = band_t[(slice(None),) * d + src]
    padded = torch.zeros(tuple(n_loc), dtype=torch.bool,
                         device=band_t.device)
    for a in range(d):
        shape = [1] * d
        shape[a] = n_loc[a]
        idx = torch.arange(n_loc[a], device=band_t.device) + starts[a]
        padded = padded | (idx >= npts[a]).reshape(shape)
    out[tuple(pads)][padded] = 1.0
    return out


class _DistLevel:
    """Static data of one distributed level (setup, on the rank)."""

    def __init__(self, op_arrays, spec, N, npts, restrict, prolong,
                 labels=None):
        # ``op_arrays``: banded: this rank's block of the identity-padded
        # offset-major band; kron: per axis, the distinct padded global 1D
        # bands (``labels``[a][r] is term r's)
        self.op_arrays = op_arrays
        self.spec = spec              # HaloSpec (pads = stencil pads)
        self.N = N
        self.npts = npts
        self.restrict = restrict      # tuple[DistTransfer1D] | None
        self.prolong = prolong        # tuple[DistTransfer1D] | None (l+1 → l)
        self.labels = labels


class _LevelOps:
    """One distributed level's operator in one dtype: the band (its pack
    under v2, its faces for the overlap form) or the 1D bands, the diagonal,
    and the colour masks of the Kronecker-sum RB-GS."""

    def __init__(self, lev: _DistLevel, dtype, overlap: bool, rbgs: bool):
        self.spec = spec = lev.spec
        self.labels = lev.labels
        self.packed = self.faces = self.masks = None
        v2 = dispatch.engine() is stencil_apply_v2
        if lev.labels is not None:
            self.bands = tuple(tuple(B.to(dtype) for B in row)
                               for row in lev.op_arrays)
            self.diag = dist_kron_diag(self.bands, lev.labels, spec)
            if rbgs:
                starts = local_starts(spec)
                self.masks = [color_mask(spec.n_loc, c, starts,
                                         device=self.diag.device)
                              for c in (0, 1)]
            return
        self.band = lev.op_arrays.to(dtype).contiguous()
        self.diag = self.band[spec.pads]
        if v2:
            self.packed = pack_band_v2(self.band, spec.n_loc, spec.pads)
        if overlap:
            self.faces = [
                (rows, band, pack_band_v2(band, tuple(s.stop - s.start
                                                      for s in rows),
                                          spec.pads) if v2 else None)
                for rows, band in face_bands(self.band, spec)]


@dataclass
class _Ops:
    """A hierarchy in one dtype: the distributed levels' operators, the
    agglomerated tail (the serial port's levels) and its transfers."""
    levels: List[_LevelOps]
    tail: list
    tail_restrict: tuple
    tail_prolong: tuple


class DistributedMG(LamsOwner):
    """Multilevel distributed multigrid (semantics ≡ MultigridSolver, and
    with ``mixed`` ≡ MixedPrecisionMG), one block a rank.

    ``group``: the process group whose ranks form ``mesh_shape`` (default:
    the world; its size must be the mesh's).  The problem is built on every
    rank (on the rank's device: a NCCL rank's card, or what a gloo rank's
    caller chose).  Fields in and out of :meth:`step` and :meth:`solve` are
    the rank's blocks of the padded global grid; :meth:`local` cuts one from
    a global interior field and :meth:`gather` assembles one.

    Once built, the solver holds the rank's blocks of the distributed
    levels, the agglomerated tail's levels and the global right-hand side
    (``b``), not the global operators of the distributed levels: a caller
    that drops the problem frees them.  Setup itself builds the global
    hierarchy on every rank (the λ estimates and the tail need it), so the
    peak of a rank's memory is the serial solver's.
    """

    def __init__(self, problem, num_levels: int,
                 mesh_shape: Tuple[int, ...],
                 cfg: CycleConfig = CycleConfig(), group=None,
                 dist_levels: int | str = "auto", overlap: bool = True,
                 mixed: bool = False, operator: str = "banded",
                 mixed_residual: str = "auto", inner_cycles: int = 1):
        # ``overlap``: the banded SpMV computes the interior while the halo
        # is in flight (parallel/halo.py::dist_spmv); equal to the plain
        # form to roundoff.  ``mixed``: distributed defect correction, f32
        # cycles inside an f64 (or double-word) residual loop.
        if num_levels < 2:
            raise ValueError("DistributedMG needs >= 2 levels")
        if mixed and problem.b.interior.dtype != torch.float64:
            raise ValueError(
                "mixed=True needs f64 buffers; got "
                f"{problem.b.interior.dtype}")
        if mixed_residual == "auto":
            mixed_residual = ("twofloat" if (mixed and operator == "kron")
                              else "f64")
        if mixed_residual not in ("f64", "twofloat"):
            raise ValueError(f"mixed_residual={mixed_residual!r}")
        if mixed_residual == "twofloat" and operator != "kron":
            raise ValueError("mixed_residual='twofloat' needs the kron "
                             "operator (the dw residual exploits its "
                             "structure)")
        self.mixed_residual = mixed_residual if mixed else None
        self.inner_cycles = max(1, int(inner_cycles))
        if cfg.smoother.kind not in ("jacobi", "rbgs", "chebyshev"):
            raise ValueError(
                f"smoother {cfg.smoother.kind!r} is not distributed "
                "(gs_lex is sequential)")
        if operator not in ("banded", "kron"):
            raise ValueError(f"operator={operator!r}")
        d = problem.dim
        p = problem.degree
        mesh_shape = tuple(mesh_shape) + (1,) * (d - len(mesh_shape))
        periodic_problem = hasattr(problem, "shift")   # PeriodicProblem
        n_el_l = [tuple(ne // (1 << l) for ne in problem.n_el)
                  for l in range(num_levels)]
        npts_l = [tuple(ne + (0 if periodic_problem else p - 2)
                        for ne in n_el)
                  for n_el in n_el_l]
        self.L_dist, Ns = dist_depth(npts_l, mesh_shape, p, dist_levels)
        # periodic dims tolerate no grid padding: the wrap neighbour of the
        # last interior point must be the first one
        for a in range(d):
            if problem.space.periodic[a]:
                bad = [(l, Ns[l][a], npts_l[l][a]) for l in range(self.L_dist)
                       if Ns[l][a] != npts_l[l][a]]
                if bad:
                    raise ValueError(
                        f"periodic dim {a}: grid sizes {bad} need padding to "
                        f"tile mesh axis {mesh_shape[a]}; choose a mesh that "
                        f"divides every distributed level's npts (or fewer "
                        f"dist_levels)")
        dev = problem.space.device
        self.grid = grid = RankGrid.current(mesh_shape, group)
        if grid.backend == "nccl" and dev.type != "cuda":
            raise ValueError("backend 'nccl' moves CUDA tensors: build the "
                             "problem on the rank's card")

        self.b = problem.b
        self.operator = operator
        self.overlap = overlap
        self.mixed = mixed
        self.mesh_shape = mesh_shape
        self.names = _AXIS_NAMES[:d]
        levels = build_levels(problem, num_levels, operator)
        if [lev.A.space.npts for lev in levels] != npts_l:
            raise RuntimeError("the hierarchy's sizes are not the plan's")
        cfg = replace(cfg, smoother=resolve_omega(cfg.smoother,
                                                  levels[0].A))
        lams = attach_spectral_estimates(levels, cfg.smoother)
        # every rank smooths with rank 0's ω and λ estimates
        shared = [cfg.smoother.omega, lams]
        dist.broadcast_object_list(shared, src=grid.global_rank(0),
                                   group=grid.group)
        self.cfg = replace(cfg, smoother=replace(cfg.smoother,
                                                 omega=shared[0]))
        self.lams = tuple(shared[1])
        dtype = problem.space.dtype

        self.dist: List[_DistLevel] = []
        for l in range(self.L_dist):
            lev = levels[l]
            sp = lev.A.space
            N = Ns[l]
            n_loc = tuple(N[a] // mesh_shape[a] for a in range(d))
            spec = HaloSpec.build(self.names, mesh_shape, n_loc, sp.pads,
                                  sp.periodic, grid)
            labels = None
            if operator == "kron":
                labels = lev.A._band_labels()
                op_arrays = tuple(
                    tuple(torch.as_tensor(
                        pad_band_1d_identity(B.cpu().numpy(), N[a]),
                        dtype=dtype, device=dev)
                        for B in self._distinct(lev.A, labels, a))
                    for a in range(d))
            else:
                op_arrays = _pad_band_identity(lev.A.band_t, sp.npts, N,
                                               sp.pads, local_starts(spec),
                                               n_loc)
            restrict = prolong = None
            if l + 1 < self.L_dist:
                P1 = (prolongation_periodic_1d if periodic_problem
                      else prolongation_interior_1d)
                P1s = [P1(n_el_l[l + 1][a], p) for a in range(d)]
                N_c = Ns[l + 1]
                restrict = tuple(
                    build_dist_transfer(P1s[a].T, N_c[a], N[a],
                                        mesh_shape[a], sp.periodic[a])
                    for a in range(d))
                prolong = tuple(
                    build_dist_transfer(P1s[a], N[a], N_c[a],
                                        mesh_shape[a], sp.periodic[a])
                    for a in range(d))
            self.dist.append(_DistLevel(op_arrays, spec, N, sp.npts,
                                        restrict, prolong, labels))

        # the double-word split of the finest kron bands for the twofloat
        # residual: hi padded with identity rows, lo with zeros (identity is
        # exact in f32, so the pair stays a double word)
        self._bands_df0 = None
        if mixed and self.mixed_residual == "twofloat":
            A0, N0 = levels[0].A, self.dist[0].N
            labels0 = self.dist[0].labels
            by_axis = []
            for a in range(d):
                row = []
                for B in self._distinct(A0, labels0, a):
                    hi, lo = split_f64(B.to(torch.float64))
                    hi = torch.as_tensor(
                        pad_band_1d_identity(hi.cpu().numpy(), N0[a]),
                        device=dev)
                    lo = F.pad(lo, (0, 0, 0, N0[a] - B.shape[0]))
                    row.append((hi, lo))
                by_axis.append(tuple(row))
            self._bands_df0 = tuple(by_axis)

        self.npts = npts_l[0]
        self.N = Ns[0]
        rbgs = self.cfg.smoother.kind == "rbgs"
        tail = levels[self.L_dist:]
        t_lev = levels[self.L_dist - 1]
        self._h = _Ops([_LevelOps(lv, dtype, overlap, rbgs)
                        for lv in self.dist], tail, t_lev.restrict,
                       t_lev.prolong)
        self._h_lo = self._h
        if mixed:
            f32 = torch.float32

            def cast(tbs):
                return tuple(replace(tb, w=tb.w.to(f32)) for tb in tbs)

            self._h_lo = _Ops([_LevelOps(lv, f32, overlap, rbgs)
                               for lv in self.dist],
                              _cast_levels(tail, f32),
                              cast(t_lev.restrict), cast(t_lev.prolong))

    @staticmethod
    def _distinct(A, labels, a):
        """The distinct bands of axis ``a`` in label order."""
        distinct = [None] * (max(labels[a]) + 1)
        for r, term in enumerate(A.terms):
            distinct[labels[a][r]] = term[a]
        return distinct

    # -- fields ------------------------------------------------------------
    def local(self, a_int: torch.Tensor, level: int = 0) -> torch.Tensor:
        """This rank's block of a global interior field of ``level``."""
        lv = self.dist[level]
        pad = [q for a in reversed(range(len(lv.N)))
               for q in (0, lv.N[a] - a_int.shape[a])]
        full = F.pad(a_int, pad)
        return full[tuple(slice(s, s + n) for s, n in
                          zip(local_starts(lv.spec), lv.spec.n_loc))]

    def gather(self, x_loc: torch.Tensor, level: int = 0) -> torch.Tensor:
        """The global interior field of ``level`` from every rank's block,
        on every rank."""
        lv = self.dist[level]
        full = gather_blocks(x_loc, self.grid)
        return full[tuple(slice(0, n) for n in lv.npts)]

    # -- the cycle ---------------------------------------------------------
    def _apply(self, lv: _LevelOps, x):
        if lv.labels is not None:
            return dist_kron_apply(lv.bands, lv.labels, x, lv.spec)
        return dist_spmv(lv.band, x, lv.spec, self.overlap, packed=lv.packed,
                         faces=lv.faces)

    def _smooth(self, h: _Ops, l: int, x, b):
        lv = h.levels[l]
        sm = self.cfg.smoother
        omega, diag = sm.omega, lv.diag
        if sm.kind == "jacobi":
            return x + omega * (b - self._apply(lv, x)) / diag
        if sm.kind == "chebyshev":
            lam_max = self.lams[l]
            lam_min = lam_max / sm.cheb_fraction
            theta = 0.5 * (lam_max + lam_min)
            delta = 0.5 * (lam_max - lam_min)
            z = (b - self._apply(lv, x)) / diag
            dd = z / theta
            x = x + dd
            sigma = theta / delta
            rho = 1.0 / sigma
            for _ in range(sm.cheb_degree - 1):
                z = (b - self._apply(lv, x)) / diag
                rho_new = 1.0 / (2.0 * sigma - rho)
                dd = rho_new * rho * dd + (2.0 * rho_new / delta) * z
                x = x + dd
                rho = rho_new
            return x
        # red-black Gauss–Seidel, colours by the global index
        if lv.labels is not None:
            for color in (0, 1):
                s = self._apply(lv, x) - diag * x
                gs = (b - s) / diag
                x = torch.where(lv.masks[color],
                                (1.0 - omega) * x + omega * gs, x)
            return x
        spec = lv.spec
        for color in (0, 1):
            x = dispatch.rbgs_color(lv.band, pad_and_exchange(x, spec), b,
                                    omega, color, spec.n_loc, spec.pads,
                                    local_starts(spec), packed=lv.packed)
        return x

    def _tail_correction(self, h: _Ops, l: int, r):
        """Gather the residual, restrict it onto the tail, run the serial
        cycle there, prolong, and keep this rank's block."""
        r_int = self.gather(r, l)
        sp_c = h.tail[0].A.space
        b_c = StencilVector.from_interior(
            sp_c, apply_transfer(h.tail_restrict, r_int))
        x_c = StencilVector.zeros(sp_c)
        tail_lams = self.lams[self.L_dist:]
        for _ in range(self.cfg.gamma):
            x_c = cycle(h.tail, 0, x_c, b_c, self.cfg, tail_lams)
        return self.local(apply_transfer(h.tail_prolong, x_c.interior), l)

    def _vcycle(self, h: _Ops, l: int, x, b):
        lv = h.levels[l]
        meta = self.dist[l]
        for _ in range(self.cfg.nu1):
            x = self._smooth(h, l, x, b)
        r = b - self._apply(lv, x)
        if l + 1 < self.L_dist:
            b_c = dist_apply_transfer(meta.restrict, r, lv.spec.axes,
                                      self.grid)
            x_c = torch.zeros_like(b_c)
            for _ in range(self.cfg.gamma):
                x_c = self._vcycle(h, l + 1, x_c, b_c)
            x = dist_apply_transfer(meta.prolong, x_c,
                                    h.levels[l + 1].spec.axes, self.grid,
                                    add=x)
        else:
            x = x + self._tail_correction(h, l, r)
        for _ in range(self.cfg.nu2):
            x = self._smooth(h, l, x, b)
        return x

    def _error_cycles(self, r_lo):
        """``inner_cycles`` low-precision cycles on the error equation,
        chained through the low-precision residual."""
        h = self._h_lo
        e = self._vcycle(h, 0, torch.zeros_like(r_lo), r_lo)
        for _ in range(self.inner_cycles - 1):
            d = r_lo - self._apply(h.levels[0], e)
            e = e + self._vcycle(h, 0, torch.zeros_like(d), d)
        return e

    def _residual_norm(self, x, b):
        lv = self._h.levels[0]
        return dist_norm2(b - self._apply(lv, x), lv.spec)

    def residual_norm(self, x_loc: torch.Tensor,
                      b: Optional[StencilVector] = None) -> float:
        """‖b − A x‖₂ of the padded global system in the problem's dtype
        (f64 under ``mixed``), from the rank's block of ``x`` through the
        distributed operator (the interior residual while the padded
        entries of x are zero, as the solver keeps them)."""
        b = b if b is not None else self.b
        x = x_loc.to(self._h.levels[0].diag.dtype)
        return float(self._residual_norm(x, self.local(b.interior)))

    def _step(self, x, b):
        """One cycle (or, with ``mixed``, one correction with an f64
        residual) → (x, ‖b − A x‖)."""
        if not self.mixed:
            x = self._vcycle(self._h, 0, x, b)
            return x, self._residual_norm(x, b)
        spec0 = self._h.levels[0].spec
        r = b - self._apply(self._h.levels[0], x)
        scale = dist_norm2(r, spec0)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        e = self._error_cycles((r / safe).to(torch.float32))
        x = x + e.to(x.dtype) * safe
        return x, self._residual_norm(x, b)

    def _step_tf(self, xh, xl, rh, rl, rn_prev, bh, bl):
        """One double-word correction from the carried residual (rh, rl)
        and its norm ``rn_prev`` (‖b‖ at the start): K6u scales the hi word
        and adds the correction, the residual is the distributed
        double-word one, its norm K6r and an all_reduce."""
        e = self._error_cycles(dw_update("div", rh, rn_prev))
        xh, xl = dw_update("defect", xh, xl, e, rn_prev)
        spec0 = self.dist[0].spec
        rh, rl = dist_kron_residual_df(self._bands_df0, self.dist[0].labels,
                                       bh, bl, xh, xl, spec0)
        rn = dist_dw_norm2(rh, rl, spec0)
        return xh, xl, rh, rl, rn, rn

    def _fmg_body(self, b):
        h = self._h
        bs = [b]
        for l in range(self.L_dist - 1):
            bs.append(dist_apply_transfer(self.dist[l].restrict, bs[-1],
                                          self.dist[l].spec.axes, self.grid))
        last = self.L_dist - 1
        sp_t = h.tail[0].A.space
        b_tail = StencilVector.from_interior(
            sp_t, apply_transfer(h.tail_restrict, self.gather(bs[-1], last)))
        x_t = fmg(h.tail, b_tail, self.cfg, lams=self.lams[self.L_dist:])
        x = self.local(apply_transfer(h.tail_prolong, x_t.interior), last)
        for l in range(last, -1, -1):
            if l < last:
                x = dist_apply_transfer(self.dist[l].prolong, x,
                                        self.dist[l + 1].spec.axes, self.grid)
            x = self._vcycle(h, l, x, bs[l])
        return x, self._residual_norm(x, b)

    # -- public steps --------------------------------------------------------
    @property
    def twofloat(self) -> bool:
        return self.mixed and self.mixed_residual == "twofloat"

    def step(self, *fields):
        """One cycle on the rank's blocks: ``step(x, b)`` → (x, ‖r‖), or in
        the twofloat mode ``step(xh, xl, rh, rl, rn_prev, bh, bl)`` →
        (xh, xl, rh, rl, ‖r‖)."""
        if self.twofloat:
            return self._step_tf(*fields)[:5]
        return self._step(*fields)

    def fmg_step(self, b_loc):
        """One FMG (nested-iteration) pass on the rank's block of the
        padded right-hand side → (x, ‖r‖)."""
        if self.mixed:
            raise ValueError("FMG is not built for mixed=True (the mixed "
                             "scheme corrects from x=0 each outer step)")
        return self._fmg_body(b_loc)

    def _start(self, b: StencilVector):
        """(state, consts, step, ‖b‖) at x = 0 (‖b‖ of the global interior,
        as the JAX package takes it)."""
        b_loc = self.local(b.interior)
        rn = torch.linalg.vector_norm(b.interior)
        if self.twofloat:
            bh, bl = split_f64(b_loc)
            zero = torch.zeros_like(bh)
            return (zero, zero, bh, bl, rn), (bh, bl), self._step_tf, rn
        return (torch.zeros_like(b_loc),), (b_loc,), self._step, rn

    def _x(self, state):
        return merge_f64(state[0], state[1]) if self.twofloat else state[0]

    def solve(self, b: Optional[StencilVector] = None, tol: float = 1e-10,
              maxiter: int = 50, use_fmg: bool = False) -> SolveResult:
        """Host loop; every rank gets the same history.  ``x`` of the
        result is this rank's block (:meth:`gather` assembles it)."""
        b = b if b is not None else self.b
        if use_fmg and self.twofloat:
            raise ValueError("use_fmg is not available for the mixed "
                             "twofloat solve")
        state, consts, step, rn = self._start(b)
        if use_fmg:
            x, rn = self.fmg_step(consts[0])
            state = (x,)
        residuals = [float(rn)]
        wall = []
        it, converged = 0, residuals[-1] <= tol
        while not converged and it < maxiter:
            t0 = time.perf_counter()
            *state, rn = step(*state, *consts)
            rn = float(rn)
            wall.append(time.perf_counter() - t0)
            residuals.append(rn)
            it += 1
            converged = rn <= tol
        return SolveResult(x=self._x(state), residuals=residuals,
                           iterations=it, converged=converged,
                           wall_times=wall)

    def solve_compiled(self, b: Optional[StencilVector] = None,
                       tol: float = 1e-10, maxiter: int = 50):
        """The cycles of :meth:`solve` without the history → (x, rn, it),
        ``x`` this rank's block.  On CPU tensors the eager loop; under NCCL
        one step captured as a CUDA graph (``mg/graph.py``) and replayed per
        cycle; under gloo on CUDA tensors it raises: gloo's collectives
        cannot be captured, and nothing runs eager in their place."""
        b = b if b is not None else self.b
        state, consts, step, rn = self._start(b)
        dev = state[0].device
        if dev.type == "cuda":
            if self.grid.backend != "nccl":
                raise RuntimeError(
                    f"solve_compiled captures a CUDA graph; "
                    f"{self.grid.backend} collectives cannot be captured "
                    "(use backend='nccl', or solve())")
            key = "dist-tf" if self.twofloat else "dist"
            state, rn, it = _graph_loop(self, key, step, list(state), consts,
                                        rn, tol, maxiter)
            x = self._x(state)
            return (x if self.twofloat else x.clone()), rn, it
        it = 0
        while float(rn) > tol and it < maxiter:
            *state, rn = step(*state, *consts)
            it += 1
        return self._x(state), rn, it
