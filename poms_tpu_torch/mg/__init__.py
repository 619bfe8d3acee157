"""Multigrid: hierarchy, smoothers, cycles and the preconditioned CG solver."""
