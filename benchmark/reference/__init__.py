"""The plain reference the benchmark judges the program's solutions by.

NumPy and plain PyTorch only: it imports neither ``jax`` nor the JAX package
nor anything of ``poms_tpu_torch``, and takes nothing the program made.

- :mod:`.rhs`: the seeded right-hand sides that both the program and the
  reference are given;
- :mod:`.check`: the f64 residual of a solution;
- ``kinds/<kind>.py``: what one problem kind is to these two, found by the
  configuration's ``problem.kind`` (``poisson`` where it names none): its
  operator, its 1D loads, the sign a mirror puts on a mode, the ‖b‖₂ every
  source is scaled to.  A new problem kind is a new file there;
- :mod:`.bspline`, :mod:`.operator`: the 1D B-spline bands and loads (open
  uniform knots, homogeneous Dirichlet conditions) and the Kronecker-sum
  stiffness operator of 1, 2 or 3 axes in f64, which the ``poisson`` kind
  uses.
"""
