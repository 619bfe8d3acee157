"""The plain reference the benchmark judges the program's solutions by.

NumPy and plain PyTorch only: it imports neither ``jax`` nor the JAX package
nor anything of ``poms_tpu_torch``, and takes nothing the program made.

- :mod:`.bspline`: the 1D B-spline stiffness and mass bands and load vectors
  (Gauss quadrature over the knot spans of an open uniform knot vector,
  homogeneous Dirichlet conditions);
- :mod:`.operator`: the 3D Kronecker-sum stiffness operator applied in f64;
- :mod:`.rhs`: the seeded right-hand sides that both the program and the
  reference are given;
- :mod:`.check`: the f64 residual of a solution.
"""
