"""The benchmark of poms_tpu_torch on one NVIDIA card: closed-loop solves of
3D B-spline Poisson to a fixed residual, driven by the cells that
``BENCHMARK.json`` names (see ``run.py``)."""
