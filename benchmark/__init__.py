"""The benchmark of poms_tpu_torch on one NVIDIA card: closed-loop solves of
B-spline Poisson problems (of 1, 2 or 3 axes) to a fixed residual, driven by
the cells that ``BENCHMARK.json`` names (see ``run.py``)."""
