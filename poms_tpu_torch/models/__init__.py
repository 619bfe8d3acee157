"""Problem definitions: B-spline assembly and the Poisson model."""
