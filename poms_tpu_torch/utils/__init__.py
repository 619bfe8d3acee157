"""Convergence logging and checkpoint/resume of solver state."""
