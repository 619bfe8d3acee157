"""Benchmark entry points for the card."""
