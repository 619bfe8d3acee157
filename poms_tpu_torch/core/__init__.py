"""Stencil spaces, halo-padded vectors and Kronecker-sum operators."""
