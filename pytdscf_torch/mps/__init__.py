"""MPS engine: kernels, integrators, TDVP sweeps."""
