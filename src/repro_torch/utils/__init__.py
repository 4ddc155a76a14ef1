"""Numerical helpers of the port's models (``so3``: MACE's spherical
harmonics and coupling coefficients)."""
