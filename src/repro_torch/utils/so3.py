"""SO(3) machinery for MACE: the port's copy of the reference's
``utils/so3.py``.  Real spherical harmonics (l <= 3) of torch tensors and
real Clebsch-Gordan (Wigner-3j-style) coupling coefficients.

Complex CG coefficients come from the Racah closed form; real-basis
coefficients are obtained by conjugating with the standard complex->real
spherical-harmonic unitary (numpy float64, as in the reference).  For
integer l the result is purely real (or purely imaginary, fixed by an
i^{l1+l2-l3} phase); ``real_cg`` asserts that the imaginary residue is ~0.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

# --------------------------------------------------------------------------
# complex Clebsch-Gordan (Racah formula)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _fact(n: int) -> float:
    return math.factorial(n)


def cg_complex(j1, m1, j2, m2, j3, m3) -> float:
    """<j1 m1 j2 m2 | j3 m3> (Condon-Shortley)."""
    if m3 != m1 + m2:
        return 0.0
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    if abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3:
        return 0.0
    pref = math.sqrt(
        (2 * j3 + 1) * _fact(j3 + j1 - j2) * _fact(j3 - j1 + j2)
        * _fact(j1 + j2 - j3) / _fact(j1 + j2 + j3 + 1))
    pref *= math.sqrt(
        _fact(j3 + m3) * _fact(j3 - m3) * _fact(j1 - m1) * _fact(j1 + m1)
        * _fact(j2 - m2) * _fact(j2 + m2))
    s = 0.0
    for k in range(0, j1 + j2 - j3 + 1):
        d1 = j1 + j2 - j3 - k
        d2 = j1 - m1 - k
        d3 = j2 + m2 - k
        d4 = j3 - j2 + m1 + k
        d5 = j3 - j1 - m2 + k
        if min(d1, d2, d3, d4, d5) < 0:
            continue
        s += (-1) ** k / (_fact(k) * _fact(d1) * _fact(d2) * _fact(d3)
                          * _fact(d4) * _fact(d5))
    return pref * s


# --------------------------------------------------------------------------
# complex -> real spherical-harmonic change of basis
# --------------------------------------------------------------------------


def real_basis_matrix(l: int) -> np.ndarray:
    """U[l] with  Y_real = U @ Y_complex  (rows: m_real = -l..l)."""
    dim = 2 * l + 1
    U = np.zeros((dim, dim), np.complex128)
    s2 = 1.0 / math.sqrt(2.0)
    for m in range(-l, l + 1):
        r = m + l  # row index for real m
        if m < 0:
            U[r, l + m] = 1j * s2
            U[r, l - m] = -1j * s2 * (-1) ** m
        elif m == 0:
            U[r, l] = 1.0
        else:
            U[r, l - m] = s2
            U[r, l + m] = s2 * (-1) ** m
    return U


@functools.lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis coupling tensor C[m1, m2, m3] (float64).

    Satisfies:  (Y_{l1} outer Y_{l2}) : C  transforms as Y_{l3}.
    """
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    Cc = np.zeros((d1, d2, d3), np.complex128)
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) <= l3:
                Cc[m1 + l1, m2 + l2, m3 + l3] = cg_complex(
                    l1, m1, l2, m2, l3, m3)
    U1, U2, U3 = (real_basis_matrix(l) for l in (l1, l2, l3))
    # C_real = U1* x U2* x U3 applied to C_complex
    C = np.einsum("ai,bj,ijk,ck->abc", np.conj(U1), np.conj(U2), Cc, U3)
    # integer-l coupling is real up to a global i^{l1+l2+l3} phase
    if np.abs(C.imag).max() > np.abs(C.real).max():
        C = (C / 1j)
    assert np.abs(C.imag).max() < 1e-10, (l1, l2, l3, np.abs(C.imag).max())
    return np.ascontiguousarray(C.real)


# --------------------------------------------------------------------------
# real spherical harmonics of unit vectors (l <= 3, racah normalization)
# --------------------------------------------------------------------------


def spherical_harmonics(vec: torch.Tensor, l_max: int) -> torch.Tensor:
    """vec [..., 3] (unit vectors) -> [..., (l_max+1)^2], in vec's dtype.

    Racah normalization (Y_0 = 1), matching e3nn's 'integral'-free
    convention used by MACE: components are polynomials in (x, y, z), in
    e3nn's component order (l = 1 is (y, z, x)), as the reference's.
    """
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    out = [torch.ones_like(x)]  # l = 0
    if l_max >= 1:
        out += [y, z, x]     # l = 1 (e3nn component order)
    if l_max >= 2:
        s3 = math.sqrt(3.0)
        out += [
            s3 * x * y,
            s3 * y * z,
            0.5 * (3 * z * z - 1.0),
            s3 * x * z,
            0.5 * s3 * (x * x - y * y),
        ]
    if l_max >= 3:
        s = math.sqrt
        out += [
            s(5.0 / 8.0) * y * (3 * x * x - y * y),
            s(15.0) * x * y * z,
            s(3.0 / 8.0) * y * (5 * z * z - 1),
            0.5 * z * (5 * z * z - 3),
            s(3.0 / 8.0) * x * (5 * z * z - 1),
            0.5 * s(15.0) * z * (x * x - y * y),
            s(5.0 / 8.0) * x * (x * x - 3 * y * y),
        ]
    return torch.stack(out, dim=-1)


def irrep_slices(l_max: int):
    """[(l, start, stop)] into the flattened (l_max+1)^2 axis."""
    out, off = [], 0
    for l in range(l_max + 1):
        out.append((l, off, off + 2 * l + 1))
        off += 2 * l + 1
    return out
