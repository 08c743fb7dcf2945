"""E(3)-equivariant substrate: real spherical harmonics (l <= 2 explicit,
orthonormal) + real-basis Clebsch-Gordan coupling tensors, from scratch
(no e3nn dependency).  The numpy half (CG, Wigner-D, rotations) is the
reference's, line for line; the spherical harmonics and the radial basis
run on tensors.

CG path: complex CG via the Racah formula -> real basis via the standard
unitary change-of-basis U(l); combinations with odd l1+l2+l3 come out purely
imaginary in the real basis and are rotated by -i (a global phase that
preserves equivariance).  Wigner-D matrices for tests are built recursively
from the CG tensors themselves, so equivariance tests are self-consistent.
"""
from __future__ import annotations

import functools
from math import factorial, sqrt

import numpy as np
import torch


# ----------------------------------------------------------- complex CG
def _cg_coeff(j1: int, m1: int, j2: int, m2: int, j3: int, m3: int) -> float:
    """<j1 m1 j2 m2 | j3 m3> (Racah's formula, float64)."""
    if m3 != m1 + m2:
        return 0.0
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    if abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3:
        return 0.0
    f = factorial
    pre = sqrt((2 * j3 + 1) * f(j3 + j1 - j2) * f(j3 - j1 + j2)
               * f(j1 + j2 - j3) / f(j1 + j2 + j3 + 1))
    pre *= sqrt(f(j3 + m3) * f(j3 - m3) * f(j1 - m1) * f(j1 + m1)
                * f(j2 - m2) * f(j2 + m2))
    s = 0.0
    for k in range(0, j1 + j2 - j3 + 1):
        denom_args = [k, j1 + j2 - j3 - k, j1 - m1 - k, j2 + m2 - k,
                      j3 - j2 + m1 + k, j3 - j1 - m2 + k]
        if any(a < 0 for a in denom_args):
            continue
        d = 1.0
        for a in denom_args:
            d *= f(a)
        s += (-1.0) ** k / d
    return pre * s


def _u_real(l: int) -> np.ndarray:
    """U s.t. Y_real = U @ Y_complex; rows ordered m = -l..l (real basis),
    columns m' = -l..l (complex basis)."""
    u = np.zeros((2 * l + 1, 2 * l + 1), np.complex128)
    for m in range(-l, l + 1):
        i = m + l
        if m < 0:
            u[i, -m + l] = 1j / sqrt(2) * (-1) ** m * (-1)
            u[i, m + l] = 1j / sqrt(2)
        elif m == 0:
            u[i, l] = 1.0
        else:
            u[i, m + l] = (-1) ** m / sqrt(2)
            u[i, -m + l] = 1 / sqrt(2)
    return u


@functools.lru_cache(maxsize=None)
def clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis coupling tensor C (2l1+1, 2l2+1, 2l3+1), float64.

    Contracting two equivariant features with C yields an l3-equivariant
    feature:  (x ⊗ y · C) transforms with D^{l3}.
    """
    cx = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1), np.complex128)
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) <= l3:
                cx[m1 + l1, m2 + l2, m3 + l3] = _cg_coeff(
                    l1, m1, l2, m2, l3, m3)
    u1, u2, u3 = _u_real(l1), _u_real(l2), _u_real(l3)
    real = np.einsum("ia,jb,kc,abc->ijk", u1, u2, np.conj(u3), cx)
    if np.abs(real.imag).max() > np.abs(real.real).max():
        real = real * (-1j)  # odd-parity combos: rotate the global phase
    assert np.abs(real.imag).max() < 1e-10, (l1, l2, l3)
    return np.ascontiguousarray(real.real)


# ------------------------------------------------- real spherical harmonics
SH_DIM = {0: 1, 1: 3, 2: 5}


def spherical_harmonics(vec, l_max: int = 2, eps: float = 1e-9):
    """vec (..., 3) -> dict l -> (..., 2l+1) orthonormal real SH of vec/|vec|.

    l=1 component order (y, z, x); l=2 order (xy, yz, 3z²-1, xz, x²-y²),
    matching the m = -l..l real-basis convention used by clebsch_gordan.
    """
    r = torch.sqrt((vec * vec).sum(-1, keepdim=True))
    u = vec / torch.clamp(r, min=eps)
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    out = {0: torch.full(vec.shape[:-1] + (1,), 0.28209479177387814,
                         dtype=vec.dtype, device=vec.device)}
    if l_max >= 1:
        c1 = 0.48860251190291992
        out[1] = torch.stack([c1 * y, c1 * z, c1 * x], dim=-1)
    if l_max >= 2:
        c2a = 1.0925484305920792   # xy, yz, xz
        c2b = 0.31539156525252005  # 3z^2 - 1
        c2c = 0.54627421529603959  # x^2 - y^2
        out[2] = torch.stack([
            c2a * x * y,
            c2a * y * z,
            c2b * (3 * z * z - 1.0),
            c2a * x * z,
            c2c * (x * x - y * y),
        ], dim=-1)
    return out


# ------------------------------------------------------ Wigner-D (for tests)
def wigner_d(l: int, R: np.ndarray) -> np.ndarray:
    """D^l(R) in the real basis, built recursively from CG tensors."""
    if l == 0:
        return np.ones((1, 1))
    P = np.zeros((3, 3))
    P[0, 1] = 1.0  # y
    P[1, 2] = 1.0  # z
    P[2, 0] = 1.0  # x
    d1 = P @ R @ P.T
    if l == 1:
        return d1
    dprev = wigner_d(l - 1, R)
    c = clebsch_gordan(l - 1, 1, l)  # (2l-1, 3, 2l+1)
    num = np.einsum("abk,ai,bj,ijn->kn", c, dprev, d1, c)
    den = np.einsum("abk,abn->kn", c, c)
    return num @ np.linalg.inv(den)


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


# ---------------------------------------------------------- radial basis
def bessel_basis(r, n_rbf: int, cutoff: float):
    """DimeNet/NequIP-style spherical Bessel radial basis with smooth cutoff.
    r (...,) -> (..., n_rbf)."""
    rc = r / cutoff
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    rb = (2.0 / cutoff) ** 0.5 * torch.sin(
        torch.pi * n * rc[..., None]) / torch.clamp(r[..., None], min=1e-9)
    # polynomial envelope (p=6)
    p = 6.0
    env = (1.0 - (p + 1) * (p + 2) / 2 * rc ** p
           + p * (p + 2) * rc ** (p + 1) - p * (p + 1) / 2 * rc ** (p + 2))
    env = torch.where(rc < 1.0, env, 0.0)
    return rb * env[..., None]
