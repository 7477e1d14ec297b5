"""SO(3) algebra: real spherical harmonics (l <= 2) on torch tensors and real
Clebsch-Gordan coefficients, computed numerically from the complex CG
(Racah formula) and the real-to-complex change of basis.

Counterpart of ``repro.models.gnn.so3``.  Conventions as there: e3nn real-SH
component order m = -l..l, vectors as l = 1 in (y, z, x) order.  The CG
tensors are numpy constants; this module keeps its own copy of their
construction, so the port computes them bit for bit as the reference does.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

import repro_torch.device  # noqa: F401  (the float32 backend flags)


# ---------------------------------------------------------------------------
# real spherical harmonics (component normalization, e3nn order)
# ---------------------------------------------------------------------------
def real_sph_harm_l1(vec: torch.Tensor) -> torch.Tensor:
    """l=1 real SH of unit vectors: (..., 3) -> (..., 3) in (y, z, x) order."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    return torch.stack([y, z, x], dim=-1)


def real_sph_harm_l2(vec: torch.Tensor) -> torch.Tensor:
    """l=2 real SH (component-normalized, e3nn order m=-2..2)."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    s3 = math.sqrt(3.0)
    return torch.stack([
        s3 * x * y,
        s3 * y * z,
        0.5 * (3 * z * z - 1.0),          # (3z^2 - r^2)/2 for unit r
        s3 * x * z,
        0.5 * s3 * (x * x - y * y),
    ], dim=-1)


def sph_harm_all(vec: torch.Tensor, l_max: int) -> dict:
    """dict l -> (..., 2l+1) for unit vectors ``vec`` (..., 3)."""
    if l_max >= 3:
        raise NotImplementedError("l_max <= 2")
    out = {0: torch.ones(vec.shape[:-1] + (1,), dtype=vec.dtype,
                         device=vec.device)}
    if l_max >= 1:
        out[1] = real_sph_harm_l1(vec)
    if l_max >= 2:
        out[2] = real_sph_harm_l2(vec)
    return out


# ---------------------------------------------------------------------------
# complex Clebsch-Gordan via the Racah formula (numpy, host constants)
# ---------------------------------------------------------------------------
def _fact(n):
    return math.factorial(int(n))


def _cg_complex(j1, m1, j2, m2, j3, m3) -> float:
    if m3 != m1 + m2:
        return 0.0
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    pref = math.sqrt(
        (2 * j3 + 1)
        * _fact(j3 + j1 - j2) * _fact(j3 - j1 + j2) * _fact(j1 + j2 - j3)
        / _fact(j1 + j2 + j3 + 1)
    )
    pref *= math.sqrt(
        _fact(j3 + m3) * _fact(j3 - m3)
        * _fact(j1 - m1) * _fact(j1 + m1)
        * _fact(j2 - m2) * _fact(j2 + m2)
    )
    total = 0.0
    for k in range(0, j1 + j2 + j3 + 2):
        denoms = [
            k,
            j1 + j2 - j3 - k,
            j1 - m1 - k,
            j2 + m2 - k,
            j3 - j2 + m1 + k,
            j3 - j1 - m2 + k,
        ]
        if any(d < 0 for d in denoms):
            continue
        total += (-1) ** k / np.prod([float(_fact(d)) for d in denoms])
    return pref * total


def _real_to_complex_U(l: int) -> np.ndarray:
    """U s.t. |l, m_real> = sum_m U[m_real, m] |l, m_complex> (e3nn phases)."""
    u = np.zeros((2 * l + 1, 2 * l + 1), dtype=complex)
    isq = 1.0 / math.sqrt(2.0)
    for m in range(-l, l + 1):
        i = m + l
        if m < 0:
            u[i, l + m] = 1j * isq
            u[i, l - m] = -1j * isq * (-1) ** m
        elif m == 0:
            u[i, l] = 1.0
        else:
            u[i, l - m] = isq
            u[i, l + m] = isq * (-1) ** m
    return u


@functools.lru_cache(maxsize=None)
def cg_real(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real CG tensor (2l1+1, 2l2+1, 2l3+1), component-normalized so that
    coupling two component-normalized irreps yields a component-normalized
    irrep.  Cached; pure numpy (a host constant).  Callers must not write
    into the array they get."""
    u1, u2, u3 = (_real_to_complex_U(l) for l in (l1, l2, l3))
    c = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1), dtype=complex)
    for mu1 in range(-l1, l1 + 1):
        for mu2 in range(-l2, l2 + 1):
            mu3 = mu1 + mu2
            if abs(mu3) > l3:
                continue
            c[mu1 + l1, mu2 + l2, mu3 + l3] = _cg_complex(
                l1, mu1, l2, mu2, l3, mu3)
    # transform to the real basis:  C_real = U1 C U2 U3^dagger (contract m's)
    c_real = np.einsum("au,bv,uvw,cw->abc", u1, u2, c, u3.conj())
    # e3nn phase convention keeps these real up to a global phase:
    if np.abs(c_real.imag).max() > 1e-10:
        c_real = (c_real * (-1j)).real if np.abs(
            (c_real * (-1j)).imag).max() < 1e-10 else c_real.real
    else:
        c_real = c_real.real
    # component normalization: scale so sum of squares = (2 l3 + 1)
    norm = np.sqrt((c_real ** 2).sum())
    if norm > 1e-12:
        c_real = c_real * math.sqrt(2 * l3 + 1) / norm
    return np.ascontiguousarray(c_real)


__all__ = ["cg_real", "real_sph_harm_l1", "real_sph_harm_l2", "sph_harm_all"]
