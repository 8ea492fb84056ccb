"""Harmonic-oscillator FBR primitives and HO-DVR.

Physics follows the MCTDH review (Phys. Rep. 324, 1 (2000), App. B) in
mass-weighted coordinates (ħ = m = 1): the dimensionless coordinate is
``ζ = √ω (q − q_eq)``.  Behavioural parity target:
``PyTDSCF:pytdscf/basis/ho.py`` (analytic tridiagonal position matrix,
analytic FBR derivative matrices, weight-sign-fixed DVR unitary).
"""

from __future__ import annotations

import math

import numpy as np

from pytdscf_torch import units as _units
from pytdscf_torch.basis.abc import DVRPrimitivesMixin


def _omega_au(omega: float, units: str) -> float:
    u = units.lower()
    if u in ("cm1", "cm-1", "kaiser"):
        return omega / _units.au_in_cm1
    if u in ("au", "hartree", "a.u."):
        return omega
    if u == "ev":
        return omega / _units.au_in_eV
    raise ValueError(f"units must be cm-1 / au / eV, got {units}")


class HarmonicOscillator(DVRPrimitivesMixin):
    """HO eigenfunction FBR with DVR obtained from the position matrix.

    Args:
        ngrid: number of basis functions = number of grid points.
        omega: harmonic frequency (see ``units``).
        q_eq: equilibrium position, mass-weighted a.u. (or dimensionless if
            ``dimensionless=True``).
        units: unit of ``omega`` — ``cm-1`` (default), ``au`` or ``eV``.
    """

    def __init__(
        self,
        ngrid: int,
        omega: float,
        q_eq: float = 0.0,
        units: str = "cm-1",
        dimensionless: bool = False,
    ):
        super().__init__(ngrid)
        self.omega = _omega_au(omega, units)
        self.freq_cm1 = self.omega * _units.au_in_cm1
        self.q_eq = q_eq / math.sqrt(self.omega) if dimensionless else q_eq
        self.origin = q_eq
        self.label = "HO"

    # ------------------------------------------------------------------ FBR
    def fbr_func(self, n: int, q):
        if not (0 <= n < self.ngrid):
            raise ValueError(f"n={n} out of [0, {self.ngrid})")
        zeta = math.sqrt(self.omega) * (np.asarray(q, dtype=float) - self.q_eq)
        norm = (
            (self.omega / math.pi) ** 0.25
            / math.sqrt(math.factorial(n) * 2.0**n)
        )
        return norm * _hermite(n, zeta) * np.exp(-(zeta**2) / 2.0)

    def get_pos_rep_matrix(self) -> np.ndarray:
        """⟨φ_j|q̂|φ_k⟩ = √((j+1)/2ω) δ_{j,k−1} + q_eq δ_{jk} + h.c."""
        if not hasattr(self, "pos_rep_matrix"):
            off = np.sqrt(np.arange(1, self.ngrid) / (2.0 * self.omega))
            mat = np.diag(np.full(self.ngrid, self.q_eq, dtype=complex))
            mat += np.diag(off.astype(complex), 1)
            mat += np.diag(off.astype(complex), -1)
            self.pos_rep_matrix = mat
        return self.pos_rep_matrix

    def get_1st_derivative_matrix_fbr(self) -> np.ndarray:
        """⟨φ_j|d/dq|φ_k⟩ = −√(ω/2)(√(j+1) δ_{j,k−1} − √j δ_{j,k+1})."""
        off = -np.sqrt(self.omega * np.arange(1, self.ngrid) / 2.0)
        return np.diag(off, 1) - np.diag(off, -1)

    def get_2nd_derivative_matrix_fbr(self) -> np.ndarray:
        """⟨φ_j|d²/dq²|φ_k⟩ (tridiagonal-in-steps-of-2, analytic)."""
        diag = -self.omega / 2.0 * (2.0 * np.arange(self.ngrid) + 1.0)
        j = np.arange(1, self.ngrid - 1)
        off2 = self.omega / 2.0 * np.sqrt(j * (j + 1.0))
        return np.diag(diag) + np.diag(off2, 2) + np.diag(off2, -2)

    # ----------------------------------------------------------- extras
    def get_ovi_CS_HO(self, p: float, q: float, type: str = "DVR") -> np.ndarray:
        """Overlap ⟨coherent-state(p, q)|HO_v⟩ (mass-weighted a.u.)."""
        z = math.sqrt(self.omega * 0.5) * (q + 1j * p / self.omega)
        v = np.arange(self.nprim)
        log_fact = np.cumsum(np.concatenate([[0.0], np.log(np.arange(1, self.nprim))])) if self.nprim > 1 else np.zeros(1)
        ints = np.exp(-0.5 * abs(z) ** 2) * z**v / np.exp(0.5 * log_fact)
        if type.upper() == "DVR":
            return np.conjugate(self.get_unitary().T) @ ints
        if type.upper() == "FBR":
            return ints
        raise ValueError(f"type must be 'DVR' or 'FBR', got {type}")


def _hermite(n: int, x):
    """Physicists' Hermite polynomial H_n(x) by upward recurrence."""
    x = np.asarray(x, dtype=float)
    h_prev = np.ones_like(x)
    if n == 0:
        return h_prev
    h = 2.0 * x
    for k in range(1, n):
        h, h_prev = 2.0 * x * h - 2.0 * k * h_prev, h
    return h


class PrimBas_HO:
    """HO-eigenfunction FBR primitive (used for FBR-mode models).

    Args:
        origin: center of the Hermite functions, dimensionless by default.
        freq_cm1: frequency ω in cm⁻¹.
        nprim: number of primitives.
        origin_is_dimless: if ``True``, ``origin`` is ζ-scale; otherwise
            mass-weighted a.u.
    """

    def __init__(
        self,
        origin: float,
        freq_cm1: float,
        nprim: int,
        origin_is_dimless: bool = True,
    ):
        self.freq_cm1 = freq_cm1
        self.nprim = nprim
        self.freq_au = freq_cm1 / _units.au_in_cm1
        if origin_is_dimless:
            self.origin = origin
            self.origin_mwc = origin / math.sqrt(self.freq_au)
        else:
            self.origin_mwc = origin
            self.origin = origin * math.sqrt(self.freq_au)

    def __len__(self) -> int:
        return self.nprim

    def todvr(self) -> HarmonicOscillator:
        return HarmonicOscillator(
            ngrid=self.nprim, omega=self.freq_cm1, q_eq=self.origin
        )
