"""Exponential (plane-wave / FFT) DVR for periodic coordinates.

Analytic first/second DVR derivative matrices per Colbert–Miller
(J. Chem. Phys. 96, 1982 (1992)) and Meyer (J. Chem. Phys. 52, 2053 (1969)).
Behavioural parity target: ``PyTDSCF:pytdscf/basis/exponential.py``.
"""

from __future__ import annotations

import numpy as np

from pytdscf_torch.basis.abc import DVRPrimitivesMixin


class Exponential(DVRPrimitivesMixin):
    r"""φ_j(x) = exp(i·2πj(x−x₀)/L)/√L with j = 0, ±1, …, ±(N−1)/2.

    ``ngrid`` must be odd.  Grid is equidistant with Δx = L/N starting at x₀.
    """

    def __init__(self, ngrid: int, length: float, x0: float = 0.0):
        if ngrid % 2 == 0:
            raise ValueError("ngrid must be odd for Exponential DVR")
        super().__init__(ngrid)
        self.x0 = x0
        self.L = length
        self.label = "Exponential"
        self.deltax = self.L / self.ngrid

    def fbr_func(self, n: int, x):
        j = n - self.ngrid // 2
        return np.exp(
            1j * 2.0 * np.pi * j * (np.asarray(x, dtype=float) - self.x0) / self.L
        ) / np.sqrt(self.L)

    def get_pos_rep_matrix(self) -> np.ndarray:
        r"""Analytic FBR position matrix ⟨φ_m|x̂|φ_n⟩ on [x₀, x₀+L].

        Diagonal x₀ + L/2; off-diagonal −iL/(2π(n−m)) (sawtooth-x Fourier
        coefficients).  The reference leaves this NotImplemented
        (``basis/exponential.py:93``) since the analytic grid construction
        never needs it; provided for completeness, quadrature-tested.
        """
        if not hasattr(self, "pos_rep_matrix"):
            n = np.arange(self.ngrid)
            k = n[None, :] - n[:, None]  # n − m
            with np.errstate(divide="ignore", invalid="ignore"):
                mat = -1j * self.L / (2.0 * np.pi * k)
            np.fill_diagonal(mat, self.x0 + self.L / 2.0)
            self.pos_rep_matrix = mat
        return self.pos_rep_matrix

    def get_1st_derivative_matrix_dvr(self) -> np.ndarray:
        if not hasattr(self, "first_derivative_matrix_dvr"):
            a = np.arange(self.ngrid)
            d = a[:, None] - a[None, :]
            with np.errstate(divide="ignore", invalid="ignore"):
                mat = np.pi / self.L * (-1.0) ** d / np.sin(np.pi * d / self.ngrid)
            np.fill_diagonal(mat, 0.0)
            self.first_derivative_matrix_dvr = mat
        return self.first_derivative_matrix_dvr

    def get_1st_derivative_matrix_fbr(self) -> np.ndarray:
        u = self.get_unitary()
        return u @ self.get_1st_derivative_matrix_dvr() @ u.T

    def get_2nd_derivative_matrix_dvr(self) -> np.ndarray:
        if not hasattr(self, "second_derivative_matrix_dvr"):
            n = self.ngrid
            a = np.arange(n)
            d = a[:, None] - a[None, :]
            with np.errstate(divide="ignore", invalid="ignore"):
                mat = (
                    -2.0
                    * np.pi**2
                    / self.L**2
                    * (-1.0) ** d
                    * np.cos(np.pi * d / n)
                    / np.sin(np.pi * d / n) ** 2
                )
            np.fill_diagonal(mat, -(np.pi**2) / 3.0 / self.L**2 * (n**2 - 1))
            self.second_derivative_matrix_dvr = mat
        return self.second_derivative_matrix_dvr

    def get_2nd_derivative_matrix_fbr(self) -> np.ndarray:
        u = self.get_unitary()
        return u @ self.get_2nd_derivative_matrix_dvr() @ u.T

    def diagonalize_pos_rep_matrix(self) -> None:
        """Set equidistant grids and the FBR→DVR transform analytically."""
        if not hasattr(self, "grids"):
            self.grids = [self.x0 + a * self.deltax for a in range(self.ngrid)]
            self.sqrt_weights = [np.sqrt(self.deltax)] * self.ngrid
            j = np.arange(self.ngrid)
            x = np.asarray(self.grids)
            self.unitary = np.conjugate(
                np.exp(
                    1j
                    * 2.0
                    * np.pi
                    * (j[:, None] - self.ngrid // 2)
                    * (x[None, :] - self.x0)
                    / self.L
                )
                / np.sqrt(self.L)
            )
