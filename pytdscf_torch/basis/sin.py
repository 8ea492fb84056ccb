"""Sine (particle-in-a-box) DVR.

Analytic grids, unitary and derivative matrices per the MCTDH review
(Phys. Rep. 324, 1 (2000), App. B.4.2).  Behavioural parity target:
``PyTDSCF:pytdscf/basis/sin.py`` (same endpoint conventions,
including the ``include_terminal`` margin trick).
"""

from __future__ import annotations

import numpy as np

from pytdscf_torch import units as _units
from pytdscf_torch.basis.abc import DVRPrimitivesMixin


class Sine(DVRPrimitivesMixin):
    r"""Sine DVR: φ_j(x) = √(2/L) sin(jπ(x−x₀)/L), j = 1..N.

    The grid is equidistant, x_α = x₀ + α·Δx with Δx = L/(N+1); terminal
    points x₀ and x₀+L are not part of the grid.

    Args:
        ngrid: number of grid points (excluding terminals).
        length: box length.
        x0: left wall position.
        units: unit of ``length``/``x0`` — ``angstrom`` (default) or ``au``.
        include_terminal: if True, ``length`` is reinterpreted so the given
            interval endpoints coincide with the outermost *grid* points.
    """

    def __init__(
        self,
        ngrid: int,
        length: float,
        x0: float = 0.0,
        units: str = "angstrom",
        include_terminal: bool = True,
    ):
        super().__init__(ngrid)
        u = units.lower()
        if u in ("angstrom", "å"):
            self.L = length / _units.au_in_angstrom
            self.x0 = x0 / _units.au_in_angstrom
        elif u in ("bohr", "a.u.", "au"):
            self.L = length
            self.x0 = x0
        else:
            raise NotImplementedError(f"units {units}")
        if include_terminal:
            dx = self.L / (ngrid - 1)
            self.x0 -= dx
            self.L = (ngrid + 1) * dx
        self.label = "Sine"
        self.deltax = self.L / (self.ngrid + 1)

    def fbr_func(self, n: int, x):
        if not (0 <= n < self.ngrid):
            raise ValueError(f"n={n} out of [0, {self.ngrid})")
        x = np.asarray(x, dtype=float)
        inside = (self.x0 <= x) & (x <= self.x0 + self.L)
        return (
            np.sqrt(2.0 / self.L)
            * np.sin((n + 1) * np.pi * (x - self.x0) / self.L)
            * inside
        )

    def get_pos_rep_matrix(self) -> np.ndarray:
        """Transformed position ẑ = cos(π(x−x₀)/L): tridiagonal with ½."""
        off = 0.5 * np.ones(self.ngrid - 1)
        return np.diag(off, 1) + np.diag(off, -1)

    def get_1st_derivative_matrix_fbr(self) -> np.ndarray:
        """⟨φ_j|d/dx|φ_k⟩ = (4/L)·jk/(j²−k²) for j−k odd, antisymmetric."""
        j = np.arange(1, self.ngrid + 1)[:, None].astype(float)
        k = np.arange(1, self.ngrid + 1)[None, :].astype(float)
        with np.errstate(divide="ignore", invalid="ignore"):
            mat = 4.0 / self.L * j * k / (j**2 - k**2)
        mat[((j - k) % 2 == 0)] = 0.0
        np.fill_diagonal(mat, 0.0)
        return mat

    def get_2nd_derivative_matrix_fbr(self) -> np.ndarray:
        """Diagonal: −(jπ/L)²."""
        j = np.arange(1, self.ngrid + 1)
        return -np.diag((np.pi * j / self.L) ** 2)

    def get_2nd_derivative_matrix_dvr(self) -> np.ndarray:
        """Analytic sine-DVR d² matrix (Colbert–Miller style)."""
        if not hasattr(self, "second_derivative_matrix_dvr"):
            n1 = self.ngrid + 1
            a = np.arange(1, self.ngrid + 1)
            ap = a * np.pi / n1
            sin_a = np.sin(ap)
            cos_a = np.cos(ap)
            diff = cos_a[:, None] - cos_a[None, :]
            with np.errstate(divide="ignore", invalid="ignore"):
                off = (
                    2.0
                    * (-1.0) ** (a[:, None] - a[None, :])
                    / n1**2
                    * sin_a[:, None]
                    * sin_a[None, :]
                    / diff**2
                )
            diag = 1.0 / 3.0 + 1.0 / (6.0 * n1**2) - 1.0 / (
                2.0 * (n1 * sin_a) ** 2
            )
            mat = off
            np.fill_diagonal(mat, diag)
            self.second_derivative_matrix_dvr = (
                -((np.pi / self.deltax) ** 2) * mat
            )
        return self.second_derivative_matrix_dvr

    def diagonalize_pos_rep_matrix(self) -> None:
        """Analytic: U_{jα} = √(2/(N+1)) sin(jαπ/(N+1)), x_α = x₀ + αΔx."""
        if not hasattr(self, "grids"):
            n1 = self.ngrid + 1
            j = np.arange(1, self.ngrid + 1)
            self.unitary = np.sqrt(2.0 / n1) * np.sin(
                np.outer(j, j) * np.pi / n1
            )
            self.grids = [self.x0 + a * self.deltax for a in range(1, n1)]
            self.sqrt_weights = [np.sqrt(self.deltax)] * self.ngrid
