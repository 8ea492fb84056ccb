"""Abstract DVR primitive basis.

Rebuild of the reference DVR layer
(``PyTDSCF:pytdscf/basis/abc.py``): same public surface
(``get_grids/get_unitary/get_1st(2nd)_derivative_matrix_fbr|dvr``), but all
matrices are built vectorized in numpy once at model-construction time (they
are tiny, time-independent inputs to the MPO compiler) and handed to the engine as
constants.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np


class DVRPrimitivesMixin(ABC):
    """Discrete variable representation built on an FBR primitive family.

    The DVR functions are :math:`\\chi_\\alpha = \\sum_j \\varphi_j U_{j\\alpha}`
    where ``U`` diagonalises the FBR position matrix.
    """

    def __init__(self, ngrid: int):
        if not isinstance(ngrid, int):
            raise TypeError(f"ngrid must be int, got {type(ngrid)}")
        self.ngrid = ngrid
        self.nprim = ngrid

    def __len__(self) -> int:
        return self.ngrid

    def __iter__(self):
        yield from self.get_grids()

    # ------------------------------------------------------------------ FBR
    @abstractmethod
    def fbr_func(self, n: int, q):
        """Primitive (FBR) function value."""

    @abstractmethod
    def get_pos_rep_matrix(self) -> np.ndarray:
        """Position (or transformed-position) operator in the FBR."""

    @abstractmethod
    def get_1st_derivative_matrix_fbr(self) -> np.ndarray:
        """⟨φ_j|d/dq|φ_k⟩."""

    @abstractmethod
    def get_2nd_derivative_matrix_fbr(self) -> np.ndarray:
        """⟨φ_j|d²/dq²|φ_k⟩."""

    # ------------------------------------------------------------------ DVR
    def diagonalize_pos_rep_matrix(self) -> None:
        """Diagonalise the position matrix → grids, unitary, weights."""
        if not hasattr(self, "grids"):
            eigval, eigvec = np.linalg.eigh(self.get_pos_rep_matrix())
            self.grids = list(eigval.real)
            self.unitary = eigvec
            self._fix_unitary_sign()

    def _fix_unitary_sign(self) -> None:
        """Fix column signs so √w_α = U*_{0α}/φ_0(x_α) > 0.

        Mirrors the weight-positivity convention of the reference
        (``basis/abc.py:129-144``) so DVR vectors match sign-for-sign.
        """
        sqrt_w = []
        for alpha in range(self.ngrid):
            w = (
                np.conjugate(self.unitary[0, alpha])
                / self.fbr_func(0, self.grids[alpha])
            ).real
            if w < 0:
                w = -w
                self.unitary[:, alpha] *= -1.0
            sqrt_w.append(float(w))
        self.sqrt_weights = sqrt_w

    def get_sqrt_weights(self) -> list[float]:
        if not hasattr(self, "sqrt_weights"):
            self.diagonalize_pos_rep_matrix()
        return self.sqrt_weights

    def get_grids(self) -> list[float]:
        """DVR grid points (eigenvalues of the position matrix)."""
        if not hasattr(self, "grids"):
            self.diagonalize_pos_rep_matrix()
        return self.grids

    def get_unitary(self) -> np.ndarray:
        """``u[j, α]`` with Σ_{jk} U_{jα} ⟨φ_j|q̂|φ_k⟩ U*_{kβ} = x_α δ_{αβ}."""
        if not hasattr(self, "unitary"):
            self.diagonalize_pos_rep_matrix()
        return self.unitary

    def get_1st_derivative_matrix_dvr(self) -> np.ndarray:
        if not hasattr(self, "first_derivative_matrix_dvr"):
            u = self.get_unitary()
            self.first_derivative_matrix_dvr = (
                u.conj().T @ self.get_1st_derivative_matrix_fbr() @ u
            )
        return self.first_derivative_matrix_dvr

    def get_2nd_derivative_matrix_dvr(self) -> np.ndarray:
        if not hasattr(self, "second_derivative_matrix_dvr"):
            u = self.get_unitary()
            self.second_derivative_matrix_dvr = (
                u.conj().T @ self.get_2nd_derivative_matrix_fbr() @ u
            )
        return self.second_derivative_matrix_dvr

    def dvr_func(self, n: int, q):
        """DVR function χ_n(q) = Σ_j φ_j(q) U_{jn}."""
        u = self.get_unitary()
        out = 0.0
        for j in range(self.ngrid):
            out = out + self.fbr_func(j, q) * u[j, n]
        return out
