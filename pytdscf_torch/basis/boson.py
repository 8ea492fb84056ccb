"""Boson (number-state) basis.

Parity target: ``PyTDSCF:pytdscf/basis/boson.py``.
"""

from __future__ import annotations

import numpy as np


class Boson:
    """Truncated boson Fock basis |0⟩ … |nstate−1⟩."""

    def __init__(self, nstate: int) -> None:
        self.nstate = nstate

    def get_annihilation_matrix(self, margin: int = 0) -> np.ndarray:
        """b|n⟩ = √n |n−1⟩."""
        return np.diag(np.sqrt(np.arange(1, self.nstate + margin)), 1)

    def get_creation_matrix(self, margin: int = 0) -> np.ndarray:
        """b†|n⟩ = √(n+1) |n+1⟩."""
        return self.get_annihilation_matrix(margin=margin).T

    def get_number_matrix(self) -> np.ndarray:
        """b†b|n⟩ = n|n⟩."""
        return np.diag(np.arange(self.nstate, dtype=np.float64))

    def get_q_matrix(self) -> np.ndarray:
        """q = (b† + b)/√2."""
        a = self.get_annihilation_matrix()
        return (a.T + a) / np.sqrt(2.0)

    def get_p_matrix(self) -> np.ndarray:
        """p = i(b† − b)/√2."""
        a = self.get_annihilation_matrix()
        return 1j * (a.T - a) / np.sqrt(2.0)

    def get_q2_matrix(self) -> np.ndarray:
        q = self.get_q_matrix()
        return q @ q

    def get_p2_matrix(self) -> np.ndarray:
        p = self.get_p_matrix()
        return (p @ p).real

    @property
    def nprim(self) -> int:
        return self.nstate

    def __len__(self) -> int:
        return self.nstate


class Exciton:
    """n-level electronic site basis with hard-core raising/lowering ops.

    Parity target: ``PyTDSCF:pytdscf/basis/exciton.py``.
    """

    def __init__(self, nstate: int, names: list[str] | None = None) -> None:
        self.nstate = nstate
        self.names = names if names is not None else [f"S{i}" for i in range(nstate)]
        if len(self.names) != nstate:
            raise ValueError(f"len(names)={len(self.names)} != nstate={nstate}")

    def get_annihilation_matrix(self) -> np.ndarray:
        mat = np.zeros((self.nstate, self.nstate), dtype=np.float64)
        for i in range(self.nstate - 1):
            mat[i, i + 1] = 1.0
        return mat

    def get_creation_matrix(self) -> np.ndarray:
        return self.get_annihilation_matrix().T

    @property
    def nprim(self) -> int:
        return self.nstate

    def __len__(self) -> int:
        return self.nstate
