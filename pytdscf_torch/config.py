"""Immutable run configuration of the port.

Holds only the fields the ported slice reads; the JAX package's
``Config`` has many more, and later slices add them back as they are
ported.  Defaults are the JAX package's, so numerical literals match.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class Config:
    """Run-type configuration, passed explicitly (never a global)."""

    #: "none" = real-time propagation; "imaginary" = imaginary-time relaxation;
    #: "improved" = improved (diagonalisation) relaxation.  The port runs
    #: "none" only (relaxation is ROADMAP A7).
    relax: Literal["none", "imaginary", "improved"] = "none"
    #: Krylov exponential integrator for the local updates.  The port runs
    #: "lanczos" only (Arnoldi is ROADMAP A2).
    integrator: Literal["lanczos", "arnoldi"] = "lanczos"
    #: SIL convergence threshold (reference ``thresh_exp``).
    thresh_exp: float = 1.0e-09
    #: Maximum Krylov subspace dimension (at most 32 in the CUDA kernel).
    max_krylov: int = 20
    #: Renormalise after each local exponential (valid for Hermitian H).
    conserve_norm: bool = True
    #: Sweep-splitting composition; the port runs "lt2" only (suzuki4 and
    #: yoshida4 are ROADMAP A10).
    splitting: Literal["lt2", "suzuki4", "yoshida4"] = "lt2"
    #: Extra numerical self-checks (gauge canonicality inside the sweep).
    pytest_enabled: bool = False
    #: Computation dtype for the tensor network.
    dtype: str = "complex128"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
