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
    #: Krylov exponential integrator for the local updates: "lanczos"
    #: (Hermitian H_eff; the Lanczos kernel) or "arnoldi" (any H_eff, e.g.
    #: a Liouvillian; Gram–Schmidt in PyTorch around the matvec kernels).
    integrator: Literal["lanczos", "arnoldi"] = "lanczos"
    #: SIL convergence threshold (reference ``thresh_exp``).
    thresh_exp: float = 1.0e-09
    #: Maximum Krylov subspace dimension (at most 32 in the Lanczos kernel).
    max_krylov: int = 20
    #: Hilbert-space (MPS) or Liouville-space (MPDO) dynamics.
    space: Literal["hilbert", "liouville"] = "hilbert"
    #: Renormalise after each local exponential (valid for Hermitian H).
    conserve_norm: bool = True
    # The exact matvecs and the environment transfer are float32 with TF32
    # off.  The JAX package's ``matvec_precision``/``env_precision`` knobs
    # ("high" = bf16x3, "default" = one bf16 pass) return with the
    # hand-built bf16x3 products (ROADMAP A6).

    #: Relaxed (inexact) Krylov: matvec iterations ``>= relax_after`` run
    #: the single-bf16-pass matvec (bf16 operands and chain intermediates,
    #: float32 accumulation; on CUDA the ``cuda_matvec`` kernels).  Their
    #: errors enter ``exp(T)e₀`` weighted by the late expansion
    #: coefficients (van den Eshof & Hochbruck relaxation), so the result
    #: stays within the integrator threshold.  Arnoldi only in the port.
    krylov_relaxed: bool = False
    #: First relaxed Krylov iteration: iterations ``< relax_after`` run the
    #: exact matvec.  2 is the conservative default; 1 locks in only the
    #: leading coefficient exactly.
    relax_after: int = 2
    #: Sweep-splitting composition; the port runs "lt2" only (suzuki4 and
    #: yoshida4 are ROADMAP A10).
    splitting: Literal["lt2", "suzuki4", "yoshida4"] = "lt2"
    #: Extra numerical self-checks (gauge canonicality inside the sweep).
    pytest_enabled: bool = False
    #: Computation dtype for the tensor network.
    dtype: str = "complex128"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def with_precision_preset(self, preset: str) -> "Config":
        """Accuracy-versus-throughput rungs of the large-bond work (the JAX
        package's presets, without its TPU routing switches):

        * ``"balanced"`` — float32-exact iteration-0 matvecs and env
          transfer; Krylov iterations >= 1 run the single-bf16-pass matvec.
        * ``"precise"`` — two float32-exact prefix iterations; iterations
          >= 2 single-pass bf16.
        * ``"exact"`` — every product float32-exact, no relaxation.
        * ``"throughput"`` needs bf16x3 products, which Hopper has no mode
          for: raises until they are built (ROADMAP A6).
        """
        if preset == "throughput":
            raise NotImplementedError(
                "precision preset 'throughput' needs bf16x3 matvec and env "
                "products, not ported yet (ROADMAP A6)"
            )
        if preset == "balanced":
            return self.replace(krylov_relaxed=True, relax_after=1)
        if preset == "precise":
            return self.replace(krylov_relaxed=True, relax_after=2)
        if preset == "exact":
            return self.replace(krylov_relaxed=False)
        raise ValueError(
            f"unknown precision preset {preset!r}: "
            "throughput | balanced | precise | exact"
        )
