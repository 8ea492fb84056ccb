"""Immutable run configuration of the port.

Holds only the fields the ported slice reads; the JAX package's
``Config`` has many more, and later slices add them back as they are
ported.  Defaults are the JAX package's, so numerical literals match.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Literal


def _fused_site_default() -> bool:
    """``PYTDSCF_PALLAS_WHOLESITE=1`` selects the fused site update, as it
    does in the JAX package (read once per ``Config``)."""
    return os.environ.get("PYTDSCF_PALLAS_WHOLESITE", "0") == "1"


@dataclasses.dataclass(frozen=True)
class Config:
    """Run-type configuration, passed explicitly (never a global)."""

    #: Job name; output directory of a Simulator run (``{jobname}/``).
    jobname: str = "job"
    #: "none" = real-time propagation; "imaginary" = imaginary-time relaxation
    #: (step scale −dt/2, the norm restored after every exponential);
    #: "improved" = improved (diagonalisation) relaxation: each site's
    #: H-Krylov is replaced by the restarted Lanczos ground state
    #: (``cuda_lanczos.ground_state``) and the K step is skipped.
    relax: Literal["none", "imaginary", "improved"] = "none"
    #: Marks the configuration of an operator application
    #: (``Simulator.operate`` sets it).  A label kept for parity with the
    #: JAX package's ``Config``: no code reads it, and
    #: ``TDVPEngine.apply_operator_fit`` runs the same either way.
    apply_dipole: bool = False
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
    #: Adaptive bond dimension (a1TDVP, ``TDVPEngine._half_sweep_adaptive``):
    #: after each site's H step the bond is enriched by up to
    #: ``adaptive_dD`` leading directions of the projection residual
    #: (1 − QQ†)·H_eff ψ whose singular values exceed ``adaptive_p_proj``
    #: (absolute), never past ``adaptive_Dmax``; after the K step, singular
    #: values of the bond matrix at or below ``adaptive_p_svd``·σ₀ are
    #: truncated.  Adaptive sweeps run every matvec and environment
    #: transfer at "highest" precision with no relaxed Krylov and no fused
    #: site, whatever the other fields say, as in the JAX package.  Each
    #: bond reads its singular values to the host twice, so a step is
    #: driven from the host (never a recorded graph).
    adaptive: bool = False
    adaptive_Dmax: int = 20
    adaptive_dD: int = 5
    adaptive_p_proj: float = 1.0e-04
    adaptive_p_svd: float = 1.0e-07
    #: The JAX package's masked fixed-buffer a1TDVP (bonds padded to static
    #: caps, the live rank carried as exact-zero channels): not ported yet
    #: (ROADMAP A9b); the engine raises with it set.
    adaptive_masked: bool = False
    #: Precision of the exact-prefix Krylov matvecs (iterations
    #: ``< relax_after``, or all of them without ``krylov_relaxed``):
    #: "highest" = float32 with TF32 off; "high" = bf16x3 (every operand
    #: split into bf16 hi and lo, three bf16 products per real product,
    #: float32 sums, about 16 mantissa bits; on CUDA the
    #: ``cuda_renorm.heff_hi``/``keff_hi`` kernel); "default" = one bf16
    #: pass per real product with float32 sums (about 8 mantissa bits,
    #: ~4e-3 relative; the ``cuda_matvec`` kernels of relaxed Krylov), the
    #: JAX package's ``Precision.DEFAULT``, for profiling: no preset uses
    #: it.  A Lanczos site below "highest" runs ``integrator.krylov_expm``
    #: over these matvecs, not the Lanczos kernel.
    matvec_precision: Literal["highest", "high", "default"] = "highest"
    #: Precision of the in-sweep environment transfers, as
    #: ``matvec_precision`` (on CUDA "high" runs ``cuda_renorm.renorm_*_hi``,
    #: "default" ``cuda_renorm.renorm_*_lo``).  The env stacks built
    #: between sweeps and ``expectation`` stay "highest", as in the JAX
    #: package.
    env_precision: Literal["highest", "high", "default"] = "highest"

    #: Relaxed (inexact) Krylov: matvec iterations ``>= relax_after`` run
    #: the single-bf16-pass matvec (bf16 operands and chain intermediates,
    #: float32 accumulation; on CUDA the ``cuda_matvec`` kernels).  Their
    #: errors enter ``exp(T)e₀`` weighted by the late expansion
    #: coefficients (van den Eshof & Hochbruck relaxation), so the result
    #: stays within the integrator threshold.  With Lanczos the sites run
    #: ``integrator.krylov_expm`` over the einsums, not the Lanczos kernel.
    krylov_relaxed: bool = False
    #: First relaxed Krylov iteration: iterations ``< relax_after`` run the
    #: exact matvec.  2 is the conservative default; 1 locks in only the
    #: leading coefficient exactly.
    relax_after: int = 2
    #: Sweep-splitting composition; the port runs "lt2" only (suzuki4 and
    #: yoshida4 are ROADMAP A10).
    splitting: Literal["lt2", "suzuki4", "yoshida4"] = "lt2"
    #: Run each non-last Lanczos site update as ONE call of the fused site
    #: kernel (``cuda_site.site_step_fused``: H-Krylov, gauge, environment
    #: renormalisation, K-Krylov, absorb) where ``cuda_site.site_fits``
    #: takes the shapes and both precisions are "highest"; elsewhere the
    #: separate kernels run.  Off unless ``PYTDSCF_PALLAS_WHOLESITE=1``, the
    #: JAX package's switch of the same update.
    fused_site: bool = dataclasses.field(default_factory=_fused_site_default)
    #: Time unit of the Simulator's outputs.
    display_time_unit: Literal["fs", "ps", "au"] = "fs"
    #: Extra numerical self-checks (gauge canonicality inside the sweep).
    pytest_enabled: bool = False
    #: Computation dtype for the tensor network.
    dtype: str = "complex128"
    #: Defer per-step property fetches: the Simulator queues the device
    #: observables of up to ``fetch_stride`` steps and reads them with ONE
    #: packed device→host copy, and runs each ``fetch_stride``-long block
    #: of steps through ``TDVPEngine.propagate_steps_collect`` (on the
    #: card, replays of a recorded step).  The ``.dat`` rows are those of
    #: stride 1; only the read (and the norm-drift warning) is delayed, by
    #: at most ``fetch_stride − 1`` steps.  Checkpoints, observables-dict
    #: evaluations and reduced-density exports flush the queue first, so
    #: file ordering is preserved.
    fetch_stride: int = 1

    def __post_init__(self):
        if self.relax not in ("none", "imaginary", "improved"):
            raise ValueError(
                f"relax={self.relax!r}: none | imaginary | improved")
        for name in ("matvec_precision", "env_precision"):
            value = getattr(self, name)
            if value not in ("highest", "high", "default"):
                raise ValueError(
                    f"{name}={value!r}: highest | high | default")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def with_precision_preset(self, preset: str) -> "Config":
        """Accuracy-versus-throughput rungs of the large-bond work (the JAX
        package's presets, without its TPU routing switches):

        * ``"throughput"`` — bf16x3 iteration-0 matvecs and env transfer;
          Krylov iterations >= 1 run the single-bf16-pass matvec.
        * ``"balanced"`` — float32-exact iteration-0 matvecs and env
          transfer; iterations >= 1 single-pass bf16.
        * ``"precise"`` — two float32-exact prefix iterations; iterations
          >= 2 single-pass bf16.
        * ``"exact"`` — every product float32-exact, no relaxation.
        """
        if preset == "throughput":
            return self.replace(
                matvec_precision="high", env_precision="high",
                krylov_relaxed=True, relax_after=1,
            )
        if preset == "balanced":
            return self.replace(
                matvec_precision="highest", env_precision="highest",
                krylov_relaxed=True, relax_after=1,
            )
        if preset == "precise":
            return self.replace(
                matvec_precision="highest", env_precision="highest",
                krylov_relaxed=True, relax_after=2,
            )
        if preset == "exact":
            return self.replace(
                matvec_precision="highest", env_precision="highest",
                krylov_relaxed=False,
            )
        raise ValueError(
            f"unknown precision preset {preset!r}: "
            "throughput | balanced | precise | exact"
        )
