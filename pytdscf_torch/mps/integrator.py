"""Krylov propagators: the short-iterative Lanczos and Arnoldi of the JAX
package.

The counterpart of the JAX package's ``mps/integrator.py:krylov_expm``:

* ``_lanczos_loop`` — the same recurrence, stopping rule and norm handling,
  with ``exp(scale·T)e₀`` from the real-symmetric eigendecomposition of T.
  It is the CPU oracle of ``cuda_lanczos.lanczos_expm``, which the engine
  runs for Lanczos.
* ``_arnoldi_loop`` — classical Gram–Schmidt against the live rows of a
  preallocated (k_max+1, n) buffer, ``exp(scale·H)e₀`` of the Hessenberg
  block by order-12 Taylor with scaling and squaring, convergence tested
  in coefficient space.  The engine runs it for non-Hermitian H_eff (the
  Liouville MPDO); its matvecs are the exact einsums and, with
  ``matvec_lo`` (relaxed Krylov), the ``cuda_matvec`` kernels.

The loops run on the host.  Each Arnoldi iteration reads three scalars
back, each a device-to-host sync: the breakdown test ``b < EPS``, the
Taylor scaling norm ‖scale·H‖₁ in ``_expm_taylor_small`` and the
convergence error (Lanczos reads two: breakdown and convergence).  At large
bond dimension an iteration is milliseconds of device work, so these reads
cost little, but each one leaves the device idle until the host has queued
the next work.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

EPS = 1.0e-14


def krylov_expm(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    v_init: torch.Tensor,
    scale: complex,
    thresh: float,
    max_dim: int = 20,
    conserve_norm: bool = True,
    arnoldi: bool = False,
    return_iterations: bool = False,
    matvec_lo: Callable[[torch.Tensor], torch.Tensor] | None = None,
    relax_after: int = 2,
):
    """Approximate ``exp(scale·H)·v_init`` in a Krylov subspace.

    ``v_init`` is a flat vector.  With ``return_iterations`` also returns
    the Krylov dimension used and a flag that is True when the loop hit
    ``max_dim`` without meeting ``thresh`` and without a breakdown.

    ``matvec_lo`` enables relaxed (inexact) Krylov: iterations
    ``k >= relax_after`` apply the cheaper low-precision matvec.  The error
    a perturbed matvec at iteration k injects into ``exp(T)e₀`` is weighted
    by the k-th expansion coefficient, which decays superlinearly (van den
    Eshof & Hochbruck, SISC 2005), so late iterations tolerate a
    ~1e-3-relative matvec.
    """
    n = v_init.shape[0]
    k_max = min(max_dim, n)
    beta0 = torch.linalg.vector_norm(v_init)
    def mv(k, v):
        if matvec_lo is not None and k >= relax_after:
            return matvec_lo(v)
        return matvec(v)

    loop = _arnoldi_loop if arnoldi else _lanczos_loop
    psi_next, k_used, bad = loop(mv, v_init / beta0, scale, thresh, k_max)
    if k_max >= n:
        # the Krylov space spanned the whole vector space: exact, never capped
        bad = False
    if conserve_norm:
        out = psi_next / torch.linalg.vector_norm(psi_next)
    else:
        out = psi_next * beta0
    if return_iterations:
        return out, k_used, bad
    return out


def _lanczos_loop(matvec, v0, scale, thresh, k_max):
    """SIL with the reference's recurrence.

    The reduced-matrix diagonal is ``α_k = ⟨v₀|H·v_k⟩`` (projection onto
    the initial vector, not ``v_k``): an oblique variant that is exact by
    construction, since ``β_k v_{k+1} ≝ H v_k − α_k v_k − β_{k−1} v_{k−1}``
    makes ``H·Vᵀ = Vᵀ·T`` hold in the generated basis.  The regression
    literals of the reference embed its stopping behaviour.
    """
    n = v0.shape[0]
    real = v0.real.dtype
    V = torch.zeros((k_max + 1, n), dtype=v0.dtype, device=v0.device)
    V[0] = v0
    alpha = torch.zeros(k_max, dtype=real, device=v0.device)
    beta = torch.zeros(k_max, dtype=real, device=v0.device)
    psi_prev = torch.zeros_like(v0)
    for k in range(k_max):
        w = matvec(k, V[k])
        a = torch.sum(v0.conj() * w)
        w = w - a * V[k]
        if k > 0:
            w = w - beta[k - 1] * V[k - 1]
        b = torch.linalg.vector_norm(w)
        breakdown = bool(b < EPS)
        if not breakdown:
            V[k + 1] = w / b
        alpha[k] = a.real
        beta[k] = b
        T = (
            torch.diag(alpha[: k + 1])
            + torch.diag(beta[:k], 1)
            + torch.diag(beta[:k], -1)
        )
        w_e, U = torch.linalg.eigh(T)
        c = (U.to(v0.dtype) * torch.exp(scale * w_e.to(v0.dtype))) @ U[0].to(
            v0.dtype
        )
        psi_next = c @ V[: k + 1]
        err = float(torch.linalg.vector_norm(psi_next - psi_prev))
        psi_prev = psi_next
        conv = k > 0 and err < thresh
        capped = k + 1 >= k_max
        if conv or breakdown or capped:  # capped at the last k, so always
            return psi_next, k + 1, capped and not conv and not breakdown


def _expm_taylor_small(A: torch.Tensor) -> torch.Tensor:
    """exp(A) of a tiny (k×k) matrix by scaling-and-squaring Taylor.

    Order 12 after scaling ‖A‖₁ below 1/8: truncation ~(1/8)¹³/13! ≈ 4e-22,
    far under float32/float64 round-off.  The number of squarings is
    clamped to 64 and forced to 0 on a non-finite ‖A‖₁, so a NaN or Inf
    in H_eff comes out at once instead of spinning the squaring loop.
    """
    k = A.shape[0]
    norm1 = float(torch.max(torch.sum(torch.abs(A), dim=0)))
    if math.isfinite(norm1):
        s = int(min(max(math.ceil(math.log2(max(norm1, 1e-30))) + 3, 0), 64))
    else:
        s = 0
    As = A / (2.0 ** s)
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    # reverse Horner: p ← I + As·p/c for c = 12, 11, …, 1
    p = eye
    for c in range(12, 0, -1):
        p = eye + (As @ p) / c
    for _ in range(s):
        p = p @ p
    return p


def _arnoldi_loop(matvec, v0, scale, thresh, k_max):
    """Arnoldi with classical Gram–Schmidt (the JAX ``_arnoldi_loop``).

    The projections run against the k+1 live rows of the buffer only: its
    other rows are exact zeros, so the result is the padded form's.  V is
    orthonormal, so ‖ψ(k) − ψ(k−1)‖ = ‖c_k − c_{k−1}‖ and the n-dim
    iterate is formed once, after the loop.
    """
    n = v0.shape[0]
    dtype = v0.dtype
    V = torch.zeros((k_max + 1, n), dtype=dtype, device=v0.device)
    V[0] = v0
    H = torch.zeros((k_max + 1, k_max), dtype=dtype, device=v0.device)
    c_prev = torch.zeros(k_max, dtype=dtype, device=v0.device)
    for k in range(k_max):
        w = matvec(k, V[k])
        live = V[: k + 1]
        # ⟨V|w⟩ = conj(V·conj(w)): conjugate the one new vector, not V
        h = (live @ w.conj()).conj()
        w = w - h @ live
        b = torch.linalg.vector_norm(w)
        breakdown = bool(b < EPS)
        if not breakdown:
            V[k + 1] = w / b
        H[: k + 1, k] = h
        H[k + 1, k] = b
        c = torch.zeros(k_max, dtype=dtype, device=v0.device)
        c[: k + 1] = _expm_taylor_small(scale * H[: k + 1, : k + 1])[:, 0]
        err = float(torch.linalg.vector_norm(c - c_prev))
        c_prev = c
        conv = k > 0 and err < thresh
        capped = k + 1 >= k_max
        if conv or breakdown or capped:
            psi_next = c[: k + 1] @ V[: k + 1]
            return psi_next, k + 1, capped and not conv and not breakdown
