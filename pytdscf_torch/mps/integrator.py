"""Krylov propagators: the short-iterative Lanczos of the JAX package.

The counterpart of the JAX package's ``mps/integrator.py:krylov_expm`` with its
``_lanczos_loop``: the same recurrence, stopping rule and norm handling,
with ``exp(scale·T)e₀`` from the real-symmetric eigendecomposition of T.
It is the CPU oracle that the tests hold against the JAX function; the
engine runs the same semantics through ``cuda_lanczos.lanczos_expm``.
Arnoldi is not ported yet (ROADMAP A2).
"""

from __future__ import annotations

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
):
    """Approximate ``exp(scale·H)·v_init`` in a Krylov subspace.

    ``v_init`` is a flat vector.  With ``return_iterations`` also returns
    the Krylov dimension used and a flag that is True when the loop hit
    ``max_dim`` without meeting ``thresh`` and without a breakdown.
    """
    if arnoldi:
        raise NotImplementedError("Arnoldi Krylov exponential: ROADMAP A2")
    n = v_init.shape[0]
    k_max = min(max_dim, n)
    beta0 = torch.linalg.vector_norm(v_init)
    psi_next, k_used, bad = _lanczos_loop(
        matvec, v_init / beta0, scale, thresh, k_max
    )
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
        w = matvec(V[k])
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
