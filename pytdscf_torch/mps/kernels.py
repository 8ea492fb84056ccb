"""Tensor kernels for the MPS/TDVP engine, in PyTorch.

The counterpart of the JAX package's ``mps/kernels.py``.  Operators are fused
into one full-chain MPO per state pair (``operators/mpo_algebra``), so the
hot contractions are three dense einsum chains:

* ``heff_apply``  — ⟨L|W|R⟩ effective Hamiltonian on a site tensor,
* ``keff_apply``  — ⟨L|R⟩ effective operator on a bond matrix,
* ``renorm_block_left/right`` — environment-block transfer.

Each chain is written as explicit pairwise einsums in the order that keeps
the intermediates small, so the cost does not depend on whether
``torch.einsum`` finds a contraction path itself.  float32 products stay
exact: the package turns TF32 off at import.

Index conventions: site tensor ``psi[l, n, r]``; MPO core ``W[a, i, j, b]``
(i = bra, j = ket); left block ``L[b_bra, a, b_ket]``; right block
``R[b_bra, a, b_ket]`` indexed by the bonds facing the block.
"""

from __future__ import annotations

import torch

from pytdscf_torch.mps import cuda_qr
from pytdscf_torch.mps.cuda_qr import mgs_qr_plain as _mgs_qr  # noqa: F401

#: Bond width from which the JAX package switches the gauge from MGS to
#: CholeskyQR³ (the JAX package's ``mps/kernels.py`` ``CHOLESKY_QR_MIN_R``).
CHOLESKY_QR_MIN_R = 192


def thin_qr(mat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Thin QR by MGS(×2) with canonical completion of dead columns.

    Every device runs the same convention as the JAX package on an
    accelerator: the CUDA kernel for a CUDA tensor, its plain version for a
    CPU tensor (``cuda_qr.mgs_qr``).  The completions of rank-deficient
    columns set the frame through which the fixed-D sweep grows amplitude
    into padded bond channels, so LAPACK's QR is not a substitute.
    """
    if mat.shape[1] >= CHOLESKY_QR_MIN_R:
        raise NotImplementedError(
            f"thin QR at r={mat.shape[1]} >= {CHOLESKY_QR_MIN_R} is "
            "CholeskyQR³, not ported yet (ROADMAP A1)"
        )
    return cuda_qr.mgs_qr(mat.contiguous())


def qr_right(psi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Psi(l, n, r) → A(l, n, k), σ(k, r) with A left-orthogonal."""
    l, n, r = psi.shape
    q, rmat = thin_qr(psi.reshape(l * n, r))
    return q.reshape(l, n, -1), rmat


def lq_left(psi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Psi(l, n, r) → σ(l, k), B(k, n, r) with B right-orthogonal."""
    l, n, r = psi.shape
    q, rmat = thin_qr(psi.permute(2, 1, 0).reshape(r * n, l))
    return rmat.T, q.reshape(r, n, -1).permute(2, 1, 0)


def heff_apply(L, W, R, psi) -> torch.Tensor:
    """σ[b, i, x] = Σ L[b,a,k] · W[a,i,j,c] · R[x,c,r] · ψ[k,j,r]."""
    t1 = torch.einsum("kjr,xcr->kjxc", psi, R)
    t2 = torch.einsum("kjxc,aijc->kiax", t1, W)
    return torch.einsum("kiax,bak->bix", t2, L)


def keff_apply(L, R, sig) -> torch.Tensor:
    """σ'[b, x] = Σ L[b,a,k] · R[x,a,r] · σ[k,r]."""
    t1 = torch.einsum("kr,xar->kxa", sig, R)
    return torch.einsum("kxa,bak->bx", t1, L)


def renorm_block_left(L, a_bra, W, a_ket) -> torch.Tensor:
    """L'[o, c, p] = Σ A*_bra[b,i,o] · W[a,i,j,c] · A_ket[k,j,p] · L[b,a,k]."""
    t1 = torch.einsum("bak,bio->kaio", L, a_bra.conj())
    t2 = torch.einsum("kaio,aijc->kojc", t1, W)
    return torch.einsum("kojc,kjp->ocp", t2, a_ket)


def renorm_block_right(R, b_bra, W, b_ket) -> torch.Tensor:
    """R'[o, c, p] = Σ B*_bra[o,i,b] · W[c,i,j,a] · B_ket[p,j,k] · R[b,a,k]."""
    t1 = torch.einsum("bak,oib->kaoi", R, b_bra.conj())
    t2 = torch.einsum("kaoi,cija->kocj", t1, W)
    return torch.einsum("kocj,pjk->ocp", t2, b_ket)


def absorb_right(sig, b_core) -> torch.Tensor:
    """Psi(p+1) = σ · B(p+1):   (k, r) × (r, n, s) → (k, n, s)."""
    return torch.einsum("kr,rns->kns", sig, b_core)


def absorb_left(a_core, sig) -> torch.Tensor:
    """Psi(p−1) = A(p−1) · σ:   (l, n, s) × (s, k) → (l, n, k)."""
    return torch.einsum("lns,sk->lnk", a_core, sig)


def ovlp_left_conj(S, bra, ket) -> torch.Tensor:
    """S'[o, p] = Σ bra*[b,n,o] · ket[k,n,p] · S[b,k]."""
    t = torch.einsum("bk,bno->kno", S, bra.conj())
    return torch.einsum("kno,knp->op", t, ket)


def ovlp_left_noconj(S, bra, ket) -> torch.Tensor:
    """Unconjugated transfer (T/2-trick autocorrelation)."""
    t = torch.einsum("bk,bno->kno", S, bra)
    return torch.einsum("kno,knp->op", t, ket)


def stack_states(states) -> torch.Tensor:
    """Concatenate raveled per-state tensors into one Krylov vector."""
    return torch.cat([s.reshape(-1) for s in states])


def split_states(vec: torch.Tensor, shapes) -> list[torch.Tensor]:
    """Inverse of :func:`stack_states`."""
    sizes = [int(torch.Size(sh).numel()) for sh in shapes]
    return [
        part.reshape(sh) for part, sh in zip(torch.split(vec, sizes), shapes)
    ]


def gauge_error(core: torch.Tensor, left: bool) -> torch.Tensor:
    """max |Q†Q − I| of a gauge move's output (left- or right-orthonormal)."""
    l, n, r = core.shape
    if left:
        m = core.reshape(l * n, r)
        g = m.conj().T @ m
    else:
        m = core.reshape(l, n * r)
        g = m @ m.conj().T
    eye = torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    return torch.max(torch.abs(g - eye))
