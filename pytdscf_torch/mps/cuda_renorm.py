"""bf16x3 ("high") environment transfers and Krylov matvecs as one CUDA kernel.

Replaces the JAX package's ``mps/pallas_renorm.py`` (``renorm_left_pallas``,
``renorm_right_pallas``; ``_renorm3_pallas``).  The kernel is
``csrc/chain_tc.cu`` in its bf16x3 mode, the four-tensor chain in its H_eff
roles as three staged tensor-core GEMMs (two for K_eff); its plain version
is ``kernels.chain3_plain``, which serves every CPU tensor.  Both round at
the same points: the operands split into bf16 hi and lo planes
(``kernels.hilo``), the chain intermediates T1 and T2 accumulated in
float32 and split by truncation, three bf16 products per real product,
float32 sums.  On the card no sum is split, so a launch repeats its result
bit for bit.  Every shape is taken.

Four mappings run it:

* :func:`renorm_left_hi` / :func:`renorm_right_hi` — the environment
  transfer at ``env_precision="high"``, with the operand roles of
  ``pallas_renorm`` (``kernels.renorm_left_operands`` /
  ``renorm_right_operands``); launches counted by :data:`renorm_hi`;
* :func:`heff_hi` / :func:`keff_hi` — the exact-prefix Krylov matvec at
  ``matvec_precision="high"``.  The JAX package runs that one as an XLA
  einsum at ``Precision.HIGH`` (``kernels.heff_apply`` / ``keff_apply``):
  the same chain at the same bf16x3 contract, so the port serves it with
  this kernel (K_eff is the chain with d = 1 and W the identity).  Their
  operands are built once per Krylov call (:func:`heff_operands`,
  :func:`keff_operands`); launches counted by :data:`matvec_hi`.

The one-pass form of the environment transfer (``env_precision=
"default"``, :func:`renorm_left_lo` / :func:`renorm_right_lo`, launches
counted by :data:`renorm_lo`) runs the same chain in the same roles
through ``cuda_matvec.chain_lo``: ``chain_tc.cu`` in its one-pass mode,
the rounding of the relaxed H_eff matvec (ψ, L, W, R and the
intermediates T1 and T2 rounded to bf16, float32 sums), whose plain
version ``kernels.heff_apply_lo`` serves the CPU
(``kernels.renorm_block_left_lo`` / ``_right_lo``).

The operands L, W and R are bf16 planes (re_hi, im_hi, re_lo, im_lo)
first, each depth axis zero-padded to a multiple of 8 (:class:`HiOps`);
ψ stays complex and is split by the kernel.  :func:`plain_hilo` gives the
plain version's ``hilo`` operands from them.  A CUDA tensor goes through
the kernel or the wrapper raises.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import torch

from pytdscf_torch import _cuda
from pytdscf_torch.mps import cuda_matvec as CM
from pytdscf_torch.mps import kernels as K

#: Launch counters: ``launches`` on the card, ``plain_calls`` on the CPU,
#: ``replayed`` the device counts of launches recorded into a CUDA graph
#: (``_cuda.replay_count``).
renorm_hi = SimpleNamespace(launches=0, plain_calls=0, replayed={})
renorm_lo = SimpleNamespace(launches=0, plain_calls=0, replayed={})
matvec_hi = SimpleNamespace(launches=0, plain_calls=0, replayed={})


class HiOps(NamedTuple):
    """Split operands of the chain in H_eff roles
    (``cuda_matvec.bf16_planes(..., passes=3)``): four bf16 planes first,
    the depth axes zero-padded to ``pad8`` of their lengths (``k``, ``r``
    and j·c for W, whose rows are (a, i)); ``j`` is W's ket width, 1 for
    K_eff, whose W is the identity over the MPO bond (``None``)."""

    L: torch.Tensor  # (4, b, a, pad8(k)) bf16
    W: torch.Tensor | None  # (4, a, i, pad8(j·c)) bf16
    R: torch.Tensor  # (4, x, c, pad8(r)) bf16
    k: int
    r: int
    j: int


def heff_operands(L, W, R) -> HiOps:
    """Split operands of the chain in H_eff roles, L (b, a, k), W (a, i, j,
    c) and R (x, c, r): the "high" H_eff matvec's, built once per call of
    the Krylov exponential, and an environment transfer's (roles
    permuted)."""
    wl, dout, j, wr = W.shape
    return HiOps(CM.bf16_planes(L, passes=3),
                 CM.bf16_planes(W.reshape(wl, dout, j * wr), passes=3),
                 CM.bf16_planes(R, passes=3), L.shape[-1], R.shape[-1], j)


def keff_operands(L, R) -> HiOps:
    """Split operands of the "high" K_eff matvec (W the identity)."""
    return HiOps(CM.bf16_planes(L, passes=3), None,
                 CM.bf16_planes(R, passes=3), L.shape[-1], R.shape[-1], 1)


def plain_hilo(ops: HiOps) -> tuple:
    """The plain version's (L, W, R) as contiguous ``kernels.hilo`` tensors
    (..., 4): the arguments of ``kernels.chain3_plain`` after ψ."""

    def hilo(t, n):
        return t[..., :n].movedim(0, -1).contiguous()

    wl, wr = ops.L.shape[2], ops.R.shape[2]
    if ops.W is None:
        W = torch.zeros((wl, 1, 1, wr, 4), dtype=torch.bfloat16,
                        device=ops.L.device)
        W[..., 0] = torch.eye(wl, device=ops.L.device).reshape(wl, 1, 1, wr)
    else:
        _, _, dout, _ = ops.W.shape
        W = hilo(ops.W, ops.j * wr).reshape(wl, dout, ops.j, wr, 4)
    return hilo(ops.L, ops.k), W, hilo(ops.R, ops.r)


def _chain(counter, psi: torch.Tensor, ops: HiOps) -> torch.Tensor:
    """out (B, dout, X) complex64 of the chain on ψ (k, j, r)."""
    if psi.ndim != 3 or ops.L.ndim != 4 or ops.R.ndim != 4 or (
            ops.W is not None and ops.W.ndim != 4):
        raise ValueError("the chain takes ψ (k, j, r) and operands from "
                         "heff_operands or keff_operands")
    k, din, r = psi.shape
    P, B, wl, kp = ops.L.shape
    PR, X, wr, rp = ops.R.shape
    dout = 1 if ops.W is None else ops.W.shape[2]
    fits = ((k, r, din) == (ops.k, ops.r, ops.j) and (P, PR) == (4, 4)
            and (kp, rp) == (CM.pad8(k), CM.pad8(r)))
    if ops.W is None:
        fits = fits and wl == wr
    else:
        fits = fits and tuple(ops.W.shape) == (4, wl, dout, CM.pad8(din * wr))
    if not fits:
        raise ValueError(
            f"chain operand shapes ψ {tuple(psi.shape)}, L "
            f"{tuple(ops.L.shape)}, W "
            f"{None if ops.W is None else tuple(ops.W.shape)}, R "
            f"{tuple(ops.R.shape)} (k={ops.k}, r={ops.r}, j={ops.j}) do not "
            "fit"
        )
    if psi.device.type == "cpu":
        counter.plain_calls += 1
        return K.chain3_plain(K.hilo(psi), *plain_hilo(ops))
    if psi.device.type != "cuda":
        raise ValueError(f"chain_tc: no kernel for device {psi.device}")
    dev = psi.device
    CM.check_operand("ψ", psi, torch.complex64, dev)
    for name in ("L", "W", "R"):
        if getattr(ops, name) is not None:
            CM.check_operand(name, getattr(ops, name), torch.bfloat16, dev)
    if ops.W is None:
        # K_eff: σ's planes (rows padded too) and T1 = T2 as (x, a, kp)
        psip = torch.empty((4, kp, rp), dtype=torch.bfloat16, device=dev)
        t1 = None
        t2 = torch.empty((4, X, wr, kp), dtype=torch.bfloat16, device=dev)
    else:
        psip, t1, t2 = CM.chain_scratch(4, k, X, r, din, dout, wl, wr, dev)
    out = torch.empty((B, dout, X), dtype=torch.complex64, device=dev)
    code = _cuda.load().pytdscf_chain3_c64(
        dev.index, psi.data_ptr(), ops.L.data_ptr(),
        None if ops.W is None else ops.W.data_ptr(), ops.R.data_ptr(),
        psip.data_ptr(), None if t1 is None else t1.data_ptr(),
        t2.data_ptr(), out.data_ptr(), B, k, X, r, din, dout, wl, wr,
        _cuda.replay_count(counter, dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda.check(code, "chain_tc")
    counter.launches += 1
    return out


def renorm_left_hi(L, a_bra, W, a_ket) -> torch.Tensor:
    """L'[o,c,p] = Σ Ā_bra[b,i,o]·W[a,i,j,c]·A_ket[k,j,p]·L[b,a,k] at
    bf16x3 (``kernels.renorm_block_left_hi`` on the CPU): the chain with
    ψ = L (b,a,k), L = Ā (o,i,b), W (i,c,a,j), R = A_ket (p,j,k)."""
    ops = heff_operands(torch.conj_physical(a_bra).permute(2, 1, 0),
                        W.permute(1, 3, 0, 2), a_ket.permute(2, 1, 0))
    return _chain(renorm_hi, L.contiguous(), ops).to(L.dtype)


def renorm_right_hi(R, b_bra, W, b_ket) -> torch.Tensor:
    """R'[o,c,p] = Σ B̄_bra[o,i,b]·W[c,i,j,a]·B_ket[p,j,k]·R[b,a,k] at
    bf16x3 (``kernels.renorm_block_right_hi`` on the CPU): the chain with
    ψ = R (b,a,k), L = B̄ (o,i,b), W (i,c,a,j), R = B_ket (p,j,k)."""
    ops = heff_operands(torch.conj_physical(b_bra), W.permute(1, 0, 3, 2),
                        b_ket)
    return _chain(renorm_hi, R.contiguous(), ops).to(R.dtype)


def heff_hi(ops: HiOps, psi: torch.Tensor) -> torch.Tensor:
    """σ[b,i,x] of the "high" H_eff matvec on ψ (k, j, r)."""
    return _chain(matvec_hi, psi, ops).to(psi.dtype)


def keff_hi(ops: HiOps, sig: torch.Tensor) -> torch.Tensor:
    """σ'[b,x] of the "high" K_eff matvec on σ (k, r)."""
    return _chain(matvec_hi, sig.unsqueeze(1), ops)[:, 0, :].to(sig.dtype)


def renorm_left_lo(L, a_bra, W, a_ket) -> torch.Tensor:
    """:func:`renorm_left_hi`'s transfer at one bf16 pass
    (``kernels.renorm_block_left_lo`` on the CPU)."""
    ops = CM.heff_operands(torch.conj_physical(a_bra).permute(2, 1, 0),
                           W.permute(1, 3, 0, 2), a_ket.permute(2, 1, 0))
    return CM.chain_lo(renorm_lo, ops, L.contiguous()).to(L.dtype)


def renorm_right_lo(R, b_bra, W, b_ket) -> torch.Tensor:
    """:func:`renorm_right_hi`'s transfer at one bf16 pass
    (``kernels.renorm_block_right_lo`` on the CPU)."""
    ops = CM.heff_operands(torch.conj_physical(b_bra), W.permute(1, 0, 3, 2),
                           b_ket)
    return CM.chain_lo(renorm_lo, ops, R.contiguous()).to(R.dtype)
