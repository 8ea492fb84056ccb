"""bf16x3 ("high") environment transfers and Krylov matvecs as one CUDA kernel.

Replaces the JAX package's ``mps/pallas_renorm.py`` (``renorm_left_pallas``,
``renorm_right_pallas``; ``_renorm3_pallas``).  The kernel is
``csrc/chain_bf16x3.cu``, the four-tensor chain at bf16x3 in its H_eff
roles; its plain version is ``kernels.chain3_plain``, which serves every
CPU tensor.  Both round at the same points: the operands split into bf16
hi and lo planes (``kernels.hilo``), the chain intermediates T1 and T2
accumulated in float32 and split by truncation, three bf16 products per
real product, float32 sums.  On the card T1 and T2 stay in shared memory
and the k tiles are summed in a fixed order, so a launch repeats its
result bit for bit.

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

A CUDA tensor goes through the kernel or the wrapper raises; every shape
the chain has is taken (ragged tiles are masked in the kernel).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import torch

from pytdscf_torch import _cuda
from pytdscf_torch.mps import kernels as K

#: Tile limits of the kernel: a T1 tile has at most ROWS1 rows (k, j) and
#: COLS1 columns (x, c); a T2 tile at most COLS3 columns (i, x), and its
#: planes, padded (columns to 8, rows (a, k) to the staged k chunk of 32,
#: plus 8), at most T2_PLANE entries; W (at most MAX_W entries) sits in
#: shared memory.
ROWS1, COLS1, COLS3, T2_PLANE, MAX_W = 128, 64, 128, 10240, 1024
#: Blocks the wrapper aims for (two waves of 132 SMs): the k tiles are cut
#: into G = TARGET_BLOCKS / (x tiles) groups, one scratch slot each.
TARGET_BLOCKS = 264

#: Launch counters: ``launches`` on the card, ``plain_calls`` on the CPU.
renorm_hi = SimpleNamespace(launches=0, plain_calls=0)
matvec_hi = SimpleNamespace(launches=0, plain_calls=0)


class HiOps(NamedTuple):
    """Split operands of the chain in H_eff roles (``kernels.hilo``)."""

    L: torch.Tensor  # (b, a, k, 4) bf16
    W: torch.Tensor  # (a, i, j, c, 4) bf16
    R: torch.Tensor  # (x, c, r, 4) bf16


def heff_operands(L, W, R) -> HiOps:
    """Split operands of the "high" H_eff matvec, built once per call of
    the Krylov exponential."""
    return HiOps(K.hilo(L), K.hilo(W), K.hilo(R))


def keff_operands(L, R) -> HiOps:
    """Split operands of the "high" K_eff matvec (W the identity)."""
    return HiOps(K.hilo(L), K.hilo(K.eye_mpo(L.shape[1], L)), K.hilo(R))


def tiles(K_: int, X: int, din: int, dout: int, wl: int, wr: int):
    """(Tk, Tx, G) of a launch: Tk rows of k and Tx columns of x per tile,
    G groups of consecutive k tiles (one scratch slot each)."""
    def fits(tk, tx):
        n3, k3 = -(-dout * tx // 8) * 8, -(-wl * tk // 32) * 32
        return dout * tx <= COLS3 and n3 * (k3 + 8) <= T2_PLANE

    tk, tx = min(ROWS1 // din, K_), min(COLS1 // wr, X)
    while tk >= 1 and not fits(tk, tx):
        if tx > 1:
            tx -= 1
        else:
            tk -= 1
    if tk < 1 or tx < 1:
        raise ValueError(
            f"chain_bf16x3: no tile fits d=({din}, {dout}), w=({wl}, {wr})"
        )
    nkt, nxt = -(-K_ // tk), -(-X // tx)
    return tk, tx, max(1, min(nkt, -(-TARGET_BLOCKS // nxt)))


def _chain(counter, psi: torch.Tensor, ops: HiOps, has_w: bool):
    """out (B, dout, X) complex64 of the chain on split operands."""
    if (psi.ndim, ops.L.ndim, ops.W.ndim, ops.R.ndim) != (4, 4, 5, 4):
        raise ValueError("the chain takes split ψ (k, j, r), L, W and R")
    k, din, r = psi.shape[:3]
    B, wl, kL = ops.L.shape[:3]
    X, wr, rR = ops.R.shape[:3]
    dout = ops.W.shape[1]
    if kL != k or rR != r or tuple(ops.W.shape) != (wl, dout, din, wr, 4):
        raise ValueError(
            f"chain operand shapes ψ {tuple(psi.shape)}, L "
            f"{tuple(ops.L.shape)}, W {tuple(ops.W.shape)}, R "
            f"{tuple(ops.R.shape)} do not fit"
        )
    if psi.device.type == "cpu":
        counter.plain_calls += 1
        return K.chain3_plain(psi, *ops)
    if psi.device.type != "cuda":
        raise ValueError(f"chain_bf16x3: no kernel for device {psi.device}")
    for name, t in zip(("ψ", "L", "W", "R"), (psi, *ops)):
        if t.device != psi.device or t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA chain takes bf16 {name} on "
                            f"{psi.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.shape[-1] != 4:
            raise ValueError(f"the CUDA chain takes a contiguous split {name}")
    if has_w and ops.W[..., 0].numel() > MAX_W:
        raise ValueError(f"chain_bf16x3: W has more than {MAX_W} entries")
    if not has_w and (din, dout, wl) != (1, 1, wr):
        raise ValueError("chain_bf16x3: the K_eff form takes d = 1, wl = wr")
    tk, tx, G = tiles(k, X, din, dout, wl, wr)
    # one (B, dout, X) slot per group of k tiles, summed in order
    part = torch.empty((G, B, dout, X), dtype=torch.complex64,
                       device=psi.device)
    out = torch.empty((B, dout, X), dtype=torch.complex64, device=psi.device)
    code = _cuda.load().pytdscf_chain3_c64(
        psi.device.index, psi.data_ptr(), ops.L.data_ptr(),
        ops.W.data_ptr() if has_w else None, ops.R.data_ptr(),
        part.data_ptr(), out.data_ptr(), B, k, X, r, din, dout, wl, wr, tk,
        tx, G, torch.cuda.current_stream(psi.device).cuda_stream,
    )
    _cuda.check(code, "chain_bf16x3")
    counter.launches += 1
    return out


def renorm_left_hi(L, a_bra, W, a_ket) -> torch.Tensor:
    """L'[o,c,p] = Σ Ā_bra[b,i,o]·W[a,i,j,c]·A_ket[k,j,p]·L[b,a,k] at
    bf16x3 (``kernels.renorm_block_left_hi`` on the CPU)."""
    psi, Lo, Wo, Ro = K.renorm_left_operands(L, a_bra, W, a_ket)
    return _chain(renorm_hi, psi, HiOps(Lo, Wo, Ro), True).to(L.dtype)


def renorm_right_hi(R, b_bra, W, b_ket) -> torch.Tensor:
    """R'[o,c,p] = Σ B̄_bra[o,i,b]·W[c,i,j,a]·B_ket[p,j,k]·R[b,a,k] at
    bf16x3 (``kernels.renorm_block_right_hi`` on the CPU)."""
    psi, Lo, Wo, Ro = K.renorm_right_operands(R, b_bra, W, b_ket)
    return _chain(renorm_hi, psi, HiOps(Lo, Wo, Ro), True).to(R.dtype)


def heff_hi(ops: HiOps, psi: torch.Tensor) -> torch.Tensor:
    """σ[b,i,x] of the "high" H_eff matvec on ψ (k, j, r)."""
    return _chain(matvec_hi, K.hilo(psi), ops, True).to(psi.dtype)


def keff_hi(ops: HiOps, sig: torch.Tensor) -> torch.Tensor:
    """σ'[b,x] of the "high" K_eff matvec on σ (k, r)."""
    out = _chain(matvec_hi, K.hilo(sig.unsqueeze(1)), ops, False)
    return out[:, 0, :].to(sig.dtype)
