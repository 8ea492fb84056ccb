"""Relaxed-Krylov H_eff and K_eff matvecs as CUDA kernels.

Replaces the JAX package's ``mps/pallas_matvec.py`` (``heff_pallas``,
``keff_pallas``).  The kernels are ``csrc/matvec_lo.cu`` (H_eff) and
``csrc/keff_tc.cu`` (K_eff); their plain versions are
``kernels.heff_apply_lo`` / ``keff_apply_lo``, which serve every CPU
tensor.  Both round at the same points: ψ (or σ) and the blocks to bf16
(round to nearest even), the chain intermediate T1 (and T2) to bf16 after
float32 accumulation, the output accumulated in float32.  On the card the
H_eff kernel keeps T1 and T2 in shared memory and sums its k tiles in a
fixed order; the K_eff kernel runs the chain as two tensor-core GEMMs with
T1 in device memory (L2) and splits no sum (see the source notes).  Either
repeats its result bit for bit.

The operands are built once per site, outside the Krylov loop
(:func:`heff_operands`, :func:`keff_operands`), in the layout each kernel
reads: for H_eff the blocks as bf16 (re, im) pairs, ``L (b, a, k, 2)``,
``W (a, i, j, c, 2)``, ``R (x, c, r, 2)``; for K_eff as bf16 planes,
``L (2, b, a, kp)`` and ``R (2, x, a, rp)``, the depth axes zero-padded to
a multiple of 8 (:class:`KeffOps`).  :func:`plain_planes` gives the plain
version's (re, im) operands from either.  The real factor that restores
the log-normalised blocks is applied to the output by the caller
(``kernels.make_hmatvec_lo``), as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pytdscf_torch import _cuda
from pytdscf_torch.mps import kernels as K

#: Largest d·w_r of an H_eff site the kernel takes (one T1 column is held
#: in registers) and largest d, w of an H_eff site (a T1 tile has TILE rows
#: of (k, j) and TILE columns of (x, c)).
MAX_DW = 32
TILE = 128
MAX_DIM = TILE


class HeffOps(NamedTuple):
    L: torch.Tensor  # (b, a, k, 2) bf16
    W: torch.Tensor  # (a, i, j, c, 2) bf16
    R: torch.Tensor  # (x, c, r, 2) bf16


class KeffOps(NamedTuple):
    """The K_eff kernel's operands: bf16 planes (re, im) first, the depth
    axes k and r zero-padded to :func:`pad8` of their lengths ``k`` and
    ``r`` (16-byte rows for the kernel's copies)."""

    L: torch.Tensor  # (2, b, a, pad8(k)) bf16
    R: torch.Tensor  # (2, x, a, pad8(r)) bf16
    k: int
    r: int


def pad8(n: int) -> int:
    """n rounded up to a multiple of 8."""
    return -(-n // 8) * 8


def _bf16_pairs(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x).to(torch.bfloat16).contiguous()


def _bf16_planes(x: torch.Tensor) -> torch.Tensor:
    """(2, *x.shape) bf16 planes (re, im) of x, the last axis zero-padded
    to a multiple of 8."""
    *lead, n = x.shape
    out = torch.zeros((2, *lead, pad8(n)), dtype=torch.bfloat16,
                      device=x.device)
    out[..., :n] = torch.view_as_real(x).to(torch.bfloat16).movedim(-1, 0)
    return out


def heff_operands(L, W, R) -> HeffOps:
    """bf16 (re, im) operands of the H_eff matvec, built once per site."""
    return HeffOps(_bf16_pairs(L), _bf16_pairs(W), _bf16_pairs(R))


def keff_operands(L, R) -> KeffOps:
    """bf16 operands of the K_eff matvec (:class:`KeffOps`), built once per
    site."""
    return KeffOps(_bf16_planes(L), _bf16_planes(R), L.shape[-1],
                   R.shape[-1])


def plain_planes(ops: HeffOps | KeffOps) -> tuple:
    """The plain version's operands, ((re, im) of L, [of W,] of R) as
    views of ``ops``: the arguments of ``kernels.heff_apply_lo`` /
    ``keff_apply_lo`` before the vector."""
    if isinstance(ops, KeffOps):
        return ((ops.L[0, ..., :ops.k], ops.L[1, ..., :ops.k]),
                (ops.R[0, ..., :ops.r], ops.R[1, ..., :ops.r]))
    return tuple(t.unbind(-1) for t in ops)


def _tiles(d: int, w: int) -> tuple[int, int]:
    """(Tk, Tx): the k rows and x columns of one block's tile, so that T1
    and T2 hold at most TILE × TILE entries (d, w ≤ TILE)."""
    return TILE // d, TILE // w


def _check(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the vector on {device}")
    if t.dtype != dtype:
        raise TypeError(f"the CUDA matvec takes {dtype} {name}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"the CUDA matvec takes a contiguous {name}")


def heff_lo(ops: HeffOps, psi: torch.Tensor) -> torch.Tensor:
    """σ[b, i, x] of the relaxed H_eff matvec on ψ (k, j, r).

    A CUDA tensor goes through the kernel (complex64 ψ, bf16 operands, all
    contiguous, d·w_r ≤ 32, or this raises); a CPU tensor through
    ``kernels.heff_apply_lo``.  ``heff_lo.launches`` counts kernel
    launches, ``heff_lo.plain_calls`` the CPU calls.
    """
    if psi.ndim != 3 or ops.L.ndim != 4 or ops.W.ndim != 5 or ops.R.ndim != 4:
        raise ValueError("heff_lo takes ψ (k, j, r) and operands from "
                         "heff_operands")
    k, d, r = psi.shape
    B, wl, kL, _ = ops.L.shape
    X, wr, rR, _ = ops.R.shape
    if kL != k or rR != r or tuple(ops.W.shape[:4]) != (wl, d, d, wr):
        raise ValueError(
            f"operand shapes L {tuple(ops.L.shape)}, W {tuple(ops.W.shape)}, "
            f"R {tuple(ops.R.shape)} do not fit ψ {tuple(psi.shape)}"
        )
    if psi.device.type == "cpu":
        heff_lo.plain_calls += 1
        return K.heff_apply_lo(*plain_planes(ops), psi)
    if psi.device.type != "cuda":
        raise ValueError(f"heff_lo: no kernel for device {psi.device}")
    _check("ψ", psi, torch.complex64, psi.device)
    for name, t in zip(("L", "W", "R"), ops):
        _check(name, t, torch.bfloat16, psi.device)
    if d * wr > MAX_DW or max(d, wl, wr) > MAX_DIM:
        raise ValueError(
            f"heff_lo: the kernel takes d·w_r <= {MAX_DW} and d, w <= "
            f"{MAX_DIM}, got d={d}, w=({wl}, {wr})"
        )
    tk, tx = _tiles(d, max(wl, wr))
    # one (B, d, X) slot per k tile, summed in order by the second kernel
    part = torch.empty((-(-k // tk), B, d, X), dtype=torch.complex64,
                       device=psi.device)
    out = torch.empty((B, d, X), dtype=torch.complex64, device=psi.device)
    code = _cuda.load().pytdscf_heff_lo_c64(
        psi.device.index, psi.data_ptr(), ops.L.data_ptr(), ops.W.data_ptr(),
        ops.R.data_ptr(), part.data_ptr(), out.data_ptr(), B, k, X, r, d, wl,
        wr, tk, tx, torch.cuda.current_stream(psi.device).cuda_stream,
    )
    _cuda.check(code, "heff_lo")
    heff_lo.launches += 1
    return out


def keff_lo(ops: KeffOps, sig: torch.Tensor) -> torch.Tensor:
    """σ'[b, x] of the relaxed K_eff matvec on σ (k, r).

    A CUDA tensor goes through the kernel (complex64 σ, the bf16 operands
    of :func:`keff_operands`, all contiguous and 16-byte aligned, or this
    raises); a CPU tensor through ``kernels.keff_apply_lo``.
    ``keff_lo.launches`` counts kernel launches, ``keff_lo.plain_calls``
    the CPU calls.
    """
    if sig.ndim != 2 or ops.L.ndim != 4 or ops.R.ndim != 4:
        raise ValueError("keff_lo takes σ (k, r) and operands from "
                         "keff_operands")
    k, r = sig.shape
    _, B, w, kp = ops.L.shape
    _, X, wR, rp = ops.R.shape
    if (k, r) != (ops.k, ops.r) or wR != w or (kp, rp) != (pad8(k), pad8(r)):
        raise ValueError(
            f"operand shapes L {tuple(ops.L.shape)}, R {tuple(ops.R.shape)} "
            f"(k={ops.k}, r={ops.r}) do not fit σ {tuple(sig.shape)}"
        )
    if sig.device.type == "cpu":
        keff_lo.plain_calls += 1
        return K.keff_apply_lo(*plain_planes(ops), sig)
    if sig.device.type != "cuda":
        raise ValueError(f"keff_lo: no kernel for device {sig.device}")
    _check("σ", sig, torch.complex64, sig.device)
    for name, t in (("L", ops.L), ("R", ops.R)):
        _check(name, t, torch.bfloat16, sig.device)
        if t.data_ptr() % 16:
            raise ValueError(f"the CUDA keff_lo takes a 16-byte aligned {name}")
    dev = sig.device
    # scratch: σ as bf16 planes, and T1 in the layout stage 2 reads
    sigp = torch.empty((2, kp, rp), dtype=torch.bfloat16, device=dev)
    t1 = torch.empty((2, X, w, kp), dtype=torch.bfloat16, device=dev)
    out = torch.empty((B, X), dtype=torch.complex64, device=dev)
    code = _cuda.load().pytdscf_keff_tc_c64(
        dev.index, sig.data_ptr(), ops.L.data_ptr(), ops.R.data_ptr(),
        sigp.data_ptr(), t1.data_ptr(), out.data_ptr(), B, k, X, r, w,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda.check(code, "keff_lo")
    keff_lo.launches += 1
    return out


heff_lo.launches = 0
heff_lo.plain_calls = 0
keff_lo.launches = 0
keff_lo.plain_calls = 0
