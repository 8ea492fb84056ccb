"""Relaxed-Krylov H_eff and K_eff matvecs as CUDA kernels.

Replaces the JAX package's ``mps/pallas_matvec.py`` (``heff_pallas``,
``keff_pallas``).  The kernels are ``csrc/chain_tc.cu`` (H_eff, in its
one-pass mode) and ``csrc/keff_tc.cu`` (K_eff); their plain versions are
``kernels.heff_apply_lo`` / ``keff_apply_lo``, which serve every CPU
tensor.  Both round at the same points: ψ (or σ) and the blocks to bf16
(round to nearest even), the chain intermediate T1 (and T2) to bf16 after
float32 accumulation, the output accumulated in float32.  On the card each
runs the chain as tensor-core GEMMs (three for H_eff, two for K_eff) with
the intermediates in device memory, each GEMM over its whole depth with no
split of a sum, so a launch repeats its result bit for bit (see the source
notes).  Every shape is taken.

The operands are built once per site, outside the Krylov loop
(:func:`heff_operands`, :func:`keff_operands`), in the layout the kernels
read: bf16 planes (re, im) first, each depth axis zero-padded to a multiple
of 8 (:func:`bf16_planes`): for H_eff ``L (2, b, a, kp)``, ``W (2, a, i,
pad8(j·c))`` (rows (a, i), depth (j, c)) and ``R (2, x, c, rp)``
(:class:`HeffOps`); for K_eff ``L`` and ``R`` alike (:class:`KeffOps`).
:func:`plain_planes` gives the plain version's (re, im) operands from
either.  The real factor that restores the log-normalised blocks is applied
to the output by the caller (``kernels.make_hmatvec_lo``), as in the JAX
package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pytdscf_torch import _cuda
from pytdscf_torch.mps import kernels as K


class HeffOps(NamedTuple):
    """The H_eff kernel's operands: bf16 planes (re, im) first, the depth
    axes zero-padded to :func:`pad8` of their lengths (``k``, ``r`` and
    j·c = d_in·w_r for W, whose rows are (a, i)); ``j`` is W's ket width
    d_in (its bra width, W's third axis, may differ: the one-pass
    environment transfer, ``cuda_renorm.renorm_left_lo``)."""

    L: torch.Tensor  # (2, b, a, pad8(k)) bf16
    W: torch.Tensor  # (2, a, i, pad8(j·c)) bf16
    R: torch.Tensor  # (2, x, c, pad8(r)) bf16
    k: int
    r: int
    j: int


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


def bf16_planes(x: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """(P, *x.shape) bf16 planes of x, the last axis zero-padded to a
    multiple of 8: P = 2, (re, im) rounded to nearest even (``passes=1``),
    or P = 4, (re_hi, im_hi, re_lo, im_lo) of ``kernels.hilo``
    (``passes=3``)."""
    *lead, n = x.shape
    split = K.hilo(x) if passes == 3 else torch.view_as_real(x).to(torch.bfloat16)
    out = torch.zeros((split.shape[-1], *lead, pad8(n)), dtype=torch.bfloat16,
                      device=x.device)
    out[..., :n] = split.movedim(-1, 0)
    return out


def heff_operands(L, W, R) -> HeffOps:
    """bf16 operands of the H_eff matvec (:class:`HeffOps`), L (b, a, k),
    W (a, i, j, c) and R (x, c, r), built once per site."""
    wl, dout, din, wr = W.shape
    return HeffOps(bf16_planes(L), bf16_planes(W.reshape(wl, dout, din * wr)),
                   bf16_planes(R), L.shape[-1], R.shape[-1], din)


def keff_operands(L, R) -> KeffOps:
    """bf16 operands of the K_eff matvec (:class:`KeffOps`), built once per
    site."""
    return KeffOps(bf16_planes(L), bf16_planes(R), L.shape[-1], R.shape[-1])


def plain_planes(ops: HeffOps | KeffOps) -> tuple:
    """The plain version's operands, ((re, im) of L, [of W,] of R) as
    views of ``ops``: the arguments of ``kernels.heff_apply_lo`` /
    ``keff_apply_lo`` before the vector."""
    L, R = ops.L[..., :ops.k], ops.R[..., :ops.r]
    if isinstance(ops, KeffOps):
        return (L[0], L[1]), (R[0], R[1])
    _, wl, dout, _ = ops.W.shape
    wr = ops.R.shape[2]
    W = ops.W[..., :ops.j * wr].reshape(2, wl, dout, ops.j, wr)
    return (L[0], L[1]), (W[0], W[1]), (R[0], R[1])


def chain_scratch(planes: int, k: int, x: int, r: int, din: int, dout: int,
                  wl: int, wr: int, device) -> tuple:
    """(psip, t1, t2) scratch of the staged chain kernel in H_eff roles
    (``csrc/chain_tc.cu``): ψ as bf16 planes (P, k·din, pad8(r)), T1
    (P, x, k, pad8(din·wr)) and T2 (P, dout, x, wl, pad8(k)).  The kernel
    writes every entry but the depth padding of T1 and T2, which the next
    GEMM reads: a padded one is allocated zeroed."""

    def alloc(shape, padded):
        return (torch.zeros if padded else torch.empty)(
            (planes, *shape), dtype=torch.bfloat16, device=device)

    dw = din * wr
    return (alloc((k * din, pad8(r)), False),
            alloc((x, k, pad8(dw)), pad8(dw) > dw),
            alloc((dout, x, wl, pad8(k)), pad8(k) > k))


def check_operand(name: str, t: torch.Tensor, dtype, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``,
    16-byte aligned if it is bf16 (the kernels' 16-byte copies)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the vector on {device}")
    if t.dtype != dtype:
        raise TypeError(f"the CUDA kernel takes {dtype} {name}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"the CUDA kernel takes a contiguous {name}")
    if dtype == torch.bfloat16 and t.data_ptr() % 16:
        raise ValueError(f"the CUDA kernel takes a 16-byte aligned {name}")


def heff_lo(ops: HeffOps, psi: torch.Tensor) -> torch.Tensor:
    """σ[b, i, x] of the relaxed H_eff matvec on ψ (k, j, r).

    A CUDA tensor goes through the kernel (complex64 ψ, the bf16 operands
    of :func:`heff_operands`, all contiguous, or this raises); a CPU tensor
    through ``kernels.heff_apply_lo``.  ``heff_lo.launches`` counts kernel
    launches (one per call: its planes kernel and three GEMMs),
    ``heff_lo.plain_calls`` the CPU calls.
    """
    return chain_lo(heff_lo, ops, psi)


def chain_lo(counter, ops: HeffOps, psi: torch.Tensor) -> torch.Tensor:
    """The one-pass chain σ[b, i, x] = Σ L[b,a,k]·W[a,i,j,c]·R[x,c,r]·
    ψ[k,j,r] (:func:`heff_lo`'s; ``cuda_renorm`` runs the one-pass
    environment transfer through it), counted on ``counter``."""
    if psi.ndim != 3 or ops.L.ndim != 4 or ops.W.ndim != 4 or ops.R.ndim != 4:
        raise ValueError("heff_lo takes ψ (k, j, r) and operands from "
                         "heff_operands")
    k, d, r = psi.shape
    _, B, wl, kp = ops.L.shape
    _, X, wr, rp = ops.R.shape
    dout = ops.W.shape[2]
    if ((k, r, d) != (ops.k, ops.r, ops.j)
            or (kp, rp) != (pad8(k), pad8(r))
            or tuple(ops.W.shape) != (2, wl, dout, pad8(d * wr))):
        raise ValueError(
            f"operand shapes L {tuple(ops.L.shape)}, W {tuple(ops.W.shape)}, "
            f"R {tuple(ops.R.shape)} (k={ops.k}, r={ops.r}, j={ops.j}) do "
            f"not fit ψ {tuple(psi.shape)}"
        )
    if psi.device.type == "cpu":
        counter.plain_calls += 1
        return K.heff_apply_lo(*plain_planes(ops), psi)
    if psi.device.type != "cuda":
        raise ValueError(f"heff_lo: no kernel for device {psi.device}")
    dev = psi.device
    check_operand("ψ", psi, torch.complex64, dev)
    for name in ("L", "W", "R"):
        check_operand(name, getattr(ops, name), torch.bfloat16, dev)
    psip, t1, t2 = chain_scratch(2, k, X, r, d, dout, wl, wr, dev)
    out = torch.empty((B, dout, X), dtype=torch.complex64, device=dev)
    code = _cuda.load().pytdscf_heff_tc_c64(
        dev.index, psi.data_ptr(), ops.L.data_ptr(), ops.W.data_ptr(),
        ops.R.data_ptr(), psip.data_ptr(), t1.data_ptr(), t2.data_ptr(),
        out.data_ptr(), B, k, X, r, d, dout, wl, wr,
        _cuda.replay_count(counter, dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda.check(code, "heff_lo")
    counter.launches += 1
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
    dev = sig.device
    check_operand("σ", sig, torch.complex64, dev)
    for name in ("L", "R"):
        check_operand(name, getattr(ops, name), torch.bfloat16, dev)
    # scratch: σ as bf16 planes, and T1 in the layout stage 2 reads
    sigp = torch.empty((2, kp, rp), dtype=torch.bfloat16, device=dev)
    t1 = torch.empty((2, X, w, kp), dtype=torch.bfloat16, device=dev)
    out = torch.empty((B, X), dtype=torch.complex64, device=dev)
    code = _cuda.load().pytdscf_keff_tc_c64(
        dev.index, sig.data_ptr(), ops.L.data_ptr(), ops.R.data_ptr(),
        sigp.data_ptr(), t1.data_ptr(), out.data_ptr(), B, k, X, r, w,
        _cuda.replay_count(keff_lo, dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda.check(code, "keff_lo")
    keff_lo.launches += 1
    return out


heff_lo.launches = 0
heff_lo.plain_calls = 0
heff_lo.replayed = {}
keff_lo.launches = 0
keff_lo.plain_calls = 0
keff_lo.replayed = {}
