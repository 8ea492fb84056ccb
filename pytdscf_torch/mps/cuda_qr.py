"""Thin QR by MGS(×2) for the small-bond gauge, as one CUDA kernel.

Replaces the JAX package's ``mps/pallas_qr.py:mgs_qr_fused`` (its Pallas body is
``_mgs_kernel`` / ``_mgs_phase``).  The kernel is ``csrc/mgs_qr.cu``; its
plain PyTorch version, :func:`mgs_qr_plain`, is the same algorithm as the
JAX package's ``kernels._mgs_qr`` and serves every CPU tensor.

Semantics (identical in both versions):

* the rank threshold is ``1e-7 · (‖m‖_F + 1e-30)``;
* column k is projected twice against the accumulated Q, and
  ``R[:, k] = c₁ + c₂``, with ``nv = ‖v‖`` on the diagonal;
* a dead column (``nv`` below the threshold) gets the canonical vector
  ``e_{k mod N}``, orthogonalised twice, and a ZERO R diagonal.  The
  completions set the frame through which the fixed-D sweep grows
  amplitude into padded bond channels, so they are part of the result.

What bounds the kernel on the H100: not bytes or FLOPs (a (240, 30) factor
is 0.35 MFLOP over 58 KB) but the serial chain of r columns, each a few
block-wide reductions.  The design keeps that chain on one SM: one block of
256 threads holds Q in shared memory, column-major so that the per-column
dot products and updates read consecutive banks, and runs all r columns in
one launch.  Q sits in the block's 227 KB of shared memory when it fits
(N·r ≤ ~28k complex entries; the 184-site chain's largest is 240 × 30);
a larger Q (the χ=1024 chain's (1024, 64) edge gauge) sits in a
device-memory scratch the wrapper allocates, read through L2.
"""

from __future__ import annotations

import torch

from pytdscf_torch import _cuda

#: Dynamic shared memory one launch may ask for on Hopper (bytes): the
#: 227 KB a block can use, less a margin for the static buffers.
MAX_SMEM = 232_448 - 1024
#: Rank threshold relative to ‖m‖_F.
RANK_TOL = 1.0e-07


def mgs_qr_plain(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Thin QR by modified Gram–Schmidt with reorthogonalisation.

    Plain PyTorch, any complex dtype and device; the oracle of the kernel
    and the gauge of every CPU run.  No host synchronisation: dead-column
    decisions stay on the device through ``torch.where``.
    """
    N, r = m.shape
    dtype, dev = m.dtype, m.device
    scale = torch.linalg.vector_norm(m) + 1e-30
    Q = torch.zeros((N, r), dtype=dtype, device=dev)
    R = torch.zeros((r, r), dtype=dtype, device=dev)
    one = torch.ones((), dtype=scale.dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    for k in range(r):
        v = m[:, k]
        # two Gram–Schmidt passes against the accumulated Q
        c1 = Q.conj().T @ v
        v = v - Q @ c1
        c2 = Q.conj().T @ v
        v = v - Q @ c2
        R[:, k] = c1 + c2
        nv = torch.linalg.vector_norm(v)
        bad = nv < RANK_TOL * scale
        # deterministic completion: canonical basis vector, orthogonalised
        e = torch.zeros((N,), dtype=dtype, device=dev)
        e[k % N] = 1.0
        e = e - Q @ (Q.conj().T @ e)
        e = e - Q @ (Q.conj().T @ e)
        ne = torch.linalg.vector_norm(e) + 1e-30
        Q[:, k] = torch.where(bad, e / ne, v / torch.where(bad, one, nv))
        R[k, k] = torch.where(bad, zero, nv.to(dtype))
    return Q, R


def smem_bytes(N: int, r: int, q_in_smem: bool = True) -> int:
    """Dynamic shared memory of one launch: Q (unless it is in device
    memory), v, e and three coefficient columns, complex64."""
    return 8 * ((N * r if q_in_smem else 0) + 2 * N + 3 * r)


def mgs_qr(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Thin QR ``m = Q·R`` of an (N, r) matrix, N ≥ r.

    A CUDA tensor goes through the kernel (complex64, contiguous, or this
    raises); a CPU tensor through :func:`mgs_qr_plain`.
    ``mgs_qr.launches`` counts kernel launches, ``mgs_qr.plain_calls``
    the CPU calls.
    """
    if m.ndim != 2:
        raise ValueError(f"mgs_qr takes a matrix, got shape {tuple(m.shape)}")
    N, r = m.shape
    if N < r or r < 1:
        raise ValueError(f"thin QR needs N >= r >= 1, got ({N}, {r})")
    if m.device.type == "cpu":
        mgs_qr.plain_calls += 1
        return mgs_qr_plain(m)
    if m.device.type != "cuda":
        raise ValueError(f"mgs_qr: no kernel for device {m.device}")
    if m.dtype != torch.complex64:
        raise TypeError(f"the CUDA mgs_qr takes complex64, got {m.dtype}")
    if not m.is_contiguous():
        raise ValueError("the CUDA mgs_qr takes a contiguous matrix")
    qwork = None
    if smem_bytes(N, r) > MAX_SMEM:
        if smem_bytes(N, r, q_in_smem=False) > MAX_SMEM:
            raise ValueError(
                f"mgs_qr: the columns of an ({N}, {r}) matrix do not fit "
                "one block's shared memory"
            )
        qwork = torch.empty((r, N), dtype=m.dtype, device=m.device)
    q = torch.empty((N, r), dtype=m.dtype, device=m.device)
    rmat = torch.empty((r, r), dtype=m.dtype, device=m.device)
    code = _cuda.load().pytdscf_mgs_qr_c64(
        m.device.index, m.data_ptr(), q.data_ptr(), rmat.data_ptr(),
        None if qwork is None else qwork.data_ptr(), N, r,
        torch.cuda.current_stream(m.device).cuda_stream,
    )
    _cuda.check(code, "mgs_qr")
    mgs_qr.launches += 1
    return q, rmat


mgs_qr.launches = 0
mgs_qr.plain_calls = 0
