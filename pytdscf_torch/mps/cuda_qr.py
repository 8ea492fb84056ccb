"""Thin QR by MGS(×2) for the gauge moves, as CUDA kernels.

Replaces the JAX package's ``mps/pallas_qr.py:mgs_qr_fused`` (its Pallas body is
``_mgs_kernel`` / ``_mgs_phase``).  The kernel is ``csrc/mgs_qr.cu``; its
plain PyTorch version, :func:`mgs_qr_plain`, is the same algorithm as the
JAX package's ``kernels._mgs_qr`` (but for the completion's scan, below)
and serves every CPU tensor.

Semantics (identical in both versions):

* the rank threshold is ``1e-7 · (‖m‖_F + 1e-30)``;
* column k is projected twice against the accumulated Q, and
  ``R[:, k] = c₁ + c₂``, with ``nv = ‖v‖`` on the diagonal;
* a dead column (``nv`` below the threshold) gets the canonical vector
  ``e_{k mod N}``, orthogonalised twice, and a ZERO R diagonal; where that
  vector lies in the span of the earlier columns (its residual below
  :func:`completion_tol`), the next canonical vector that does not
  (ROADMAP C4: the JAX package keeps e_{k mod N} and gets a column that
  is not orthonormal).  The completions set the frame through which the
  fixed-D sweep grows amplitude into padded bond channels, so they are
  part of the result.

What bounds the kernel on the H100: not bytes or FLOPs (a (240, 30) factor
is 0.35 MFLOP over 58 KB) but the serial chain of r columns, each a few
reductions over all N rows.  :func:`route` picks one of three routes by the
shared memory they need (see the source notes in ``csrc/mgs_qr.cu`` and
``csrc/tdvp_device.cuh``):

* ``"block"``: one block of 1024 threads stages m into its shared memory
  once (column-major) and orthogonalises the columns there in place, in
  one launch: the dot products two earlier columns a warp, the update one
  row a thread, four block barriers a live column.  Every shape of the
  184-site chain ((240, 30) the largest), of pyrazine and of the
  donor–acceptor models ((560, 20)) takes it.
* ``"cluster"``: one thread-block cluster of :data:`CLUSTER` CTAs, each
  holding ceil(N / 8) rows of Q in its own shared memory; the reductions run
  over the cluster's distributed shared memory, summed in rank order so
  that every CTA takes the same decisions.  The χ=1024 radical pair's
  (1024, 64) edge gauge takes it.
* ``"device"``: the one-block kernel with Q in a device-memory scratch the
  wrapper allocates (stride N), read through L2, for a Q beyond a
  cluster's shared memory.  No shape of today's paths takes it.
"""

from __future__ import annotations

import math

import torch

from pytdscf_torch import _cuda

#: Dynamic shared memory one launch may ask for on Hopper (bytes): the
#: 227 KB a block can use, less a margin for the static buffers.
MAX_SMEM = 232_448 - 1024
#: Rank threshold relative to ‖m‖_F.
RANK_TOL = 1.0e-07
#: A dead column's completion is the first canonical vector e_j, j = k,
#: k+1, … (mod N), whose residual orthogonalised twice (plus the 1e-30
#: guard of its normalisation) reaches :func:`completion_tol`: e_{k mod N}
#: wherever it does, the JAX package's semantics.  A canonical vector that
#: lies in the span of the earlier columns (the even ground state of H2O on
#: its symmetric grid) leaves rounding noise: the JAX package's MGS keeps
#: it, the columns after it lose their orthogonality, and improved
#: relaxation collapses to E ≈ 0 (ROADMAP C4).  complex64 (the kernels'
#: dtype): the float32 noise floor of two passes over N rows,
#: COMPLETION_NOISE · eps · √N.  H2O's in-span residuals read 9e-16 to
#: 4.8e-8 at N = 9 (bar 5.7e-6); noise over N random rows reads 0.07-0.1
#: eps·√N; any residual above the bar comes out of the second pass
#: orthogonal to ~eps, so the bar replaces no completion that is one.
#: complex128: 1e-28, the residuals the guard swallows (7.7e-34 for H2O),
#: which leaves every other completion as the JAX package makes it (the
#: singlet-fission chain's smallest is 5.6e-26).  Some e_j keeps at least
#: 1/√N (an orthonormal Q[:, :k], k < N, puts k of N units of weight on the
#: rows), so the scan ends for N < 5e5.
COMPLETION_NOISE = 16.0


def completion_tol(dtype: torch.dtype, N: int) -> float:
    """The residual below which a completion of N rows lies in the span
    of the earlier columns (see :data:`COMPLETION_NOISE`)."""
    if dtype == torch.complex128:
        return 1.0e-28
    return COMPLETION_NOISE * torch.finfo(torch.float32).eps * math.sqrt(N)


def _completion(Q, k: int, j: int):
    """The canonical vector e_j orthogonalised twice against Q (whose
    columns from k on are zero), and its norm (+1e-30)."""
    e = torch.zeros((Q.shape[0],), dtype=Q.dtype, device=Q.device)
    e[j] = 1.0
    e = e - Q @ (Q.conj().T @ e)
    e = e - Q @ (Q.conj().T @ e)
    return e, torch.linalg.vector_norm(e) + 1e-30


def mgs_qr_plain(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Thin QR by modified Gram–Schmidt with reorthogonalisation.

    Plain PyTorch, any complex dtype and device; the oracle of the kernel
    and the gauge of every CPU run.  Dead-column decisions stay on the
    device through ``torch.where``; a completion that must look past
    e_{k mod N} (:func:`completion_tol`) reads one flag per candidate.
    """
    N, r = m.shape
    dtype, dev = m.dtype, m.device
    scale = torch.linalg.vector_norm(m) + 1e-30
    Q = torch.zeros((N, r), dtype=dtype, device=dev)
    R = torch.zeros((r, r), dtype=dtype, device=dev)
    one = torch.ones((), dtype=scale.dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    tol = completion_tol(dtype, N)
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
        e, ne = _completion(Q, k, k % N)
        if bool(bad & (ne < tol)):  # one flag read a column
            for t in range(1, N):
                e, ne = _completion(Q, k, (k + t) % N)
                if bool(ne >= tol):
                    break
        Q[:, k] = torch.where(bad, e / ne, v / torch.where(bad, one, nv))
        R[k, k] = torch.where(bad, zero, nv.to(dtype))
    return Q, R


#: CTAs of the cluster route (the portable cluster size)
CLUSTER = 8
#: The kernel's routes, in the order :func:`route` tries them.
ROUTES = ("block", "cluster", "device")


def smem_bytes(N: int, r: int, route: str = "block") -> int:
    """Dynamic shared memory of one block (one CTA) of a route, complex64:
    ``"block"``: Q and three coefficient columns;
    ``"cluster"``: the CTA's ceil(N / CLUSTER) rows of Q (row stride r
    rounded up to an odd number), of v and of e, three coefficient columns,
    four strip partials and two inboxes of CLUSTER partial columns;
    ``"device"``: the coefficients (Q is in device memory)."""
    if route == "block":
        return 8 * (N * r + 3 * r)
    if route == "cluster":
        nc = -(-N // CLUSTER)
        return 8 * (nc * (r | 1) + 2 * nc + (3 + 4 + 2 * CLUSTER) * r)
    if route == "device":
        return 8 * 3 * r
    raise ValueError(f"unknown mgs_qr route {route!r}")


def route(N: int, r: int) -> str:
    """The route of an (N, r) factor: the first of :data:`ROUTES` whose
    shared memory fits one block; raises if none does."""
    for name in ROUTES:
        if smem_bytes(N, r, name) <= MAX_SMEM:
            return name
    raise ValueError(
        f"mgs_qr: the columns of an ({N}, {r}) matrix do not fit one "
        "block's shared memory"
    )


def mgs_qr(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Thin QR ``m = Q·R`` of an (N, r) matrix, N ≥ r.

    A CUDA tensor goes through the kernel of its :func:`route` (complex64,
    contiguous, or this raises); a CPU tensor through :func:`mgs_qr_plain`.
    ``mgs_qr.launches`` counts kernel launches (``mgs_qr.route_launches``
    by route), ``mgs_qr.plain_calls`` the CPU calls.
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
    way = route(N, r)
    q = torch.empty((N, r), dtype=m.dtype, device=m.device)
    rmat = torch.empty((r, r), dtype=m.dtype, device=m.device)
    lib, stream = _cuda.load(), torch.cuda.current_stream(m.device).cuda_stream
    if way == "cluster":
        code = lib.pytdscf_mgs_qr_cluster_c64(
            m.device.index, m.data_ptr(), q.data_ptr(), rmat.data_ptr(), N, r,
            stream,
        )
    else:
        qwork = (torch.empty((r, N), dtype=m.dtype, device=m.device)
                 if way == "device" else None)
        code = lib.pytdscf_mgs_qr_c64(
            m.device.index, m.data_ptr(), q.data_ptr(), rmat.data_ptr(),
            None if qwork is None else qwork.data_ptr(), N, r, stream,
        )
    _cuda.check(code, "mgs_qr")
    mgs_qr.launches += 1
    mgs_qr.route_launches[way] += 1
    return q, rmat


mgs_qr.launches = 0
mgs_qr.route_launches = dict.fromkeys(ROUTES, 0)
mgs_qr.plain_calls = 0
