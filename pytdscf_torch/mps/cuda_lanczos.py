"""Short-iterative Lanczos exponential as one CUDA kernel.

Replaces the JAX package's ``mps/pallas_lanczos.py:lanczos_expm_fused`` (Pallas
body ``_lanczos_kernel`` / ``_lanczos_phase``).  The kernel is
``csrc/lanczos_expm.cu``; :func:`lanczos_expm_plain` is its plain PyTorch
version, which serves every CPU tensor.

The effective operator is pre-contracted once per site into channels
(:func:`heff_channels`, :func:`keff_channels`, plain einsums):

    H_c[(b,i), (k,j)] = Σ_a L[b,a,k] · W[a,i,j,c],   Rt_c[r, x] = R[x, c, r]

so that one matvec is ``Σ_c H_c · (ψ · Rt_c)`` on ψ as an (M, r) matrix; the
K_eff step takes ``H_a = L[:, a, :]`` and no MPO core.  The real factor
``exp(lL + lR)`` that restores the log-normalised environment blocks is
folded into ``H_c``, so the float32 range holds along a 184-site chain.

Lanczos semantics (the JAX package's ``mps/integrator.py:_lanczos_loop``): oblique
``α_k = ⟨v₀|H v_k⟩`` with Re(α) on the diagonal, breakdown at β < 1e-14,
convergence when ``k > 0`` and ``‖ψ(k) − ψ(k−1)‖ < thresh``, ``k_max =
min(max_dim, n)``, ``bad`` never set when ``k_max ≥ n``; ``conserve``
renormalises the result, otherwise it is scaled by ``‖v‖``.  The
coefficients ``exp(scale·T)e₀`` come from order-10 Taylor substeps of norm
≤ 0.5 (Gershgorin count), as in the Pallas kernel; they agree with the
JAX package's ``eigh`` form to ~1e-11 relative in complex128.

What bounds the kernel on the H100 is the matvec: 7.8 M complex
multiply-adds at the chain's bulk site (nc = 4, M = 240, r = 30), a few
times per call, in sequence.  This first version runs the whole recurrence
in one block of 1024 threads (plain fp32 FMA, tiled through shared
memory), so it is bound by one SM's FP32 rate; the Krylov vectors and the
(1.8 MB) channels sit in L2, in device-memory scratch the wrapper
allocates.  Spreading the matvec over more SMs is later work.
"""

from __future__ import annotations

import math

import torch

from pytdscf_torch import _cuda

EPS_BREAKDOWN = 1.0e-14
#: Taylor order per substep: with ‖scale·T‖ ≤ 0.5 per substep the
#: truncation error is 0.5^11/11! ≈ 1e-11.
TAYLOR_ORDER = 10
SUBSTEP_NORM = 0.5
MAX_SUBSTEPS = 65536
#: Largest Krylov dimension the kernel takes (one warp holds the
#: coefficient vector).
MAX_KRYLOV = 32


def heff_channels(L, W, R, fac=None):
    """(H_c, Rt_c) of the H_eff matvec; ``fac`` (a real scalar tensor, the
    env log-scale factor) is folded into H_c.  Both come out contiguous."""
    Lf = L if fac is None else L * fac.to(L.dtype)
    H = torch.einsum("bak,aijc->cbikj", Lf, W)
    nc, b, i, k, j = H.shape
    H = H.reshape(nc, b * i, k * j).contiguous()
    return H, R.permute(1, 2, 0).contiguous()


def keff_channels(L, R, fac=None):
    """(H_a, Rt_a) of the K_eff matvec: H_a = L[:, a, :] (no MPO core)."""
    Lf = L if fac is None else L * fac.to(L.dtype)
    return Lf.permute(1, 0, 2).contiguous(), R.permute(1, 2, 0).contiguous()


def substeps(bound: float) -> int:
    """Taylor substeps for a Gershgorin bound of ‖scale·T‖ (1 if the bound
    is not finite, so a NaN propagates instead of looping)."""
    if not math.isfinite(bound):
        return 1
    return min(max(math.ceil(bound / SUBSTEP_NORM), 1), MAX_SUBSTEPS)


def tridiag_expm_e0(diag, off, scale: complex) -> torch.Tensor:
    """exp(scale·T)e₀ for the symmetric tridiagonal T = tridiag(off, diag,
    off) (real 1-D tensors), by order-10 Taylor substeps."""
    n = diag.shape[0]
    bound = abs(scale) * (
        float(diag.abs().max()) + 2.0 * (float(off.max()) if n > 1 else 0.0)
    )
    m = substeps(bound)
    s = scale / m
    cdtype = torch.complex128 if diag.dtype == torch.float64 else torch.complex64
    y = torch.zeros(n, dtype=cdtype, device=diag.device)
    y[0] = 1.0
    for _ in range(m):
        t = y
        for order in range(1, TAYLOR_ORDER + 1):
            z = diag * t
            if n > 1:
                z[1:] += off * t[:-1]
                z[:-1] += off * t[1:]
            t = (z * s) * (1.0 / order)
            y = y + t
    return y


def _matvec(H, Rt, x):
    return torch.matmul(H, torch.matmul(x, Rt)).sum(0)


def lanczos_expm_plain(H, Rt, v, scale: complex, thresh: float, kmax: int,
                       conserve: bool):
    """Plain PyTorch version of the kernel, any complex dtype and device.

    Returns ``(ψ (M, r), status)`` with ``status = [k_used, bad]`` (int32).
    The loop control reads α, β and the error on the host.
    """
    M, r = v.shape
    n = M * r
    real = v.real.dtype
    beta0 = torch.linalg.vector_norm(v)
    V = torch.zeros((kmax + 1, M, r), dtype=v.dtype, device=v.device)
    V[0] = v / beta0
    alpha = torch.zeros(kmax, dtype=real, device=v.device)  # Re(α)
    beta = torch.zeros(kmax, dtype=real, device=v.device)
    prev = torch.zeros_like(v)
    k_fin, bad = 0, False
    for k in range(kmax):
        w = _matvec(H, Rt, V[k])
        a = torch.sum(V[0].conj() * w)
        w = w - a * V[k]
        if k > 0:
            w = w - beta[k - 1] * V[k - 1]
        b = torch.linalg.vector_norm(w)
        live = bool(b > EPS_BREAKDOWN)
        if live:
            V[k + 1] = w / b
            beta[k] = b
        alpha[k] = a.real
        c = tridiag_expm_e0(alpha[: k + 1], beta[:k], scale)
        psi = torch.tensordot(c.to(v.dtype), V[: k + 1], dims=1)
        err = float(torch.linalg.vector_norm(psi - prev))
        prev = psi
        conv = k > 0 and err < thresh
        capped = k + 1 >= kmax
        k_fin = k + 1
        if conv or not live or capped:
            bad = capped and not conv and live
            break
    fac = 1.0 / torch.linalg.vector_norm(prev) if conserve else beta0
    status = torch.tensor(
        [k_fin, int(bad and kmax < n)], dtype=torch.int32, device=v.device
    )
    return prev * fac, status


def lanczos_expm(ch, v, scale: complex, thresh: float, max_dim: int,
                 conserve: bool):
    """``exp(scale·H)·v`` for the channels ``ch = (H, Rt)`` and ψ ``v``
    (M, r); returns ``(ψ', status)``, ``status = [k_used, bad]`` (int32).

    A CUDA tensor goes through the kernel (complex64, contiguous, k_max ≤
    32, or this raises); a CPU tensor through :func:`lanczos_expm_plain`.
    ``lanczos_expm.launches`` counts kernel launches,
    ``lanczos_expm.plain_calls`` the CPU calls.
    """
    H, Rt = ch
    if v.ndim != 2 or H.ndim != 3 or Rt.ndim != 3:
        raise ValueError("lanczos_expm takes v (M, r), H (nc, M, M), Rt (nc, r, r)")
    M, r = v.shape
    nc = H.shape[0]
    if H.shape != (nc, M, M) or Rt.shape != (nc, r, r):
        raise ValueError(
            f"channel shapes {tuple(H.shape)}, {tuple(Rt.shape)} do not fit "
            f"v {tuple(v.shape)}"
        )
    kmax = min(max_dim, M * r)
    if kmax < 1:
        raise ValueError(f"max_dim must be positive, got {max_dim}")
    if v.device.type == "cpu":
        lanczos_expm.plain_calls += 1
        return lanczos_expm_plain(H, Rt, v, scale, thresh, kmax, conserve)
    if v.device.type != "cuda":
        raise ValueError(f"lanczos_expm: no kernel for device {v.device}")
    for name, t in (("v", v), ("H", H), ("Rt", Rt)):
        if t.dtype != torch.complex64:
            raise TypeError(f"the CUDA lanczos_expm takes complex64 {name}, got {t.dtype}")
        if t.device != v.device:
            raise ValueError(f"{name} is on {t.device}, v on {v.device}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA lanczos_expm takes a contiguous {name}")
    if kmax > MAX_KRYLOV:
        raise ValueError(f"the CUDA lanczos_expm takes max_dim <= {MAX_KRYLOV}")
    out = torch.empty_like(v)
    status = torch.empty(2, dtype=torch.int32, device=v.device)
    scratch = torch.empty(
        (kmax + 3 + nc) * M * r, dtype=torch.complex64, device=v.device
    )
    scale = complex(scale)
    code = _cuda.load().pytdscf_lanczos_expm_c64(
        v.device.index, H.data_ptr(), Rt.data_ptr(), v.data_ptr(),
        out.data_ptr(), status.data_ptr(), scratch.data_ptr(), nc, M, r, kmax,
        scale.real, scale.imag, float(thresh), int(bool(conserve)),
        torch.cuda.current_stream(v.device).cuda_stream,
    )
    _cuda.check(code, "lanczos_expm")
    lanczos_expm.launches += 1
    return out, status


lanczos_expm.launches = 0
lanczos_expm.plain_calls = 0
