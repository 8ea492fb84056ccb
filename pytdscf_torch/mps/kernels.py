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

The relaxed-Krylov matvecs (``heff_apply_lo`` / ``keff_apply_lo``) are the
single-bf16-pass form of the first two chains: bf16 operands and chain
intermediates, float32 accumulation.  They are the plain versions of the
``cuda_matvec`` kernels, which round at the same points.

The bf16x3 forms (``"high"`` precision: ``heff_apply_hi``,
``keff_apply_hi``, ``renorm_block_left_hi`` / ``_right_hi``) all run one
plain chain, :func:`chain3_plain`, on operands split into bf16 hi and lo
planes (:func:`hilo`): the plain version of the ``cuda_renorm`` kernel.

Index conventions: site tensor ``psi[l, n, r]``; MPO core ``W[a, i, j, b]``
(i = bra, j = ket); left block ``L[b_bra, a, b_ket]``; right block
``R[b_bra, a, b_ket]`` indexed by the bonds facing the block.
"""

from __future__ import annotations

import math

import torch

from pytdscf_torch.mps import cuda_qr
from pytdscf_torch.mps.cuda_qr import mgs_qr_plain as _mgs_qr  # noqa: F401

#: Bond width from which the JAX package switches the gauge from MGS to
#: CholeskyQR³ (the JAX package's ``mps/kernels.py`` ``CHOLESKY_QR_MIN_R``).
CHOLESKY_QR_MIN_R = 192


def _cholesky_qr(
    m: torch.Tensor, shift_rel: float = 1.0e-06, iters: int = 3
) -> tuple[torch.Tensor, torch.Tensor]:
    """Thin QR by shifted CholeskyQR³ — the large-bond gauge.

    Three rounds of (Gram → shifted Cholesky → triangular solve), all
    matmul-shaped.  Orthogonality of the live columns lands at float32
    round-off; exact-zero input columns stay EXACTLY zero in Q and their R
    rows are zeroed (dead columns get a unit diagonal patch in the Gram
    matrix instead of a completion), so ``Q·R = m`` holds for the
    rank-deficient padded states too.
    """
    N, r = m.shape
    live = torch.sum(torch.abs(m), dim=0) > 0
    q = m
    R_acc = None
    # float32 Gram entries carry ~sqrt(N)·eps relative noise; columns whose
    # true Gram eigenvalue sits below that floor can come out negative,
    # which breaks Cholesky (NaN).  Both shifts must clear the floor.
    real = m.real.dtype
    eps = torch.finfo(real).eps
    noise_floor = 16.0 * math.sqrt(float(N)) * eps
    one = torch.ones((), dtype=real, device=m.device)
    for it in range(iters):
        g = q.mH @ q
        d = torch.diagonal(g).real
        # first round: Fukaya-style shift for near-singular live columns;
        # refinements: noise-floor shift only.  Dead columns: unit diagonal.
        rel = max(shift_rel if it == 0 else 0.0, noise_floor)
        s = rel * torch.clamp_min(torch.max(d), 1e-30)
        g = g + torch.diag(torch.where(live, s, one)).to(g.dtype)
        # no info check (a host read): a NaN propagates, as in the JAX
        # package
        L, _ = torch.linalg.cholesky_ex(g, check_errors=False)
        # q·L⁻ᴴ, i.e. solve X·Lᴴ = q
        q = torch.linalg.solve_triangular(L.mH, q, upper=True, left=False)
        Rit = L.mH
        R_acc = Rit if R_acc is None else Rit @ R_acc
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    q = torch.where(live[None, :], q, zero)
    R_acc = torch.where(live[:, None], R_acc, zero)
    return q, R_acc


def thin_qr(mat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Thin QR of an (N, r) matrix, the JAX package's accelerator gauge.

    ``r >= CHOLESKY_QR_MIN_R`` and ``N >= r``: shifted CholeskyQR³
    (plain torch on every device).  Otherwise MGS(×2) with canonical
    completion of dead columns: the CUDA kernel for a CUDA tensor, its
    plain version for a CPU tensor (``cuda_qr.mgs_qr``).  The completions
    of rank-deficient columns set the frame through which the fixed-D
    sweep grows amplitude into padded bond channels, so LAPACK's QR is not
    a substitute.
    """
    N, r = mat.shape
    if r >= CHOLESKY_QR_MIN_R and N >= r:
        return _cholesky_qr(mat)
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


# ------------------------------------------------- relaxed (planar bf16)
def planar_bf16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex tensor → (re, im) bfloat16 planes."""
    return x.real.to(torch.bfloat16), x.imag.to(torch.bfloat16)


def _cx_einsum(eq, a, b, out_dtype=torch.bfloat16):
    """Complex einsum on planar pairs: four real products of the bf16
    planes, float32 accumulation, ``out_dtype`` storage (bf16 keeps the
    chain intermediates half-width)."""
    ar, ai = a[0].float(), a[1].float()
    br, bi = b[0].float(), b[1].float()
    re = torch.einsum(eq, ar, br) - torch.einsum(eq, ai, bi)
    im = torch.einsum(eq, ar, bi) + torch.einsum(eq, ai, br)
    return re.to(out_dtype), im.to(out_dtype)


def heff_apply_lo(Lp, Wp, Rp, psi: torch.Tensor) -> torch.Tensor:
    """Single-bf16-pass H_eff matvec with planar operands/intermediates.

    ``Lp``/``Wp``/``Rp``: ``planar_bf16`` pairs of the blocks (split once
    per site, outside the Krylov loop).  Same contraction order as
    :func:`heff_apply`: ψ·R (over r) → ·W (over j,c) → ·L (over a,k),
    with T1 and T2 rounded to bf16 and σ kept in float32."""
    t1 = _cx_einsum("kjr,xcr->kjxc", planar_bf16(psi), Rp)
    t2 = _cx_einsum("kjxc,aijc->kiax", t1, Wp)
    sr, si = _cx_einsum("kiax,bak->bix", t2, Lp, out_dtype=torch.float32)
    return torch.complex(sr, si).to(psi.dtype)


def renorm_block_left_lo(L, a_bra, W, a_ket) -> torch.Tensor:
    """:func:`renorm_block_left` at one bf16 pass (``env_precision=
    "default"``): :func:`heff_apply_lo` in the transfer's roles, ψ = L
    (b,a,k), L = Ā (o,i,b), W (i,c,a,j), R = A_ket (p,j,k)."""
    return heff_apply_lo(planar_bf16(torch.conj_physical(a_bra).permute(2, 1, 0)),
                         planar_bf16(W.permute(1, 3, 0, 2)),
                         planar_bf16(a_ket.permute(2, 1, 0)), L).to(L.dtype)


def renorm_block_right_lo(R, b_bra, W, b_ket) -> torch.Tensor:
    """:func:`renorm_block_right` at one bf16 pass: ψ = R (b,a,k), L = B̄
    (o,i,b), W (i,c,a,j), R = B_ket (p,j,k)."""
    return heff_apply_lo(planar_bf16(torch.conj_physical(b_bra)),
                         planar_bf16(W.permute(1, 0, 3, 2)),
                         planar_bf16(b_ket), R).to(R.dtype)


def keff_apply_lo(Lp, Rp, sig: torch.Tensor) -> torch.Tensor:
    """Single-bf16-pass K_eff matvec (see :func:`heff_apply_lo`)."""
    t1 = _cx_einsum("kr,xar->kxa", planar_bf16(sig), Rp)
    sr, si = _cx_einsum("kxa,bak->bx", t1, Lp, out_dtype=torch.float32)
    return torch.complex(sr, si).to(sig.dtype)


def make_hmatvec_lo(L, W, R, shape, fac):
    """Relaxed H_eff matvec on flat Krylov vectors of a site of ``shape``.

    The bf16 operands are built once here, outside the Krylov loop
    (``cuda_matvec.heff_operands``); each call goes through
    ``cuda_matvec.heff_lo`` (the kernel on CUDA, the plain version on the
    CPU) and is then scaled by ``fac``, the real env log-scale factor, in
    the working precision."""
    from pytdscf_torch.mps import cuda_matvec as CM

    ops = CM.heff_operands(L, W, R)

    def mv(vec):
        return (CM.heff_lo(ops, vec.reshape(shape)) * fac).reshape(-1)

    return mv


def make_kmatvec_lo(L, R, shape, fac):
    """Relaxed K_eff matvec (see :func:`make_hmatvec_lo`)."""
    from pytdscf_torch.mps import cuda_matvec as CM

    ops = CM.keff_operands(L, R)

    def mv(vec):
        return (CM.keff_lo(ops, vec.reshape(shape)) * fac).reshape(-1)

    return mv


# ------------------------------------------------------ bf16x3 ("high")
def hilo(x: torch.Tensor) -> torch.Tensor:
    """Complex tensor → ``(*x.shape, 4)`` bf16 (re_hi, im_hi, re_lo, im_lo).

    hi = bf16(x) and lo = bf16(x − hi), both rounded to nearest even, from
    the float32 value (the JAX package's ``pallas_renorm._hilo`` /
    ``_hilo_planes``): hi + lo carries about 16 mantissa bits."""
    v = torch.view_as_real(x).float()
    hi = v.to(torch.bfloat16)
    lo = (v - hi.float()).to(torch.bfloat16)
    return torch.cat([hi, lo], dim=-1).contiguous()


def _split_trunc(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 → (hi, lo) float32 tensors of bf16 values: hi by clearing the
    low 16 bits, lo = bf16(t − hi) (``pallas_renorm._split_hilo``)."""
    hi = (t.view(torch.int32) & -65536).view(torch.float32)
    return hi, (t - hi).to(torch.bfloat16).float()


def _dot3(eq, x, y, passes):
    """bf16x3 real product xh·yh + xh·yl + xl·yh, each a float32 einsum of
    bf16 values (exact products, float32 sums); ``passes=1`` keeps xh·yh."""
    (xh, xl), (yh, yl) = x, y
    out = torch.einsum(eq, xh, yh)
    if passes == 3:
        out = out + torch.einsum(eq, xh, yl) + torch.einsum(eq, xl, yh)
    return out


def _cx_dot3(eq, x, y, passes):
    """Complex product on ((re_hi, re_lo), (im_hi, im_lo)) planes →
    (re, im) float32."""
    xr, xi = x
    yr, yi = y
    re = _dot3(eq, xr, yr, passes) - _dot3(eq, xi, yi, passes)
    im = _dot3(eq, xr, yi, passes) + _dot3(eq, xi, yr, passes)
    return re, im


def _hl_planes(t: torch.Tensor):
    f = t.float()
    return (f[..., 0], f[..., 2]), (f[..., 1], f[..., 3])


def chain3_plain(psi, L, W, R, passes: int = 3) -> torch.Tensor:
    """bf16x3 chain out[b,i,x] = Σ L[b,a,k]·W[a,i,j,c]·R[x,c,r]·ψ[k,j,r]
    on :func:`hilo` operands (complex64 result): the plain version of
    ``csrc/chain_tc.cu`` at bf16x3 and the counterpart of the JAX package's
    ``pallas_renorm._renorm3_kernel`` in its H_eff roles, rounding at its
    points: split operands, T1 and T2 accumulated in float32 and split by
    truncation, three bf16 products per real product.  ``passes=1`` drops
    every lo pass (one bf16 pass), for showing that a bar catches it."""
    t1 = _cx_dot3("kjr,xcr->kjxc", _hl_planes(psi), _hl_planes(R), passes)
    t1 = tuple(_split_trunc(t) for t in t1)
    t2 = _cx_dot3("kjxc,aijc->kiax", t1, _hl_planes(W), passes)
    t2 = tuple(_split_trunc(t) for t in t2)
    return torch.complex(*_cx_dot3("kiax,bak->bix", t2, _hl_planes(L), passes))


def renorm_left_operands(L, a_bra, W, a_ket):
    """(ψ, L, W, R) chain operands of L'[o,c,p] (the roles of
    ``pallas_renorm.renorm_left_pallas``): ψ = L (b,a,k), L = Ā (o,i,b),
    W (i,c,a,j), R = A_ket (p,j,k)."""
    return (hilo(L), hilo(torch.conj_physical(a_bra).permute(2, 1, 0)),
            hilo(W.permute(1, 3, 0, 2)), hilo(a_ket.permute(2, 1, 0)))


def renorm_right_operands(R, b_bra, W, b_ket):
    """(ψ, L, W, R) chain operands of R'[o,c,p]: ψ = R (b,a,k),
    L = B̄ (o,i,b), W (i,c,a,j), R = B_ket (p,j,k)."""
    return (hilo(R), hilo(torch.conj_physical(b_bra)),
            hilo(W.permute(1, 0, 3, 2)), hilo(b_ket))


def eye_mpo(w: int, like: torch.Tensor) -> torch.Tensor:
    """The identity over an MPO bond of width w as a (w, 1, 1, w) core:
    K_eff is the H_eff chain with d = 1 and this W."""
    eye = torch.eye(w, dtype=like.dtype, device=like.device)
    return eye.reshape(w, 1, 1, w)


def renorm_block_left_hi(L, a_bra, W, a_ket, passes: int = 3):
    """:func:`renorm_block_left` at bf16x3 (``env_precision="high"``)."""
    ops = renorm_left_operands(L, a_bra, W, a_ket)
    return chain3_plain(*ops, passes=passes).to(L.dtype)


def renorm_block_right_hi(R, b_bra, W, b_ket, passes: int = 3):
    """:func:`renorm_block_right` at bf16x3 (``env_precision="high"``)."""
    ops = renorm_right_operands(R, b_bra, W, b_ket)
    return chain3_plain(*ops, passes=passes).to(R.dtype)


def heff_apply_hi(L, W, R, psi, passes: int = 3):
    """:func:`heff_apply` at bf16x3 (``matvec_precision="high"``)."""
    out = chain3_plain(hilo(psi), hilo(L), hilo(W), hilo(R), passes=passes)
    return out.to(psi.dtype)


def keff_apply_hi(L, R, sig, passes: int = 3):
    """:func:`keff_apply` at bf16x3: the chain with d = 1 and W the
    identity over the MPO bond."""
    out = chain3_plain(hilo(sig.unsqueeze(1)), hilo(L),
                       hilo(eye_mpo(L.shape[1], L)), hilo(R), passes=passes)
    return out[:, 0, :].to(sig.dtype)


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
