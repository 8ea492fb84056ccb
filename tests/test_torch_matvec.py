"""The relaxed-Krylov matvecs of the port against the JAX package.

``kernels.heff_apply_lo`` / ``keff_apply_lo`` are the plain versions of the
``cuda_matvec`` kernels.  On the CPU they are held against the JAX
package's planar-bf16 einsums (``K.heff_apply_lo``), against its Pallas
kernels (``pallas_matvec.heff_pallas`` in interpret mode) and against the
exact complex128 chains.  The tests marked ``cuda`` hold each kernel
against its plain version on an NVIDIA GPU and skip elsewhere.

Tolerances.  Both versions round ψ, the blocks and the chain
intermediates T1, T2 to bf16 at the same points and accumulate in float32;
they differ only in the order of the float32 sums, which now and then
moves a T1/T2 entry across a bf16 rounding boundary (one bf16 ulp,
2^-8 relative).  Those rare flips leave the outputs 3e-8 to 4e-5 apart
relative to the output norm (measured on the CPU at the shapes below and
at (256, 256, 256, 8, 4)); the bar against JAX is 5e-4.  On the card each
kernel sums in the tensor cores' fixed order along the whole depth of
each GEMM.  On an H100 it reads 1.7e-7 to 9.2e-6 against plain on the
χ=1024 chain's own operands (``chip_smoke.py`` holds those to 1e-4), and
up to 1.1e-4 on random operands at the χ=1024 bulk with d = 16 (long
unstructured sums put many T1 entries near a bf16 rounding boundary).
One bf16 rounding more
or less (the output rounded to bf16, or T1 kept in float32) moves the
output by 1.4e-3 to 2.6e-3, so the bar between kernel and plain on random
operands is 3e-4, about 3× above the largest sound reading and 5× below
the smallest fault; the ``test_card_bar_catches_*`` tests show that both
faults fail it.  A second launch must repeat
the first bit for bit.  Against the exact chain the bf16 rounding itself
is the error: rel < 2e-2, the bar of ``tests/test_pallas_matvec.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pytdscf_torch.mps import cuda_matvec as CM
from pytdscf_torch.mps import kernels as TK

torch.set_num_threads(1)

REL_JAX = 5e-4  # plain port vs JAX bf16 chain: float32 sum order only
REL_EXACT = 2e-2  # bf16 chain vs exact complex128 chain
REL_CARD = 3e-4  # kernel vs plain on the card, random operands: sum order only


def _cx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _heff_case(seed, b, k, x, w, d):
    rng = np.random.default_rng(seed)
    return _cx(rng, b, w, k), _cx(rng, w, d, d, w), _cx(rng, x, w, x), _cx(rng, k, d, x)


def _keff_case(seed, b, k, x, w):
    rng = np.random.default_rng(seed)
    return _cx(rng, b, w, k), _cx(rng, x, w, x), _cx(rng, k, x)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


T = torch.from_numpy

SHAPES_H = [(128, 128, 128, 3, 2), (24, 16, 40, 3, 4)]  # tile-divisible, ragged
SHAPES_K = [(128, 128, 128, 3), (24, 16, 40, 3)]


@pytest.mark.parametrize("b,k,x,w,d", SHAPES_H)
def test_heff_plain_matches_jax(b, k, x, w, d):
    import pytdscf_tpu.mps.kernels as JK

    L, W, R, psi = _heff_case(1, b, k, x, w, d)
    ops = CM.heff_operands(T(L), T(W), T(R))
    calls = CM.heff_lo.plain_calls
    got = CM.heff_lo(ops, T(psi)).numpy()
    assert CM.heff_lo.plain_calls == calls + 1
    want = JK.heff_apply_lo(JK.planar_bf16(L), JK.planar_bf16(W),
                            JK.planar_bf16(R), psi)
    exact = JK.heff_apply(L, W, R, psi)
    assert got.shape == (b, d, x)
    assert _rel(got, want) < REL_JAX
    assert _rel(got, exact) < REL_EXACT
    assert _rel(want, exact) < REL_EXACT


@pytest.mark.parametrize("b,k,x,w", SHAPES_K)
def test_keff_plain_matches_jax(b, k, x, w):
    import pytdscf_tpu.mps.kernels as JK

    L, R, sig = _keff_case(2, b, k, x, w)
    ops = CM.keff_operands(T(L), T(R))
    calls = CM.keff_lo.plain_calls
    got = CM.keff_lo(ops, T(sig)).numpy()
    assert CM.keff_lo.plain_calls == calls + 1
    want = JK.keff_apply_lo(JK.planar_bf16(L), JK.planar_bf16(R), sig)
    exact = JK.keff_apply(L, R, sig)
    assert got.shape == (b, x)
    assert _rel(got, want) < REL_JAX
    assert _rel(got, exact) < REL_EXACT


def test_plain_matches_pallas_kernels():
    """One 128-tile shape through the Pallas kernels in interpret mode."""
    from pytdscf_tpu.mps import pallas_matvec as PM

    L, W, R, psi = _heff_case(3, 128, 128, 128, 2, 2)
    got = CM.heff_lo(CM.heff_operands(T(L), T(W), T(R)), T(psi)).numpy()
    want = PM.heff_pallas(*PM.heff_operands(L, W, R), psi)
    assert _rel(got, want) < REL_JAX
    L, R, sig = _keff_case(4, 128, 128, 128, 2)
    got = CM.keff_lo(CM.keff_operands(T(L), T(R)), T(sig)).numpy()
    want = PM.keff_pallas(*PM.keff_operands(L, R), sig)
    assert _rel(got, want) < REL_JAX


def test_matvec_builders_scale_and_flatten():
    L, W, R, psi = _heff_case(5, 24, 16, 40, 3, 4)
    fac = torch.tensor(0.37, dtype=torch.float64)
    mv = TK.make_hmatvec_lo(T(L), T(W), T(R), psi.shape, fac)
    ops = CM.heff_operands(T(L), T(W), T(R))
    out = mv(T(psi).reshape(-1))
    assert out.shape == (24 * 4 * 40,)
    assert torch.equal(out, (CM.heff_lo(ops, T(psi)) * 0.37).reshape(-1))
    L, R, sig = _keff_case(6, 24, 16, 40, 3)
    mv = TK.make_kmatvec_lo(T(L), T(R), sig.shape, fac)
    out = mv(T(sig).reshape(-1))
    ops = CM.keff_operands(T(L), T(R))
    assert torch.equal(out, (CM.keff_lo(ops, T(sig)) * 0.37).reshape(-1))


def test_wrappers_check_shapes():
    L, W, R, psi = _heff_case(7, 24, 16, 40, 3, 4)
    ops = CM.heff_operands(T(L), T(W), T(R))
    with pytest.raises(ValueError):
        CM.heff_lo(ops, T(psi[:8]))
    with pytest.raises(ValueError):
        CM.heff_lo(ops, T(psi).reshape(16, -1))
    L, R, sig = _keff_case(8, 24, 16, 40, 3)
    with pytest.raises(ValueError):
        CM.keff_lo(CM.keff_operands(T(L), T(R)), T(sig[:, :8]))


def _keff_staged(ops, sig):
    """The K_eff kernel's two stages in plain PyTorch, through its layouts
    (``csrc/keff_tc.cu``): σ as zero-padded bf16 planes (2, kp, rp); stage 1
    transposed, T1t[(x,a), k] = Σ_r R[(x,a), r] σ[k, r], rounded to bf16 and
    written to the (2, x, a, kp) scratch; stage 2 reads it back as rows x
    of depth (a, k) against L's rows b of depth (a, k)."""
    _, b, w, kp = ops.L.shape
    _, x, _, rp = ops.R.shape
    k, r = sig.shape
    sigp = torch.zeros((2, kp, rp), dtype=torch.bfloat16)
    sigp[:, :k, :r] = torch.view_as_real(sig).to(torch.bfloat16).movedim(-1, 0)
    f32 = torch.float32
    Rr, Ri = ops.R.reshape(2, x * w, rp).to(f32)
    sr, si = sigp.to(f32)
    t1 = torch.empty((2, x, w, kp), dtype=torch.bfloat16)
    t1[0] = (Rr @ sr.T - Ri @ si.T).to(torch.bfloat16).reshape(x, w, kp)
    t1[1] = (Rr @ si.T + Ri @ sr.T).to(torch.bfloat16).reshape(x, w, kp)
    Lr, Li = ops.L.reshape(2, b, w * kp).to(f32)
    Tr, Ti = t1.reshape(2, x, w * kp).to(f32)
    return torch.complex(Lr @ Tr.T - Li @ Ti.T, Lr @ Ti.T + Li @ Tr.T)


@pytest.mark.parametrize("b,k,x,w", [(130, 70, 33, 7), (4, 1, 16, 7), (24, 16, 40, 3)])
def test_keff_kernel_layout_matches_plain(b, k, x, w):
    """The K_eff kernel's layout contract on the CPU: σ, R and L as small
    integers (exact in bf16), so that every float32 sum is exact in any
    order and T1's bf16 rounding (its entries reach ~10³) is the only
    rounding: the staged reference must equal ``keff_apply_lo`` bit for
    bit, and the padding must hold zeros."""
    rng = np.random.default_rng(15)

    def ints(*shape):
        return T(rng.integers(-3, 4, shape) + 1j * rng.integers(-3, 4, shape))

    L, R, sig = ints(b, w, k), ints(x, w, x), ints(k, x)
    ops = CM.keff_operands(L, R)
    assert ops.L.shape == (2, b, w, CM.pad8(k)) and ops.R.shape == (2, x, w, CM.pad8(x))
    assert not ops.L[..., k:].any() and not ops.R[..., x:].any()
    want = CM.keff_lo(ops, sig.to(torch.complex64))
    got = _keff_staged(ops, sig.to(torch.complex64))
    assert float(torch.linalg.vector_norm(want)) > 0
    assert torch.equal(got, want)


def _gemm(A, B, passes):
    """C[m, n] = Σ_d A[m, d] B[n, d] on planes (P, M, D) and (P, N, D):
    the exact bf16 products of the kernel's mma (four real ones per complex
    product, three passes each at bf16x3), summed in float32."""
    A, B = A.float(), B.float()
    if passes == 1:
        (ar, ai), (br, bi) = A, B
        return ar @ br.T - ai @ bi.T, ar @ bi.T + ai @ br.T

    def dot3(x, xl, y, yl):
        return x @ y.T + x @ yl.T + xl @ y.T

    (arh, aih, arl, ail), (brh, bih, brl, bil) = A, B
    return (dot3(arh, arl, brh, brl) - dot3(aih, ail, bih, bil),
            dot3(arh, arl, bih, bil) + dot3(aih, ail, brh, brl))


def _store(re, im, passes):
    """The epilogue's planes of float32 (re, im): rounded to bf16 (one
    pass) or split by truncation into (re_hi, im_hi, re_lo, im_lo)."""
    if passes == 1:
        return torch.stack([re, im]).to(torch.bfloat16)
    (rh, rl), (ih, il) = TK._split_trunc(re), TK._split_trunc(im)
    return torch.stack([rh, ih, rl, il]).to(torch.bfloat16)


def _scatter(buf, off, vals):
    """buf.view(P, -1)[:, off] = vals, after checking that the offsets are
    distinct (the epilogue writes each entry once)."""
    flat = off.reshape(-1)
    assert flat.unique().numel() == flat.numel()
    buf.view(buf.shape[0], -1)[:, flat] = vals.reshape(vals.shape[0], -1)


def staged_chain(psi, ops, passes):
    """The staged chain kernel (``csrc/chain_tc.cu``) in plain PyTorch,
    through its layouts: ψ (k, j, r) as the planes that
    ``cgemm::planes_kernel`` makes (``bf16_planes``); GEMM 1 scattered into T1
    (P, x, k, pad8(j·c)), the W mix into T2 (P, i, x, a, pad8(k)), GEMM 3
    into out (b, i, x); for K_eff (``ops.W is None``) GEMM 1 transposed into
    T2 (P, x, a, pad8(k)) and GEMM 3.  The scratch comes from
    ``cuda_matvec.chain_scratch`` (the wrapper's own), and its depth
    padding must come out zero.  Returns out (complex)."""
    k, din, r = psi.shape
    P, B, wl, kp = ops.L.shape
    _, X, wr, rp = ops.R.shape
    if ops.W is None:  # K_eff at bf16x3
        sigp = torch.zeros((P, kp, rp), dtype=torch.bfloat16)
        sigp[:, :k] = CM.bf16_planes(psi[:, 0, :], passes)
        t2 = _store(*_gemm(ops.R.reshape(P, X * wr, rp), sigp, passes), passes)
        out = _gemm(ops.L.reshape(P, B, wl * kp), t2.reshape(P, X, wr * kp), passes)
        return torch.complex(*out).reshape(B, 1, X)
    dout, dwp = ops.W.shape[2], ops.W.shape[3]
    psip, t1, t2 = CM.chain_scratch(P, k, X, r, din, dout, wl, wr, "cpu")
    psip[:] = CM.bf16_planes(psi.reshape(k * din, r), passes)
    # GEMM 1: C[(k,j), (x,c)] -> T1[(x,k), (j,c)]
    c1 = _gemm(psip, ops.R.reshape(P, X * wr, rp), passes)
    kk, j, x, c = torch.meshgrid(torch.arange(k), torch.arange(din),
                                 torch.arange(X), torch.arange(wr), indexing="ij")
    _scatter(t1, (x * k + kk) * dwp + j * wr + c, _store(*c1, passes))
    assert not t1[..., din * wr:].any()
    # GEMM 2: C[(a,i), (x,k)] -> T2[(i,x), (a,k)]
    c2 = _gemm(ops.W.reshape(P, wl * dout, dwp), t1.reshape(P, X * k, dwp), passes)
    a, i, x, kk = torch.meshgrid(torch.arange(wl), torch.arange(dout),
                                 torch.arange(X), torch.arange(k), indexing="ij")
    _scatter(t2, (i * X + x) * (wl * kp) + a * kp + kk, _store(*c2, passes))
    assert not t2[..., k:].any()
    # GEMM 3: out[b, (i,x)] = Σ_(a,k) L[b, (a,k)] T2[(i,x), (a,k)]
    out = _gemm(ops.L.reshape(P, B, wl * kp), t2.reshape(P, dout * X, wl * kp), passes)
    return torch.complex(*out).reshape(B, dout, X)


def small_ints(rng, hi, *shape):
    """Complex small nonzero integers (exact in bf16): every float32 sum of
    their products is exact in any order, so the bf16 roundings and splits
    of the chain intermediates are the only roundings."""
    def part():
        return rng.integers(1, hi + 1, shape) * rng.choice([-1, 1], shape)

    return T(part() + 1j * part())


@pytest.mark.parametrize("b,k,x,r,wl,d,wr", [
    (13, 10, 11, 9, 3, 3, 5),  # ragged: every depth padded (15, 10, 9)
    (1, 1, 4, 4, 1, 4, 7),  # the chain's edge: B = K = 1, w_l = 1
    (12, 10, 14, 6, 8, 9, 8),  # a spin-1 nucleus: d = 9, d·w_r = 72
    (8, 6, 9, 5, 8, 16, 8),  # the electron pair of BENCH_SPLIT=0: d = 16
])
def test_heff_kernel_layout_matches_plain(b, k, x, r, wl, d, wr):
    """The H_eff kernel's layout contract on the CPU: small-integer ψ, L,
    W and R, the three staged GEMMs through the kernel's padded layouts
    equal ``heff_apply_lo`` bit for bit, and the padding holds zeros."""
    rng = np.random.default_rng(16)
    L, W = small_ints(rng, 3, b, wl, k), small_ints(rng, 3, wl, d, d, wr)
    R = small_ints(rng, 3, x, wr, r)
    psi = small_ints(rng, 3, k, d, r).to(torch.complex64)
    ops = CM.heff_operands(L, W, R)
    assert ops.W.shape == (2, wl, d, CM.pad8(d * wr))
    for t, n in ((ops.L, k), (ops.W, d * wr), (ops.R, r)):
        assert not t[..., n:].any()
    want = CM.heff_lo(ops, psi)
    got = staged_chain(psi, ops, passes=1)
    assert float(torch.linalg.vector_norm(want)) > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("forward", [True, False])
def test_one_pass_transfer_matches_plain(forward):
    """The one-pass environment transfer (``env_precision="default"``):
    ``cuda_renorm.renorm_left_lo`` / ``_right_lo`` on the CPU equal their
    plain versions ``kernels.renorm_block_left_lo`` / ``_right_lo`` bit for
    bit, and on small integers the staged chain through the kernel's
    layouts, with MPO widths in and out that differ (7 → 8, the radical
    pair's), equals them too."""
    from pytdscf_torch.mps import cuda_renorm as CR

    rng = np.random.default_rng(23)
    m, d, n, wa, wc = 6, 4, 9, 7, 8  # bonds, physical dim, MPO widths
    if forward:
        blk = small_ints(rng, 3, m, wa, m).to(torch.complex64)
        core = small_ints(rng, 2, m, d, n).to(torch.complex64)
        W = small_ints(rng, 2, wa, d, d, wc).to(torch.complex64)
        got = CR.renorm_left_lo(blk, core, W, core)
        want = TK.renorm_block_left_lo(blk, core, W, core)
        ops = CM.heff_operands(torch.conj_physical(core).permute(2, 1, 0),
                               W.permute(1, 3, 0, 2), core.permute(2, 1, 0))
    else:
        blk = small_ints(rng, 3, m, wc, m).to(torch.complex64)
        core = small_ints(rng, 2, n, d, m).to(torch.complex64)
        W = small_ints(rng, 2, wa, d, d, wc).to(torch.complex64)
        got = CR.renorm_right_lo(blk, core, W, core)
        want = TK.renorm_block_right_lo(blk, core, W, core)
        ops = CM.heff_operands(torch.conj_physical(core), W.permute(1, 0, 3, 2),
                               core)
    assert ops.W.shape[2] != ops.j  # din != dout
    assert float(torch.linalg.vector_norm(want)) > 0
    assert torch.equal(got, want)
    assert torch.equal(staged_chain(blk, ops, passes=1), want)


def _lossy(name, variant, ops, v):
    """The plain matvec with one bf16 rounding more ("bf16 output") or
    one less ("T1 in float32"): faults REL_CARD must catch."""
    planes = CM.plain_planes(ops)
    f32 = torch.float32
    if variant == "bf16 output":
        plain = TK.heff_apply_lo if name == "heff" else TK.keff_apply_lo
        out = plain(*planes, v)
        return torch.complex(out.real.to(torch.bfloat16).to(f32),
                             out.imag.to(torch.bfloat16).to(f32))
    if name == "heff":
        Lp, Wp, Rp = planes
        t1 = TK._cx_einsum("kjr,xcr->kjxc", TK.planar_bf16(v), Rp, out_dtype=f32)
        t2 = TK._cx_einsum("kjxc,aijc->kiax", t1, Wp)
        return torch.complex(*TK._cx_einsum("kiax,bak->bix", t2, Lp, out_dtype=f32))
    Lp, Rp = planes
    t1 = TK._cx_einsum("kr,xar->kxa", TK.planar_bf16(v), Rp, out_dtype=f32)
    return torch.complex(*TK._cx_einsum("kxa,bak->bx", t1, Lp, out_dtype=f32))


def _bar_case(name, device, b, k, x, w, d):
    rng = np.random.default_rng(14)
    cx = lambda *s: torch.as_tensor(_cx(rng, *s), dtype=torch.complex64, device=device)  # noqa: E731
    if name == "heff":
        ops = CM.heff_operands(cx(b, w, k), cx(w, d, d, w), cx(x, w, x))
        v = cx(k, d, x)
        return ops, v, TK.heff_apply_lo(*CM.plain_planes(ops), v)
    ops = CM.keff_operands(cx(b, w, k), cx(x, w, x))
    v = cx(k, x)
    return ops, v, TK.keff_apply_lo(*CM.plain_planes(ops), v)


@pytest.mark.parametrize("name", ["heff", "keff"])
@pytest.mark.parametrize("variant", ["bf16 output", "T1 in float32"])
def test_card_bar_catches_lost_rounding(name, variant):
    """REL_CARD lies below one bf16 rounding: the plain matvec with one
    rounding more or less fails it (a ragged shape, on the CPU)."""
    ops, v, plain = _bar_case(name, "cpu", 130, 70, 33, 7, 4)
    assert _rel(_lossy(name, variant, ops, v), plain) > REL_CARD


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(cuda, *arrays):
    return [torch.as_tensor(a, dtype=torch.complex64, device=cuda) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,x,w,d", [
    (1024, 1024, 1024, 8, 4),  # the chi=1024 bulk site
    (1, 1, 4, 1, 4), (4, 1, 16, 7, 4), (64, 16, 256, 8, 4),  # chain edges
    (24, 16, 40, 3, 4), (130, 70, 33, 7, 4),  # ragged tiles
    (130, 70, 33, 8, 9), (64, 40, 72, 8, 16),  # d = 9 and d = 16 sites
])
def test_heff_kernel_matches_plain_on_card(cuda, b, k, x, w, d):
    wl, wr = (1, w) if b == 1 else (w, w)
    rng = np.random.default_rng(11)
    L, W, R, psi = _on(cuda, _cx(rng, b, wl, k), _cx(rng, wl, d, d, wr),
                       _cx(rng, x, wr, x), _cx(rng, k, d, x))
    ops = CM.heff_operands(L, W, R)
    launches = CM.heff_lo.launches
    got = CM.heff_lo(ops, psi)
    again = CM.heff_lo(ops, psi)
    plain = TK.heff_apply_lo(*CM.plain_planes(ops), psi)
    torch.cuda.synchronize()
    assert CM.heff_lo.launches == launches + 2
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    assert _rel(got.cpu(), plain.cpu()) < REL_CARD


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,x,w", [
    (1024, 1024, 1024, 8), (4, 4, 16, 7), (256, 256, 64, 8), (24, 16, 40, 3),
    (130, 70, 33, 7),  # ragged in both GEMMs: stage 2's depth 7 × 72
    (1, 1, 4, 1), (4, 1, 16, 7),  # the chain's edge bonds: k, r < 8
])
def test_keff_kernel_matches_plain_on_card(cuda, b, k, x, w):
    rng = np.random.default_rng(12)
    L, R, sig = _on(cuda, _cx(rng, b, w, k), _cx(rng, x, w, x), _cx(rng, k, x))
    ops = CM.keff_operands(L, R)
    launches = CM.keff_lo.launches
    got = CM.keff_lo(ops, sig)
    again = CM.keff_lo(ops, sig)
    plain = TK.keff_apply_lo(*CM.plain_planes(ops), sig)
    torch.cuda.synchronize()
    assert CM.keff_lo.launches == launches + 2
    assert torch.equal(got, again)
    assert _rel(got.cpu(), plain.cpu()) < REL_CARD


def _transfer_case(forward, blk, core, W):
    """One-pass transfer of ``blk`` through ``core`` and ``W``: the kernel's
    wrapper and the plain version on the same tensors."""
    from pytdscf_torch.mps import cuda_renorm as CR

    if forward:
        return (CR.renorm_left_lo(blk, core, W, core),
                TK.renorm_block_left_lo(blk, core, W, core))
    return (CR.renorm_right_lo(blk, core, W, core),
            TK.renorm_block_right_lo(blk, core, W, core))


@pytest.mark.cuda
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("m,d,n,wa,wc", [
    (6, 4, 9, 7, 8),  # small integers: exact in any sum order
    (1024, 4, 1024, 7, 8),  # the radical pair's bulk, widths in ≠ out
])
def test_one_pass_transfer_matches_plain_on_card(cuda, forward, m, d, n, wa,
                                                 wc):
    """``renorm_left_lo`` / ``_right_lo`` launch ``chain_tc.cu``'s one-pass
    chain with din ≠ dout: on small integers bit for bit with the plain
    version, on random operands at the radical pair's bulk within
    ``REL_CARD`` (the order of the float32 sums)."""
    from pytdscf_torch.mps import cuda_renorm as CR

    rng = np.random.default_rng(29)
    exact = m < 64

    def make(hi, *shape):
        if exact:
            return small_ints(rng, hi, *shape).to(cuda, torch.complex64)
        a = _cx(rng, *shape)
        return torch.as_tensor(a / np.linalg.norm(a), dtype=torch.complex64,
                               device=cuda)

    if forward:
        blk, core = make(3, m, wa, m), make(2, m, d, n)
    else:
        blk, core = make(3, m, wc, m), make(2, n, d, m)
    W = make(2, wa, d, d, wc)
    launches = CR.renorm_lo.launches
    got, want = _transfer_case(forward, blk, core, W)
    again, _ = _transfer_case(forward, blk, core, W)
    torch.cuda.synchronize()
    assert CR.renorm_lo.launches == launches + 2
    assert bool(torch.isfinite(got).all()) and torch.equal(got, again)
    assert float(torch.linalg.vector_norm(want)) > 0
    if exact:
        assert torch.equal(got, want)
    else:
        assert _rel(got.cpu(), want.cpu()) < REL_CARD


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["heff", "keff"])
@pytest.mark.parametrize("variant", ["bf16 output", "T1 in float32"])
def test_card_bar_catches_lost_rounding_at_bulk(cuda, name, variant):
    """As test_card_bar_catches_lost_rounding, at the χ=1024 bulk shape on
    the card, where the kernel itself passes the bar."""
    ops, v, plain = _bar_case(name, cuda, 1024, 1024, 1024, 8, 4)
    kernel = CM.heff_lo if name == "heff" else CM.keff_lo
    assert _rel(kernel(ops, v).cpu(), plain.cpu()) < REL_CARD
    assert _rel(_lossy(name, variant, ops, v).cpu(), plain.cpu()) > REL_CARD


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    rng = np.random.default_rng(13)
    L, W, R, psi = _on(cuda, _cx(rng, 8, 2, 8), _cx(rng, 2, 4, 4, 2),
                       _cx(rng, 8, 2, 8), _cx(rng, 8, 4, 8))
    ops = CM.heff_operands(L, W, R)
    with pytest.raises(TypeError):
        CM.heff_lo(ops, psi.to(torch.complex128))
    with pytest.raises(ValueError):
        CM.heff_lo(ops, psi.transpose(0, 2).contiguous().transpose(0, 2))
    with pytest.raises(ValueError):
        CM.heff_lo(ops, psi[:4])
    with pytest.raises(TypeError):
        CM.heff_lo(ops._replace(L=ops.L.float()), psi)
    shifted = torch.empty(ops.W.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = shifted[1:].view(ops.W.shape)  # contiguous, 2 bytes off 16
    shifted.copy_(ops.W)
    with pytest.raises(ValueError):
        CM.heff_lo(ops._replace(W=shifted), psi)
    # d·w_r = 36 and W of 1296 entries, which the fp32-FMA kernel refused
    wide = CM.heff_operands(*_on(cuda, _cx(rng, 8, 9, 8), _cx(rng, 9, 4, 4, 9),
                                 _cx(rng, 8, 9, 8)))
    got = CM.heff_lo(wide, psi)
    want = TK.heff_apply_lo(*CM.plain_planes(wide), psi)
    assert _rel(got.cpu(), want.cpu()) < REL_CARD
    kops = CM.keff_operands(L, R)
    sig = psi[:, 0, :].contiguous()
    with pytest.raises(TypeError):
        CM.keff_lo(kops, sig.to(torch.complex128))
    with pytest.raises(ValueError):
        CM.keff_lo(kops, sig.T)
    with pytest.raises(ValueError):
        CM.keff_lo(kops, sig[:, :4])
