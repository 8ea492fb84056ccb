"""The bf16x3 chain of the port (``cuda_renorm``) against the JAX package.

``kernels.chain3_plain`` is the plain version of ``csrc/chain_tc.cu`` at
bf16x3 and the port's counterpart of the JAX package's
``pallas_renorm._renorm3_kernel``.  On the CPU its four mappings are held
against JAX: the environment transfers against ``renorm_left_pallas`` /
``renorm_right_pallas`` (interpret mode, the shapes of
``tests/test_pallas_renorm.py``, with bra ≠ ket and b, k, o, p all
different), the "high" matvecs against ``_renorm3_pallas`` on operands in
H_eff roles, and all of them against JAX's exact chains.  The tests marked
``cuda`` hold the kernel against the plain version on an NVIDIA GPU and
skip elsewhere.

Tolerances.  Plain against Pallas: the same splits and rounding points,
float32 sums in another order.  That order alone moves the output by
2.1e-6 to 2.4e-6 relative at these shapes (measured: a float64-sum
reference with the same splits sits 1.9e-6 from the Pallas kernel and
2.1e-6 from the plain version, both fed complex128 operands), so the bar
is 5e-6; it still catches a changed rounding point: splitting T1 and T2
to nearest instead of by truncation reads 1.2e-5, keeping them float32
1.0e-5.  Against the exact chain the bf16x3 error itself, ~1.2e-5: the
bar 1e-4 is ``tests/test_pallas_renorm.py``'s, and the one-pass form (every
lo pass dropped, ~7e-3) must fail it.  Kernel against plain on the card:
the kernel's tensor cores accumulate the same bf16 products in float32 in
their own order and rounding (on an H100: 1.5e-7 to 9.1e-6 on the χ=1024
chain's own operands, ``chip_smoke.py``); the bar is 2e-5, 25× below the
smallest one-pass reading there (5.5e-4), and a second launch repeats the
first bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pytdscf_torch.mps import cuda_matvec as CM
from pytdscf_torch.mps import cuda_renorm as CR
from pytdscf_torch.mps import kernels as TK
from test_torch_matvec import small_ints, staged_chain

torch.set_num_threads(1)

REL_PALLAS = 5e-6  # plain vs the Pallas kernel: float32 sum order only
REL_EXACT = 1e-4  # bf16x3 vs the exact chain (tests/test_pallas_renorm.py)
REL_CARD = 2e-5  # kernel vs plain on the card: float32 sum order only

T = torch.from_numpy


def _cx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _renorm_case(seed, direction, b, k, p, o, w, d):
    """(block, bra, W, ket) of one transfer: L (b, w, k) with A_bra
    (b, d, o) and A_ket (k, d, p), or R (b, w, k) with B_bra (o, d, b) and
    B_ket (p, d, k)."""
    rng = np.random.default_rng(seed)
    blk, W = _cx(rng, b, w, k), _cx(rng, w, d, d, w)
    if direction == "left":
        return blk, _cx(rng, b, d, o), W, _cx(rng, k, d, p)
    return blk, _cx(rng, o, d, b), W, _cx(rng, p, d, k)


@pytest.mark.parametrize("direction,b,k,p,o,w,d,tile", [
    ("left", 256, 128, 128, 48, 8, 4, 128),
    ("left", 128, 256, 256, 128, 8, 4, 128),
    ("right", 256, 128, 128, 48, 8, 4, 128),
    ("right", 128, 128, 256, 128, 8, 4, 128),
    ("left", 16, 16, 16, 16, 3, 2, 8),
    ("right", 16, 16, 16, 16, 3, 2, 8),
])
def test_renorm_plain_matches_pallas(direction, b, k, p, o, w, d, tile):
    import jax.numpy as jnp

    import pytdscf_tpu.mps.kernels as JK
    from pytdscf_tpu.mps import pallas_renorm as PR

    args = _renorm_case(3, direction, b, k, p, o, w, d)
    if direction == "left":
        plain, pallas = TK.renorm_block_left_hi, PR.renorm_left_pallas
        exact = JK.renorm_block_left(*args, "highest")
    else:
        plain, pallas = TK.renorm_block_right_hi, PR.renorm_right_pallas
        exact = JK.renorm_block_right(*args, "highest")
    want = pallas(*map(jnp.asarray, args), tk=tile, tx=tile)
    got = plain(*map(T, args)).numpy()
    assert got.shape == (o, w, p)
    assert _rel(got, want) < REL_PALLAS
    assert _rel(got, exact) < REL_EXACT
    assert _rel(plain(*map(T, args), passes=1).numpy(), exact) > REL_EXACT


def _pallas_heff(L, W, R, psi):
    """The Pallas chain on H_eff-mapped operands, as (b, i, x)."""
    import jax.numpy as jnp

    from pytdscf_tpu.mps import pallas_renorm as PR

    L, W, R, psi = map(jnp.asarray, (L, W, R, psi))
    out = PR._renorm3_pallas(
        PR._hilo_planes(psi, (1, 0, 2)), PR._hilo_planes(R, (1, 2, 0)),
        PR._hilo_planes(L, (1, 0, 2)), PR._wbig(W), tk=8, tx=8,
    )
    return np.transpose(np.asarray(out[0] + 1j * out[1]), (1, 0, 2))


def test_heff_hi_matches_pallas_chain():
    import pytdscf_tpu.mps.kernels as JK

    rng = np.random.default_rng(4)
    b, k, x, r, w, d = 24, 16, 24, 40, 3, 2
    L, W, R, psi = _cx(rng, b, w, k), _cx(rng, w, d, d, w), _cx(rng, x, w, r), _cx(rng, k, d, r)
    got = TK.heff_apply_hi(T(L), T(W), T(R), T(psi)).numpy()
    assert got.shape == (b, d, x)
    assert _rel(got, _pallas_heff(L, W, R, psi)) < REL_PALLAS
    exact = JK.heff_apply(L, W, R, psi, "highest")
    assert _rel(got, exact) < REL_EXACT
    lo = TK.heff_apply_hi(T(L), T(W), T(R), T(psi), passes=1).numpy()
    assert _rel(lo, exact) > REL_EXACT


def test_keff_hi_matches_pallas_chain():
    """K_eff: the chain with d = 1 and W the identity over the MPO bond."""
    import pytdscf_tpu.mps.kernels as JK

    rng = np.random.default_rng(5)
    b, k, x, r, w = 24, 16, 32, 40, 3
    L, R, sig = _cx(rng, b, w, k), _cx(rng, x, w, r), _cx(rng, k, r)
    got = TK.keff_apply_hi(T(L), T(R), T(sig)).numpy()
    assert got.shape == (b, x)
    eye = np.eye(w).reshape(w, 1, 1, w)
    want = _pallas_heff(L, eye, R, sig[:, None, :])[:, 0, :]
    assert _rel(got, want) < REL_PALLAS
    exact = JK.keff_apply(L, R, sig, "highest")
    assert _rel(got, exact) < REL_EXACT
    assert _rel(TK.keff_apply_hi(T(L), T(R), T(sig), passes=1).numpy(), exact) > REL_EXACT


def test_wrappers_take_the_plain_version_on_cpu():
    """On the CPU each wrapper is its plain mapping, bit for bit, and
    counts a plain call on its counter."""
    args = [T(a) for a in _renorm_case(6, "left", 24, 20, 12, 16, 7, 4)]
    r0, m0 = CR.renorm_hi.plain_calls, CR.matvec_hi.plain_calls
    assert torch.equal(CR.renorm_left_hi(*args), TK.renorm_block_left_hi(*args))
    args = [T(a) for a in _renorm_case(7, "right", 24, 20, 12, 16, 7, 4)]
    assert torch.equal(CR.renorm_right_hi(*args), TK.renorm_block_right_hi(*args))
    rng = np.random.default_rng(8)
    L, W, R = T(_cx(rng, 12, 7, 20)), T(_cx(rng, 7, 4, 4, 8)), T(_cx(rng, 16, 8, 24))
    psi, sig = T(_cx(rng, 20, 4, 24)), T(_cx(rng, 20, 24))
    assert torch.equal(CR.heff_hi(CR.heff_operands(L, W, R), psi),
                       TK.heff_apply_hi(L, W, R, psi))
    R7 = T(_cx(rng, 16, 7, 24))
    assert torch.equal(CR.keff_hi(CR.keff_operands(L, R7), sig),
                       TK.keff_apply_hi(L, R7, sig))
    assert CR.renorm_hi.plain_calls == r0 + 2
    assert CR.matvec_hi.plain_calls == m0 + 2
    with pytest.raises(ValueError):
        CR.heff_hi(CR.heff_operands(L, W, R), psi[:8])


def test_hilo_planes_carry_sixteen_bits():
    rng = np.random.default_rng(9)
    x = T(_cx(rng, 64, 64)).to(torch.complex64)
    hl = TK.hilo(x).float()
    assert hl.shape == (64, 64, 4)
    back = torch.complex(hl[..., 0] + hl[..., 2], hl[..., 1] + hl[..., 3])
    assert float(torch.max(torch.abs(back - x) / torch.abs(x))) < 2.0 ** -15
    assert bool((hl[..., 2:] != 0).any())  # the lo planes are not folded away
    hi, lo = TK._split_trunc(x.real.contiguous())
    assert torch.equal(hi.to(torch.bfloat16).float(), hi)  # hi is a bf16 value
    assert bool((torch.abs(hi) <= torch.abs(x.real)).all())  # truncated


# (b, k, p, o, w, d) of the layout test: ragged (every depth padded), the
# chain's first site (b = k = 1, w = 1), and d = 9, 16 with w = 8 (W of
# 5184 and 16384 entries)
LAYOUT_SHAPES = [
    (13, 10, 11, 9, 3, 3), (1, 1, 4, 4, 1, 4), (6, 5, 7, 4, 8, 9),
    (4, 3, 5, 6, 8, 16),
]


def _layout_case(mapping, b, k, p, o, w, d):
    """(ψ, ops, the wrapper's output on the CPU) of one mapping on small
    nonzero integers: ψ and R up to 15 (T1 then carries more than the 8
    bits of its hi plane), L and W up to 3."""
    rng = np.random.default_rng(17)
    def big(*shape):
        return small_ints(rng, 15, *shape)

    def small(*shape):
        return small_ints(rng, 3, *shape)

    if mapping in ("left", "right"):
        blk, W = big(b, w, k), small(w, d, d, w)
        if mapping == "left":
            a_bra, a_ket = small(b, d, o), big(k, d, p)
            ops = CR.heff_operands(torch.conj_physical(a_bra).permute(2, 1, 0),
                                 W.permute(1, 3, 0, 2), a_ket.permute(2, 1, 0))
            return blk, ops, CR.renorm_left_hi(blk, a_bra, W, a_ket)
        b_bra, b_ket = small(o, d, b), big(p, d, k)
        ops = CR.heff_operands(torch.conj_physical(b_bra), W.permute(1, 0, 3, 2), b_ket)
        return blk, ops, CR.renorm_right_hi(blk, b_bra, W, b_ket)
    L, R = small(b, w, k), big(p, w, o)
    if mapping == "heff":
        psi = big(k, d, o)
        ops = CR.heff_operands(L, small(w, d, d, w), R)
        return psi, ops, CR.heff_hi(ops, psi)
    sig = big(k, o)
    ops = CR.keff_operands(L, R)
    return sig.unsqueeze(1), ops, CR.keff_hi(ops, sig).unsqueeze(1)


@pytest.mark.parametrize("mapping", ["left", "right", "heff", "keff"])
@pytest.mark.parametrize("b,k,p,o,w,d", LAYOUT_SHAPES)
def test_chain_kernel_layout_matches_plain(mapping, b, k, p, o, w, d):
    """The bf16x3 chain kernel's layout contract on the CPU, in each of its
    four mappings: on small integers every float32 sum is exact, so the
    splits of T1 and T2 are the only roundings, and the staged GEMMs
    through the kernel's four-plane padded layouts (``staged_chain``,
    ``tests/test_torch_matvec.py``) equal ``chain3_plain`` (the wrapper's
    CPU route) bit for bit, with the padding zero."""
    psi, ops, want = _layout_case(mapping, b, k, p, o, w, d)
    for t, n in ((ops.L, ops.k), (ops.R, ops.r)):
        assert t.shape[0] == 4 and t.shape[-1] == CM.pad8(n) and not t[..., n:].any()
    if ops.W is not None:
        assert not ops.W[..., ops.j * ops.R.shape[2]:].any()
    got = staged_chain(psi.to(torch.complex64), ops, passes=3)
    assert float(torch.linalg.vector_norm(want)) > 0
    assert torch.equal(got.to(want.dtype), want)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_check(kernel, plain, counter, args):
    """Kernel against plain on the card; a second launch is bit-identical."""
    launches = counter.launches
    got = kernel(*args)
    again = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert counter.launches == launches + 2
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    assert _rel(got.cpu(), want.cpu()) < REL_CARD
    return want


RENORM_SHAPES = [  # (b, k, p, o, w, d)
    (1024, 1024, 1024, 1024, 8, 4),  # the χ=1024 bulk
    (1, 1, 4, 4, 1, 4), (4, 4, 16, 16, 7, 4),  # chain edges
    (256, 256, 1024, 1024, 8, 4),
    (130, 70, 33, 45, 7, 4),  # ragged, all four bonds different
    (130, 70, 33, 45, 8, 9), (64, 40, 72, 36, 8, 16),  # d = 9, 16: W > 1024
]


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["left", "right"])
@pytest.mark.parametrize("b,k,p,o,w,d", RENORM_SHAPES)
def test_renorm_kernel_matches_plain_on_card(cuda, direction, b, k, p, o, w, d):
    args = [torch.as_tensor(a, dtype=torch.complex64, device=cuda)
            for a in _renorm_case(11, direction, b, k, p, o, w, d)]
    if direction == "left":
        kernel, plain = CR.renorm_left_hi, TK.renorm_block_left_hi
        ops = TK.renorm_left_operands(*args)
    else:
        kernel, plain = CR.renorm_right_hi, TK.renorm_block_right_hi
        ops = TK.renorm_right_operands(*args)
    _card_check(kernel, plain, CR.renorm_hi, args)
    for t in ops:  # the lo planes survive on the card
        assert bool((t[..., 2:] != 0).any())
    planes = CM.bf16_planes(args[1], passes=3)  # the wrapper's split
    assert bool((planes[2:] != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,x,w,d", [
    (1024, 1024, 1024, 8, 4), (1, 1, 4, 1, 4), (4, 1, 16, 7, 4),
    (64, 16, 256, 8, 4), (130, 70, 33, 7, 4),
    (130, 70, 33, 8, 9), (64, 40, 72, 8, 16),  # d = 9, 16: W > 1024
])
def test_matvec_hi_kernel_matches_plain_on_card(cuda, b, k, x, w, d):
    wl, wr = (1, w) if b == 1 else (w, w)
    rng = np.random.default_rng(12)
    L, W, R, psi = (torch.as_tensor(a, dtype=torch.complex64, device=cuda) for a in (
        _cx(rng, b, wl, k), _cx(rng, wl, d, d, wr), _cx(rng, x, wr, x), _cx(rng, k, d, x)))
    ops = CR.heff_operands(L, W, R)
    _card_check(CR.heff_hi, lambda o, v: TK.chain3_plain(TK.hilo(v), *CR.plain_hilo(o)),
                CR.matvec_hi, (ops, psi))
    # K_eff on the bond right of the site: L' (x, wr, x), R, σ (x, x)
    Lk = torch.as_tensor(_cx(rng, x, wr, x), dtype=torch.complex64, device=cuda)
    sig = torch.as_tensor(_cx(rng, x, x), dtype=torch.complex64, device=cuda)
    kops = CR.keff_operands(Lk, R)
    _card_check(CR.keff_hi, lambda o, v: TK.chain3_plain(
        TK.hilo(v.unsqueeze(1)), *CR.plain_hilo(o))[:, 0, :], CR.matvec_hi,
        (kops, sig))


@pytest.mark.cuda
@pytest.mark.parametrize("direction", ["left", "right"])
def test_card_bar_catches_dropped_lo_at_bulk(cuda, direction):
    """At the χ=1024 bulk the kernel passes REL_CARD and the one-pass form
    of the plain version fails it."""
    args = [torch.as_tensor(a, dtype=torch.complex64, device=cuda)
            for a in _renorm_case(13, direction, 1024, 1024, 1024, 1024, 8, 4)]
    kernel = CR.renorm_left_hi if direction == "left" else CR.renorm_right_hi
    plain = TK.renorm_block_left_hi if direction == "left" else TK.renorm_block_right_hi
    want = plain(*args).cpu()
    assert _rel(kernel(*args).cpu(), want) < REL_CARD
    assert _rel(plain(*args, passes=1).cpu(), want) > REL_CARD


@pytest.mark.cuda
def test_chain_refuses_what_it_does_not_take(cuda):
    rng = np.random.default_rng(14)
    L, W, R, psi = (torch.as_tensor(a, dtype=torch.complex64, device=cuda) for a in (
        _cx(rng, 8, 2, 8), _cx(rng, 2, 4, 4, 2), _cx(rng, 8, 2, 8), _cx(rng, 8, 4, 8)))
    ops = CR.heff_operands(L, W, R)
    with pytest.raises(ValueError):
        CR.heff_hi(ops, psi[:4])
    with pytest.raises(TypeError):
        CR.heff_hi(ops._replace(L=ops.L.float()), psi)
    with pytest.raises(TypeError):
        CR.heff_hi(ops, psi.to(torch.complex128))
    with pytest.raises(ValueError):  # a non-contiguous operand
        strided = ops.R.transpose(1, 2).contiguous().transpose(1, 2)
        CR.heff_hi(ops._replace(R=strided), psi)
    with pytest.raises(ValueError):  # a non-contiguous vector
        CR.heff_hi(ops, psi.transpose(0, 2).contiguous().transpose(0, 2))
