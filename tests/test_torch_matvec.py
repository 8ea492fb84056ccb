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
at (256, 256, 256, 8, 4)); the bar against JAX is 5e-4.  On the card the
kernel sums over χ=1024 at the bulk site in its own fixed order (k tiles
summed one after the other).  On an H100 it reads 1.6e-7 to 5e-7 against
plain on the χ=1024 chain's own operands (``chip_smoke.py`` holds those
to 1e-4), and up to 9.7e-5 on the random operands below (the largest at
the (1024, 1024, 1024, 8, 4) bulk shape, where many T1 entries are long
unstructured sums near a bf16 rounding boundary).  One bf16 rounding more
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


def _lossy(name, variant, ops, v):
    """The plain matvec with one bf16 rounding more ("bf16 output") or
    one less ("T1 in float32"): faults REL_CARD must catch."""
    planes = [t.unbind(-1) for t in ops]
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
        return ops, v, TK.heff_apply_lo(*(t.unbind(-1) for t in ops), v)
    ops = CM.keff_operands(cx(b, w, k), cx(x, w, x))
    v = cx(k, x)
    return ops, v, TK.keff_apply_lo(*(t.unbind(-1) for t in ops), v)


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
    plain = TK.heff_apply_lo(*(t.unbind(-1) for t in ops), psi)
    torch.cuda.synchronize()
    assert CM.heff_lo.launches == launches + 2
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    assert _rel(got.cpu(), plain.cpu()) < REL_CARD


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,x,w", [
    (1024, 1024, 1024, 8), (4, 4, 16, 7), (256, 256, 64, 8), (24, 16, 40, 3),
])
def test_keff_kernel_matches_plain_on_card(cuda, b, k, x, w):
    rng = np.random.default_rng(12)
    L, R, sig = _on(cuda, _cx(rng, b, w, k), _cx(rng, x, w, x), _cx(rng, k, x))
    ops = CM.keff_operands(L, R)
    launches = CM.keff_lo.launches
    got = CM.keff_lo(ops, sig)
    again = CM.keff_lo(ops, sig)
    plain = TK.keff_apply_lo(*(t.unbind(-1) for t in ops), sig)
    torch.cuda.synchronize()
    assert CM.keff_lo.launches == launches + 2
    assert torch.equal(got, again)
    assert _rel(got.cpu(), plain.cpu()) < REL_CARD


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
        CM.heff_lo(CM.HeffOps(ops.L.float(), ops.W, ops.R), psi)
    wide = CM.heff_operands(*_on(cuda, _cx(rng, 8, 9, 8), _cx(rng, 9, 4, 4, 9),
                                 _cx(rng, 8, 9, 8)))
    with pytest.raises(ValueError):  # d·w_r = 36 > 32
        CM.heff_lo(wide, psi)
    kops = CM.keff_operands(L, R)
    sig = psi[:, 0, :].contiguous()
    with pytest.raises(TypeError):
        CM.keff_lo(kops, sig.to(torch.complex128))
    with pytest.raises(ValueError):
        CM.keff_lo(kops, sig.T)
    with pytest.raises(ValueError):
        CM.keff_lo(kops, sig[:, :4])
