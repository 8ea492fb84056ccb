"""The ported slice as a whole: TDVP steps of the port against the JAX engine.

The 6-site singlet-fission chain (``singlet_fission_chain(2, 3)``) at D=8
in complex128.  The JAX engine is pinned to the MGS(×2) gauge (the
convention of its accelerator runs, and the port's on every device): the
Hartree-product start is rank-deficient, so the fixed-D trajectory depends
on the dead-column completion frame, and LAPACK's completions would give a
different valid trajectory ~1e-4 away (``tests/test_pallas_lanczos.py``).
Its state enters the port through ``convert.from_numpy``; both then take
three steps of 0.2 fs.

The test marked ``cuda`` runs the slice through both kernels on an NVIDIA
GPU and skips elsewhere; JAX is imported inside the ``jx`` fixture, so it
also runs where JAX is not installed (``python -m pytest --noconftest -m
cuda ...``).

Tolerances: the two run the same recurrence, stopping rule and gauge in
float64, and differ only in the order of sums and in exp(scale·T)e₀ (eigh
in JAX, Taylor substeps in the port, ~1e-11 apart per call), so the dense
states agree to 1e-10 and ⟨H⟩ to 1e-12.  The overlap form of ``distance``
cannot resolve below ~1e-8 (it is the square root of a difference of
norms of order 1, so float64 round-off of 1e-16 appears as 1e-8): it is
held to 1e-7.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytdscf_torch import convert, units
from pytdscf_torch.config import Config
from pytdscf_torch.models.holstein import singlet_fission_chain
from pytdscf_torch.mps import cuda_lanczos as CL
from pytdscf_torch.mps import cuda_qr as CQ
from pytdscf_torch.mps.lattice import alloc_hartree_product
from pytdscf_torch.mps.tdvp import TDVPEngine

torch.set_num_threads(1)

DT = 0.2 / units.au_in_fs
N_LEFT, N_RIGHT, BOND = 2, 3, 8
NSITE = N_LEFT + 1 + N_RIGHT


def _start():
    basis, ham = singlet_fission_chain(n_left=N_LEFT, n_right=N_RIGHT)
    phys = [b.nprim for b in basis]
    vecs = []
    for i, b in enumerate(basis):
        v = np.zeros(b.nprim, dtype=complex)
        v[1 if i == N_LEFT else 0] = 1.0
        vecs.append(v)
    return [alloc_hartree_product(phys, BOND, vecs)], ham, phys


def _dense(cores):
    out = cores[0]
    for c in cores[1:]:
        out = np.einsum("...r,rns->...ns", out, c)
    return out[0, ..., 0]


@pytest.fixture
def jx(monkeypatch):
    """The JAX engine, pinned to its XLA MGS(×2) gauge."""
    import jax

    import pytdscf_tpu.mps.kernels as JK
    from pytdscf_tpu.config import Config as JConfig
    from pytdscf_tpu.mps.tdvp import TDVPEngine as JEngine

    monkeypatch.setattr(JK, "_PALLAS_QR_FORCE", True)
    monkeypatch.setattr(JK, "_PALLAS_QR_OFF", True)
    # the flags are read at trace time and are not part of any jit cache
    # key: drop traces made under the other convention, before and after
    jax.clear_caches()
    yield SimpleNamespace(Config=JConfig, TDVPEngine=JEngine)
    jax.clear_caches()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_slice_matches_jax_engine(jx):
    cores, ham, phys = _start()
    jax_engine = jx.TDVPEngine(
        cores, ham, jx.Config(thresh_exp=1e-9, pallas_site=False)
    )
    fused = ham.fused_mpo(phys)
    cfg = Config(thresh_exp=1e-9, pytest_enabled=True)
    port = convert.from_numpy(jax_engine.to_numpy(), fused, cfg, "cpu")
    for _ in range(3):
        lz0, qr0 = CL.lanczos_expm.plain_calls, CQ.mgs_qr.plain_calls
        jax_engine.propagate(DT)
        port.propagate(DT)
        # 2 half-sweeps × (6 H + 5 K) exponentials and 2 × 5 gauge moves
        assert CL.lanczos_expm.plain_calls - lz0 == 2 * (2 * NSITE - 1)
        assert CQ.mgs_qr.plain_calls - qr0 == 2 * (NSITE - 1)
        mirror = convert.from_numpy(jax_engine.to_numpy(), fused, cfg, "cpu")
        assert port.distance(mirror) < 1e-7
        d = np.linalg.norm(
            _dense(port.to_numpy()[0]) - _dense(jax_engine.to_numpy()[0])
        )
        assert d < 1e-10, d
        e_port, e_jax = port.expectation().real, jax_engine.expectation().real
        assert abs(e_port - e_jax) < 1e-12
    assert abs(port.norm() - jax_engine.norm()) < 1e-12
    assert abs(port.autocorr() - jax_engine.autocorr()) < 1e-10
    *stats, relaxed = port.krylov_stats()
    assert stats == pytest.approx(jax_engine.krylov_stats())
    assert relaxed == 0  # Lanczos runs no relaxed matvec


def test_convert_round_trip():
    cores, ham, phys = _start()
    port = convert.from_numpy(cores, ham.fused_mpo(phys), Config(), "cpu")
    back = port.to_numpy()
    assert all(np.array_equal(a, b) for a, b in zip(back[0], cores[0]))
    # the port's own Hamiltonian builds the same engine
    own = TDVPEngine(cores, ham, Config(), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(own.W, port.W))


@pytest.mark.parametrize("field,value,item", [
    ("splitting", "suzuki4", "A10"),
    ("splitting", "yoshida4", "A10"),
])
def test_outside_the_slice_raises(field, value, item):
    cores, ham, _ = _start()
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        TDVPEngine(cores, ham, Config(**{field: value}), "cpu")


def test_engine_defaults_to_the_card():
    """With no device the engine and the converter go to the card; without
    one they raise instead of falling back to the CPU."""
    cores, ham, phys = _start()
    if torch.cuda.is_available():
        assert TDVPEngine(cores, ham, Config(dtype="complex64")).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDVPEngine(cores, ham, Config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_numpy(cores, ham.fused_mpo(phys), Config())


def test_multi_state_and_gates_raise():
    cores, ham, _ = _start()
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        TDVPEngine(cores + cores, ham, Config(), "cpu")
    engine = TDVPEngine(cores, ham, Config(), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        engine.propagate(DT, kraus_op=object())


def _hermitian_site(seed, chi=8, d=4, w=3):
    """A Hermitian H_eff site at bond χ: L, R (χ, w, χ) and W (w, d, d, w)
    each Hermitian in their bra/ket pair, ψ (χ, d, χ) and the next core."""
    rng = np.random.default_rng(seed)

    def cx(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    L, R, W = cx(chi, w, chi), cx(chi, w, chi), cx(w, d, d, w)
    L = 0.5 * (L + L.transpose(2, 1, 0).conj())
    R = 0.5 * (R + R.transpose(2, 1, 0).conj())
    W = 0.5 * (W + W.transpose(0, 2, 1, 3).conj())
    # unit-norm blocks, as the engine keeps them: ‖H_eff‖ of order 1
    L, R, W = (a / np.linalg.norm(a) for a in (L, R, W))
    psi = cx(chi, d, chi)
    return L, W, R, psi / np.linalg.norm(psi), cx(chi, d, chi)


SCALE = -0.5j  # exp(−i·H·0.5) at ‖H_eff‖ of order 1


def _site_args(L, W, R, psi, nxt):
    t = [torch.as_tensor(a) for a in (psi, nxt, L, W, R)]
    zero = torch.zeros((), dtype=torch.float64)
    return (*t, SCALE, zero, zero + 0.3)


def _both_routes(monkeypatch, args, cfg, counter):
    """``_site_step`` of a Lanczos site through the kernel's route, then
    again with the gate's byte limit at 0.  Checks that the second run
    built no channels, left the Lanczos kernel's ``counter`` (its launches
    or its plain calls) alone and ran ``krylov_expm``'s Lanczos for both
    exponentials; returns (einsum route, kernel route)."""
    from pytdscf_torch.mps import tdvp

    n0 = getattr(CL.lanczos_expm, counter)
    want = tdvp._site_step(*args, cfg=cfg, forward=True, last=False)
    assert getattr(CL.lanczos_expm, counter) == n0 + 2
    calls = []

    def counted(*a, **kw):
        calls.append(kw["arnoldi"])
        return krylov_expm(*a, **kw)

    def refused(*a, **kw):
        raise AssertionError("channels built for a site that does not use them")

    krylov_expm = tdvp.krylov_expm
    monkeypatch.setattr(tdvp, "krylov_expm", counted)
    monkeypatch.setattr(CL, "heff_channels", refused)
    monkeypatch.setattr(CL, "keff_channels", refused)
    monkeypatch.setattr(CL, "MAX_BYTES", 0)
    got = tdvp._site_step(*args, cfg=cfg, forward=True, last=False)
    assert getattr(CL.lanczos_expm, counter) == n0 + 2
    assert calls == [False, False]  # Lanczos, H then K
    return got, want


def test_large_lanczos_site_takes_the_einsum_route(monkeypatch):
    """A Lanczos site whose channels exceed ``cuda_lanczos.MAX_BYTES`` runs
    ``krylov_expm`` over the chain einsums for both exponentials, builds no
    channels and never calls the kernel's route; its update agrees with the
    kernel route's plain version (eigh against Taylor substeps, ~1e-11)."""
    got, want = _both_routes(monkeypatch, _site_args(*_hermitian_site(21)),
                             Config(thresh_exp=1e-10), "plain_calls")
    for a, b in ((got[0], want[0]), (got[1], want[1]), (got[2][0], want[2][0])):
        assert float(torch.max(torch.abs(a - b))) < 1e-10
    assert abs(float(got[2][1] - want[2][1])) < 1e-10
    assert [s.tolist() for s in got[3]] == [s.tolist() for s in want[3]]


def test_einsum_route_matches_jax_krylov(monkeypatch):
    """The einsum route of a large Lanczos site against the JAX package's
    ``krylov_expm`` (Lanczos) over its ``heff_apply``, on the same numpy
    inputs, in complex128."""
    import jax.numpy as jnp

    import pytdscf_tpu.mps.kernels as JK
    from pytdscf_tpu.mps.integrator import krylov_expm as jax_krylov

    from pytdscf_torch.mps import tdvp

    L, W, R, psi, nxt = _hermitian_site(22)
    args = _site_args(L, W, R, psi, nxt)
    cfg = Config(thresh_exp=1e-10)
    monkeypatch.setattr(CL, "MAX_BYTES", 0)
    got, _, _, (st,), _ = tdvp._site_step(*args, cfg=cfg, forward=True, last=True)
    fac = float(np.exp(0.3))
    Lj, Wj, Rj = (jnp.asarray(a) for a in (L, W, R))

    def mv(v):
        return (JK.heff_apply(Lj, Wj, Rj, v.reshape(psi.shape)) * fac).reshape(-1)

    want, k_used, bad = jax_krylov(mv, jnp.asarray(psi.reshape(-1)), SCALE,
                                   cfg.thresh_exp, cfg.max_krylov, cfg.conserve_norm,
                                   arnoldi=False, return_iterations=True)
    assert st.tolist() == [int(k_used), int(bad)]
    assert np.max(np.abs(got.numpy().reshape(-1) - np.asarray(want))) < 1e-10


def test_lanczos_gate_keeps_the_chain_on_the_kernel():
    """Every site of the 184-site chain (D = 30, Fock dimension 8, the
    exciton's 3, fused MPO width 4) keeps the kernel at the chain's and the
    Simulator's max_krylov; a site the JAX package's 60 MB gate refuses, M
    = l·d = 1024 with 8 channels, does not."""
    for M, r in ((240, 30), (90, 30), (8, 8), (30, 8)):
        for kmax in (10, 20):
            assert CL.fits((M, r), 4, kmax)
    assert CL.fits((30, 30), 4, 20)  # a K step
    assert not CL.fits((1024, 256), 8, 7)
    assert not CL.fits((4096, 1024), 8, 10)


# ------------------------------------------------------------ on the card
@pytest.mark.cuda
def test_slice_on_card_tracks_cpu(cuda):
    """complex64 through both kernels on the card tracks the complex128
    plain path on the CPU at float32 scale (the bound of
    tests/test_pallas_lanczos.py's engine test)."""
    cores, ham, _ = _start()
    cpu = TDVPEngine(cores, ham, Config(thresh_exp=1e-9), "cpu")
    card = TDVPEngine(cores, ham, Config(thresh_exp=1e-9, dtype="complex64"),
                      device=cuda)
    for _ in range(3):
        lz0, qr0 = CL.lanczos_expm.launches, CQ.mgs_qr.launches
        cpu.propagate(DT)
        card.propagate(DT)
        assert CL.lanczos_expm.launches - lz0 == 2 * (2 * NSITE - 1)
        assert CQ.mgs_qr.launches - qr0 == 2 * (NSITE - 1)
    mirror = convert.from_numpy(card.to_numpy(), ham.fused_mpo(card.phys_dims),
                                Config(), "cpu")
    assert cpu.distance(mirror) < 5e-5
    assert abs(cpu.expectation().real - card.expectation().real) < 1e-6


@pytest.mark.cuda
def test_large_lanczos_site_takes_the_einsum_route_on_card(cuda, monkeypatch):
    """The einsum route of a site past the gate on the card, in complex64:
    no Lanczos kernel launch, and the update within float32 scale of the
    kernel route's (both stop at thresh 1e-6, so their Krylov dimensions
    may differ by one: 1e-4 relative)."""
    psi, nxt, L, W, R, scale, lL, lR = _site_args(*_hermitian_site(23, chi=16))
    args = (*(t.to(cuda, torch.complex64) for t in (psi, nxt, L, W, R)), scale,
            lL.to(cuda, torch.float32), lR.to(cuda, torch.float32))
    got, want = _both_routes(monkeypatch, args, Config(thresh_exp=1e-6), "launches")
    for a, b in ((got[0], want[0]), (got[1], want[1]), (got[2][0], want[2][0])):
        assert a.is_cuda and bool(torch.isfinite(a).all())
        assert float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)) < 1e-4


# Lanczos sites off the kernel: relaxed Krylov, bf16x3 ("high") and
# one-pass ("default") matvecs run ``integrator.krylov_expm`` over the
# einsums, as the JAX package's ``use_plz`` rule sends them to its XLA
# loop.  The JAX engine on the CPU computes its "high" and "default"
# einsums exactly (float64: one JAX run serves both) and its relaxed
# matvecs in bf16 with its own sum order, so the gap is the port's own
# low-precision products: measured after 3 steps (relative to the state)
# below 1.5e-6 relaxed (its matvecs from iteration 2 on), 1.7e-5 "high"
# (bf16x3 carries ~16 mantissa bits) and 1.4e-2 "default" (one bf16 pass,
# ~8 bits, in every matvec and transfer).
def _off_kernel_run(jx, jax_change, runs):
    from pytdscf_torch.mps import cuda_krylov as CK

    cores, ham, phys = _start()
    jax_engine = jx.TDVPEngine(
        cores, ham, jx.Config(thresh_exp=1e-9, pallas_site=False,
                              **jax_change))
    ports = [convert.from_numpy(jax_engine.to_numpy(), ham.fused_mpo(phys),
                                Config(thresh_exp=1e-9, **change), "cpu")
             for change, _ in runs]
    for _ in range(3):
        jax_engine.propagate(DT)
    want = _dense(jax_engine.to_numpy()[0])
    j_calls, j_capped = jax_engine.krylov_stats()[1:]
    for port, (change, tol) in zip(ports, runs):
        lz0, ctl0 = CL.lanczos_expm.plain_calls, CK.krylov_ctl.plain_calls
        for _ in range(3):
            port.propagate(DT)
        gap = np.linalg.norm(_dense(port.to_numpy()[0]) - want)
        assert gap < tol * np.linalg.norm(want), (change, gap)
        # no site took the Lanczos kernel; each Krylov iteration ran one
        # control step
        avg, calls, capped, relaxed = port.krylov_stats()
        assert CL.lanczos_expm.plain_calls == lz0
        assert CK.krylov_ctl.plain_calls - ctl0 == round(avg * calls)
        assert (calls, capped) == (j_calls, j_capped)
        assert (relaxed > 0) == bool(change.get("krylov_relaxed"))


def test_relaxed_lanczos_matches_jax(jx):
    change = dict(krylov_relaxed=True)
    _off_kernel_run(jx, change, [(change, 1.5e-6)])


def test_high_and_default_lanczos_match_jax(jx):
    default = dict(matvec_precision="default", env_precision="default")
    _off_kernel_run(jx, default, [(dict(matvec_precision="high"), 1e-4),
                                  (default, 5e-2)])


@pytest.mark.cuda
@pytest.mark.parametrize("change,tol", [
    (dict(krylov_relaxed=True), 5e-5),
    (dict(matvec_precision="high"), 5e-5),
    (dict(matvec_precision="default", env_precision="default"), 2e-2),
])
def test_lanczos_off_the_kernel_on_card(cuda, change, tol):
    """The same three configurations on the card in complex64, host-driven
    and as CUDA-graph replays (``propagate_steps``): the replays equal the
    host-driven steps and both track the CPU's complex128 run at the
    configuration's own precision (the state distance, relative); no site
    takes the Lanczos kernel, every Krylov iteration one control kernel,
    and the low-precision products their kernels."""
    from pytdscf_torch.mps import cuda_krylov as CK
    from pytdscf_torch.mps import cuda_matvec as CM
    from pytdscf_torch.mps import cuda_renorm as CR

    def launches():
        return (CL.lanczos_expm.launches, CK.krylov_ctl.launches,
                CM.heff_lo.launches + CM.keff_lo.launches,
                CR.matvec_hi.launches, CR.renorm_lo.launches)

    cores, ham, phys = _start()
    cfg = Config(thresh_exp=1e-6, **change)
    cpu = TDVPEngine(cores, ham, cfg, "cpu")
    host = TDVPEngine(cores, ham, cfg.replace(dtype="complex64"), cuda)
    graph = TDVPEngine(cores, ham, cfg.replace(dtype="complex64"), cuda)
    before = launches()
    for _ in range(3):
        cpu.propagate(DT)
        host.propagate(DT)
    n = [a - b for a, b in zip(launches(), before)]
    graph.propagate_steps(DT, 3)
    torch.cuda.synchronize()
    assert (graph.eager_steps, graph.graph_steps) == (1, 2)
    stats = host.krylov_stats()
    assert stats == graph.krylov_stats()
    assert all(torch.equal(a, b) for a, b in zip(host.cores[0], graph.cores[0]))
    mirror = convert.from_numpy(host.to_numpy(), ham.fused_mpo(phys),
                                Config(), "cpu")
    assert cpu.distance(mirror) < tol
    avg, calls, _, relaxed = stats
    assert n[0] == 0 and n[1] == round(avg * calls)
    low = change.get("matvec_precision") == "default"
    assert n[2] == (round(avg * calls) if low else relaxed)
    assert (n[2] > 0) == (low or bool(change.get("krylov_relaxed")))
    assert (n[3] > 0) == (change.get("matvec_precision") == "high")
    assert n[4] == (3 * 2 * (NSITE - 1) if low else 0)
