"""The Liouville-space (MPDO) slice of the port against the JAX package.

The radical-pair Liouvillian of ``bench_chi.py`` with the split-electron
layout, cut to 2+2 nuclei (6 sites of dimension 4) and χ=16, from the
bench's start: the singlet product state plus ε=1e-4 noise from
``default_rng(42)``, then ``right_canonicalize``.  Both engines run
Arnoldi (``max_krylov=7``, ``conserve_norm=False``, dt=0.5, lt2) for three
steps in complex128 on the CPU.  The JAX engine is pinned to its XLA MGS(×2)
gauge, the port's convention on every device (χ=16 stays below the
CholeskyQR³ width).

Tolerances.  Exact Arnoldi: both run classical Gram–Schmidt, the same
Taylor exponential and stopping rule in float64, so the dense ρ agree to
1e-10.  Relaxed Krylov (``relax_after=1``): both run the single-bf16-pass
matvec with the same rounding points (the port's plain version against
JAX's planar einsum path, ``pallas_matvec=False``).  One such Krylov call
agrees between the two to 1e-11, but the relaxed trajectory is sensitive:
the bf16 noise sits at the scale of the stopping threshold, so a
perturbation of 1e-11 can end a later call one iteration earlier and
moves the state by the size of the bf16 tail itself (a 1e-12 change of
the start gives 1.6e-6 after three steps; exact runs keep it at 1e-12).
Measured here: the two relaxed runs' dense ρ are 2.4e-7, 1.1e-6 and
1.8e-6 apart after steps 1-3 and their electron populations 2.9e-7,
while each sits ~3e-6 from the exact run; the bars are 1e-5 on ρ and
1e-6 on the populations.  The "throughput" rung (bf16x3 iteration-0
matvecs and env transfers) is held to the same bars: JAX's "high" products
are exact on the CPU, so that gap is the bf16x3 error (measured 2.6e-6 on
ρ, 2.3e-7 on the populations after three steps).
"""

from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytdscf_torch.config import Config
from pytdscf_torch.mps import cuda_matvec as CM
from pytdscf_torch.mps import cuda_renorm as CR
from pytdscf_torch.mps.tdvp import TDVPEngine

torch.set_num_threads(1)

NUC, CHI, DT, STEPS = 2, 16, 0.5, 3
# throughput rung against JAX (exact "high" on the CPU): measured 9.6e-7,
# 2.0e-6 and 2.6e-6 on ρ after steps 1-3 and 2.3e-7 on the populations,
# the size of the relaxed runs' own gap; the bars are the relaxed test's
REL_HIGH_RHO = 1e-5
REL_HIGH_POPS = 1e-6


def _model(pkg: str, n_nuc: int, split: bool = True):
    """(basis, Model, phys dims, first electron site) of ``pkg``."""
    import importlib

    rp = importlib.import_module(f"{pkg}.models.radical_pair")
    Model = importlib.import_module(f"{pkg}.model").Model
    hfc = [round(0.15 + 0.07 * k, 4) for k in range(n_nuc)]
    basis, mpo, ele = rp.radical_pair_liouvillian(
        hfcs_1=[(2, a) for a in hfc], hfcs_2=[(2, a) for a in hfc],
        split_electron=split,
    )
    model = Model(basis, {"hamiltonian": mpo}, space="liouville",
                  bond_dim=CHI)
    return basis, model, [b.nstate for b in basis], ele


def _start(basis, phys, ele, chi=CHI):
    """bench_chi.py's start state (its lines 133-149) at bond ``chi``."""
    from pytdscf_torch.models.radical_pair import singlet_product_state
    from pytdscf_torch.mps.lattice import (
        alloc_hartree_product,
        bond_dims_for_site,
    )

    vecs = singlet_product_state(basis, ele, split_electron=True)
    cores = alloc_hartree_product(phys, 4, vecs, space="liouville")
    rng = np.random.default_rng(42)
    out = []
    for p, c in enumerate(cores):
        m_l, m_r = bond_dims_for_site(phys, p, chi)
        full = np.zeros((m_l, phys[p], m_r), dtype=np.complex128)
        full[: c.shape[0], :, : c.shape[2]] = c
        scale = 1.0e-04 * max(np.abs(c).max(), 1e-30)
        full += scale * (rng.normal(size=full.shape)
                         + 1j * rng.normal(size=full.shape))
        out.append(full)
    return out


def _dense(cores):
    out = np.asarray(cores[0])
    for c in cores[1:]:
        out = np.einsum("...r,rns->...ns", out, np.asarray(c))
    return out[0, ..., 0]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture
def jx(monkeypatch):
    """The JAX engine, pinned to its XLA MGS(×2) gauge."""
    import jax

    import pytdscf_tpu.mps.kernels as JK
    from pytdscf_tpu.config import Config as JConfig
    from pytdscf_tpu.mps.tdvp import TDVPEngine as JEngine

    monkeypatch.setattr(JK, "_PALLAS_QR_FORCE", True)
    monkeypatch.setattr(JK, "_PALLAS_QR_OFF", True)
    jax.clear_caches()
    yield SimpleNamespace(Config=JConfig, TDVPEngine=JEngine)
    jax.clear_caches()


@pytest.mark.parametrize("n_nuc,split", [(1, True), (2, False), (8, True)])
def test_liouville_model_identical(n_nuc, split):
    """The copied builders give the JAX package's fused Liouville MPO,
    start vectors and Hartree cores, bit for bit (8 nuclei: the χ=1024
    bench's 18 sites, MPO widths 7/8)."""
    from pytdscf_torch.models.radical_pair import singlet_product_state as t_sps
    from pytdscf_torch.mps.lattice import alloc_hartree_product as t_alloc
    from pytdscf_tpu.models.radical_pair import singlet_product_state as j_sps
    from pytdscf_tpu.mps.lattice import alloc_hartree_product as j_alloc

    tb, tm, phys, ele = _model("pytdscf_torch", n_nuc, split)
    jb, jm, jphys, jele = _model("pytdscf_tpu", n_nuc, split)
    assert (phys, ele) == (jphys, jele)
    tf = tm.hamiltonian.fused_mpo(phys)[0][0]
    jf = jm.hamiltonian.fused_mpo(phys)[0][0]
    assert len(tf) == len(phys) == 2 * n_nuc + (2 if split else 1)
    for a, b in zip(tf, jf):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    tv, jv = t_sps(tb, ele, split_electron=split), j_sps(jb, jele, split_electron=split)
    assert all(np.array_equal(a, b) for a, b in zip(tv, jv))
    tc = t_alloc(phys, 4, tv, space="liouville")
    jc = j_alloc(phys, 4, jv, space="liouville")
    assert all(np.array_equal(a, b) for a, b in zip(tc, jc))
    if n_nuc == 8 and split:
        assert [c.shape[0] for c in tf[1:]] == [7] + [8] * 15 + [7]


@pytest.mark.parametrize("preset", ["throughput", "balanced", "precise", "exact"])
def test_precision_presets_match_jax(preset):
    from pytdscf_tpu.config import Config as JConfig

    port = Config().with_precision_preset(preset)
    jax_cfg = JConfig().with_precision_preset(preset)
    # the JAX package selects the fused site by its environment switch
    jax_switch = os.environ.get("PYTDSCF_PALLAS_WHOLESITE", "0") == "1"
    for field in dataclasses.fields(port):
        want = (jax_switch if field.name == "fused_site"
                else getattr(jax_cfg, field.name))
        assert getattr(port, field.name) == want, field.name
    # a preset sets both precisions, whatever the rung before it was
    again = port.with_precision_preset("throughput").with_precision_preset(preset)
    assert (again.matvec_precision, again.env_precision) == (
        port.matvec_precision, port.env_precision)


def test_throughput_preset_raises():
    """The throughput rung runs ("high" = bf16x3), and so does the one-pass
    "default" product, which no preset selects; unknown presets and
    precisions raise."""
    assert Config().with_precision_preset("throughput").env_precision == "high"
    for field in ("matvec_precision", "env_precision"):
        assert getattr(Config(**{field: "default"}), field) == "default"
        for preset in ("throughput", "balanced", "precise", "exact"):
            assert getattr(Config().with_precision_preset(preset),
                           field) != "default"
        with pytest.raises(ValueError):
            Config(**{field: "fast"})
    with pytest.raises(ValueError):
        Config().with_precision_preset("fast")


def _engines(jx, relaxed: bool, with_jax: bool = True, prec="highest"):
    basis, tmodel, phys, ele = _model("pytdscf_torch", NUC)
    _, jmodel, _, _ = _model("pytdscf_tpu", NUC)
    cores = _start(basis, phys, ele)
    kw = dict(space="liouville", integrator="arnoldi", thresh_exp=1e-9,
              max_krylov=7, conserve_norm=False, krylov_relaxed=relaxed,
              relax_after=1, matvec_precision=prec, env_precision=prec)
    je = None
    if with_jax:
        je = jx.TDVPEngine([cores], jmodel.hamiltonian, jx.Config(
            pallas_matvec=False, pallas_site=False,
            pallas_env=prec == "high", **kw))
        je.right_canonicalize()
    te = TDVPEngine([cores], tmodel.hamiltonian, Config(**kw), "cpu")
    te.right_canonicalize()
    return je, te, ele


def test_liouville_engine_matches_jax(jx):
    """Exact Arnoldi: canonicalisation, three steps, trace, reduced
    density matrices, Krylov telemetry and the cost model."""
    je, te, ele = _engines(jx, relaxed=False)
    assert _rel(_dense(te.to_numpy()[0]), je.contract_all()) < 1e-10
    for _ in range(STEPS):
        je.propagate(DT)
        te.propagate(DT)
        want = je.contract_all()
        assert _rel(_dense(te.to_numpy()[0]), want) < 1e-10
        assert abs(te.trace() - je.trace(0)) < 1e-10
    assert 0.9 < te.trace().real < 1.0001
    assert te.norm() == pytest.approx(abs(je.trace(0)), abs=1e-10)
    for legs in [(0,) * ele + (2, 2), (1, 0, 2), (0, 2, 0, 0, 1)]:
        got = te.reduced_density_liouville(legs)
        want = np.asarray(je.reduced_density_liouville(legs))
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) < 1e-10
    pops = np.real(np.einsum("aabb->ab", te.reduced_density_liouville(
        (0,) * ele + (2, 2)))).ravel()
    assert np.sum(pops) == pytest.approx(te.trace().real, abs=1e-10)
    *stats, relaxed = te.krylov_stats()
    j_stats = je.krylov_stats()
    assert stats == pytest.approx(j_stats)
    assert relaxed == 0
    assert te.flops_estimate(j_stats[0]) == pytest.approx(
        je.flops_estimate(j_stats[0]), rel=1e-15)


def test_liouville_relaxed_matches_jax(jx):
    """Relaxed Krylov from iteration 1 (the "balanced" rung): the port's
    plain bf16 matvecs against JAX's planar einsum path; every relaxed
    matvec is counted by the wrappers and by ``krylov_stats``."""
    je, te, ele = _engines(jx, relaxed=True)
    _, exact, _ = _engines(jx, relaxed=False, with_jax=False)
    calls0 = CM.heff_lo.plain_calls + CM.keff_lo.plain_calls
    for _ in range(STEPS):
        je.propagate(DT)
        te.propagate(DT)
        exact.propagate(DT)
        want = je.contract_all()
        got = _dense(te.to_numpy()[0])
        assert _rel(got, want) < 1e-5
    legs = (0,) * ele + (2, 2)
    pops = np.real(np.einsum("aabb->ab", te.reduced_density_liouville(legs)))
    j_pops = np.real(np.einsum(
        "aabb->ab", np.asarray(je.reduced_density_liouville(legs))))
    assert np.max(np.abs(pops - j_pops)) < 1e-6
    ref = _dense(exact.to_numpy()[0])
    # the bf16 tail really ran, and stayed within the relaxation bound
    assert 1e-7 < _rel(got, ref) < 1e-4
    avg, calls, capped, relaxed = te.krylov_stats()
    assert (avg, calls, capped) == pytest.approx(je.krylov_stats())
    calls1 = CM.heff_lo.plain_calls + CM.keff_lo.plain_calls
    assert relaxed == calls1 - calls0 > 0
    assert relaxed == round(avg * calls) - calls  # k_used − 1 per call


def test_relaxed_needs_arnoldi_and_liouville_norm():
    basis, model, phys, ele = _model("pytdscf_torch", 1)
    cores = _start(basis, phys, ele, chi=4)
    # relaxed Krylov with Lanczos is taken (its sites run krylov_expm)
    TDVPEngine([cores], model.hamiltonian,
               Config(space="liouville", krylov_relaxed=True), "cpu")
    te = TDVPEngine([cores], model.hamiltonian,
                    Config(space="liouville", integrator="arnoldi"), "cpu")
    assert te.norm() == pytest.approx(abs(te.trace()))
    assert te.trace().real == pytest.approx(1.0, abs=1e-3)


def test_liouville_throughput_matches_jax(jx):
    """The "throughput" rung (bf16x3 iteration-0 matvecs and env transfers,
    relaxed Krylov from iteration 1) against JAX's, whose "high" products
    are exact on the CPU (and its Pallas transfer is gated off at χ=16), so
    the gap is the bf16x3 error itself.  Every in-sweep transfer and every
    exact-prefix matvec went through the port's bf16x3 plain chain."""
    je, te, ele = _engines(jx, relaxed=True, prec="high")
    _, bal, _ = _engines(jx, relaxed=True, with_jax=False)
    r0, m0 = CR.renorm_hi.plain_calls, CR.matvec_hi.plain_calls
    for _ in range(STEPS):
        je.propagate(DT)
        te.propagate(DT)
        bal.propagate(DT)
        assert _rel(_dense(te.to_numpy()[0]), je.contract_all()) < REL_HIGH_RHO
    legs = (0,) * ele + (2, 2)
    pops = np.real(np.einsum("aabb->ab", te.reduced_density_liouville(legs)))
    j_pops = np.real(np.einsum(
        "aabb->ab", np.asarray(je.reduced_density_liouville(legs))))
    assert np.max(np.abs(pops - j_pops)) < REL_HIGH_POPS
    # bf16x3 ran: the run left the balanced (float32-exact prefix) one
    assert _rel(_dense(te.to_numpy()[0]), _dense(bal.to_numpy()[0])) > 1e-7
    avg, calls, capped, relaxed = te.krylov_stats()
    assert (calls, capped) == tuple(je.krylov_stats()[1:])
    # 2 half-sweeps × (NSITE − 1) transfers a step; one exact-prefix matvec
    # per Krylov call
    nsite = te.nsite
    assert CR.renorm_hi.plain_calls - r0 == STEPS * 2 * (nsite - 1)
    assert CR.matvec_hi.plain_calls - m0 == calls


# ------------------------------------- the reference's literal (ROADMAP A4)
@pytest.mark.parametrize("stride", [1, 4])
def test_simulator_matches_dense_radical_pair(tmp_path, monkeypatch, stride):
    """The port's Liouville ``Simulator.propagate`` (Arnoldi,
    ``conserve_norm=False``) on ``tests/test_radical_pair.py``'s small
    radical pair against its dense ``expm`` trajectory at that test's
    atol 5e-7: the electron-pair reduced density of every step (through
    the port's ``reduced_density.nc``), at ``fetch_stride`` 1 and 4.  At
    stride 4 a run of populations rows runs the fused blocks (the step
    program, uncaptured on the CPU): its rows are the stride-1 run's, text
    for text."""
    from test_radical_pair import (B0, D0, DT, J, KS, KT, NSTEP, SCALE,
                                   _dense_trajectory)

    from pytdscf_torch import Model, Simulator, units
    from pytdscf_torch.models.radical_pair import (
        radical_pair_liouvillian,
        singlet_product_state,
    )
    from pytdscf_tpu.util import read_nc

    monkeypatch.chdir(tmp_path)
    basis, mpo, ele = radical_pair_liouvillian(
        hfcs_1=[(2, 0.4)], hfcs_2=[(3, 0.5)],
        B0=B0, J=J, D0=D0, kS=KS, kT=KT, scale=SCALE)
    model = Model(basis, {"hamiltonian": mpo}, space="liouville", bond_dim=16)
    model.init_HartreeProduct = [singlet_product_state(basis, ele)]
    kw = dict(stepsize=DT * units.au_in_fs, conserve_norm=False,
              integrator="arnoldi", fetch_stride=stride)
    Simulator("rp", model, verbose=0, device="cpu").propagate(
        reduced_density=([(ele, ele)], 1), maxstep=NSTEP + 1,
        autocorr=False, energy=False, norm=False, populations=False, **kw)
    rd = read_nc("rp_prop/reduced_density.nc", [(ele, ele)])
    got = np.asarray(rd[(ele, ele)])[: NSTEP + 1]
    np.testing.assert_allclose(got, _dense_trajectory(), atol=5.0e-07)
    # the rows of the fused blocks against a stride-1 run's
    rows = {}
    for s in (1, stride):
        kw["fetch_stride"] = s
        Simulator(f"rows{s}", model, verbose=0, device="cpu").propagate(
            maxstep=9, autocorr=False, energy=False, **kw)
        with open(f"rows{s}_prop/populations.dat") as f:
            rows[s] = f.read()
    assert len(rows[1].splitlines()) == 10
    assert rows[stride] == rows[1]
