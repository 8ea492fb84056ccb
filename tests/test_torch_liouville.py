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
1e-6 on the populations.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytdscf_torch.config import Config
from pytdscf_torch.mps import cuda_matvec as CM
from pytdscf_torch.mps.tdvp import TDVPEngine

torch.set_num_threads(1)

NUC, CHI, DT, STEPS = 2, 16, 0.5, 3


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


@pytest.mark.parametrize("preset", ["balanced", "precise", "exact"])
def test_precision_presets_match_jax(preset):
    from pytdscf_tpu.config import Config as JConfig

    port = Config().with_precision_preset(preset)
    jax_cfg = JConfig().with_precision_preset(preset)
    for field in dataclasses.fields(port):
        assert getattr(port, field.name) == getattr(jax_cfg, field.name), field.name
    # the port's products are the JAX "highest" rung: float32, TF32 off
    assert (jax_cfg.matvec_precision, jax_cfg.env_precision) == ("highest", "highest")


def test_throughput_preset_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        Config().with_precision_preset("throughput")
    with pytest.raises(ValueError):
        Config().with_precision_preset("fast")


def _engines(jx, relaxed: bool, with_jax: bool = True):
    basis, tmodel, phys, ele = _model("pytdscf_torch", NUC)
    _, jmodel, _, _ = _model("pytdscf_tpu", NUC)
    cores = _start(basis, phys, ele)
    kw = dict(space="liouville", integrator="arnoldi", thresh_exp=1e-9,
              max_krylov=7, conserve_norm=False, krylov_relaxed=relaxed,
              relax_after=1)
    je = None
    if with_jax:
        je = jx.TDVPEngine([cores], jmodel.hamiltonian, jx.Config(
            pallas_matvec=False, pallas_site=False, **kw))
        je.right_canonicalize()
    te = TDVPEngine([cores], tmodel.hamiltonian, Config(**kw))
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
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        TDVPEngine([cores], model.hamiltonian,
                   Config(space="liouville", krylov_relaxed=True))
    te = TDVPEngine([cores], model.hamiltonian,
                    Config(space="liouville", integrator="arnoldi"))
    assert te.norm() == pytest.approx(abs(te.trace()))
    assert te.trace().real == pytest.approx(1.0, abs=1e-3)
