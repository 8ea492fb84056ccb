"""Adaptive bond dimension (a1TDVP, the variable-width sweep) on the port.

``TDVPEngine._half_sweep_adaptive`` grows each bond by the leading
directions of the projection residual (1 − QQ†)·H_eff ψ and truncates it
by SVD after the K step, for one electronic state and for several, in real
time, imaginary time and improved relaxation; ``Simulator.propagate(
adaptive=True)`` runs it step by step and writes ``bonddim.dat``.  On the
CPU in complex128:

* ``tests/test_adaptive.py``'s variable-form bodies against the port
  (``torch_ported.ported``), with the energy literal 0.010000180312707298
  at their own 2e-6;
* the LVC exciton model (``tests/test_exciton_propagate.py``) from bond
  dimension 1 and 4, 5 steps in each mode, against the JAX engine on its
  MGS gauge (``tests/torch_adaptive_cases.py`` says why these gauges):
  bond dimensions equal, the dense state (up to the phase of a ground
  state in improved relaxation) and ⟨H⟩ within 1e-10, against the JAX
  package's runs stored by ``scripts/a9_gold.py tests --write``
  (``tests/fixtures/a9_jax.npz``), and one step through both packages
  here on LAPACK's gauge (``tests/test_torch_adaptive_live.py`` runs the
  other kinds of case live);
* ``tests/test_adaptive.py:157``'s two-state model under the variable form
  against the JAX package: populations within 1e-10, their sum within
  1e-8 of 1, and within 1e-5 of the fixed-bond run; the states' bonds
  differ, and the stacked norm (not each state's) is restored after a
  truncation;
* a small LH2 chain (``lh2_chain(nmol=1, nfock=3)``, D=6, 3 steps at the
  example's settings) through both Simulators on LAPACK's gauge: bond
  dimensions, dense state, ⟨H⟩ and the chromophore populations, and
  ``bonddim.dat`` line for line;
* the refusals: ``adaptive_masked=True`` names ROADMAP A9b, and
  ``propagate_steps_collect`` raises under adaptive, while
  ``propagate_steps`` runs the steps one by one;
* the sweep's parts (the thin QR of a bond wider than its rows, the
  enrichment's caps, the truncation's rule, the stacked norm, the padded
  stack of states of different bonds).

The tests marked ``cuda`` need an NVIDIA GPU and skip elsewhere: the
kernels of this path at its shapes (the one-block Lanczos H step at (400,
40), the cluster H step at (80, 40), the (40, 40) K step and MGS at (400,
40)) against their plain versions, and an adaptive run of a 9-site LH2
chain at nfock 10 and D=40 on the card against the same run on the CPU.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import torch_adaptive_cases as cases
from pytdscf_torch import units
from pytdscf_torch.config import Config
from pytdscf_torch.mps import cuda_lanczos as CL
from pytdscf_torch.mps import cuda_qr as CQ
from pytdscf_torch.mps import kernels as K
from pytdscf_torch.mps import tdvp as TT

# the JAX engine's adaptive sweeps trace many distinct bond shapes
pytestmark = pytest.mark.clear_jax_caches

LVC_ENERGY = 0.010000180312707298  # tests/test_exciton_propagate.py
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's runs (``scripts/a9_gold.py tests --write``)."""
    with np.load(cases.FIXTURE) as npz:
        return {k: npz[k] for k in npz.files}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _phase_gap(a, b) -> float:
    """max |a·e^{iφ} − b| at the phase φ that aligns a with b."""
    ov = np.vdot(a, b)
    return float(np.max(np.abs(a * (ov / abs(ov)) - b)))


# ------------------------------------------------ the JAX suite's bodies
@pytest.mark.parametrize("test", ["test_adaptive_grows_and_matches",
                                  "test_adaptive_no_expansion_is_exact"])
def test_adaptive_bodies(test, tmp_path, monkeypatch):
    from pytdscf_torch.basis import Exciton, HarmonicOscillator as HO
    from tests import test_adaptive as ta
    from tests import test_exciton_propagate as jt
    from torch_ported import ported

    prim = [HO(8, f, units="cm-1") for f in jt.freqs_cm1] + [
        Exciton(nstate=2, names=["S0", "S1"])]
    build = ported(jt._build_hamiltonian, prim_info=prim)
    ported(getattr(ta, test), prim_info=prim,
           _build_hamiltonian=build)(tmp_path, monkeypatch)


# -------------------------------------------- the LVC model against JAX
@pytest.mark.parametrize("bond", cases.LVC_BONDS)
@pytest.mark.parametrize("relax", cases.LVC_RELAX)
def test_lvc_matches_jax(jax_runs, relax, bond):
    got = cases.lvc_run("torch", relax, bond)
    want = {k: jax_runs[f"lvc/{relax}/{bond}/{k}"]
            for k in ("dense", "energy", "bonds")}
    assert got["bonds"].tolist() == want["bonds"].tolist()
    if relax == "improved":
        # a ground state is fixed up to its phase
        assert _phase_gap(got["dense"], want["dense"]) < TOL
    else:
        assert np.max(np.abs(got["dense"] - want["dense"])) < TOL
    assert abs(got["energy"] - float(want["energy"])) < TOL
    assert abs(np.linalg.norm(got["dense"]) - 1.0) < TOL
    if relax == "none":
        # the bonds grew from 1, or the padded start was truncated
        assert got["bonds"].tolist() == [2, 2, 2]
        assert abs(got["energy"] - LVC_ENERGY) < 2e-6


def test_lvc_live_against_jax():
    """One LVC step (real time from bond dimension 1, the fixture's
    settings) through both engines here, on the JAX package's own CPU
    gauge (LAPACK's QR; one JAX step compiles for ~10 s, on MGS ~3× that)."""
    jax_out = cases.lvc_run("tpu", "none", 1, steps=1, qr="lapack")
    got = cases.lvc_run("torch", "none", 1, steps=1, qr="lapack")
    assert got["bonds"].tolist() == jax_out["bonds"].tolist() == [2, 2, 2]
    assert np.max(np.abs(got["dense"] - jax_out["dense"])) < TOL
    assert abs(got["energy"] - jax_out["energy"]) < TOL


# --------------------------------------- several states against JAX
@pytest.fixture(scope="module")
def two_state(tmp_path_factory):
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("two_state"))
    try:
        return {tag: cases.two_state_run("torch", tag == "adaptive")
                for tag in ("adaptive", "fixed")}
    finally:
        os.chdir(cwd)


def test_two_state_matches_jax(jax_runs, two_state):
    got = two_state["adaptive"]
    pops = got["pops"]
    assert np.max(np.abs(pops - jax_runs["ms/adaptive/pops"])) < TOL
    assert got["bonds"].tolist() == jax_runs["ms/adaptive/bonds"].tolist()
    assert np.max(np.abs(got["dense"] - jax_runs["ms/adaptive/dense"])) < TOL
    # transferred, not equalised; the stacked norm stays 1
    assert abs(pops.sum() - 1.0) < 1e-8
    assert pops[1] > 1e-3
    assert np.max(np.abs(pops - two_state["fixed"]["pops"])) < 1e-5
    assert np.max(np.abs(pops - jax_runs["ms/fixed/pops"])) < 1e-5


def test_two_state_bonds_differ(two_state):
    """The states size their bonds on their own: the engine's padded
    stack of them gives each state's own norm."""
    bonds = two_state["adaptive"]["bonds"]
    assert bonds[0].tolist() != bonds[1].tolist()
    dense = two_state["adaptive"]["dense"]
    assert np.allclose(np.sum(np.abs(dense) ** 2, axis=(1, 2, 3, 4)),
                       two_state["adaptive"]["pops"], rtol=0, atol=1e-12)


# ------------------------------------------- a small LH2 chain against JAX
@pytest.fixture(scope="module")
def lh2(tmp_path_factory):
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("lh2"))
    try:
        return cases.lh2_run("torch")
    finally:
        os.chdir(cwd)


def test_lh2_chain_matches_jax(jax_runs, lh2):
    assert lh2["bonds"].tolist() == jax_runs["lh2/bonds"].tolist()
    assert np.max(np.abs(lh2["dense"] - jax_runs["lh2/dense"])) < TOL
    assert abs(lh2["energy"] - float(jax_runs["lh2/energy"])) < TOL
    assert np.max(np.abs(lh2["pops"] - jax_runs["lh2/pops"])) < TOL
    # the excited γ exciton starts to move to β and α
    assert lh2["pops"][0] < 1.0 and min(lh2["pops"][1:]) > 1e-7


def test_bonddim_dat_matches_jax(jax_runs, lh2):
    got = str(lh2["bonddim_dat"]).splitlines()
    want = str(jax_runs["lh2/bonddim_dat"]).splitlines()
    assert got == want
    assert got[0].split("\t")[1:] == [f"bond_{i}" for i in range(8)]
    assert len(got) == 1 + cases.LH2_STEPS
    # the start's padded bonds, then the bonds the sweep kept
    assert got[1].split("\t")[1:] == ["2", "6", "6", "6", "6", "6", "6", "3"]
    rows = [np.array(line.split("\t"), float)
            for line in str(lh2["expectations_dat"]).splitlines()[1:]]
    ref = [np.array(line.split("\t"), float)
           for line in str(jax_runs["lh2/expectations_dat"]).splitlines()[1:]]
    assert len(rows) == len(ref) == cases.LH2_STEPS
    assert np.max(np.abs(np.array(rows) - np.array(ref))) <= 1.5e-9


# ------------------------------------------------------------ refusals
def _lvc_engine(**kw):
    prim, ham = cases.lvc_hamiltonian("torch")
    vecs = [np.asarray(ho.get_unitary()[0]) for ho in prim[:3]] + [
        np.array([0.0, 1.0])]
    from pytdscf_torch.mps.lattice import alloc_hartree_product

    cores = [alloc_hartree_product([b.nprim for b in prim], 1, vecs)]
    cfg = Config(**{**cases.LVC_ADAPTIVE, **kw})
    return TT.TDVPEngine(cores, ham, cfg, "cpu"), ham


def test_masked_raises_a9b(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="A9b"):
        _lvc_engine(adaptive_masked=True)
    from pytdscf_torch import Model, Simulator

    prim, ham = cases.lvc_hamiltonian("torch")
    monkeypatch.chdir(tmp_path)
    sim = Simulator("msk", Model(prim, {"hamiltonian": ham}, bond_dim=1),
                    device="cpu", verbose=0)
    with pytest.raises(NotImplementedError, match="A9b"):
        sim.propagate(maxstep=1, adaptive=True, adaptive_masked=True)


def test_block_drivers_under_adaptive():
    """``propagate_steps`` is ``propagate`` step by step (bit for bit), no
    step is captured, and ``propagate_steps_collect`` raises."""
    a, _ = _lvc_engine()
    b, _ = _lvc_engine()
    dt = cases.LVC_DT_FS / units.au_in_fs
    assert not a.capturable()
    a.propagate_steps(dt, 3)
    for _ in range(3):
        b.propagate(dt)
    assert a.eager_steps == b.eager_steps == 3 and a.graph_steps == 0
    assert a.enrichments == b.enrichments > 0
    for x, y in zip(a.cores[0], b.cores[0]):
        assert torch.equal(x, y)
    assert a.bond_dims() == b.bond_dims() == [2, 2, 2]
    with pytest.raises(NotImplementedError, match="adaptive"):
        a.propagate_steps_collect(dt, 2)


# ----------------------------------------------------- the sweep's parts
def _cx(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape))


@pytest.mark.parametrize("N,r,rank", [(3, 6, 3), (3, 6, 1), (6, 4, 4)])
def test_adaptive_qr(N, r, rank):
    """min(N, r) columns of Q, orthonormal, and Q·R the matrix; a bond
    wider than the rows takes the gauge of the first N columns."""
    rng = np.random.default_rng(7)
    m = _cx(rng, N, rank) @ _cx(rng, rank, r)
    q, rm = TT._adaptive_qr(m)
    k = min(N, r)
    assert q.shape == (N, k) and rm.shape == (k, r)
    assert torch.allclose(q.mH @ q, torch.eye(k, dtype=q.dtype), atol=1e-12)
    assert torch.allclose(q @ rm, m, atol=1e-12)
    if N < r:
        assert torch.equal(q, K.thin_qr(m[:, :N].contiguous())[0])


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("dmax,dD,p_proj,added", [
    (20, 5, 1e-9, 3),    # the residual's rank caps it
    (20, 2, 1e-9, 2),    # adaptive_dD caps it
    (6, 5, 1e-9, 2),     # adaptive_Dmax caps it
    (20, 5, 1e6, 0),     # nothing above p_proj
])
def test_enrich_caps(forward, dmax, dD, p_proj, added):
    rng = np.random.default_rng(3)
    psi = _cx(rng, 4, 3, 4)
    # H_eff ψ of rank 3 as a matrix towards the next site
    h = _cx(rng, 12, 3) @ _cx(rng, 3, 4)
    hpsi = (h.reshape(4, 3, 4) if forward
            else h.reshape(4, 3, 4).permute(2, 1, 0))
    cfg = Config(adaptive=True, adaptive_Dmax=dmax, adaptive_dD=dD,
                 adaptive_p_proj=p_proj)
    site, sig, add = TT._enrich(psi, hpsi, cfg, forward)
    assert add == added
    k = 4 + added
    if forward:
        assert site.shape == (4, 3, k) and sig.shape == (k, 4)
        back = torch.einsum("lnk,kr->lnr", site, sig)
        a = site.reshape(12, k)
    else:
        assert site.shape == (k, 3, 4) and sig.shape == (4, k)
        back = torch.einsum("lk,knr->lnr", sig, site)
        a = site.permute(2, 1, 0).reshape(12, k)
    assert torch.allclose(back, psi, atol=1e-12)
    assert torch.allclose(a.mH @ a, torch.eye(k, dtype=a.dtype), atol=1e-12)
    # the added directions carry no weight until the K step
    rows = sig[4:] if forward else sig[:, 4:]
    assert torch.count_nonzero(rows) == 0


@pytest.mark.parametrize("forward", [True, False])
def test_truncate_rule(forward):
    """Singular values at or below p_svd·σ₀ go, one is always kept, and the
    site times σ is the kept part of the state."""
    rng = np.random.default_rng(5)
    u, _ = np.linalg.qr(rng.standard_normal((5, 5)))
    v, _ = np.linalg.qr(rng.standard_normal((4, 4)))
    s = np.array([1.0, 1e-3, 1e-7, 0.0])
    sig = torch.from_numpy((u[:, :4] * s) @ v.T).to(torch.complex128)
    site = torch.eye(5, dtype=torch.complex128).reshape(1, 5, 5)
    if not forward:
        sig = sig.T.contiguous()
        site = site.permute(2, 1, 0)
    for p_svd, keep in ((1e-5, 2), (1e-2, 1), (1e-8, 3), (1e-12, 3)):
        cfg = Config(adaptive=True, adaptive_p_svd=p_svd)
        a, sg, cut = TT._truncate(site, sig, cfg, forward)
        assert cut and (sg.shape[0] if forward else sg.shape[1]) == keep
        full = (torch.einsum("lnk,kr->lnr", site, sig) if forward
                else torch.einsum("lk,knr->lnr", sig, site))
        part = (torch.einsum("lnk,kr->lnr", a, sg) if forward
                else torch.einsum("lk,knr->lnr", sg, a))
        gone = float(np.sqrt(np.sum(s[keep:] ** 2)))
        assert abs(float(torch.linalg.vector_norm(full - part)) - gone) < 1e-12
    # p_svd under float64's resolution: the exact zero stays, as LAPACK's
    # rounding-level value would
    cfg = Config(adaptive=True, adaptive_p_svd=1e-20)
    a, sg, cut = TT._truncate(site, sig, cfg, forward)
    assert not cut and sg is sig
    cfg = Config(adaptive=True, adaptive_p_svd=1e-5)
    zero = torch.zeros_like(sig)
    a, sg, cut = TT._truncate(site, zero, cfg, forward)
    assert cut and (sg.shape[0] if forward else sg.shape[1]) == 1
    full_rank = torch.eye(4, dtype=torch.complex128)
    a, sg, cut = TT._truncate(site[..., :4] if forward else site[:4],
                              full_rank, cfg, forward)
    assert not cut and sg is full_rank


def test_restore_norm_is_stacked():
    sigs = [torch.full((2, 2), 0.3, dtype=torch.complex128),
            torch.full((3, 1), 0.1, dtype=torch.complex128)]
    out = TT._restore_norm(sigs)
    tot = sum(float(torch.sum(torch.abs(s) ** 2)) for s in out)
    assert abs(tot - 1.0) < 1e-14
    # the states' shares stay as they were
    ratio = float(torch.sum(torch.abs(out[0]) ** 2)
                  / torch.sum(torch.abs(out[1]) ** 2))
    assert abs(ratio - 0.36 / 0.03) < 1e-12


def test_padded_stack_of_states():
    """``TDVPEngine._site`` pads the narrower states' cores with zero
    channels: a two-state engine whose states differ in bonds gives the
    norms, ⟨H⟩ and autocorrelation of the same states padded by hand."""
    from pytdscf_torch import convert

    model = cases.two_state_model("torch")
    rng = np.random.default_rng(11)
    shapes = [[(1, 5, 2), (2, 5, 3), (3, 5, 2), (2, 5, 1)],
              [(1, 5, 3), (3, 5, 4), (4, 5, 3), (3, 5, 1)]]
    cores = [[rng.standard_normal(s) + 1j * rng.standard_normal(s)
              for s in state] for state in shapes]
    padded = [[np.zeros(b, complex) for b in shapes[1]] for _ in cores]
    for state, out in zip(cores, padded):
        for c, o in zip(state, out):
            o[:c.shape[0], :, :c.shape[2]] = c
    fused = model.hamiltonian.fused_mpo([5] * 4)
    eng = convert.from_numpy(cores, fused, Config(adaptive=True), "cpu")
    ref = convert.from_numpy(padded, fused, Config(), "cpu")
    stacked = eng._site(1)
    assert tuple(stacked.shape) == (2, 3, 5, 4)
    assert torch.equal(stacked[0, :2, :, :3], eng.cores[0][1])
    assert torch.count_nonzero(stacked[0, 2:]) == 0
    assert torch.allclose(eng._norms2(), ref._norms2(), rtol=1e-14, atol=0)
    assert abs(eng.expectation() - ref.expectation()) < 1e-12 * abs(
        ref.expectation())
    assert abs(eng.autocorr() - ref.autocorr()) < 1e-12 * abs(ref.autocorr())
    items, plan = eng.properties_submit()
    got = eng.properties_resolve(TT.fetch_many(items, torch.float64), plan)
    want = ref.properties_bundle()
    for key in ("energy", "autocorr", "norm"):
        assert abs(got[key] - want[key]) < 1e-12 * abs(want[key])


# ------------------------------------------------------------ on the card
def _path_site(seed, l, d, r, w, device):
    """Seeded Hermitian operands of an H step at (l·d, r) over w channels,
    as on the adaptive LH2 path."""
    rng = np.random.default_rng(seed)

    def cx(*shape):
        a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        return a / np.linalg.norm(a)

    psi, L, R, W = cx(l, d, r), cx(l, w, l), cx(r, w, r), cx(w, d, d, w)
    L = 0.5 * (L + L.transpose(2, 1, 0).conj())
    R = 0.5 * (R + R.transpose(2, 1, 0).conj())
    W = 0.5 * (W + W.transpose(0, 2, 1, 3).conj())

    def t(x):
        return torch.from_numpy(x).to(torch.complex64).to(device)

    return t(psi), t(L), t(W), t(R)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,way", [
    ((40, 10, 40, 12), "block"),    # a boson site: no cluster holds x
    ((40, 2, 40, 12), "cluster"),   # an exciton site
])
def test_lanczos_h_step_on_card(cuda, shape, way):
    l, d, r, w = shape
    psi, L, W, R = _path_site(41, l, d, r, w, cuda)
    ch = CL.heff_channels(L, W, R)
    v = psi.reshape(l * d, r).contiguous()
    assert CL.route(l * d, r, w) == way
    launches = CL.lanczos_expm.route_launches[way]
    out, st = CL.lanczos_expm(ch, v, -0.5j, 1e-7, 20, True)
    ref, st_ref = CL.lanczos_expm_plain(*ch, v, -0.5j, 1e-7, 20, True)
    torch.cuda.synchronize()
    assert CL.lanczos_expm.route_launches[way] == launches + 1
    assert st.tolist() == st_ref.tolist()
    assert float(torch.linalg.vector_norm(out - ref)) < 5e-6


@pytest.mark.cuda
def test_k_step_and_mgs_on_card(cuda):
    psi, L, _, R = _path_site(43, 40, 10, 40, 12, cuda)
    kch = CL.keff_channels(L, R)
    sig = psi[:, 0, :].contiguous()
    sig = sig / torch.linalg.vector_norm(sig)
    out, st = CL.lanczos_expm(kch, sig, 0.5j, 1e-7, 20, True)
    ref, st_ref = CL.lanczos_expm_plain(*kch, sig, 0.5j, 1e-7, 20, True)
    torch.cuda.synchronize()
    assert st.tolist() == st_ref.tolist()
    assert float(torch.linalg.vector_norm(out - ref)) < 5e-6
    m = psi.reshape(400, 40).contiguous()
    m[:, 30:] = 0  # dead columns, as a padded start gives
    launches = CQ.mgs_qr.launches
    q, rm = CQ.mgs_qr(m)
    qp, rp = CQ.mgs_qr_plain(m)
    torch.cuda.synchronize()
    assert CQ.mgs_qr.launches == launches + 1
    eye = torch.eye(40, dtype=q.dtype, device=cuda)
    assert float(torch.max(torch.abs(q.mH @ q - eye))) < 1e-5
    assert float(torch.max(torch.abs(q @ rm - m))) < 1e-5
    assert float(torch.max(torch.abs(q[:, :30] - qp[:, :30]))) < 1e-4


@pytest.mark.cuda
def test_adaptive_chain_on_card(cuda, tmp_path, monkeypatch):
    """Two adaptive steps of a 9-site LH2 chain at nfock 10, D=40 on the
    card (its widest boson sites take the one-block Lanczos route)
    against the same steps on the CPU in complex64: ⟨H⟩ and the
    chromophore populations."""
    from pytdscf_torch import Simulator

    monkeypatch.chdir(tmp_path)
    out = {}
    for dev in ("cuda", "cpu"):
        model, ops = cases.lh2_model("torch", nfock=10, bond=40)
        block = CL.lanczos_expm.route_launches["block"]
        _, wf = Simulator(f"c_{dev}", model, device=dev, verbose=0).propagate(
            maxstep=2, stepsize=0.2, dtype="complex64", energy=True,
            autocorr=False, **dict(cases.LH2_ADAPTIVE, adaptive_Dmax=40))
        out[dev] = (wf.engine.expectation().real,
                    [wf.engine.expectation(op).real for op in ops.values()],
                    wf.engine.bond_dims(),
                    CL.lanczos_expm.route_launches["block"] - block)
    (e_g, p_g, b_g, blocks), (e_c, p_c, b_c, _) = out["cuda"], out["cpu"]
    assert blocks > 0 and max(b_g) > 6
    assert abs(e_g - e_c) < 1e-5 * abs(e_c)
    assert max(abs(a - b) for a, b in zip(p_g, p_c)) < 1e-4


@pytest.mark.cuda
def test_two_state_adaptive_on_card(cuda, tmp_path, monkeypatch):
    """The two-state model's adaptive run on the card (the pair sums over
    the padded stack of states whose bonds differ) against the same run on
    the CPU in complex128: populations, their sum and the bonds grown."""
    from pytdscf_torch import Simulator

    monkeypatch.chdir(tmp_path)
    out = {}
    for dev, dtype in (("cuda", "complex64"), ("cpu", "complex128")):
        _, wf = Simulator(f"m_{dev}", cases.two_state_model("torch"),
                          device=dev, verbose=0).propagate(
            dtype=dtype, **dict(cases.MS_KW, **cases.MS_ADAPTIVE))
        out[dev] = (np.asarray(wf.engine.pop_states()),
                    [wf.engine.bond_dims(i) for i in range(2)])
    (p_g, b_g), (p_c, b_c) = out["cuda"], out["cpu"]
    assert b_g[0] != b_g[1]
    assert np.max(np.abs(p_g - p_c)) < 1e-5
    assert abs(p_g.sum() - 1.0) < 1e-5 and p_g[1] > 1e-3
