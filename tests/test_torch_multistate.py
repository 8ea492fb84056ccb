"""Several electronic states through the port (ROADMAP A3).

One MPS per electronic state, coupled through a fused MPO per state pair
(``mps/pairs.py``), through ``Simulator.relax`` (imaginary time and
improved), ``operate`` and ``propagate``, on the CPU in complex128:

* the Ambrosek aggregate of ``tests/test_relax_operate.py`` (two
  molecules, two modes each, two states): the JAX suite's own five test
  bodies run against the port (``torch_ported.ported``), with their
  literals and tolerances, ``proj_gs`` and improved relaxation included;
* ``tests/test_util.py``'s exciton-helper test against the port's copy of
  ``util/helper_input.py`` (``torch_ported.ported_source``);
* the engine against the JAX engine (pinned to its MGS gauge, whose
  dead-column completions the port shares): a 3-state
  ``matJ_1D_exciton`` aggregate (3 sites, 4 primitives, D=4; state 2
  starts with zero weight, so every gauge move of its cores completes dead
  columns) enters the port through ``convert.from_numpy``, then both take
  2 real-time steps and 1 imaginary-time step of 0.5 fs.  Each state's
  dense vector, the populations and ⟨H⟩ agree to 1e-10 (dense vectors and
  populations: 4e-15 measured; ⟨H⟩ 2e-17).  The raw cores agree only to
  ~3e-9: a weakly occupied column of a gauge is fixed up to the rounding
  of its small norm, which the dense product does not see;
* the "high" (bf16x3) and "default" (one bf16 pass) pair sums at one site
  against the JAX package's pair loops (``_make_hmatvec`` exact and
  ``kernels.make_hmatvec_lo``) and against the port's one-pair wrappers;
* the route rules: with several states no site takes the Lanczos,
  fused-site or ground-state kernel, and improved relaxation is not
  captured;
* the step program (uncaptured on the CPU) against the per-step loop,
  and ``apply_operator_fit`` of a multi-state operator against its
  dense product.

The tests marked ``cuda`` need an NVIDIA GPU and skip elsewhere: a
multi-state replay against its host-driven step, and the MGS kernel at
the 27-state LH2 model's gauge shapes against its plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from pytdscf_torch import convert, units
from pytdscf_torch.config import Config
from pytdscf_torch.mps import cuda_lanczos as CL
from pytdscf_torch.mps import cuda_qr as CQ
from pytdscf_torch.mps import cuda_site as CS
from pytdscf_torch.mps import pairs as P
from pytdscf_torch.mps import tdvp as TT
from torch_ported import one_blas_thread, ported, ported_source

torch.set_num_threads(1)

DT = 0.5 / units.au_in_fs
NPRIM, BOND = 4, 4
FREQ, DISP = 763.31, 0.317


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    with one_blas_thread():
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _jax_tests(name: str):
    import importlib

    return importlib.import_module(f"tests.{name}")


# ------------------------------------------------ the JAX suite's checks
@pytest.mark.parametrize("test", [
    "test_ambrosek_imag_relax", "test_ambrosek_propagate",
    "test_ambrosek_projgs_propagate", "test_ambrosek_projgs_imag_relax",
    "test_improved_relax_finds_ground_state",
])
def test_ambrosek_literals(test, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jt = _jax_tests("test_relax_operate")
    ported(getattr(jt, test), _build_model=ported(jt._build_model))(tmp_path)


def test_exciton_helpers():
    ported_source(_jax_tests("test_util").test_helper_input_exciton_builders)()


# ------------------------------------------------ the engine against JAX
def _aggregate(pkg: str):
    """The 3-state aggregate (one mode a molecule, coupleJ −0.04 eV) built
    by ``pytdscf_{pkg}``: (Hamiltonian, fused MPO, Hartree-product cores)."""
    import importlib

    mod = {name: importlib.import_module(f"pytdscf_{pkg}.{name}") for name in (
        "basis", "model", "operators.sop", "util.helper_input",
        "mps.lattice")}
    ho = mod["basis"].PrimBas_HO
    prim, _, _, matJ = mod["util.helper_input"].matJ_1D_exciton(
        3, NPRIM, [ho(0.0, FREQ, NPRIM)], [ho(DISP, FREQ, NPRIM)],
        -0.04 / units.au_in_eV)
    bas = mod["model"].BasInfo(prim)
    ham = mod["operators.sop"].PolynomialHamiltonian(bas.get_ndof(),
                                                     bas.get_nstate())
    ham.coupleJ = matJ
    ham.set_HO_potential(bas)
    ham.bind_basis(bas)
    phys = [NPRIM] * 3
    cores = []
    for i, weight in enumerate((0.8, 0.6, 0.0)):
        vecs = []
        for k in range(3):
            v = np.zeros(NPRIM, complex)
            v[:2] = (0.8, 0.6) if i == k == 0 else (1.0, 0.0)
            vecs.append(v)
        cores.append(mod["mps.lattice"].alloc_hartree_product(
            phys, BOND, vecs, weight=weight))
    return ham, ham.fused_mpo(phys), cores


def _dense(cores):
    out = cores[0]
    for c in cores[1:]:
        out = np.einsum("...r,rns->...ns", out, c)
    return out[0, ..., 0]


@pytest.fixture(scope="module")
def three_states():
    """Both engines after each of 2 real-time steps and 1 imaginary-time
    step (one JAX run for the module): each state's dense vector, the
    populations, ⟨H⟩, the autocorrelation and the Krylov statistics."""
    import jax

    import pytdscf_tpu.mps.kernels as JK
    from pytdscf_tpu.config import Config as JConfig
    from pytdscf_tpu.mps.tdvp import TDVPEngine as JEngine

    mp = pytest.MonkeyPatch()
    mp.setattr(JK, "_PALLAS_QR_FORCE", True)
    mp.setattr(JK, "_PALLAS_QR_OFF", True)
    jax.clear_caches()
    try:
        ham, fused, cores = _aggregate("tpu")
        je = JEngine(cores, ham, JConfig(thresh_exp=1e-10, pallas_site=False))
        pe = convert.from_numpy(je.to_numpy(), fused,
                                Config(thresh_exp=1e-10, pytest_enabled=True),
                                "cpu")
        lz0, qr0 = CL.lanczos_expm.plain_calls, CQ.mgs_qr.plain_calls
        out = {}
        for tag in ("real 1", "real 2", "imag"):
            if tag == "imag":
                je.config = dataclasses.replace(je.config, relax="imaginary")
                pe.config = pe.config.replace(relax="imaginary")
            je.propagate(DT)
            pe.propagate(DT)
            out[tag] = {
                "dense": [[_dense(s) for s in e.to_numpy()] for e in (je, pe)],
                "pops": (je.pop_states(), pe.pop_states()),
                "energy": (je.expectation(), pe.expectation()),
            }
        out["autocorr"] = (je.autocorr(), pe.autocorr())
        out["krylov"] = (je.krylov_stats(), pe.krylov_stats())
        out["lanczos_kernel_calls"] = CL.lanczos_expm.plain_calls - lz0
        out["mgs_calls"] = CQ.mgs_qr.plain_calls - qr0
        out["pairs"] = (je.pairs, pe.pairs)
        yield out
    finally:
        mp.undo()
        jax.clear_caches()


@pytest.mark.parametrize("tag", ["real 1", "real 2", "imag"])
def test_engine_matches_jax(three_states, tag):
    got = three_states[tag]
    (jd, pd), (jp, pp), (je, pe) = got["dense"], got["pops"], got["energy"]
    for a, b in zip(jd, pd):
        assert np.max(np.abs(a - b)) < 1e-10
    assert np.max(np.abs(np.asarray(jp) - np.asarray(pp))) < 1e-10
    assert abs(je - pe) < 1e-10
    # the population leaves state 0, and reaches the empty state 2
    assert pp[2] > 1e-4 and abs(sum(pp) - 1.0) < 1e-12


def test_engine_statistics_match_jax(three_states):
    ja, pa = three_states["autocorr"]
    assert abs(ja - pa) < 1e-10
    jk, (*pk, relaxed) = three_states["krylov"]
    assert pk == pytest.approx(jk) and relaxed == 0
    jpairs, ppairs = three_states["pairs"]
    assert tuple(jpairs) == ppairs and len(ppairs) == 7
    # the einsum Krylov program at every site; 3 states' gauge moves,
    # 2 sites a half-sweep, 2 half-sweeps a step, 3 steps
    assert three_states["lanczos_kernel_calls"] == 0
    assert three_states["mgs_calls"] == 3 * 2 * 2 * 3


# ------------------------------------------------ the pair sums at one site
def _site_operands(seed: int):
    """Seeded blocks and facs for every pair of the aggregate at its bulk
    site (l = r = 4, d = 4), the three states' site tensors, and the
    port's pair set."""
    _, fused, _ = _aggregate("torch")
    ps = P.PairSet(fused, 3, lambda a: torch.as_tensor(np.asarray(a)),
                   "cpu", torch.complex128)
    rng = np.random.default_rng(seed)

    def cx(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    blocks = {}
    for pair in ps.pairs:
        W = fused[pair[0]][pair[1]][1]
        blocks[pair] = (cx(BOND, W.shape[0], BOND), cx(BOND, W.shape[3], BOND),
                        float(rng.uniform(0.5, 2.0)))
    return fused, ps, blocks, cx(3, BOND, NPRIM, BOND), cx(3, BOND, BOND)


def _grouped(ps, blocks, heff: bool):
    Ls, Ws, Rs, facs = [], [], [], []
    for g in ps.groups:
        pairs = [ps.pairs[q] for q in g.members]
        Ls.append(torch.as_tensor(np.stack([blocks[q][0] for q in pairs])))
        Rs.append(torch.as_tensor(np.stack([blocks[q][1] for q in pairs])))
        facs.append(torch.tensor([blocks[q][2] for q in pairs],
                                 dtype=torch.float64))
        Ws.append(g.W[1])
    return Ls, Ws if heff else None, Rs, facs


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("prec", ["high", "lo"])
@pytest.mark.parametrize("heff", [True, False], ids=["H", "K"])
def test_pair_sums_at_one_site(prec, heff):
    """The "high" and one-pass ("lo") pair sums of H_eff and K_eff at the
    aggregate's bulk site: against the exact sum over pairs (bf16x3 to
    1e-4, one pass to 2e-2, the bars of ``tests/test_torch_renorm.py`` and
    ``test_torch_matvec.py``), the one-pass sum against the JAX package's
    ``kernels.make_hmatvec_lo`` / ``make_kmatvec_lo`` pair loop (float32
    sum order, 5e-4), and against the port's one-pair wrappers summed
    state by state (1e-12)."""
    import pytdscf_tpu.mps.kernels as JK

    fused, ps, blocks, psi, sig = _site_operands(7)
    x = psi if heff else sig
    shape = x.shape[1:]
    Ls, Ws, Rs, facs = _grouped(ps, blocks, heff)
    got = P.matvec(ps.groups, Ls, Ws, Rs, facs, 3, shape, prec)(
        torch.as_tensor(x).reshape(-1)).numpy()
    jL = [blocks[q][0] for q in ps.pairs]
    jR = [blocks[q][1] for q in ps.pairs]
    jW = [fused[q[0]][q[1]][1] for q in ps.pairs]
    jf = [np.asarray(blocks[q][2]) for q in ps.pairs]
    exact = np.zeros_like(x)
    for q, (i, j) in enumerate(ps.pairs):
        if heff:
            exact[i] += jf[q] * np.einsum("bak,aijc,xcr,kjr->bix", jL[q],
                                          jW[q], jR[q], x[j])
        else:
            exact[i] += jf[q] * np.einsum("bak,xar,kr->bx", jL[q], jR[q],
                                          x[j])
    exact = exact.reshape(-1)
    if prec == "lo":
        # the JAX package's pair loop at one bf16 pass
        shapes, vec = (shape,) * 3, x.reshape(-1)
        lo = (JK.make_hmatvec_lo(ps.pairs, jL, jW, jR, shapes, np.complex128,
                                 jf) if heff else
              JK.make_kmatvec_lo(ps.pairs, jL, jR, shapes, np.complex128,
                                 jf))(vec)
        assert _rel(got, lo) < 5e-4
        assert _rel(got, exact) < 2e-2
    else:
        assert _rel(got, exact) < 1e-4
    # the same terms through the port's one-pair wrappers, summed state by
    # state
    from pytdscf_torch.mps import cuda_matvec as CM
    from pytdscf_torch.mps import cuda_renorm as CR

    want = np.zeros_like(x)
    for q, (i, j) in enumerate(ps.pairs):
        L, R = (torch.as_tensor(jL[q]), torch.as_tensor(jR[q]))
        xj = torch.as_tensor(x[j])
        if prec == "high":
            term = (CR.heff_hi(CR.heff_operands(L, torch.as_tensor(jW[q]), R),
                               xj) if heff
                    else CR.keff_hi(CR.keff_operands(L, R), xj))
        else:
            term = (CM.heff_lo(CM.heff_operands(L, torch.as_tensor(jW[q]), R),
                               xj) if heff
                    else CM.keff_lo(CM.keff_operands(L, R), xj))
        want[i] += jf[q] * term.numpy()
    assert _rel(got, want.reshape(-1)) < 1e-12


# ------------------------------------------------ routes and drivers
def _port_engine(cfg=None):
    _, fused, cores = _aggregate("torch")
    return convert.from_numpy(cores, fused, cfg or Config(), "cpu")


def test_multistate_routes():
    cfg = Config(fused_site=True)
    assert TT._takes_lanczos_kernel(cfg, 1)
    assert not TT._takes_lanczos_kernel(cfg, 3)
    psi, W, nxt = (4, 4, 4), (2, 4, 4, 2), (4, 4, 4)
    assert CS.site_fits(psi, W, nxt, cfg.max_krylov)
    assert TT._takes_fused_site(cfg, psi, W, nxt, 1)
    assert not TT._takes_fused_site(cfg, psi, W, nxt, 3)
    assert TT._takes_gs_kernel((16, 4), 2, 1)
    assert not TT._takes_gs_kernel((16, 4), 2, 3)
    counters = (CL.lanczos_expm, CL.ground_state, CS.site_step_fused)
    for relax in ("none", "imaginary", "improved"):
        eng = _port_engine(cfg.replace(relax=relax))
        assert eng.nstate == 3 and len(eng.pairset.groups) == 2
        assert eng.capturable() == (relax != "improved")
        before = [c.plain_calls for c in counters]
        eng.propagate(DT)
        assert [c.plain_calls for c in counters] == before
        if relax == "improved":
            assert eng.ground_state_stats()["calls"] == 3 * 2


def test_step_program_matches_steps():
    """``propagate_steps_collect`` (the step program, uncaptured on the
    CPU) against ``propagate`` and ``properties_bundle`` step by step:
    cores bit for bit, every row, the plans of several states."""
    a, b = _port_engine(), _port_engine()
    items, plan = a.propagate_steps_collect(DT, 3)
    assert plan == [("energy", 7), ("autocorr", 3), ("pops", 3)]
    vals = TT.fetch_many(items, a.fetch_real_dtype())
    for t in range(3):
        row = a.properties_resolve([v[t] for v in vals], plan)
        want = b.properties_bundle()
        assert row == want
        b.propagate(DT)
    assert a.eager_steps == 3 and a.graph_steps == 0
    for sa, sb in zip(a.cores, b.cores):
        assert all(torch.equal(x, y) for x, y in zip(sa, sb))


def test_operator_fit_of_several_states():
    """``apply_operator_fit`` of a multi-state operator (the Hamiltonian
    with its couplings) at full bond dimension, where O|Ψ⟩ is an MPS of
    the bonds: ‖O|Ψ⟩‖ to 1e-10 (5e-15 measured) and the fitted state's
    fidelity to the dense product 1 − 1e-12.  (Its amplitudes agree to
    ~1e-7: the fit stops on 1 − |⟨prev|new⟩| < conv_tol, which the
    rounding of the overlap, ~1e-14, bounds.)"""
    ham, fused, cores = _aggregate("torch")
    eng = _port_engine()
    eng.propagate(DT)
    psi = [_dense(s) for s in eng.to_numpy()]
    dense = np.zeros((3, 3) + (NPRIM,) * 6, complex)
    for i, j in eng.pairs:
        dense[i, j] = _dense([w.reshape(w.shape[0], -1, w.shape[-1])
                              for w in fused[i][j]]).reshape(
            (NPRIM, NPRIM) * 3).transpose(0, 2, 4, 1, 3, 5)
    want = np.einsum("ijabcdef,jdef->iabc", dense, np.stack(psi))
    norm = eng.apply_operator_fit(ham, maxiter=4)
    got = np.stack([_dense(s) for s in eng.to_numpy()])
    scale = np.linalg.norm(want)
    assert abs(norm - scale) < 1e-10 * scale
    assert 1.0 - abs(np.vdot(got, want / scale)) < 1e-12
    assert np.max(np.abs(got - want / scale)) < 1e-6
    assert abs(eng.norm() - 1.0) < 1e-12


def test_multistate_observables(tmp_path, monkeypatch):
    """``Simulator.propagate(observables=True)`` on the Ambrosek aggregate
    with a state projector as an observable (an operator of one state
    pair, (0, 0), of the two): its ``expectations.dat`` column equals the
    state's ``populations.dat`` column, row by row."""
    from pytdscf_torch import Simulator
    from pytdscf_torch.model import Model
    from pytdscf_torch.operators.sop import PolynomialHamiltonian

    monkeypatch.chdir(tmp_path)
    jt = _jax_tests("test_relax_operate")
    model = ported(jt._build_model)(-0.04 / units.au_in_eV, 4)
    proj = PolynomialHamiltonian(model.get_ndof(), 2)
    proj.coupleJ = [[1.0, 0.0], [0.0, 0.0]]
    model = Model(model.basinfo, {"hamiltonian": model.hamiltonian,
                                  "P0": proj}, bond_dim=4)
    model.init_weight_ESTATE = [0.6, 0.4]
    Simulator("obs", model, verbose=0, device="cpu").propagate(
        maxstep=3, stepsize=0.5, observables=True)
    pops = np.loadtxt("obs_prop/populations.dat", ndmin=2)
    obs = np.loadtxt("obs_prop/expectations.dat", ndmin=2)
    assert pops.shape == (3, 3) and obs.shape == (3, 2)
    assert np.array_equal(obs[:, 0], pops[:, 0])
    assert np.max(np.abs(obs[:, 1] - pops[:, 1])) < 2e-9
    assert abs(pops[0, 1] - 0.6) < 1e-9 and pops[-1, 1] != pops[0, 1]


# ------------------------------------------------ on the card
@pytest.mark.cuda
def test_multistate_replay_matches_host_step(cuda):
    """A captured step of the 3-state aggregate replayed on the card
    against the same step driven from the host: the Krylov statistics,
    the kernels' launches, the populations and ⟨H⟩."""
    from pytdscf_torch.mps import cuda_krylov as CK

    cfg = Config(dtype="complex64", thresh_exp=1e-7)
    _, fused, cores = _aggregate("torch")
    eng = convert.from_numpy(cores, fused, cfg, cuda)
    eng.propagate_steps(DT, 1)  # a host step and the capture
    saved = [[c.clone() for c in s] for s in eng.cores]
    eng.krylov_stats()
    kernels = (CL.lanczos_expm.launches, CL.ground_state.launches,
               CS.site_step_fused.launches)
    n_ctl, n_qr = CK.krylov_ctl.launches, CQ.mgs_qr.launches
    eng.propagate_steps(DT, 1)
    replayed = (eng.krylov_stats(), CK.krylov_ctl.launches - n_ctl,
                CQ.mgs_qr.launches - n_qr, eng.pop_states(),
                eng.expectation().real)
    assert eng.graph_steps == 1
    host = convert.from_numpy([[c.cpu().numpy() for c in s] for s in saved],
                              fused, cfg, cuda)
    n_ctl, n_qr = CK.krylov_ctl.launches, CQ.mgs_qr.launches
    host.propagate(DT)
    again = (host.krylov_stats(), CK.krylov_ctl.launches - n_ctl,
             CQ.mgs_qr.launches - n_qr, host.pop_states(),
             host.expectation().real)
    assert replayed[:3] == again[:3]
    assert np.max(np.abs(np.subtract(replayed[3], again[3]))) < 1e-6
    assert abs(replayed[4] - again[4]) < 1e-6
    # no one-state kernel route runs, replayed or host-driven
    assert (CL.lanczos_expm.launches, CL.ground_state.launches,
            CS.site_step_fused.launches) == kernels


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 8), (8, 8)])
@pytest.mark.parametrize("dead", [False, True], ids=["live", "zero"])
def test_mgs_at_lh2_shapes(cuda, shape, dead):
    """The MGS kernel at the 27-state LH2 model's gauge shapes (bulk (64,
    8) and edge (8, 8) at D=8, 8 primitives) against its plain version,
    on a live core and on an exactly-zero one (a state without weight:
    every column a dead-column completion)."""
    g = torch.Generator().manual_seed(11)
    m = torch.randn(*shape, generator=g, dtype=torch.complex64)
    if dead:
        m.zero_()
    m = m.to(cuda)
    q, r = CQ.mgs_qr(m)
    qp, rp = CQ.mgs_qr_plain(m)
    assert torch.allclose(q, qp, atol=1e-5) and torch.allclose(r, rp, atol=1e-5)
    eye = torch.eye(shape[1], dtype=q.dtype, device=cuda)
    assert torch.max(torch.abs(q.mH @ q - eye)) < 1e-5
    assert torch.max(torch.abs(q @ r - m)) < 1e-5
