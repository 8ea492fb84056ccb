"""``Simulator.propagate`` of the port against the JAX package's.

The 6-site singlet-fission chain (``singlet_fission_chain(2, 3)``) at bond
dimension 6, exciton level 1 occupied and the bosons in vacuum, three
steps of 0.2 fs in complex128 on the CPU, with the autocorrelation,
energy, norm, populations and the exciton site's reduced density written
each step.  The JAX run is pinned to its XLA MGS gauge (the Hartree-product
start is rank-deficient, so the trajectory depends on the dead-column
completion frame; ``tests/test_torch_engine.py``) and runs once per module;
the port runs with its fused site update on (``PYTDSCF_PALLAS_WHOLESITE=1``,
which takes the chain's two square-MPO inner sites) and off.

Tolerances: the two run the same recurrence, stopping rule and gauge in
float64 and differ in the order of sums and in exp(scale·T)e₀ (eigh in
JAX, Taylor substeps in the port, ~1e-11 apart per call), so the energy,
the cores and the reduced densities agree to 1e-10, and the ``.dat`` rows,
printed to 9 decimals, to the last digit.
"""

from __future__ import annotations

import os
import pickle
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytdscf_torch import Simulator
from pytdscf_torch.checkpoint import load_wavefunction, save_wavefunction
from pytdscf_torch.model import BasInfo, Model
from pytdscf_torch.models.holstein import singlet_fission_chain
from pytdscf_torch.mps import cuda_site as CS
from pytdscf_torch.util.nc4 import as_complex

torch.set_num_threads(1)

N_LEFT, N_RIGHT, BOND, STEPS, DT_FS = 2, 3, 6, 3, 0.2
RD_KEY = (N_LEFT, N_LEFT)  # the exciton site's density, both legs


def _model(chain, model_cls):
    basis, ham = chain(n_left=N_LEFT, n_right=N_RIGHT)
    model = model_cls(basis, ham, bond_dim=BOND)
    vecs = []
    for i, b in enumerate(basis):
        v = np.zeros(b.nprim, dtype=complex)
        v[1 if i == N_LEFT else 0] = 1.0
        vecs.append(v)
    model.init_HartreeProduct = [vecs]
    return model


def _outputs(jobname, energy):
    """What a run left behind: the energy, the two .dat files' lines, the
    saved cores and the reduced densities."""
    import h5py

    with open(os.path.join(f"{jobname}_prop", "autocorr.dat")) as fh:
        autocorr = fh.read().splitlines()
    with open(os.path.join(f"{jobname}_prop", "populations.dat")) as fh:
        pops = fh.read().splitlines()
    with open(f"wf_{jobname}.pkl", "rb") as fh:
        cores = pickle.load(fh)["cores"]
    with h5py.File(os.path.join(f"{jobname}_prop", "reduced_density.nc")) as f:
        rho = as_complex(f[f"rho_{RD_KEY}_0"][()])
    return SimpleNamespace(energy=energy, autocorr=autocorr, pops=pops,
                           cores=cores, rho=rho)


def _propagate(sim):
    return sim.propagate(stepsize=DT_FS, maxstep=STEPS,
                         reduced_density=([RD_KEY], 1))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's Simulator.propagate, once per module."""
    import jax

    import pytdscf_tpu.mps.kernels as JK
    from pytdscf_tpu.model import Model as JModel
    from pytdscf_tpu.models.holstein import singlet_fission_chain as jchain
    from pytdscf_tpu.simulator import Simulator as JSimulator

    cwd = os.getcwd()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JK, "_PALLAS_QR_FORCE", True)
        mp.setattr(JK, "_PALLAS_QR_OFF", True)
        mp.setenv("PYTDSCF_NO_COMPILE_CACHE", "1")
        jax.clear_caches()
        os.chdir(tmp_path_factory.mktemp("jax_sim"))
        try:
            energy, _ = _propagate(JSimulator("jx", _model(jchain, JModel)))
            yield _outputs("jx", energy)
        finally:
            os.chdir(cwd)
            jax.clear_caches()


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("fused", [True, False])
def test_propagate_matches_jax(jax_run, in_tmp, monkeypatch, fused):
    monkeypatch.setenv("PYTDSCF_PALLAS_WHOLESITE", "1" if fused else "0")
    before = CS.site_step_fused.plain_calls
    sim = Simulator("pt", _model(singlet_fission_chain, Model), device="cpu")
    energy, wf = _propagate(sim)
    # sites 2 and 3 take the fused update in each half-sweep
    assert CS.site_step_fused.plain_calls - before == (4 * STEPS if fused else 0)
    got = _outputs("pt", energy)
    assert abs(got.energy - jax_run.energy) < 1e-10
    assert len(got.autocorr) == len(got.pops) == STEPS + 1  # header + rows
    assert got.autocorr == jax_run.autocorr
    assert got.pops == jax_run.pops
    for a, b in zip(got.cores[0], jax_run.cores[0]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-10)
    assert got.rho.shape == jax_run.rho.shape == (STEPS, 3, 3)
    np.testing.assert_allclose(got.rho, jax_run.rho, atol=1e-10)
    assert abs(wf.norm() - 1.0) < 1e-10
    assert wf.bonddim() == [int(c.shape[2]) for c in got.cores[0][:-1]]
    assert sim.diagnostics.counts["steps"] == STEPS


def test_checkpoint_round_trip(in_tmp):
    """A saved wavefunction reads back as it was, and a run restarted from
    its checkpoint continues the trajectory of an unbroken run."""
    model = _model(singlet_fission_chain, Model)
    _, whole = Simulator("a", model, device="cpu").propagate(
        stepsize=DT_FS, maxstep=2)
    Simulator("b", model, device="cpu").propagate(
        stepsize=DT_FS, maxstep=1, savefile_ext="_half")
    payload = load_wavefunction("wf_b_half.pkl")
    save_wavefunction(payload, "copy.pkl")
    again = load_wavefunction("copy.pkl")
    assert all(np.array_equal(x, y)
               for x, y in zip(payload["cores"][0], again["cores"][0]))
    _, resumed = Simulator("b", model, device="cpu").propagate(
        stepsize=DT_FS, maxstep=1, restart=True, loadfile_ext="_half")
    for x, y in zip(whole.engine.to_numpy()[0], resumed.engine.to_numpy()[0]):
        np.testing.assert_allclose(x, y, atol=1e-12)
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        save_wavefunction(payload, "x.pkl", backend="orbax")


def _refuse_model(attr):
    def make():
        model = _model(singlet_fission_chain, Model)
        setattr(model, attr, object())
        return Simulator("r", model, device="cpu")
    return make


def _nonstandard():
    basis, ham = singlet_fission_chain(n_left=N_LEFT, n_right=N_RIGHT)
    info = BasInfo([basis], spf_info=[[b.nprim for b in basis]])
    return Simulator("r", Model(info, ham, bond_dim=BOND), device="cpu")


def _sim(**init):
    def make():
        model = _model(singlet_fission_chain, Model)
        return Simulator("r", model, device="cpu", **init)
    return make


@pytest.mark.parametrize("make,kw,item", [
    (_sim(ci_type="mctdh"), {}, "A12"),
    (_nonstandard, {}, "A12"),
    (_sim(), {"cmf": True}, "A12"),
    (_sim(), {"parallel_split_indices": [(0, 2), (3, 5)]}, "A13"),
    (_sim(), {"bond_tp_devices": 2}, "A13"),
    # the variable-width sweep is ported; the masked one is A9b
    (_sim(), {"adaptive": True, "adaptive_masked": True}, "A9"),
    (_sim(), {"splitting": "suzuki4"}, "A10"),
    (_sim(), {"splitting": "yoshida4"}, "A10"),
    (_refuse_model("one_gate_to_apply"), {}, "A10"),
    (_refuse_model("kraus_op"), {}, "A10"),
    (_refuse_model("build_td_hamiltonian"), {}, "A10"),
])
def test_refused_options_name_their_item(in_tmp, make, kw, item):
    sim = make()
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        sim.propagate(stepsize=DT_FS, maxstep=1, **kw)


@pytest.mark.parametrize("call", ["relax", "operate", "proj_gs"])
def test_relax_operate_and_proj_gs_raise(call, in_tmp):
    """``relax``, ``operate`` and ``proj_gs`` run on a two-state model
    (ROADMAP A3, ported; ``tests/test_torch_multistate.py`` holds them to
    the JAX package's literals): improved relaxation lowers ⟨H⟩ below the
    start's with the norm kept, the fit returns ‖H|Ψ⟩‖ > 0 with a unit
    fitted state, ``proj_gs`` starts from ``primbas_gs``'s ground state."""
    from pytdscf_torch.config import Config

    if call == "proj_gs":
        model = _model(singlet_fission_chain, Model)
        sim = Simulator("r", model, proj_gs=True, device="cpu")
        assert sim.proj_gs and model.primbas_gs is None
        plain = Simulator("r", model, device="cpu")._alloc_initial_cores()
        for a, b in zip(sim._alloc_initial_cores(), plain):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        return
    from pytdscf_torch.basis.ho import PrimBas_HO
    from pytdscf_torch.model import BasInfo
    from pytdscf_torch.operators.sop import PolynomialHamiltonian

    basinfo = BasInfo([[PrimBas_HO(0.0, 1000.0, 4) for _ in range(2)]
                       for _ in range(2)])
    ham = PolynomialHamiltonian(2, nstate=2,
                                matJ=[[0.0, 1.0e-3], [1.0e-3, 1.0e-2]])
    ham.set_HO_potential(basinfo)
    model = Model(basinfo, {"hamiltonian": ham}, bond_dim=2)
    sim = Simulator("r", model, device="cpu")
    start = sim._initial_engine(Config(), False, "")
    e0 = start.expectation().real
    value, wf = getattr(sim, call)()
    assert wf.engine.nstate == 2 and len(wf.engine.pairs) == 4
    assert abs(wf.norm() - 1.0) < 1e-10
    if call == "relax":
        assert value < e0
    else:
        assert value > 0.0


def test_reduced_density_without_h5py_fails_before_any_step(in_tmp,
                                                            monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    sim = Simulator("h", _model(singlet_fission_chain, Model), device="cpu")
    with pytest.raises(ImportError, match="h5py"):
        _propagate(sim)
    assert not os.path.exists(os.path.join("h_prop", "autocorr.dat"))


def test_simulator_defaults_to_the_card():
    model = _model(singlet_fission_chain, Model)
    sim = Simulator("c", model)
    assert sim.device.type == "cuda"
    assert sim._auto_dtype() == "complex64"
    assert Simulator("c", model, device="cpu")._auto_dtype() == "complex128"
