"""The IR-spectrum workflow (relax → operate(μ·E) → propagate → spectrum)
through the port's Simulator on the CPU in complex128 (ROADMAP A7, one
electronic state).

* H2O against ``tests/test_h2o_pipeline.py``'s literals: the ZPE
  0.0208557166 to 1e-8, the bend 1612 ± 90 cm⁻¹ and the stretch 3787 ±
  180 cm⁻¹.  This needs the MGS completion that looks past a canonical
  vector lying in the span of the earlier columns (ROADMAP C4): the even
  ground state on the symmetric grid makes the JAX package's MGS gauge
  collapse the improved relaxation to E = 0.
* Butadiene at ``examples/butadiene_ir_spectrum.py``'s settings, relax (8
  improved steps) and operate at full depth, propagate cut to none here
  (its 400 steps take minutes on a CPU; ``chip_smoke.py`` runs them on
  the card and holds the strongest line to the gold): E_gs and ‖μ|0⟩‖
  against the JAX package pinned to its MGS gauge (the port's: 1e-10, and
  1e-10 relative) and against its gold with the example's own settings
  (LAPACK's gauge on the CPU, 1.5e-9 and 5e-6 relative away: 1e-8, and
  2e-5 relative).  Both literals come from the JAX package on the CPU in
  complex128 (``scripts/ir_gold.py``, with and without ``--mgs``).
"""

from __future__ import annotations

import math
import os

import numpy as np
import pytest
import torch

from pytdscf_torch import Simulator, spectra, units
from pytdscf_torch.basis.ho import PrimBas_HO
from pytdscf_torch.model import BasInfo, Model
from pytdscf_torch.operators.sop import read_potential_nMR
from pytdscf_torch.potentials import h2o_k_orig, h2o_mu, load

torch.set_num_threads(1)

EFIELD = (1.0e-02, 1.0e-02, 1.0e-02)
C4H6_MGS = {"e_gs": 0.06757225533221635, "norm": 0.0013707910419449817}
C4H6_GOLD = {"e_gs": 0.06757225687261864, "norm": 0.0013707978631834132}


def test_h2o_workflow_meets_jax_literals(tmp_path, monkeypatch):
    """``tests/test_h2o_pipeline.py`` through the port's Simulator."""
    monkeypatch.chdir(tmp_path)
    prim = [[PrimBas_HO(0.0, math.sqrt(h2o_k_orig[(i, i)]) * units.au_in_cm1,
                        9) for i in (1, 2, 3)]]
    basinfo = BasInfo(prim)
    model = Model(basinfo, {"hamiltonian": read_potential_nMR(h2o_k_orig)},
                  bond_dim=9)
    e_gs, wf = Simulator("h2o", model, verbose=0, device="cpu").relax(
        maxstep=10, stepsize=0.1, improved=True)
    assert e_gs == pytest.approx(0.0208557166, abs=1.0e-08)
    harm_zpe = sum(math.sqrt(h2o_k_orig[(i, i)]) for i in (1, 2, 3)) / 2
    assert e_gs < harm_zpe
    assert os.path.exists("wf_h2o_gs.pkl")
    assert wf.engine.ground_state_stats()["calls"] == 10 * 2 * 3
    model_mu = Model(basinfo, {"hamiltonian": read_potential_nMR(
        None, dipole_emu=h2o_mu, efield=EFIELD)}, bond_dim=9)
    norm, _ = Simulator("h2o", model_mu, verbose=0, device="cpu").operate(
        maxstep=10, restart=True, loadfile_ext="_gs")
    assert norm > 0
    assert os.path.exists("wf_h2o_operate.pkl")
    Simulator("h2o", model, verbose=0, device="cpu").propagate(
        maxstep=500, stepsize=0.2, restart=True, loadfile_ext="_operate")
    t_fs, ac = spectra.load_autocorr("h2o_prop/autocorr.dat")
    assert t_fs[-1] == pytest.approx(2 * 499 * 0.2, rel=1e-6)  # T/2 trick
    freq, inten = spectra.ifft_autocorr(
        t_fs, ac, E_shift=e_gs * units.au_in_eV)
    sel = (freq > 1000) & (freq < 3000)
    assert freq[sel][np.argmax(inten[sel])] == pytest.approx(1612.0, abs=90.0)
    sel = (freq > 3000) & (freq < 4100)
    assert freq[sel][np.argmax(inten[sel])] == pytest.approx(3787.0, abs=180.0)


def test_butadiene_relax_operate_gold(tmp_path, monkeypatch):
    """Butadiene at the example's settings, relax and operate at full
    depth (propagate cut to none here)."""
    monkeypatch.chdir(tmp_path)
    k_orig = load("c4h6_local_potential")["k_orig"]
    mu = load("c4h6_local_dipole")["mu"]
    modes = sorted({i for key in k_orig for i in key})
    prim = [[PrimBas_HO(0.0, math.sqrt(k_orig[(m, m)]) * units.au_in_cm1, 6)
             for m in modes]]
    basinfo = BasInfo(prim)
    model = Model(basinfo, {"hamiltonian": read_potential_nMR(k_orig)},
                  bond_dim=12)
    e_gs, _ = Simulator("c4h6", model, verbose=0, device="cpu").relax(
        maxstep=8, stepsize=0.1, improved=True)
    assert abs(e_gs - C4H6_MGS["e_gs"]) < 1e-10
    assert abs(e_gs - C4H6_GOLD["e_gs"]) < 1e-8
    model_mu = Model(basinfo, {"hamiltonian": read_potential_nMR(
        None, dipole_emu=mu, efield=EFIELD, active_modes=modes)},
        bond_dim=12)
    norm, _ = Simulator("c4h6", model_mu, verbose=0, device="cpu").operate(
        maxstep=10, restart=True, loadfile_ext="_gs")
    assert abs(norm / C4H6_MGS["norm"] - 1) < 1e-10
    assert abs(norm / C4H6_GOLD["norm"] - 1) < 2e-5
