"""Adaptive bond dimension (a1TDVP) on the port against the JAX package run
here, live, one short run of each kind of case.

``tests/test_torch_adaptive.py`` holds the port to the JAX package's runs
stored in ``tests/fixtures/a9_jax.npz`` (an adaptive JAX step recompiles
its Krylov programs at every bond, so the whole matrix takes minutes
through JAX).  These tests run the JAX package itself, on the CPU in
complex128, beside the port (``tests/torch_adaptive_cases.py`` builds both
sides and pins the gauges):

* improved relaxation of the LVC model, 5 steps from bond dimension 1 on
  the MGS gauge (the port's own, unpatched): the port against the live JAX
  run, and the live JAX run against the stored one;
* imaginary time of the LVC model, one step from a padded start (bond
  dimension 4, exactly-zero channels), on the MGS gauge (LAPACK's
  Householder completions of columns at the rounding level follow the
  rounding, so the two packages part there at ~1e-6);
* ``tests/test_adaptive.py:157``'s two-state model, 2 steps on the MGS
  gauge (the port's own, unpatched);
* the small LH2 chain (``lh2_chain(nmol=1, nfock=3)``, D=6), one step on
  LAPACK's gauge, with ``bonddim.dat`` line for line.

Bond dimensions equal; dense states, ⟨H⟩ and populations within 1e-10.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_adaptive_cases as cases

# the JAX engine's adaptive sweeps trace many distinct bond shapes
pytestmark = pytest.mark.clear_jax_caches

TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _phase_gap(a, b) -> float:
    """max |a·e^{iφ} − b| at the phase φ that aligns a with b."""
    ov = np.vdot(a, b)
    return float(np.max(np.abs(a * (ov / abs(ov)) - b)))


def test_lvc_improved_live_on_mgs():
    """The port's own gauge against the JAX package pinned to MGS; the
    live JAX run is the one stored for ``test_lvc_matches_jax``."""
    jax_out = cases.lvc_run("tpu", "improved", 1)
    got = cases.lvc_run("torch", "improved", 1)
    with np.load(cases.FIXTURE) as npz:
        stored = {k: npz[f"lvc/improved/1/{k}"]
                  for k in ("dense", "energy", "bonds")}
    assert got["bonds"].tolist() == jax_out["bonds"].tolist()
    assert jax_out["bonds"].tolist() == stored["bonds"].tolist()
    # a ground state is fixed up to its phase
    assert _phase_gap(got["dense"], jax_out["dense"]) < TOL
    assert _phase_gap(jax_out["dense"], stored["dense"]) < TOL
    assert abs(got["energy"] - jax_out["energy"]) < TOL
    assert abs(jax_out["energy"] - float(stored["energy"])) < TOL


def test_lvc_imaginary_live_padded():
    """One imaginary-time step from a padded start (bond dimension 4,
    exactly-zero channels), the port on its own MGS gauge."""
    jax_out = cases.lvc_run("tpu", "imaginary", 4, steps=1)
    got = cases.lvc_run("torch", "imaginary", 4, steps=1)
    assert got["bonds"].tolist() == jax_out["bonds"].tolist()
    assert np.max(np.abs(got["dense"] - jax_out["dense"])) < TOL
    assert abs(got["energy"] - jax_out["energy"]) < TOL
    assert abs(np.linalg.norm(got["dense"]) - 1.0) < TOL


def test_two_state_live_on_mgs(tmp_path, monkeypatch):
    """Two steps of the two-state model, the port on its own gauge: the
    states' bonds, dense states and populations, the stacked norm 1."""
    out = {}
    for pkg in ("tpu", "torch"):
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        out[pkg] = cases.two_state_run(pkg, True, steps=2)
    got, want = out["torch"], out["tpu"]
    assert got["bonds"].tolist() == want["bonds"].tolist()
    assert np.max(np.abs(got["dense"] - want["dense"])) < TOL
    assert np.max(np.abs(got["pops"] - want["pops"])) < TOL
    assert abs(got["pops"].sum() - 1.0) < 1e-8


def test_lh2_chain_live(tmp_path, monkeypatch):
    """One step of the small LH2 chain through both Simulators on LAPACK's
    gauge: bonds, dense state, ⟨H⟩, populations and ``bonddim.dat``."""
    out = {}
    for pkg in ("tpu", "torch"):
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        out[pkg] = cases.lh2_run(pkg, steps=1)
    got, want = out["torch"], out["tpu"]
    assert got["bonds"].tolist() == want["bonds"].tolist()
    assert np.max(np.abs(got["dense"] - want["dense"])) < TOL
    assert abs(got["energy"] - want["energy"]) < TOL
    assert np.max(np.abs(got["pops"] - want["pops"])) < TOL
    assert (str(got["bonddim_dat"]).splitlines()
            == str(want["bonddim_dat"]).splitlines())
