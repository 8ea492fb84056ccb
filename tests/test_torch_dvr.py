"""The JAX package's DVR grid models, tables and utilities through the port.

The grid layer (``basis/sin.py``, ``basis/exponential.py``,
``operators/dvr.py``, ``ase_handler.py``), the potential tables and the
format utilities (``util/converters.py``, ``grid2qff.py``,
``hess_util.py``) are copies of the JAX package's; the models built from
them run through the port's ``Simulator`` on the CPU in complex128.  Each
check is a JAX test's own body run against the port
(``torch_ported.ported``), with its literals and tolerances:

* ``tests/test_henon_heiles.py``: both parameter sets' energy literals;
* ``tests/test_fulldimensional.py``: the harmonic ZPE after improved
  relaxation, to 1e-9;
* ``tests/test_cs_sampling.py``: ``operate``'s ‖μ|0⟩‖ = 1.3111895155460684
  (its coherent-state sampling, ``get_CI_coef_state``, is ROADMAP A10);
* ``tests/test_nmr_db.py``: the SQLite grid database written by the
  parallel job runner, read back into the same MPO as the analytic nMR
  terms, and the same dynamics;
* ``tests/test_h2co.py``: H2CO's 6-mode SOP propagation (e10 = e0 to
  1e-9); its TPU-venue advisory is not carried over;
* ``tests/test_potential_tables.py``, ``tests/test_basis_dvr.py`` and the
  converter, normal-mode and QFF cases of ``tests/test_util.py``.
"""

from __future__ import annotations

import importlib

import pytest
import torch

from torch_ported import one_blas_thread, ported

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    with one_blas_thread():
        yield


def _jax_test(module: str, test: str):
    return getattr(importlib.import_module(f"tests.{module}"), test)


@pytest.mark.parametrize("case", [0, 1], ids=["1d", "2d"])
def test_henon_heiles(case, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    fn = _jax_test("test_henon_heiles", "test_henon_heiles")
    args = fn.pytestmark[0].args[1][case]
    ported(fn)(*args, tmp_path)


@pytest.mark.parametrize("module,test", [
    ("test_fulldimensional", "test_harmonic_fulldimensional_relax"),
    ("test_nmr_db", "test_db_nmr_matches_func_path"),
    ("test_h2co", "test_h2co_6mode_propagate"),
])
def test_grid_and_sop_models(module, test, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    helpers = {}
    if module == "test_nmr_db":  # its ``run`` helper runs the Simulator
        helpers["run"] = ported(_jax_test(module, "run"))
    ported(_jax_test(module, test), **helpers)(tmp_path)


def test_cs_sampling_norm(tmp_path, monkeypatch):
    """``operate`` applies the linear dipole MPO of
    ``tests/test_cs_sampling.py`` to the 3-mode HO-DVR ground state:
    ‖μ|0⟩‖ = 1.3111895155460684 to 1e-8."""
    from pytdscf_torch import Simulator
    from pytdscf_torch.basis import HarmonicOscillator
    from pytdscf_torch.model import BasInfo, Model
    from pytdscf_torch.operators.dvr import construct_nMR_recursive
    from pytdscf_torch.operators.hamiltonian import TensorHamiltonian
    from pytdscf_torch.operators.tensor_op import TensorOperator

    monkeypatch.chdir(tmp_path)
    prims = [HarmonicOscillator(5, w, 0.0) for w in (1500, 2000, 2500)]
    funcs = {(0,): lambda q0: 0.1 * q0, (1,): lambda q1: 0.1 * q1,
             (2,): lambda q2: 0.1 * q2}
    dipole = TensorHamiltonian(
        ndof=3, kinetic=None, backend="numpy",
        potential=[[{(0, 1, 2): TensorOperator(
            mpo=construct_nMR_recursive(prims, func=funcs))}]])
    model = Model(BasInfo([prims]), {"hamiltonian": dipole}, bond_dim=4)
    norm, _ = Simulator("cs_sample", model, verbose=0,
                        device="cpu").operate(maxstep=10, restart=False)
    assert norm == pytest.approx(1.3111895155460684, abs=1e-8)


@pytest.mark.parametrize("module,test", [
    ("test_potential_tables", "test_table_inventory"),
    ("test_potential_tables", "test_wat3_literals"),
    ("test_potential_tables", "test_polyene_literals_and_sizes"),
    ("test_potential_tables", "test_feeds_nmr_reader"),
    ("test_basis_dvr", "test_ho_dvr_grids_symmetric"),
    ("test_basis_dvr", "test_ho_kinetic_eigenvalues"),
    ("test_basis_dvr", "test_sine_dvr_particle_in_box"),
    ("test_basis_dvr", "test_exponential_dvr_free_rotor"),
    ("test_basis_dvr", "test_exponential_pos_rep_matrix_quadrature"),
    ("test_util", "test_normal_mode_analysis_diatomic"),
    ("test_util", "test_fit_qff_recovers_polynomial"),
])
def test_host_layer(module, test):
    ported(_jax_test(module, test))()


@pytest.mark.parametrize("test", ["test_mop_roundtrip", "test_op_roundtrip"])
def test_converters(test, tmp_path):
    ported(_jax_test("test_util", test))(tmp_path)
