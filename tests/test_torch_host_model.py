"""The port's host-side model building equals the JAX package's, bit for bit.

``pytdscf_torch`` carries copies of the numpy modules that build its
models (basis, operators, models, lattice, model), because it must import
without JAX; the Liouville copies are held to theirs in
``tests/test_torch_liouville.py``.  These tests hold the copies to the originals, and
check that the port really loads neither JAX nor ``pytdscf_tpu``.

The IR-spectrum workflow's host modules (``basis/op_matrix``,
``operators/sop``, ``potentials``, ``spectra``) are held to theirs bit for
bit on their outputs (the H2O and butadiene Hamiltonian and dipole fused
MPOs, the tables, the spectrum of the H2O fixture) and line for line.

The Simulator's host modules (``_logging``, ``diagnostics``, ``util/nc4``,
``properties``, ``simulator``) are held to theirs line for line: each
copied function has the original's lines (package name aside), apart from
the documented cuts (lines dropped) and the lines listed here as added.
Their behaviour is held to the JAX package's in
``tests/test_torch_simulator.py``.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pytdscf_torch.models.holstein import singlet_fission_chain as t_chain
from pytdscf_torch.mps.lattice import alloc_hartree_product as t_alloc
from pytdscf_torch.mps.lattice import bond_dims_for_site as t_bonds
from pytdscf_tpu.models.holstein import singlet_fission_chain as j_chain
from pytdscf_tpu.mps.lattice import alloc_hartree_product as j_alloc
from pytdscf_tpu.mps.lattice import bond_dims_for_site as j_bonds

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hartree_vecs(basis, exc_site):
    vecs = []
    for i, b in enumerate(basis):
        v = np.zeros(b.nprim, dtype=complex)
        v[1 if i == exc_site else 0] = 1.0
        vecs.append(v)
    return vecs


@pytest.mark.parametrize("n_left,n_right", [(2, 3), (4, 1)])
def test_fused_mpo_identical(n_left, n_right):
    tb, th = t_chain(n_left=n_left, n_right=n_right)
    jb, jh = j_chain(n_left=n_left, n_right=n_right)
    phys = [b.nprim for b in tb]
    assert phys == [b.nprim for b in jb]
    tf, jf = th.fused_mpo(phys), jh.fused_mpo(phys)
    assert len(tf[0][0]) == len(jf[0][0]) == n_left + 1 + n_right
    for a, b in zip(tf[0][0], jf[0][0]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.mark.parametrize("bond", [4, 8, 30])
def test_hartree_product_identical(bond):
    basis, _ = t_chain(n_left=2, n_right=3)
    phys = [b.nprim for b in basis]
    vecs = _hartree_vecs(basis, 2)
    t_cores = t_alloc(phys, bond, vecs)
    j_cores = j_alloc(phys, bond, vecs)
    for p, (a, b) in enumerate(zip(t_cores, j_cores)):
        assert a.shape == b.shape
        assert t_bonds(phys, p, bond) == j_bonds(phys, p, bond)
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", [
    "au_in_cm1", "au_in_fs", "au_in_eV", "au_in_dalton", "au_in_angstrom",
    "au_in_debye",
])
def test_units_identical(name):
    from pytdscf_torch import units as tu
    from pytdscf_tpu import units as ju

    assert getattr(tu, name) == getattr(ju, name)


def test_basis_matrices_identical():
    from pytdscf_torch.basis import Boson as TB, Exciton as TE
    from pytdscf_tpu.basis import Boson as JB, Exciton as JE

    for meth in ("get_annihilation_matrix", "get_creation_matrix",
                 "get_number_matrix", "get_q_matrix", "get_p_matrix",
                 "get_q2_matrix", "get_p2_matrix"):
        assert np.array_equal(getattr(TB(8), meth)(), getattr(JB(8), meth)())
    for meth in ("get_annihilation_matrix", "get_creation_matrix"):
        assert np.array_equal(getattr(TE(3), meth)(), getattr(JE(3), meth)())


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import pytdscf_torch, pytdscf_torch.convert, pytdscf_torch.mps.tdvp\n"
        "import pytdscf_torch.mps.integrator, pytdscf_torch.models\n"
        "import pytdscf_torch.model, pytdscf_torch.mps.cuda_matvec\n"
        "import pytdscf_torch.spectra, pytdscf_torch.potentials\n"
        "import pytdscf_torch.operators.sop, pytdscf_torch.basis.op_matrix\n"
        "bad = [m for m in sys.modules if m.startswith('pytdscf_tpu')\n"
        "       or (m.split('.')[0] == 'jax' and sys.modules[m] is not None)]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_name_no_jax():
    pkg = os.path.join(REPO, "pytdscf_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if not name.endswith((".py", ".cu", ".cuh")):
                continue
            with open(os.path.join(root, name), encoding="utf-8") as fh:
                text = fh.read()
            assert "import jax" not in text, name
            assert "from jax" not in text, name
            assert "pytdscf_tpu" not in text, name


# ------------------------------------------------ the Simulator's host modules
def _defs(path: str) -> dict[str, list[str]]:
    """Top-level functions and methods of a module: qualified name →
    stripped, non-blank source lines, with the package name normalised."""
    with open(os.path.join(REPO, path), encoding="utf-8") as fh:
        text = fh.read().replace("pytdscf_tpu", "pytdscf_torch")
    lines = text.splitlines()
    out = {}
    for node in ast.parse(text).body:
        members = [(getattr(node, "name", ""), node)]
        if isinstance(node, ast.ClassDef):
            members = [(f"{node.name}.{m.name}", m) for m in node.body
                       if isinstance(m, ast.FunctionDef)]
        for name, fn in members:
            if isinstance(fn, ast.FunctionDef):
                body = lines[fn.lineno - 1 - len(fn.decorator_list):fn.end_lineno]
                out[name] = [ln.strip() for ln in body if ln.strip()]
    return out


#: (JAX module, port module, {function: lines the port adds}); a function
#: absent from the table is a verbatim copy, and every other line of the
#: port's function must be one of the original's (what it drops is a cut:
#: the adaptive bond file of A9, the device_io transfers, the TPU venue
#: advisory)
COPIES = [
    ("pytdscf_tpu/diagnostics.py", "pytdscf_torch/diagnostics.py", {}),
    ("pytdscf_tpu/basis/op_matrix.py", "pytdscf_torch/basis/op_matrix.py",
     {}),
    ("pytdscf_tpu/operators/sop.py", "pytdscf_torch/operators/sop.py", {}),
    ("pytdscf_tpu/potentials/_tables.py", "pytdscf_torch/potentials/_tables.py",
     {}),
    # a complex64 run writes a(0) to ~1e-6 (spectra.A0_TOL, ROADMAP C5)
    ("pytdscf_tpu/spectra.py", "pytdscf_torch/spectra.py", {
        "load_autocorr": ["if abs(autocorr[0] - 1.0) > A0_TOL:"],
    }),
    ("pytdscf_tpu/_logging.py", "pytdscf_torch/_logging.py", {
        "_process_index": [
            '"""Multi-host process index (the reference\'s MPI rank analogue): the',
            'port runs one process (the multi-device engines are ROADMAP A13)."""',
        ],
        "get_logger": ["for a multi-process runtime.\"\"\""],
    }),
    ("pytdscf_tpu/util/nc4.py", "pytdscf_torch/util/nc4.py", {
        "NC4Writer.__init__": [
            "global h5py",
            "import h5py  # here, not with the module: h5py may be missing",
        ],
    }),
    ("pytdscf_tpu/properties.py", "pytdscf_torch/properties.py", {
        "Properties.__init__": [
            "[engine._put(c) for c in state] for state in initial_cores"],
        "Properties.get_properties": [
            "# one packed device→host read instead of one per property",
        ],
        "Properties._write_rows": [],
        "Properties.close": [],
        "Properties.flush": [
            "vals = fetch_many(items, self.engine.fetch_real_dtype())",
        ],
        "Properties.run_fused_block": [
            '"""Propagate ``nsteps`` as ONE block and write the per-step .dat',
            "rows.",
            "Wraps ``TDVPEngine.propagate_steps_collect``: each step collects",
            "its PRE-step observables on the device (on the card inside the",
            "replayed step graph), then the block is resolved with one packed",
            "fetch — rows are identical to the per-step driver, and the host",
            'reads the device once per block instead of once per step."""',
            "vals = fetch_many(items, self.engine.fetch_real_dtype())",
        ],
    }),
    ("pytdscf_tpu/simulator.py", "pytdscf_torch/simulator.py", {
        "Simulator._step_inline": [
            "properties → export → backup → propagate → update).\"\"\"",
            "engine.propagate(dt_au)",
            'if engine.device.type == "cuda":',
            "torch.cuda.synchronize(engine.device)",
            "props.update(dt_au)",
            "kry, calls, _, _ = engine.krylov_stats(reset=False)",
            'f"[{config.display_time_unit}]  | {diag.report()}"',
            'f"  AVG Krylov = {kry:.2f}"',
        ],
        "Simulator._save": [],
        "Simulator._alloc_initial_cores": [],
    }),
]

#: functions rewritten rather than copied (their behaviour is tested in
#: tests/test_torch_simulator.py): the refusals naming ROADMAP items, the
#: device argument, the per-step loop without the fused block driver
REWRITTEN = {
    "Simulator.__init__", "Simulator.propagate", "Simulator.relax",
    "Simulator.operate", "Simulator._auto_dtype", "Simulator._initial_engine",
    "Simulator._prepare_primints", "Simulator._execute",
}


@pytest.mark.parametrize("jax_path,port_path,added", COPIES,
                         ids=[c[1].split("/")[-1] for c in COPIES])
def test_host_copies_line_for_line(jax_path, port_path, added):
    ref, port = _defs(jax_path), _defs(port_path)
    assert port, port_path
    for name, lines in port.items():
        if name in REWRITTEN or name.startswith("_not_ported"):
            continue
        assert name in ref, f"{port_path}: {name} has no original"
        if name not in added:
            assert lines == ref[name], f"{port_path}: {name} is not a copy"
            continue
        new = [ln for ln in lines if ln not in ref[name]]
        assert sorted(new) == sorted(added[name]), (name, new)


# ------------------------------------------------ the IR-spectrum workflow
def _ir_models(pkg: str, molecule: str):
    """(H, μ·E) SOPs and the primitive bases of a workflow, built by the
    port (``pkg`` "torch") or the JAX package ("tpu")."""
    import importlib
    import math

    units = importlib.import_module(f"pytdscf_{pkg}.units")
    sop = importlib.import_module(f"pytdscf_{pkg}.operators.sop")
    pot = importlib.import_module(f"pytdscf_{pkg}.potentials")
    ho = importlib.import_module(f"pytdscf_{pkg}.basis.ho")
    if molecule == "h2o":
        k_orig, mu, modes, nprim, active = (pot.h2o_k_orig, pot.h2o_mu,
                                            [1, 2, 3], 9, None)
    else:
        k_orig = pot.load("c4h6_local_potential")["k_orig"]
        mu = pot.load("c4h6_local_dipole")["mu"]
        modes = sorted({i for key in k_orig for i in key})
        nprim, active = 6, modes
    prim = [ho.PrimBas_HO(0.0, math.sqrt(k_orig[(m, m)]) * units.au_in_cm1,
                          nprim) for m in modes]
    ham = sop.read_potential_nMR(k_orig)
    dip = sop.read_potential_nMR(None, dipole_emu=mu,
                                 efield=(1e-2, 1e-2, 1e-2),
                                 active_modes=active)
    return ham, dip, prim


@pytest.mark.parametrize("molecule", ["h2o", "c4h6"])
def test_sop_fused_mpos_identical(molecule):
    """The Hamiltonian and dipole SOPs compile to the same fused MPO, bit
    for bit, through the port's copies and the JAX package's modules."""
    from pytdscf_torch.model import BasInfo as TBas
    from pytdscf_tpu.model import BasInfo as JBas

    t_ham, t_dip, t_prim = _ir_models("torch", molecule)
    j_ham, j_dip, j_prim = _ir_models("tpu", molecule)
    phys = [b.nprim for b in t_prim]
    for t_op, j_op in ((t_ham, j_ham), (t_dip, j_dip)):
        t_op.bind_basis(TBas([t_prim]))
        j_op.bind_basis(JBas([j_prim]))
        tf, jf = t_op.fused_mpo(phys)[0][0], j_op.fused_mpo(phys)[0][0]
        assert len(tf) == len(jf) == len(phys)
        for a, b in zip(tf, jf):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


def test_op_matrix_identical():
    from pytdscf_torch.basis.ho import PrimBas_HO as TP
    from pytdscf_torch.basis.op_matrix import op_matrix as t_op
    from pytdscf_tpu.basis.ho import PrimBas_HO as JP
    from pytdscf_tpu.basis.op_matrix import op_matrix as j_op

    for key in ("ovlp", "q^1", "q^3", "d^1", "d^2"):
        for args in ((0.0, 1500.0, 7), (0.3, 1200.0, 6)):
            got = t_op(TP(*args), TP(0.0, 1500.0, 7), key)
            want = j_op(JP(*args), JP(0.0, 1500.0, 7), key)
            assert np.array_equal(got, want), key


def test_potential_tables_identical():
    from pytdscf_torch import potentials as tp
    from pytdscf_tpu import potentials as jp

    assert tp.h2o_k_orig == jp.h2o_k_orig and tp.h2o_mu == jp.h2o_mu
    for table in tp.TABLES:
        assert tp.load(table) == jp.load(table)


def test_spectra_identical(tmp_path):
    from pytdscf_torch import spectra as ts
    from pytdscf_tpu import spectra as js

    path = os.path.join(REPO, "tests", "fixtures", "autocorr.dat")
    t_t, a_t = ts.load_autocorr(path)
    t_j, a_j = js.load_autocorr(path)
    assert np.array_equal(t_t, t_j) and np.array_equal(a_t, a_j)
    for window in ("cos2", "cos", None):
        for power in (False, True):
            got = ts.ifft_autocorr(t_t, a_t, E_shift=0.5, window=window,
                                   power=power)
            want = js.ifft_autocorr(t_j, a_j, E_shift=0.5, window=window,
                                    power=power)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
    freq, inten = ts.ifft_autocorr(t_t, a_t)
    ts.export_spectrum(freq, inten, str(tmp_path / "t.dat"))
    js.export_spectrum(freq, inten, str(tmp_path / "j.dat"))
    assert (tmp_path / "t.dat").read_text() == (tmp_path / "j.dat").read_text()
