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

The one-state models' host modules (the model builders ``pyrazine``,
``donor_acceptor`` and ``lh2``; the DVR layer ``basis/sin``,
``basis/exponential``, ``operators/dvr`` and ``ase_handler``; the
potential tables and their shims; ``util/read_nc``, ``converters``,
``grid2qff`` and ``hess_util``) are whole-file copies: each file's lines
are the original's, the package name and the upstream path prefix
normalised (the only change in their import lines), apart from the lines
listed in ``FILE_CHANGES``.  Their outputs are held bit for bit: each
builder's fused MPO cores (the full models through a SHA-256 of each core,
built in two worker processes at once), the DVR operators, bases and grid
database, the tables.
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
from torch_ported import one_blas_thread

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    with one_blas_thread():
        yield

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
        "import pytdscf_torch.basis.primints, pytdscf_torch.util.helper_input\n"
        "import pytdscf_torch.mps.pairs\n"
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
#: the device_io transfers, the TPU venue advisory)
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
    "Simulator._execute",
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


# ------------------------------------------------ the one-state models (A4)
def _text(path: str) -> list[str]:
    """A module's non-blank lines, stripped, with the package name and the
    upstream path prefix normalised."""
    import re

    with open(os.path.join(REPO, path), encoding="utf-8") as fh:
        text = fh.read().replace("pytdscf_tpu", "pytdscf_torch")
    # the originals cite upstream PyTDSCF by a checkout path; the copies
    # as ``PyTDSCF:<path>``
    text = re.sub(r"/\w+/reference/", "PyTDSCF:", text)
    return [ln.strip() for ln in text.splitlines() if ln.strip()]


_SHIMS = [f"potentials/{t}.py" for t in (
    "c2h4_potential", "c4h6_local_potential", "c4h6_local_dipole",
    "c6h8_local_potential", "c6h8_potential", "c6h8_local_dipole",
    "c8h10_local_potential", "c10h12_local_potential",
    "c12h14_local_potential", "c14h16_local_potential", "wat3_potential",
    "wat3_dipole", "wat6_potential", "wat6_dipole")]

#: the whole-file copies, and the lines each port file adds and drops
#: against its original (every other line is the original's, in order)
FILE_CHANGES = {
    **{f: ([], []) for f in (
        "basis/__init__.py", "basis/exciton.py", "basis/sin.py",
        "basis/exponential.py", "models/pyrazine.py",
        "models/donor_acceptor.py", "models/lh2.py", "operators/dvr.py",
        "operators/__init__.py", "ase_handler.py", "potentials/ch2o.py",
        "potentials/_tables.py", "potentials/__init__.py",
        "util/converters.py", "util/grid2qff.py", "util/hess_util.py",
        "util/helper_input.py", *_SHIMS)},
    # the primitive-integral tables come from op_matrix alone: the JAX
    # package's optional native kernels are not copied
    "basis/primints.py": ([
        "Gauss–Hermite cross-basis overlaps; the JAX package's native C++ kernels,",
        "an optional accelerator of the same integrals, are not copied).",
    ], [
        "Gauss–Hermite cross-basis overlaps, optionally the native C++ kernels).",
    ]),
    # h5py imported where a file is read, so that the port imports where
    # h5py is missing (the GPU machine), as util/nc4.py does
    "util/read_nc.py": ([
        "Reads both that and the legacy plain-complex HDF5 layout through h5py,",
        "which is imported when a file is read, not with the module (as in",
        "``util/nc4.py``): the port imports where h5py is missing.",
        "import h5py  # here, not with the module: h5py may be missing",
    ], [
        "Reads both that and the legacy plain-complex HDF5 layout through h5py.",
        "import h5py",
    ]),
}


@pytest.mark.parametrize("path", sorted(FILE_CHANGES))
def test_whole_file_copies(path):
    import difflib

    ref = _text(f"pytdscf_tpu/{path}")
    port = _text(f"pytdscf_torch/{path}")
    diff = list(difflib.ndiff(ref, port))
    added = [ln[2:] for ln in diff if ln.startswith("+ ")]
    dropped = [ln[2:] for ln in diff if ln.startswith("- ")]
    assert (added, dropped) == FILE_CHANGES[path], path


def test_primints_tables_identical(tmp_path):
    """The Ambrosek aggregate's primitive-integral tables
    (``basis/primints.PrimInts``: every state pair, operator and DOF)
    through the port's copies and the JAX package's modules, entry by
    entry, and through the port's pickle cache."""
    import importlib

    from torch_ported import ported

    jt = importlib.import_module("tests.test_relax_operate")
    from pytdscf_torch.basis.primints import PrimInts as TP
    from pytdscf_tpu.basis.primints import PrimInts as JP

    from pytdscf_torch import units

    coupling = -0.04 / units.au_in_eV
    want = JP(jt._build_model(coupling, 5, proj_gs=True))
    got = TP(ported(jt._build_model)(coupling, 5, proj_gs=True))
    assert got.tables.keys() == want.tables.keys()
    assert len(got.tables) == 4 and got.op_keys() == want.op_keys()
    for pair, per_op in want.tables.items():
        for key, mats in per_op.items():
            assert len(got[pair][key]) == len(mats) == 4
            for a, b in zip(got[pair][key], mats):
                assert (a is None) == (b is None), (pair, key)
                if b is not None:
                    assert a.dtype == b.dtype and np.array_equal(a, b)
    path = str(tmp_path / "ints.pkl")
    got.save(path)
    back = TP.load(path)
    assert all(np.array_equal(a, b)
               for pair in got.tables for key in got[pair]
               for a, b in zip(back[pair][key], got[pair][key])
               if b is not None)


def _fused_cores(built):
    basis, ham = built[0], built[1]
    return ham.fused_mpo([b.nprim for b in basis])[0][0]


def _assert_cores_identical(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


@pytest.mark.parametrize("builder,kwargs", [
    ("pyrazine.pyrazine_qvc", {"modes": [0, 1, 2, 5], "nprim": 6}),
    ("pyrazine.pyrazine_qvc", {"nprim": 10}),
    ("donor_acceptor.donor_acceptor", {"n_bath": 3, "nfock": 3}),
    ("donor_acceptor.donor_acceptor_b",
     {"n_frag": 2, "n_f": 1, "n_ot": 1, "nfock": 3}),
    ("lh2.lh2_chain", {"nmol": 2, "modes": (6,), "nfock": 2}),
], ids=["pyrazine4", "pyrazine24", "da_small", "da_b_small", "lh2_nmol2"])
def test_model_builders_identical(builder, kwargs):
    import importlib

    module, name = builder.rsplit(".", 1)
    t_out = getattr(importlib.import_module(
        f"pytdscf_torch.models.{module}"), name)(**kwargs)
    j_out = getattr(importlib.import_module(
        f"pytdscf_tpu.models.{module}"), name)(**kwargs)
    assert [b.nprim for b in t_out[0]] == [b.nprim for b in j_out[0]]
    _assert_cores_identical(_fused_cores(t_out), _fused_cores(j_out))
    if module == "lh2":
        from pytdscf_torch.models.lh2 import lh2_initial_weights as tw
        from pytdscf_tpu.models.lh2 import lh2_initial_weights as jw

        assert t_out[2] == j_out[2]
        for excite in (None, (1,)):
            assert (tw(t_out[0], t_out[2], excite)
                    == jw(j_out[0], j_out[2], excite))


def test_full_models_identical(monkeypatch):
    """The full donor–acceptor models (A: 101 sites; B: 114 sites, nfock
    28, the smoke's model) fused bit for bit, through a SHA-256 of each
    core, the JAX package's and the port's built in worker processes at
    the same time, each on one BLAS thread (their ~54k small SVDs and QRs
    run slower on more)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from torch_ported import fused_digest

    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        monkeypatch.setenv(var, "1")  # read by the spawned workers
    jobs = [("donor_acceptor.donor_acceptor", {"nfock": 28}),
            ("donor_acceptor.donor_acceptor_b", {"nfock": 28})]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=2, mp_context=ctx) as pool:
        futures = [(pool.submit(fused_digest, "torch", b, kw),
                    pool.submit(fused_digest, "tpu", b, kw))
                   for b, kw in jobs]
        for (t_fut, j_fut), (builder, _) in zip(futures, jobs):
            got, want = t_fut.result(timeout=600), j_fut.result(timeout=600)
            assert len(got) in (101, 114)
            assert got == want, builder


def test_model_observables_identical():
    import importlib

    T = importlib.import_module("pytdscf_torch.models.donor_acceptor")
    J = importlib.import_module("pytdscf_tpu.models.donor_acceptor")

    t_basis, _ = T.donor_acceptor_b(n_frag=2, n_f=1, n_ot=1, nfock=3)
    j_basis, _ = J.donor_acceptor_b(n_frag=2, n_f=1, n_ot=1, nfock=3)
    phys = [b.nprim for b in t_basis]
    for fn in ("electron_level_projectors", "mode_number_operators"):
        t_ops = getattr(T, fn)(t_basis)
        j_ops = getattr(J, fn)(j_basis)
        assert list(t_ops) == list(j_ops)
        for name in t_ops:
            _assert_cores_identical(t_ops[name].fused_mpo(phys)[0][0],
                                    j_ops[name].fused_mpo(phys)[0][0])


def test_dvr_bases_identical():
    import pytdscf_torch.basis as T
    import pytdscf_tpu.basis as J

    cases = [("HarmonicOscillator", (7, 1500.0)), ("Sine", (9, 3.0, -2.0)),
             ("Exponential", (7, 2 * np.pi))]
    for name, args in cases:
        t, j = getattr(T, name)(*args), getattr(J, name)(*args)
        for meth in ("get_grids", "get_unitary", "get_sqrt_weights",
                     "get_pos_rep_matrix", "get_1st_derivative_matrix_dvr",
                     "get_2nd_derivative_matrix_dvr",
                     "get_2nd_derivative_matrix_fbr"):
            assert np.array_equal(np.asarray(getattr(t, meth)()),
                                  np.asarray(getattr(j, meth)())), (name, meth)


def test_dvr_operators_identical(tmp_path):
    """``construct_nMR_recursive`` from functions and from a grid
    database (written by the port's ``DVR_Mesh``, read by both packages),
    ``construct_fulldimensional`` and ``construct_kinetic_mpo``, bit for
    bit; the database keys (``to_dbkey``) and its reading alike."""
    import pytdscf_torch.operators.dvr as TD
    import pytdscf_tpu.operators.dvr as JD
    from pytdscf_torch.ase_handler import DVR_Mesh
    from pytdscf_torch.basis import HarmonicOscillator as TH
    from pytdscf_tpu.basis import HarmonicOscillator as JH

    t_prims = [TH(5, 1500.0), TH(5, 3000.0)]
    j_prims = [JH(5, 1500.0), JH(5, 3000.0)]
    funcs = {(0,): lambda q: 1e-5 * q**2 + 1e-6 * q**3,
             (1,): lambda q: 4e-5 * q**2,
             (0, 1): lambda a, b: 1e-6 * (a * b**2 + a**2 * b)}
    pairs = [(TD.construct_nMR_recursive(t_prims, nMR=2, func=funcs),
              JD.construct_nMR_recursive(j_prims, nMR=2, func=funcs)),
             (TD.construct_kinetic_mpo(t_prims),
              JD.construct_kinetic_mpo(j_prims)),
             (TD.construct_fulldimensional(
                 t_prims, func=lambda a, b: 1e-5 * a**2 + 2e-5 * a * b),
              JD.construct_fulldimensional(
                  j_prims, func=lambda a, b: 1e-5 * a**2 + 2e-5 * a * b))]
    db = str(tmp_path / "pes.db")
    mesh = DVR_Mesh(t_prims)
    mesh.save_geoms(db, nMR=2)
    from pytdscf_torch.ase_handler import _write_result

    for _, grids in mesh.mesh_points(nMR=2):  # the job runner's work
        q = [float(mesh.grids[d][i]) for d, i in enumerate(grids)]
        energy = funcs[(0,)](q[0]) + funcs[(1,)](q[1]) + funcs[(0, 1)](*q)
        _write_result(db, TD.to_dbkey(grids), energy, None)
    pairs.append((TD.construct_nMR_recursive(t_prims, nMR=2, db=db),
                  JD.construct_nMR_recursive(j_prims, nMR=2, db=db)))
    for got, want in pairs:
        if isinstance(got, dict):  # {legs: TensorOperator} of the grid
            (got,), (want,) = got.values(), want.values()
            got, want = [got.tensor_orig], [want.tensor_orig]
        _assert_cores_identical([np.asarray(c) for c in got],
                                [np.asarray(c) for c in want])
    t_df, j_df = TD.database_to_dataframe(db), JD.database_to_dataframe(db)
    assert t_df.to_dict() == j_df.to_dict()
    assert TD.to_dbkey((3, 0, 12)) == JD.to_dbkey((3, 0, 12))


def test_ch2o_tables_identical():
    from pytdscf_torch import potentials as tp
    from pytdscf_tpu import potentials as jp

    assert tp.ch2o_k_orig == jp.ch2o_k_orig and tp.ch2o_mu == jp.ch2o_mu
    assert tp.TABLES == jp.TABLES
