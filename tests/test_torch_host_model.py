"""The port's host-side model building equals the JAX package's, bit for bit.

``pytdscf_torch`` carries copies of the numpy modules that build its
models (basis, operators, models, lattice, model), because it must import
without JAX; the Liouville copies are held to theirs in
``tests/test_torch_liouville.py``.  These tests hold the copies to the originals, and
check that the port really loads neither JAX nor ``pytdscf_tpu``.
"""

from __future__ import annotations

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
            if not name.endswith((".py", ".cu")):
                continue
            with open(os.path.join(root, name), encoding="utf-8") as fh:
                text = fh.read()
            assert "import jax" not in text, name
            assert "from jax" not in text, name
            assert "pytdscf_tpu" not in text, name
