"""⟨H⟩ of a complex64 state of the 184-site chain (ROADMAP C3).

A complex64 engine forms ⟨H⟩ (``TDVPEngine.expectation`` and the energy
item of ``properties_submit``, the Simulator's rows) with the right
environment, H_eff at site 0 and the dot product contracted in complex128,
and only the value rounded to complex64.  Contracted in complex64 throughout,
as before, the 183 transfers lose ~1e-5 in the top block.

The state: ``bench.py``'s chain at D=30 from its Hartree product, every
core perturbed by 1e-3 of seeded complex noise, right-canonicalised and
normalised in complex128, then rounded to complex64.  The reference is the
complex128 contraction of those same complex64 cores.  Measured on the
CPU: the complex64 contraction 5.1e-6 from the reference, the repaired
one 4.9e-8 (its float32 log-scale); held at 5e-7, and the complex64
contraction must miss it.
"""

from __future__ import annotations

import numpy as np
import torch

from pytdscf_torch.config import Config
from pytdscf_torch.models.holstein import singlet_fission_chain
from pytdscf_torch.mps import kernels as K
from pytdscf_torch.mps.lattice import alloc_hartree_product
from pytdscf_torch.mps.tdvp import TDVPEngine

torch.set_num_threads(1)

N_LEFT, BOND, NOISE = 61, 30, 1.0e-3
TOL = 5.0e-7


def _complex64_state():
    basis, ham = singlet_fission_chain()
    phys = [b.nprim for b in basis]
    vecs = []
    for i, b in enumerate(basis):
        v = np.zeros(b.nprim, dtype=complex)
        v[1 if i == N_LEFT else 0] = 1.0
        vecs.append(v)
    rng = np.random.default_rng(7)
    cores = [c + NOISE * (rng.normal(size=c.shape) + 1j * rng.normal(size=c.shape))
             for c in alloc_hartree_product(phys, BOND, vecs)]
    wide = TDVPEngine([cores], ham, Config(dtype="complex128"), "cpu")
    wide.right_canonicalize()
    wide.cores[0][0] = wide.cores[0][0] / wide.norm()
    return ham, [c.to(torch.complex64).numpy() for c in wide.cores[0]]


def test_complex64_energy_matches_complex128():
    ham, cores = _complex64_state()
    ref = TDVPEngine([[c.astype(np.complex128) for c in cores]], ham,
                     Config(dtype="complex128"), "cpu").expectation().real
    eng = TDVPEngine([cores], ham, Config(dtype="complex64"), "cpu")
    repaired = eng.expectation().real
    # the deferred item the Simulator's rows read
    items, plan = eng.properties_submit(autocorr=False, norm=False,
                                        populations=False)
    vals = [x.numpy() for x in items]
    row = eng.properties_resolve(vals, plan, norm=False,
                                 populations=False)["energy"].real
    # the complex64 contraction the repair replaced
    block, log = eng._right_block(eng.W)
    triv, _ = eng._trivial()
    psi = eng.cores[0][0]
    sig = K.heff_apply(triv, eng.W[0], block, psi)
    narrow = complex(torch.sum(psi.conj() * sig) * torch.exp(log)).real
    assert abs(repaired - ref) < TOL, (repaired - ref, narrow - ref)
    assert abs(row - ref) < TOL
    assert abs(narrow - ref) > TOL
