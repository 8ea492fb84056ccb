"""Holstein exciton–phonon chain models (benchmark family).

The reference's headline performance anchor is a 184-site singlet-fission
MPS — 61 bosons, one 3-level exciton site, 122 bosons, all Fock dim 8 —
propagated with 1-site TDVP (BASELINE.md; model description in
``PyTDSCF:docs/notebook/singlet_fission_nprocs.md``).  This module
builds a structurally equivalent Frenkel–Holstein Hamiltonian with
formula-generated (deterministic) parameters:

    H = Σ_k E_k |k⟩⟨k|  +  Σ_{k≠l} J |k⟩⟨l|
      + Σ_b ω_b b†b
      + Σ_b g_b q_b ⊗ |s(b)⟩⟨s(b)|

where each phonon mode b couples to one exciton level s(b) (cycling over
levels), so the compressed MPO bond dimension stays at the physical minimum
(#distinct exciton coupling operators + 2).

Why formula-generated parameters: the reference notebook loads its MPO
from ``singlet_fission_mpo.npz`` built in "example 12", which is NOT
distributed with the repository (the visualisation notebook records only
ωc = 0.18 eV, ωmax = 0.40 eV, λ = 0.10 eV of a Debye bath).  This builder
therefore reproduces the exact tensor-network SHAPES of the benchmark —
same site count/ordering, physical dims (Boson(8)/Exciton(3)), bond-dim
cap D=30, dt=0.2 fs, and a fused MPO width (4) at the Holstein physical
minimum, matching what example 12's per-reservoir Holstein coupling
compiles to — so the measured sec/step compares the same contraction
workload as the reference's 3.23 s/step anchor.
"""

from __future__ import annotations

import numpy as np

from pytdscf_torch import units
from pytdscf_torch.basis.boson import Boson, Exciton
from pytdscf_torch.operators.hamiltonian import TensorHamiltonian
from pytdscf_torch.operators.tensor_op import TensorOperator


def singlet_fission_chain(
    n_left: int = 61,
    n_right: int = 122,
    nlevels: int = 8,
    nexciton: int = 3,
    omega_min_cm1: float = 1000.0,
    omega_max_cm1: float = 1600.0,
    coupling_cm1: float = 200.0,
    j_cm1: float = 400.0,
):
    """Build (basis_list, TensorHamiltonian) for the benchmark chain.

    Returns the per-site basis objects and the MPO Hamiltonian over
    ``n_left + 1 + n_right`` sites with the exciton at index ``n_left``.
    """
    nboson = n_left + n_right
    nsite = nboson + 1
    exc_site = n_left

    basis = [Boson(nlevels) for _ in range(n_left)]
    basis.append(Exciton(nexciton))
    basis += [Boson(nlevels) for _ in range(n_right)]

    cm1 = 1.0 / units.au_in_cm1
    omegas = np.linspace(omega_min_cm1, omega_max_cm1, nboson) * cm1
    gs = coupling_cm1 * cm1 * np.sqrt(omegas / omegas.mean())

    # Exciton-site local Hamiltonian: ladder of levels + uniform coupling J.
    e_exc = (np.arange(nexciton) + 1.0) * 2000.0 * cm1
    h_exc = np.diag(e_exc) + j_cm1 * cm1 * (
        np.ones((nexciton, nexciton)) - np.eye(nexciton)
    )

    boson = Boson(nlevels)
    n_mat = boson.get_number_matrix()
    q_mat = boson.get_q_matrix()

    def proj(k: int) -> np.ndarray:
        p = np.zeros((nexciton, nexciton))
        p[k, k] = 1.0
        return p

    potential: dict = {}

    def add(key, mat_by_site):
        """Register a product term given {site: operator matrix}."""
        cores = {}
        for s, mat in mat_by_site.items():
            cores[s] = mat[None, :, :, None]
        legs = tuple(x for s in sorted(mat_by_site) for x in (s, s))
        mpo = [cores[s] for s in sorted(mat_by_site)]
        potential[legs] = TensorOperator(mpo=mpo, legs=legs)

    # local boson energies ω b†b
    ib = 0
    for s in range(nsite):
        if s == exc_site:
            add((s, s), {s: h_exc})
            continue
        add((s, s), {s: omegas[ib] * n_mat})
        ib += 1

    # exciton–phonon couplings g_b q_b ⊗ |k⟩⟨k|
    ib = 0
    for s in range(nsite):
        if s == exc_site:
            continue
        k = ib % nexciton
        lo, hi = (s, exc_site) if s < exc_site else (exc_site, s)
        mats = {s: gs[ib] * q_mat, exc_site: proj(k)}
        add((lo, lo, hi, hi), mats)
        ib += 1

    # NOTE: duplicate leg-keys would overwrite; ensure uniqueness by merging.
    ham = TensorHamiltonian(
        ndof=nsite,
        potential=[[potential]],
        kinetic=None,
        backend="torch",
    )
    return basis, ham
