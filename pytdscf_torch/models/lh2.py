"""LH2 antenna-complex exciton-delocalization model (B850/B800 rings).

The light-harvesting-2 workflow the reference ships as a notebook
(parity target: ``PyTDSCF:docs/notebook/lh2.ipynb``; parameters
from Cupellini et al., JPC B 120, 11348 (2016) and Shibl et al.,
JPB 50, 184001 (2017)).  ``nmol`` molecules each carry three
chromophores — B850 α, B850 β, and B800 γ — laid out on the MPS chain
as (γ, β, α) blocks of one 2-level exciton site followed by ``len(modes)``
Holstein bath modes:

    H = Σ_c E_c n̂_c                                  (site energies)
      + Σ_c Σ_k ω_k ( n̂_k + √(2 S_k) n̂_c Q_k )       (bath + Holstein)
      + Σ_{c≠c'} V_{cc'} (a†_c a_{c'} + h.c.)        (excitonic hopping)

with the published intra-molecule (V_αβ¹, V_αγ¹, V_βγ¹) and
nearest-neighbour inter-molecule couplings (V_αα¹ᐟ², V_ββ¹, V_γγ¹,
V_αβ²ᐟ³ᐟ⁴, V_αγ²) over the notebook's ring-neighbour pair list.  All
energies are stored in cm⁻¹ (physical data, not code) and converted to
au in the builder.  The notebook's second coupling loop iterates
``nn_pairs`` again (its ``skip_pairs`` list is defined but unused) —
reproduced verbatim so the compiled operator matches.

The Hamiltonian compiles through the in-package symbolic SOP route
(``operators/symbolic.py``, the ``pympo`` analog the notebook drives)
into one fused MPO.
"""

from __future__ import annotations

import numpy as np

from pytdscf_torch import units
from pytdscf_torch.basis.boson import Boson, Exciton
from pytdscf_torch.operators.hamiltonian import TensorHamiltonian
from pytdscf_torch.operators.symbolic import (
    AssignManager,
    OpSite,
    SumOfProducts,
)

#: bath mode frequencies ω_ξ (cm⁻¹): 7 vibrational + 19 phonon modes
OMEGA_CM1 = [
    23.3, 88.2, 203.3, 361.6, 562.6, 748.2, 915.7,
    25.0, 50.0, 75.0, 100.0, 125.0, 150.0, 175.0, 200.0, 225.0,
    250.0, 275.0, 300.0, 325.0, 350.0, 375.0, 400.0, 425.0, 450.0, 475.0,
]

#: Huang–Rhys factors S_ξ (dimensionless), same order
HUANG_RHYS = [
    0.017, 0.020, 0.056, 0.044, 0.021, 0.050, 0.051,
    0.106, 0.081, 0.065, 0.050, 0.037, 0.028, 0.021, 0.016, 0.013,
    0.010, 0.008, 0.007, 0.006, 0.005, 0.004, 0.004, 0.003, 0.003, 0.003,
]

#: chromophore site energies (cm⁻¹, MMPol)
E_ALPHA_CM1 = 13089.0
E_BETA_CM1 = 13051.0
E_GAMMA_CM1 = 13350.0

#: excitonic couplings (cm⁻¹): intra-molecule …1, inter-molecule the rest
V_CM1 = {
    "ab1": 317.0, "ab2": 339.0, "ab3": 20.0, "ab4": 18.0,
    "aa1": -66.0, "aa2": -10.0,
    "bb1": -51.0,
    "ag1": 42.0, "ag2": -16.0,
    "bg1": -10.0,
    "gg1": -32.0,
}

#: ring nearest-neighbour molecule pairs (notebook cell 17); pairs whose
#: molecules exceed ``nmol - 1`` are dropped by the builder
NN_PAIRS = [
    (0, 2), (2, 4), (4, 6), (6, 7),
    (8, 7), (7, 5), (5, 1), (3, 0), (1, 0),
]

#: default bath reduction used by the notebook (omega[6:8])
DEFAULT_MODES = (6, 7)


def lh2_chain(
    nmol: int = 9,
    modes: tuple[int, ...] = DEFAULT_MODES,
    nfock: int = 10,
    cutoff: float = 1.0e-13,
):
    """Build (basis_list, TensorHamiltonian, site_map) for the LH2 chain.

    ``site_map`` holds the exciton site indices per chromophore type
    (``"gamma"``/``"beta"``/``"alpha"``, each a list of ``nmol`` chain
    positions) — the γ sites are the B800 ring the notebook excites and
    tracks.  Each chromophore block is one ``Exciton(2)`` site followed
    by ``len(modes)`` ``Boson(nfock)`` bath sites; chromophore order per
    molecule is (γ, β, α), matching the notebook lattice.
    """
    modes = tuple(modes)
    nmode = len(modes)
    block = nmode + 1
    nsite = block * 3 * nmol
    cm1 = 1.0 / units.au_in_cm1

    basis = []
    for isite in range(nsite):
        basis.append(Exciton(2) if isite % block == 0 else Boson(nfock))
    gamma = list(range(0, nsite, block * 3))
    beta = list(range(block, nsite, block * 3))
    alpha = list(range(block * 2, nsite, block * 3))
    sys_sites = list(range(0, nsite, block))

    exc = Exciton(2)
    a = exc.get_annihilation_matrix()
    adag = exc.get_creation_matrix()
    n_exc = adag @ a  # |1⟩⟨1|
    bos = Boson(nfock)
    q_mat = bos.get_q_matrix()
    num_mat = bos.get_number_matrix()

    def A(s: int) -> OpSite:
        return OpSite(f"a_{s}", s, value=a)

    def Adag(s: int) -> OpSite:
        return OpSite(f"adag_{s}", s, value=adag)

    def hop(v_cm1: float, s_to: int, s_from: int) -> SumOfProducts:
        v = v_cm1 * cm1
        return v * Adag(s_to) * A(s_from) + v * A(s_to) * Adag(s_from)

    sop = SumOfProducts()
    # site energies E_c n̂_c (the notebook writes −E/2 σz with
    # σz = diag(1,−1) − 1 = diag(0,−2), i.e. exactly E·|1⟩⟨1|)
    for asite, bsite, gsite in zip(alpha, beta, gamma):
        sop += (E_ALPHA_CM1 * cm1) * OpSite(f"n_{asite}", asite, value=n_exc)
        sop += (E_BETA_CM1 * cm1) * OpSite(f"n_{bsite}", bsite, value=n_exc)
        sop += (E_GAMMA_CM1 * cm1) * OpSite(f"n_{gsite}", gsite, value=n_exc)
    # bath energies + Holstein couplings on each chromophore's own modes
    for isite in sys_sites:
        for k, jsite in zip(modes, range(isite + 1, isite + 1 + nmode)):
            w = OMEGA_CM1[k] * cm1
            g = w * np.sqrt(2.0 * HUANG_RHYS[k])
            sop += w * OpSite(f"N_{jsite}", jsite, value=num_mat)
            sop += (
                g
                * OpSite(f"n_{isite}", isite, value=n_exc)
                * OpSite(f"Q_{jsite}", jsite, value=q_mat)
            )
    # intra-molecule hops
    for asite, bsite, gsite in zip(alpha, beta, gamma):
        sop += hop(V_CM1["ab1"], bsite, asite)
        sop += hop(V_CM1["ag1"], gsite, asite)
        sop += hop(V_CM1["bg1"], gsite, bsite)
    # inter-molecule ring-neighbour hops (both notebook loops run over
    # NN_PAIRS — see module docstring)
    for p1, p2 in NN_PAIRS:
        if max(p1, p2) > nmol - 1:
            continue
        sop += hop(V_CM1["aa1"], alpha[p1], alpha[p2])
        sop += hop(V_CM1["bb1"], beta[p1], beta[p2])
        sop += hop(V_CM1["gg1"], gamma[p1], gamma[p2])
        sop += hop(V_CM1["ab2"], beta[p1], alpha[p2])
        sop += hop(V_CM1["ag2"], gamma[p1], alpha[p2])
        sop += hop(V_CM1["ab3"], alpha[p1], beta[p2])
    for p1, p2 in NN_PAIRS:
        if max(p1, p2) > nmol - 1:
            continue
        sop += hop(V_CM1["aa2"], alpha[p1], alpha[p2])
        sop += hop(V_CM1["ab4"], beta[p1], alpha[p2])

    am = AssignManager(sop.simplify())
    am.assign()
    mpo = am.numerical_mpo(cutoff=cutoff)
    legs = tuple((s, s) for s in range(nsite))
    from pytdscf_torch.operators.tensor_op import TensorOperator

    ham = TensorHamiltonian(
        ndof=nsite, potential=[[{legs: TensorOperator(mpo=mpo)}]]
    )
    site_map = {"gamma": gamma, "beta": beta, "alpha": alpha}
    return basis, ham, site_map


def lh2_initial_weights(
    basis: list, site_map: dict, excite: tuple[int, ...] | None = None
) -> list:
    """Hartree-product weights: γ excitons of molecules ``excite`` start
    in |1⟩ (notebook default: first and last molecule), everything else
    in the ground/vacuum level."""
    gamma = site_map["gamma"]
    if excite is None:
        excite = (0, len(gamma) - 1)
    hot = {gamma[i] for i in excite}
    weights = []
    for s, b in enumerate(basis):
        v = [0.0] * b.nprim
        v[1 if s in hot else 0] = 1.0
        weights.append(v)
    return weights
