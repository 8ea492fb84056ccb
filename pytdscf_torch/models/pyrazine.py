"""Pyrazine S1/S2 quadratic vibronic-coupling (QVC) model.

The 2-state, 24-mode pyrazine QVC Hamiltonian of Raab, Worth, Meyer &
Cederbaum [J. Chem. Phys. 110, 936 (1999)] — the classic large-MCTDH
benchmark, and the model the reference ships as a workflow notebook
(parity target: ``PyTDSCF:docs/notebook/pyrazine-qvc.ipynb``).
In mass-frequency-weighted coordinates:

    H = Δ σz  +  Σ_k ω_k/2 (p_k² + q_k²)              (H_el + H_vib)
      + Σ_{k∈G1} diag(a_k, b_k) q_k                    (intra-state linear)
      + c σx q_10a                                     (linear coupling, G3)
      + Σ_{(k,l)∈G2} diag(a_kl, b_kl) q_k q_l          (intra-state bilinear)
      + Σ_{(k,l)∈G4} c_kl σx q_k q_l                   (inter-state bilinear)

Parameters below are the published model constants in eV (physical data,
not code).  The builder compiles the Hamiltonian through the in-package
symbolic SOP route (``operators/symbolic.py`` — the ``pympo`` analog the
notebook drives) into one fused MPO.
"""

from __future__ import annotations

import numpy as np

from pytdscf_torch import units
from pytdscf_torch.basis.boson import Boson, Exciton
from pytdscf_torch.operators.hamiltonian import TensorHamiltonian
from pytdscf_torch.operators.symbolic import OpSite, SumOfProducts, AssignManager
from pytdscf_torch.operators.tensor_op import TensorOperator

#: 2Δ = E(S2) − E(S1) vertical gap (eV)
DELTA_EV = 0.4230

#: harmonic frequencies ω_k (eV), mode order: Ag (6a, 1, 9a, 8a, 2),
#: B1g (10a), B2g (4, 5), B3g (6b, 3, 8b, 7b), Au (16a, 17a),
#: B1u (12, 18a, 19a, 13), B2u (18b, 14, 19b, 20b), B3u (16b, 11)
OMEGA_EV = [
    0.0739, 0.1258, 0.1525, 0.1961, 0.3788,
    0.1139,
    0.0937, 0.1219,
    0.0873, 0.1669, 0.1891, 0.3769,
    0.0423, 0.1190,
    0.1266, 0.1408, 0.1840, 0.3734,
    0.1318, 0.1425, 0.1756, 0.3798,
    0.0521, 0.0973,
]

#: mode index of ν10a (the only coupling-active B1g mode)
MODE_10A = 5

#: G1 — intra-state linear couplings diag(a_k, b_k) on the Ag modes (eV)
G1_EV = {
    0: (-0.0981, 0.1355),
    1: (-0.0503, -0.1710),
    2: (0.1452, 0.0375),
    3: (-0.0445, 0.0168),
    4: (0.0247, 0.0162),
}

#: G3 — S1/S2 linear coupling strength c on ν10a (eV)
G3_EV = 0.2080

#: G2 — intra-state bilinear couplings diag(a_kl, b_kl) (eV)
G2_EV = {
    (13, 13): (0.01145, -0.01459),
    (17, 17): (-0.02040, -0.00618),
    (13, 17): (0.00100, -0.00091),
    (5, 5): (-0.01159, -0.01159),
    (6, 6): (-0.02252, -0.03445),
    (11, 11): (-0.01825, -0.00265),
    (6, 11): (-0.00049, 0.00911),
    (7, 7): (-0.00741, -0.00385),
    (8, 8): (0.05183, 0.04842),
    (9, 9): (-0.05733, -0.06332),
    (10, 10): (-0.00333, -0.00040),
    (7, 8): (0.01321, -0.00661),
    (7, 9): (-0.00717, 0.00429),
    (7, 10): (0.00515, -0.00246),
    (8, 9): (-0.03942, -0.03034),
    (8, 10): (0.00170, -0.00185),
    (9, 10): (-0.00204, -0.00388),
    (12, 12): (-0.04819, -0.00840),
    (14, 14): (-0.00792, 0.00429),
    (15, 15): (-0.02429, -0.00734),
    (16, 16): (-0.00492, 0.00346),
    (12, 14): (0.00525, 0.00536),
    (12, 15): (-0.00485, -0.00097),
    (12, 16): (-0.00326, 0.00034),
    (14, 15): (0.00852, 0.00209),
    (14, 16): (0.00888, -0.00049),
    (15, 16): (-0.00443, 0.00346),
    (18, 18): (-0.00277, -0.01179),
    (20, 20): (0.03924, 0.04000),
    (21, 21): (0.00992, 0.01246),
    (22, 22): (-0.00110, 0.00069),
    (18, 20): (0.00016, -0.00844),
    (18, 21): (-0.00250, 0.07000),
    (18, 22): (0.00357, -0.01249),
    (20, 21): (-0.00197, -0.05000),
    (20, 22): (-0.00355, 0.00265),
    (21, 22): (0.00623, -0.00422),
    (19, 19): (-0.02176, -0.02214),
    (23, 23): (0.00315, -0.00496),
    (19, 23): (-0.00624, -0.00261),
}

#: G4 — inter-state (σx) bilinear couplings c_kl (eV)
G4_EV = {
    (5, 0): -0.01000,
    (5, 1): -0.00551,
    (5, 2): 0.00127,
    (5, 3): 0.00799,
    (5, 4): -0.00512,
    (6, 7): -0.01372,
    (6, 8): -0.00466,
    (6, 9): 0.00329,
    (6, 10): -0.00031,
    (11, 7): 0.00598,
    (11, 8): -0.00914,
    (11, 9): 0.00961,
    (11, 10): 0.00500,
    (13, 12): -0.01056,
    (13, 14): 0.00559,
    (13, 15): 0.00401,
    (13, 16): -0.00226,
    (17, 12): -0.01200,
    (17, 14): -0.00213,
    (17, 15): 0.00328,
    (17, 16): -0.00396,
    (19, 18): 0.00118,
    (19, 20): -0.00009,
    (19, 21): -0.00285,
    (19, 22): -0.00095,
    (23, 18): 0.01281,
    (23, 20): -0.01780,
    (23, 21): 0.00134,
    (23, 22): -0.00481,
}


def pyrazine_qvc(
    modes: list[int] | None = None,
    nprim: int = 10,
    cutoff: float = 1.0e-13,
):
    """Build (basis_list, TensorHamiltonian) for the pyrazine QVC model.

    Site 0 is the 2-level electronic site (S1, S2); sites 1..n are the
    vibrational modes in ``modes`` order (default: all 24).  Passing a
    subset keeps every published coupling whose modes BOTH survive — e.g.
    ``modes=[0, 1, 2, 5]`` is the standard 4-mode (6a, 1, 9a, 10a)
    reduction.  ``nprim`` is the harmonic-oscillator Fock dimension per
    mode.
    """
    if modes is None:
        modes = list(range(len(OMEGA_EV)))
    site_of = {m: 1 + i for i, m in enumerate(modes)}
    nsite = 1 + len(modes)

    basis = [Exciton(2)] + [Boson(nprim) for _ in modes]
    ev = 1.0 / units.au_in_eV
    delta = DELTA_EV * ev

    b = Boson(nprim)
    q, pp, qq = b.get_q_matrix(), b.get_p2_matrix(), b.get_q2_matrix()
    q_op = {m: OpSite(f"Q_{m}", site_of[m], value=q) for m in modes}
    hvib = {
        m: OpSite(f"Hvib_{m}", site_of[m], value=0.5 * (pp + qq))
        for m in modes
    }
    sigx = np.array([[0.0, 1.0], [1.0, 0.0]])

    sop = SumOfProducts()
    sop += OpSite("H_el", 0, value=np.diag([-delta, delta]))
    for m in modes:
        sop += (OMEGA_EV[m] * ev) * hvib[m]
        if m in G1_EV:
            sop += OpSite(
                f"G1_{m}", 0, value=np.diag(G1_EV[m]) * ev
            ) * q_op[m]
        elif m == MODE_10A:
            sop += OpSite("G3", 0, value=sigx * (G3_EV * ev)) * q_op[m]
    for (k, l), ab in G2_EV.items():
        if k in site_of and l in site_of:
            sop += (
                OpSite(f"G2_{k}_{l}", 0, value=np.diag(ab) * ev)
                * q_op[k] * q_op[l]
            )
    for (k, l), c in G4_EV.items():
        if k in site_of and l in site_of:
            sop += (
                OpSite(f"G4_{k}_{l}", 0, value=sigx * (c * ev))
                * q_op[k] * q_op[l]
            )

    am = AssignManager(sop)
    am.assign()
    mpo = am.numerical_mpo(cutoff=cutoff)
    legs = tuple((k, k) for k in range(nsite))
    ham = TensorHamiltonian(
        ndof=nsite, potential=[[{legs: TensorOperator(mpo=mpo)}]]
    )
    return basis, ham
