"""Donor–acceptor exciton-dissociation model (LE/CS linear vibronic coupling).

The charge-separation workflow the reference ships as a notebook
(parity target: ``PyTDSCF:docs/notebook/donor-acceptor.ipynb``;
model A of Dorfner et al., JCTC 20, 8767 (2024)).  Two electronic
states — LE (local excitation) and CS (charge separated) — couple to one
intermolecular mode R and a discretised bath of 99 effective vibrations:

    H = ε |CS⟩⟨CS| + t (|CS⟩⟨LE| + h.c.)
      + g_CS |CS⟩⟨CS| (b_R + b_R†) + g_LE (|CS⟩⟨LE| + h.c.)(b_R + b_R†)
      + ω_R b_R† b_R
      + Σ_μ g_μ |CS⟩⟨CS| (b_μ + b_μ†) + Σ_μ ω_μ b_μ† b_μ

All parameter tables below are the published constants in eV/meV
(physical data, not code).  The Hamiltonian compiles through the
in-package symbolic SOP route into one fused MPO.
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
from pytdscf_torch.operators.tensor_op import TensorOperator

#: CS state energy offset (eV)
EPSILON_EV = -0.079
#: LE/CS diabatic coupling (eV)
T_LECS_EV = 0.130
#: intermolecular-mode frequency (eV)
OMEGA_R_EV = 0.010
#: CS–CS coupling to the intermolecular mode (eV): 0.030/√2
G_CS_EV = 0.030 / np.sqrt(2.0)
#: LE–CS coupling to the intermolecular mode (eV): −0.010/√2
G_LE_EV = -0.010 / np.sqrt(2.0)

#: bath frequencies ω_μ (meV), 99 modes
BATH_OMEGA_MEV = [
    3.643, 7.286, 10.929, 14.573, 18.216, 21.859, 25.502, 29.145,
    32.788, 36.431, 40.075, 43.718, 47.361, 51.004, 54.647, 58.29,
    61.933, 65.577, 69.22, 72.863, 76.506, 80.149, 83.792, 87.435,
    91.079, 94.722, 98.365, 102.008, 105.651, 109.294, 112.937,
    116.581, 120.224, 123.867, 127.51, 131.153, 134.706, 138.439,
    142.083, 145.726, 149.369, 153.012, 156.655, 160.298, 163.941,
    167.585, 171.228, 174.871, 178.514, 182.157, 185.800, 189.443,
    193.087, 196.730, 200.373, 204.016, 207.659, 211.302, 214.945,
    218.589, 222.232, 225.875, 229.518, 233.161, 236.804, 240.447,
    244.091, 247.734, 251.377, 255.020, 258.663, 262.306, 265.949,
    269.593, 273.236, 276.879, 280.522, 284.165, 287.808, 291.451,
    295.095, 298.738, 302.381, 306.024, 309.667, 313.310, 316.953,
    320.597, 324.240, 327.883, 331.526, 335.169, 338.812, 342.455,
    346.099, 349.742, 353.385, 357.028, 360.671,
]

#: CS–CS bath couplings g_μ (meV), same order
BATH_G_MEV = [
    2.511, 2.359, 2.347, 2.586, 3.190, 4.203, 5.224, 5.741, 5.572,
    5.547, 6.578, 8.456, 9.935, 10.056, 9.147, 8.002, 7.379, 8.038,
    10.582, 14.242, 17.279, 18.380, 17.698, 15.808, 13.623, 12.158,
    11.779, 12.196, 13.061, 13.549, 12.606, 10.303, 8.069, 7.192,
    7.630, 8.721, 9.858, 10.601, 10.599, 10.123, 10.344, 12.335,
    15.285, 16.939, 16.095, 14.735, 15.279, 19.071, 26.827, 38.225,
    47.272, 47.873, 43.415, 39.088, 34.622, 28.686, 22.148, 16.585,
    12.443, 9.701, 8.142, 7.254, 6.554, 5.910, 5.362, 4.932, 4.586,
    4.287, 4.020, 3.785, 3.578, 3.395, 3.230, 3.081, 2.945, 2.822,
    2.709, 2.605, 2.509, 2.420, 2.338, 2.262, 2.190, 2.123, 2.061,
    2.003, 1.948, 1.897, 1.848, 1.803, 1.761, 1.721, 1.685, 1.650,
    1.619, 1.593, 1.573, 1.552, 1.530,
]


def donor_acceptor(
    n_bath: int | None = None,
    nfock: int = 28,
    cutoff: float = 1.0e-13,
):
    """Build (basis_list, TensorHamiltonian) for the donor–acceptor chain.

    Site 0 is the 2-level electronic site (LE, CS); site 1 the
    intermolecular mode R; sites 2.. the first ``n_bath`` effective bath
    modes (default: all 99; 0 disables the bath — the notebook's
    ``use_bath=False``).  ``nfock`` is the Fock dimension per mode
    (notebook: 28).
    """
    if n_bath is None:
        n_bath = len(BATH_OMEGA_MEV)
    nsite = 2 + n_bath
    ev = 1.0 / units.au_in_eV

    basis = [Exciton(2, names=["LE", "CS"])] + [
        Boson(nfock) for _ in range(nsite - 1)
    ]

    exc = basis[0]
    a = exc.get_annihilation_matrix()
    adag = exc.get_creation_matrix()
    n_cs = adag @ a  # |CS⟩⟨CS|
    sx = a + adag  # |CS⟩⟨LE| + |LE⟩⟨CS|
    bos = Boson(nfock)
    x = bos.get_annihilation_matrix() + bos.get_creation_matrix()
    num = bos.get_number_matrix()

    def X(s: int) -> OpSite:
        return OpSite(f"x_{s}", s, value=x)

    def N(s: int) -> OpSite:
        return OpSite(f"N_{s}", s, value=num)

    ncs_op = OpSite("n_CS", 0, value=n_cs)
    sx_op = OpSite("sx", 0, value=sx)

    sop = SumOfProducts()
    sop += (EPSILON_EV * ev) * ncs_op
    sop += (T_LECS_EV * ev) * sx_op
    sop += (G_CS_EV * ev) * ncs_op * X(1)
    sop += (G_LE_EV * ev) * sx_op * X(1)
    sop += (OMEGA_R_EV * ev) * N(1)
    for i in range(n_bath):
        s = 2 + i
        sop += (BATH_G_MEV[i] * 1e-3 * ev) * ncs_op * X(s)
        sop += (BATH_OMEGA_MEV[i] * 1e-3 * ev) * N(s)

    am = AssignManager(sop.simplify())
    am.assign()
    mpo = am.numerical_mpo(cutoff=cutoff)
    legs = tuple((s, s) for s in range(nsite))
    ham = TensorHamiltonian(
        ndof=nsite, potential=[[{legs: TensorOperator(mpo=mpo)}]]
    )
    return basis, ham


# ---------------------------------------------------------------------------
# Model B (Dorfner et al. JCTC 20, 8767 (2024); reference notebook
# PyTDSCF:docs/notebook/donor-acceptor_B.ipynb, "example 14"):
# N oligothiophene fragments with LE_n / CS_n states on ONE 2N-level
# electronic site, a shared reaction mode R, N_F fragment (F) bath modes
# coupled to the total CS population, and N_OT intramolecular modes per
# fragment coupled to that fragment's CS and LE populations.
# ---------------------------------------------------------------------------

#: Model B: LE on-site energy ε^LE (eV)
B_EPSILON_LE_EV = 0.100
#: Model B: LE₁–CS₁ interface coupling λ (eV)
B_LAMBDA_EV = -0.200
#: Model B: CS–CS nearest-neighbour transfer t (eV)
B_T_EV = -0.120
#: Model B: LE–LE nearest-neighbour transfer J (eV)
B_J_EV = 0.100
#: Model B: CS₁ coupling to the reaction mode (eV): 0.030/√2
B_G_CS_EV = 0.030 / np.sqrt(2.0)
#: Model B: interface-hop coupling to the reaction mode (eV): −0.010/√2
B_G_LE_EV = -0.010 / np.sqrt(2.0)
#: Model B: reaction-mode frequency ω_R (eV)
B_OMEGA_R_EV = 0.010

#: Model B: CS_n on-site energies ε^CS_n (meV), n = 1..13
B_EPSILON_CS_MEV = [
    0.0, 33.6, 47.4, 56.0, 61.8, 65.7, 68.4, 70.0, 70.9, 71.2, 71.1,
    70.5, 69.5,
]
#: Model B: fragment (F) bath frequencies ω^F_l (meV), l = 1..8
B_OMEGA_F_MEV = [
    200.025, 184.269, 177.853, 141.11, 93.952, 79.933, 55.892, 33.264,
]
#: Model B: fragment-bath couplings g^F_l (meV) to the total CS population
B_G_F_MEV = [
    45.246, 65.701, -40.280, -17.511, 28.026, -13.629, -23.732, 9.86,
]
#: Model B: oligothiophene (OT) mode frequencies ω^OT_l (meV), l = 1..8
B_OMEGA_OT_MEV = [
    401.283, 397.773, 182.714, 178.531, 134.550, 111.848, 42.621, 18.316,
]
#: Model B: OT couplings g^OT_CS,l (meV) to the local CS population
B_G_OT_CS_MEV = [
    7.017, -0.077, -67.849, 57.668, -40.145, 11.68, -10.784, -12.309,
]
#: Model B: OT couplings g^OT_LE,l (meV) to the local LE population
B_G_OT_LE_MEV = [
    4.035, 2.921, -129.712, 46.885, -32.908, 36.591, -20.211, -7.77,
]


def donor_acceptor_b(
    n_frag: int = 13,
    n_f: int = 8,
    n_ot: int = 8,
    nfock: int = 28,
    cutoff: float = 1.0e-13,
):
    """Build (basis_list, TensorHamiltonian) for donor–acceptor model B.

    Site 0 is the 2·``n_frag``-level electronic site in the reference's
    level order ``[CS_N, …, CS_1, LE_1, …, LE_N]`` (CS indices count DOWN
    toward the interface at the middle of the ladder); site 1 the
    reaction mode R; sites 2..1+``n_f`` the fragment (F) bath; then
    ``n_ot`` OT modes per fragment in fragment order.  Reduced
    ``n_frag``/``n_f``/``n_ot`` take the leading entries of the published
    tables (the full notebook model is 13/8/8 → 114 sites).

    Faithfulness note: the reference accumulates the F/OT mode energies
    as ω·b b† (annihilation first — its ``pot_sop`` cells).  Against the
    normal-ordered R-mode term that is ω·(n̂+1) — a constant +Σω offset —
    EXCEPT that the truncated-Fock product zeroes the top level
    (diag(1, …, nfock−1, 0)).  Both quirks are replicated so absolute
    energies match the notebook run.
    """
    if not (1 <= n_frag <= len(B_EPSILON_CS_MEV)):
        raise ValueError(f"n_frag must be in 1..{len(B_EPSILON_CS_MEV)}")
    if n_f > len(B_OMEGA_F_MEV) or n_ot > len(B_OMEGA_OT_MEV):
        raise ValueError("n_f/n_ot exceed the published tables")
    ev = 1.0 / units.au_in_eV
    mev = 1.0e-3 * ev
    nele = 2 * n_frag
    nsite = 2 + n_f + n_frag * n_ot

    basis = [Exciton(nele)] + [Boson(nfock) for _ in range(nsite - 1)]

    def ele(mat: np.ndarray, name: str) -> OpSite:
        return OpSite(name, 0, value=mat)

    def proj(k: int) -> np.ndarray:
        m = np.zeros((nele, nele))
        m[k, k] = 1.0
        return m

    def hop(k: int, j: int) -> np.ndarray:
        m = np.zeros((nele, nele))
        m[k, j] = m[j, k] = 1.0
        return m

    # level order: index N-i = CS_i (i=1..N), index N-1+i = LE_i
    cs = [None] + [ele(proj(n_frag - i), f"CS{i}") for i in range(1, n_frag + 1)]
    le = [None] + [ele(proj(n_frag - 1 + i), f"LE{i}") for i in range(1, n_frag + 1)]
    le_hop = [None] + [
        ele(hop(n_frag - 1 + i, n_frag + i), f"LE{i}LE{i+1}")
        for i in range(1, n_frag)
    ]
    cs_hop = [None] + [
        ele(hop(n_frag - i, n_frag - i - 1), f"CS{i}CS{i+1}")
        for i in range(1, n_frag)
    ]
    lecs = ele(hop(n_frag - 1, n_frag), "LE1CS1")

    bos = Boson(nfock)
    x = bos.get_annihilation_matrix() + bos.get_creation_matrix()
    num = bos.get_number_matrix()
    # the notebook's literal b·b† — in the TRUNCATED Fock space this is
    # diag(1, …, nfock−1, 0): the top level's mode energy is zeroed, not
    # n̂+1.  Replicated verbatim (negligible at nfock=28, but it is what
    # the reference computes).
    num_p1 = (
        bos.get_annihilation_matrix() @ bos.get_creation_matrix()
    )

    def X(s: int) -> OpSite:
        return OpSite(f"x_{s}", s, value=x)

    def ot_site(i: int, j: int) -> int:
        """Chain site of OT mode j (1-based) of fragment i (1-based)."""
        return 1 + n_f + (i - 1) * n_ot + j

    sop = SumOfProducts()
    sop += (B_OMEGA_R_EV * ev) * OpSite("N_R", 1, value=num)
    for L in range(n_f):
        sop += (B_OMEGA_F_MEV[L] * mev) * OpSite(
            f"Np1_F{L}", 2 + L, value=num_p1
        )
    for i in range(1, n_frag + 1):
        for j in range(1, n_ot + 1):
            s = ot_site(i, j)
            sop += (B_OMEGA_OT_MEV[j - 1] * mev) * OpSite(
                f"Np1_{s}", s, value=num_p1
            )
    for i in range(1, n_frag + 1):
        sop += (B_EPSILON_LE_EV * ev) * le[i]
        sop += (B_EPSILON_CS_MEV[i - 1] * mev) * cs[i]
    for i in range(1, n_frag):
        sop += (B_J_EV * ev) * le_hop[i]
        sop += (B_T_EV * ev) * cs_hop[i]
    sop += (B_LAMBDA_EV * ev) * lecs
    for L in range(n_f):
        for i in range(1, n_frag + 1):
            sop += (B_G_F_MEV[L] * mev) * X(2 + L) * cs[i]
    for i in range(1, n_frag + 1):
        for j in range(1, n_ot + 1):
            s = ot_site(i, j)
            sop += (B_G_OT_CS_MEV[j - 1] * mev) * X(s) * cs[i]
            sop += (B_G_OT_LE_MEV[j - 1] * mev) * X(s) * le[i]
    sop += (B_G_CS_EV * ev) * X(1) * cs[1]
    sop += (B_G_LE_EV * ev) * X(1) * lecs

    am = AssignManager(sop.simplify())
    am.assign()
    mpo = am.numerical_mpo(cutoff=cutoff)
    legs = tuple((s, s) for s in range(nsite))
    ham = TensorHamiltonian(
        ndof=nsite, potential=[[{legs: TensorOperator(mpo=mpo)}]]
    )
    return basis, ham


def electron_level_projectors(basis: list) -> dict[str, TensorHamiltonian]:
    """Model B's per-level ⟨N̂_k⟩ observables: one projector MPO per level
    of the electronic site (reference notebook's ``N{i}`` operators)."""
    nele = basis[0].nprim
    ops: dict[str, TensorHamiltonian] = {}
    for k in range(nele):
        core = np.zeros((1, nele, 1))
        core[0, k, 0] = 1.0
        ops[f"N{k}"] = TensorHamiltonian(
            ndof=len(basis),
            potential=[[{(0,): TensorOperator(mpo=[core], legs=(0,))}]],
            kinetic=None,
        )
    return ops


def mode_number_operators(basis: list) -> dict[str, TensorHamiltonian]:
    """The notebook's per-mode ⟨N̂_i⟩ observables (one-site MPOs)."""
    ops: dict[str, TensorHamiltonian] = {}
    for i in range(1, len(basis)):
        core = np.zeros((1, basis[i].nprim, 1))
        core[0, :, 0] = np.arange(basis[i].nprim)
        ops[f"N{i}"] = TensorHamiltonian(
            ndof=len(basis),
            potential=[[{(i,): TensorOperator(mpo=[core], legs=(i,))}]],
            kinetic=None,
        )
    return ops
