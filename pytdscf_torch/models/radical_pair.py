"""Radical-pair spin chain: Liouville-space MPDO model builder.

The reference's flagship open-system workflow
(``PyTDSCF:docs/notebook/radicalpair-liouville.ipynb``) builds the
vectorised Liouvillian of two electron spins (one 4-dim electron-pair
site) hyperfine-coupled to nuclear spins (one site per nucleus, physical
dim = multiplicity²) under a magnetic field, with exchange/dipolar
electron-electron terms and Haberkorn singlet/triplet recombination.  The
reference constructs the one-particle operators with the external
RadicalPy library; here the (textbook) spin operators and gyromagnetic
ratios are built in, so the model is self-contained.

Site ordering follows the notebook: nuclei of radical 1, the
electron-pair site, nuclei of radical 2.  Vectorisation is row-major
(vec(AρB) = (A ⊗ Bᵀ)·vec(ρ)), matching the engine's Liouville
convention: bra-side factors enter as ``kron(Oᵀ, 1)`` and ket-side as
``kron(1, O)`` — see :func:`twin_l` / :func:`twin_r`.

``split_electron=True`` puts each electron spin on its OWN 4-dim
vectorised site (exchange, dipolar and the Haberkorn projectors become
two-site products).  This is a deliberate tensor-network layout change
over the reference: a 16-dim site makes every environment transfer carry
a (χ, 16, w, χ) intermediate — at χ=2048 that single buffer is 2 GB and
overflows HBM — while two 4-dim sites keep all transients at d=4.

Units: couplings are given in mT (RadicalPy convention) and multiplied by
the gyromagnetic ratio γ [rad/s/mT] and ``scale`` (default 1e-9), so the
Liouvillian is in rad/ns and a ``dt`` of 1 propagates 1 ns.
"""

from __future__ import annotations

import math

import numpy as np

from pytdscf_torch.basis import Exciton
from pytdscf_torch.operators.symbolic import (
    AssignManager,
    OpSite,
    SumOfProducts,
    get_eye_site,
)

#: gyromagnetic ratios in rad·s⁻¹·mT⁻¹ (electron, ¹H, ¹⁴N) — the values
#: RadicalPy ships (CODATA γ/2π · 2π, mT).
GAMMA_E = -1.76085963023e8
GAMMA_1H = 2.6752218744e5
GAMMA_14N = 1.9337792e4


def spin_matrices(multiplicity: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(Sx, Sy, Sz) for spin s = (multiplicity−1)/2, ħ = 1."""
    s = (multiplicity - 1) / 2
    m = np.arange(s, -s - 1, -1)
    sp = np.zeros((multiplicity, multiplicity))
    for k in range(multiplicity - 1):
        sp[k, k + 1] = math.sqrt(s * (s + 1) - m[k + 1] * (m[k + 1] + 1))
    sx = 0.5 * (sp + sp.T)
    sy = -0.5j * (sp - sp.T)
    sz = np.diag(m.astype(float))
    return sx, sy, sz


def twin_l(op: np.ndarray) -> np.ndarray:
    """Bra-side superoperator factor: O·ρ ↦ ``kron(op, 1)``·vec(ρ)
    (row-major vectorisation)."""
    return np.kron(op, np.eye(op.shape[0], dtype=op.dtype))


def twin_r(op: np.ndarray) -> np.ndarray:
    """Ket-side factor: ρ·op ↦ ``kron(1, opᵀ)``·vec(ρ) (row-major)."""
    return np.kron(np.eye(op.shape[0], dtype=op.dtype), op.T)


def _singlet_projector() -> np.ndarray:
    singlet = np.zeros(4, dtype=complex)
    singlet[1], singlet[2] = 1 / math.sqrt(2), -1 / math.sqrt(2)
    return np.outer(singlet, singlet.conj())


def radical_pair_liouvillian(
    hfcs_1: list[tuple[int, float]] | None = None,
    hfcs_2: list[tuple[int, float]] | None = None,
    B0: float = 0.2,
    J: float = 0.1,
    D0: float = -0.1,
    kS: float = 1.0e06,
    kT: float = 1.0e06,
    scale: float = 1.0e-09,
    split_electron: bool = False,
):
    """Build (basis, mpo, ele_site) for the radical-pair Liouvillian.

    Args:
        hfcs_1 / hfcs_2: per-nucleus ``(multiplicity, A_mT)`` for radicals
            1 and 2 (defaults: one ¹H at 0.4 mT / one ¹⁴N at 0.5 mT — the
            notebook's small case).
        B0: magnetic field along z [mT].
        J / D0: exchange / dipolar couplings [mT] (D0 ≤ 0; the tensor is
            (2/3)·diag(−1,−1,2)·D0 as in the notebook).
        kS / kT: Haberkorn singlet/triplet recombination rates [s⁻¹].
        scale: energy rescale (1e-9 ⇒ rad/ns, the notebook's choice).
        split_electron: one 4-dim site per electron spin instead of the
            notebook's single 16-dim pair site (see module docstring).

    Returns:
        ``(basis, mpo, ele_site)`` — Exciton bases (physical dims d²),
        the numerical MPO core list of the (non-Hermitian) Liouvillian
        H_eff with i dρ/dt = H_eff ρ, and the electron-pair site index
        (the FIRST electron site when ``split_electron``).
    """
    if hfcs_1 is None:
        hfcs_1 = [(2, 0.4)]
    if hfcs_2 is None:
        hfcs_2 = [(3, 0.5)]

    sx, sy, sz = spin_matrices(2)
    E2 = np.eye(2)
    ele_site = len(hfcs_1)
    n_ele_sites = 2 if split_electron else 1
    nsite = len(hfcs_1) + n_ele_sites + len(hfcs_2)
    nuclei: list[tuple[int, int, float, int]] = []  # (site, mult, A, radical)
    for k, (mult, A) in enumerate(hfcs_1):
        nuclei.append((k, mult, A, 0))
    for k, (mult, A) in enumerate(hfcs_2):
        nuclei.append((ele_site + n_ele_sites + k, mult, A, 1))

    def gamma_n(mult: int) -> float:
        return GAMMA_1H if mult == 2 else GAMMA_14N

    def OL(tag: str, site: int, op: np.ndarray) -> OpSite:
        return OpSite(f"L:{tag}", site, value=twin_l(op))

    def OR(tag: str, site: int, op: np.ndarray) -> OpSite:
        return OpSite(f"R:{tag}", site, value=twin_r(op))

    xyz = "xyz"
    sop = SumOfProducts()

    if split_electron:
        # per-spin 2-dim operators, one vectorised 4-dim site per spin
        ele_of = (ele_site, ele_site + 1)
        spin_ops = (sx, sy, sz)

        def ele_L(i_ele: int, r: int) -> OpSite:
            return OL(f"S{xyz[r]}{i_ele}", ele_of[i_ele], spin_ops[r])

        def ele_R(i_ele: int, r: int) -> OpSite:
            return OR(f"S{xyz[r]}{i_ele}", ele_of[i_ele], spin_ops[r])

        # exchange −J|γe|·2·S1·S2 (the E/2 shift cancels in the
        # commutator) and dipolar |γe|·S1ᵀDS2: two-site products
        cJ = -J * abs(GAMMA_E) * scale * 2.0
        Dt = (2.0 / 3.0) * np.diag((-1.0, -1.0, 2.0)) * D0
        for r in range(3):
            c = cJ + abs(GAMMA_E) * scale * Dt[r, r]
            if c != 0.0:
                sop += c * (ele_L(0, r) * ele_L(1, r))
                sop -= c * (ele_R(0, r) * ele_R(1, r))
        # Haberkorn with P_S = E/4 − S1·S2, P_T = 3E/4 + S1·S2:
        # −(i/2)[kS(L+R)(P_S) + kT(L+R)(P_T)]
        #   = −i(kS+3kT)/4 · Id + (kS−kT)(i/2)(Σ_r L_r L_r + R_r R_r)
        c_sw = (kS - kT) * 0.5j * scale
        if c_sw != 0.0:
            for r in range(3):
                sop += c_sw * (ele_L(0, r) * ele_L(1, r))
                sop += c_sw * (ele_R(0, r) * ele_R(1, r))
        c_id = -0.25j * (kS + 3 * kT) * scale
        if c_id != 0.0:
            sop += c_id * OpSite("L:Ee", ele_site, value=np.eye(4))
        # Zeeman (z): each electron spin on its own site
        for i_ele in range(2):
            c = -B0 * GAMMA_E * scale
            sop += c * ele_L(i_ele, 2)
            sop -= c * ele_R(i_ele, 2)
        # hyperfine couples each radical's nuclei to ITS electron site
        for site, mult, A, i_ele in nuclei:
            Imats = spin_matrices(mult)
            c = abs(GAMMA_E) * A * scale
            for r in range(3):
                tagI = f"I{xyz[r]}{site}"
                sop += c * ele_L(i_ele, r) * OL(tagI, site, Imats[r])
                sop -= c * ele_R(i_ele, r) * OR(tagI, site, Imats[r])
    else:
        # notebook layout: both spins on one 16-dim vectorised site
        S1 = [np.kron(m, E2) for m in (sx, sy, sz)]
        S2 = [np.kron(E2, m) for m in (sx, sy, sz)]
        Qs = _singlet_projector()
        Qt = np.eye(4) - Qs

        for i, S in enumerate((S1, S2)):
            c = -B0 * GAMMA_E * scale
            sop += c * OL(f"Sz{i}", ele_site, S[2])
            sop -= c * OR(f"Sz{i}", ele_site, S[2])
        for site, mult, A, i_ele in nuclei:
            Svec = S1 if i_ele == 0 else S2
            Imats = spin_matrices(mult)
            c = abs(GAMMA_E) * A * scale
            for r in range(3):
                tagS, tagI = f"S{xyz[r]}{i_ele}", f"I{xyz[r]}{site}"
                sop += c * OL(tagS, ele_site, Svec[r]) * OL(tagI, site, Imats[r])
                sop -= c * OR(tagS, ele_site, Svec[r]) * OR(tagI, site, Imats[r])
        if J != 0.0:
            S1S2 = sum(a @ b for a, b in zip(S1, S2))
            Hj = -J * abs(GAMMA_E) * scale * (2 * S1S2 + 0.5 * np.eye(4))
            sop += OL("Hj", ele_site, Hj)
            sop -= OR("Hj", ele_site, Hj)
        if D0 != 0.0:
            if D0 > 0:
                raise ValueError("D0 must be ≤ 0 (axial dipolar tensor)")
            Dt = (2.0 / 3.0) * np.diag((-1.0, -1.0, 2.0)) * D0
            Hd = abs(GAMMA_E) * scale * sum(
                Dt[k, k] * S1[k] @ S2[k] for k in range(3)
            )
            sop += OL("Hd", ele_site, Hd)
            sop -= OR("Hd", ele_site, Hd)
        for rate, Q, tag in ((kS, Qs, "Qs"), (kT, Qt, "Qt")):
            if rate != 0.0:
                c = -0.5j * rate * scale
                sop += c * (OL(tag, ele_site, Q) + OR(tag, ele_site, Q))

    # Zeeman for nuclei (z), either layout
    for site, mult, _A, _i in nuclei:
        Iz = spin_matrices(mult)[2]
        c = -B0 * gamma_n(mult) * scale
        sop += c * OL(f"Iz{site}", site, Iz)
        sop -= c * OR(f"Iz{site}", site, Iz)

    # anchor every site so the MPO covers the full chain
    dims = {site: mult**2 for site, mult, _, _ in nuclei}
    if split_electron:
        dims[ele_site] = 4
        dims[ele_site + 1] = 4
    else:
        dims[ele_site] = 16
    eye_prod = get_eye_site(0, dims[0])
    for site in range(1, nsite):
        eye_prod = eye_prod * get_eye_site(site, dims[site])
    sop += 0.0 * eye_prod

    am = AssignManager(sop.simplify())
    am.assign()
    mpo = am.numerical_mpo()

    basis = [Exciton(dims[s]) for s in range(nsite)]
    return basis, mpo, ele_site


def radical_pair_hamiltonian(
    hfcs_1: list[tuple[int, float]] | None = None,
    hfcs_2: list[tuple[int, float]] | None = None,
    B0: float = 0.2,
    J: float = 0.1,
    D0: float = -0.1,
    kS: float = 1.0e06,
    kT: float = 1.0e06,
    scale: float = 1.0e-09,
):
    """Hilbert-space radical-pair H_eff for the SSE / trajectory route.

    The wavefunction-ensemble analog of :func:`radical_pair_liouvillian`
    (reference workflow ``radicalpair-sse.ipynb``): the same Zeeman +
    hyperfine + exchange + dipolar model with the Haberkorn recombination
    as a non-Hermitian CAP, −(i/2)(kS·P_S + kT·P_T), acting on plain
    wavefunctions.  Nuclear mixed states are handled by ensemble
    averaging over initial nuclear states (projection or spin-coherent
    sampling, :func:`spin_coherent_weights`).  Propagate with
    ``integrator="arnoldi"`` and ``conserve_norm=False``.

    Same parameter conventions (and signs) as the Liouvillian builder, so
    the trajectory average is directly comparable to the MPDO dynamics.

    Returns ``(basis, mpo, ele_site)`` with physical dims = multiplicities
    (4 at the electron-pair site).
    """
    if hfcs_1 is None:
        hfcs_1 = [(2, 0.4)]
    if hfcs_2 is None:
        hfcs_2 = [(3, 0.5)]

    sx, sy, sz = spin_matrices(2)
    E2 = np.eye(2)
    ele_site = len(hfcs_1)
    nsite = len(hfcs_1) + 1 + len(hfcs_2)
    nuclei: list[tuple[int, int, float, int]] = []
    for k, (mult, A) in enumerate(hfcs_1):
        nuclei.append((k, mult, A, 0))
    for k, (mult, A) in enumerate(hfcs_2):
        nuclei.append((ele_site + 1 + k, mult, A, 1))

    def gamma_n(mult: int) -> float:
        return GAMMA_1H if mult == 2 else GAMMA_14N

    S1 = [np.kron(m, E2) for m in (sx, sy, sz)]
    S2 = [np.kron(E2, m) for m in (sx, sy, sz)]
    Qs = _singlet_projector()
    Qt = np.eye(4) - Qs
    xyz = "xyz"

    sop = SumOfProducts()
    for i, S in enumerate((S1, S2)):
        sop += (-B0 * GAMMA_E * scale) * OpSite(
            f"Sz{i}", ele_site, value=S[2]
        )
    for site, mult, A, i_ele in nuclei:
        Svec = S1 if i_ele == 0 else S2
        Imats = spin_matrices(mult)
        c = abs(GAMMA_E) * A * scale
        for r in range(3):
            sop += c * OpSite(
                f"S{xyz[r]}{i_ele}", ele_site, value=Svec[r]
            ) * OpSite(f"I{xyz[r]}{site}", site, value=Imats[r])
        sop += (-B0 * gamma_n(mult) * scale) * OpSite(
            f"Iz{site}", site, value=Imats[2]
        )
    S1S2 = sum(a @ b for a, b in zip(S1, S2))
    if J != 0.0:
        sop += OpSite(
            "Hj", ele_site,
            value=-J * abs(GAMMA_E) * scale * (2 * S1S2 + 0.5 * np.eye(4)),
        )
    if D0 != 0.0:
        if D0 > 0:
            raise ValueError("D0 must be ≤ 0 (axial dipolar tensor)")
        Dt = (2.0 / 3.0) * np.diag((-1.0, -1.0, 2.0)) * D0
        sop += OpSite(
            "Hd", ele_site,
            value=abs(GAMMA_E) * scale
            * sum(Dt[k, k] * S1[k] @ S2[k] for k in range(3)),
        )
    if kS != 0.0 or kT != 0.0:
        sop += OpSite(
            "CAP", ele_site, value=-0.5j * scale * (kS * Qs + kT * Qt)
        )

    dims = {site: mult for site, mult, _, _ in nuclei}
    dims[ele_site] = 4
    eye_prod = get_eye_site(0, dims[0])
    for site in range(1, nsite):
        eye_prod = eye_prod * get_eye_site(site, dims[site])
    sop += 0.0 * eye_prod

    am = AssignManager(sop.simplify())
    am.assign()
    mpo = am.numerical_mpo()
    basis = [Exciton(dims[s]) for s in range(nsite)]
    return basis, mpo, ele_site


def spin_coherent_weights(
    multiplicity: int, u_theta: float, u_phi: float
) -> np.ndarray:
    """SU(2) spin-coherent state |Ω(θ, φ)⟩ from uniform samples in [0, 1).

    |Ω⟩ = cos(θ/2)^{2I} · exp(tan(θ/2) e^{iφ} Î₋) |I, I⟩ with
    θ = arccos(2u_θ − 1), φ = 2π u_φ — uniform over the sphere (JCP 154,
    084121 (2021)); averaging |Ω⟩⟨Ω| over samples reproduces the
    maximally mixed nuclear state 1/(2I+1).  The lowering-operator
    exponential is the exact finite (nilpotent) series.
    """
    theta = math.acos(2.0 * u_theta - 1.0)
    phi = 2.0 * math.pi * u_phi
    s = (multiplicity - 1) / 2
    sx, sy, _ = spin_matrices(multiplicity)
    sm = (sx - 1j * sy).astype(complex)  # lowering
    z = math.tan(theta / 2.0) * np.exp(1j * phi)
    term = np.eye(multiplicity, dtype=complex)
    expm_sm = term.copy()
    for k in range(1, multiplicity):
        term = term @ (z * sm) / k
        expm_sm += term
    w = np.zeros(multiplicity, dtype=complex)
    w[0] = 1.0  # |I, I⟩ (m sorted descending in spin_matrices)
    w = math.cos(theta / 2.0) ** (2 * s) * (expm_sm @ w)
    return w


def singlet_product_state(basis, ele_site: int, split_electron: bool = False):
    """Initial MPDO: singlet projector at the electron pair, maximally
    mixed nuclei (vec(1/d)) elsewhere — the notebook's initial ensemble.

    With ``split_electron`` the two-site vec(P_S) is returned as a pair of
    entangled (l, n, r) cores (SVD split; the Hartree-product allocator
    accepts 3-dim cores for exactly this purpose)."""
    Qs = _singlet_projector()
    hp: list = []
    isite = 0
    while isite < len(basis):
        if isite == ele_site:
            if split_electron:
                # vec(P_S) over two 4-dim sites: reorder (a1 a2, b1 b2) →
                # (a1 b1), (a2 b2) and SVD-split
                M = Qs.reshape(2, 2, 2, 2).transpose(0, 2, 1, 3).reshape(4, 4)
                u, s, vh = np.linalg.svd(M)
                r = int(np.sum(s > 1e-12))
                a = (u[:, :r] * s[:r]).reshape(1, 4, r)
                b = vh[:r].reshape(r, 4, 1)
                hp.append(a)
                hp.append(b)
                isite += 2
                continue
            hp.append(Qs.reshape(-1))
        else:
            d = math.isqrt(basis[isite].nstate)
            hp.append(np.eye(d, dtype=complex).reshape(-1))
        isite += 1
    return hp
