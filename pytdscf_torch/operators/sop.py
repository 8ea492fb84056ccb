"""Sum-of-products (polynomial) Hamiltonians.

A copy of the JAX package's ``operators/sop.py`` (pure numpy), with the API
of upstream PyTDSCF's ``pytdscf/hamiltonian_cls.py`` (`TermProductForm`,
`TermOneSiteForm`, `PolynomialHamiltonian` with the HO / LVC / Henon–Heiles
model builders, `read_potential_nMR`): terms stay symbolic until a basis is
bound, then the whole sum compiles ONCE into a fused dense MPO per
electronic-state pair (the same contract as
:class:`~pytdscf_torch.operators.hamiltonian.TensorHamiltonian`), so the
runtime never loops over terms or complementary blocks.
``tests/test_torch_host_model.py`` holds the fused MPOs to the original's
bit for bit.

Cross-state term matrices use the exact FBR integrals of
:mod:`pytdscf_torch.basis.op_matrix`; for state pairs with different primitive
bases the "identity" fill between operator sites is the overlap matrix.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import numpy as np

from pytdscf_torch.basis.op_matrix import op_matrix
from pytdscf_torch.operators import mpo_algebra as alg
from pytdscf_torch.operators.hamiltonian import HamiltonianMixin
from pytdscf_torch import units as _units


class TermProductForm:
    """coef × Π_d op_d — one product term of a SOP operator."""

    def __init__(self, coef: float, op_dofs: Sequence[int], op_keys: Sequence[str]):
        if len(op_dofs) != len(op_keys):
            raise ValueError("op_dofs and op_keys length mismatch")
        self.coef = coef
        self.op_dofs = list(op_dofs)
        self.op_keys = list(op_keys)

    @property
    def mode_ops(self) -> dict[int, str]:
        return dict(zip(self.op_dofs, self.op_keys))

    def set_blockop_key(self, ndof: int, print_out: bool = False) -> None:
        """Kept for API parity; fused-MPO compilation needs no block keys."""

    def __repr__(self) -> str:
        ops = " ".join(
            f"{k}[{d}]" for d, k in zip(self.op_dofs, self.op_keys)
        )
        return f"{self.coef:+.6e} · {ops}"


class TermOneSiteForm(TermProductForm):
    """coef × op acting on a single DOF."""

    def __init__(self, coef: float, op_dof: int, op_key: str):
        super().__init__(coef, [op_dof], [op_key])
        self.op_dof = op_dof
        self.op_key = op_key


def truncate_terms(
    terms: list[TermProductForm], cut_off: float | None = None
) -> list[TermProductForm]:
    """Merge duplicate operator products and drop small coefficients."""
    merged: dict[tuple, TermProductForm] = {}
    for t in terms:
        order = np.argsort(t.op_dofs)
        key = tuple(
            (t.op_dofs[i], t.op_keys[i]) for i in order
        )
        if key in merged:
            merged[key].coef += t.coef
        else:
            merged[key] = TermProductForm(
                t.coef,
                [t.op_dofs[i] for i in order],
                [t.op_keys[i] for i in order],
            )
    out = list(merged.values())
    if cut_off is not None:
        out = [t for t in out if abs(t.coef) >= cut_off]
    return out


def _extract_onesite(
    terms: list[TermProductForm],
) -> tuple[list[TermProductForm], list[TermOneSiteForm]]:
    general, onesite = [], []
    for t in terms:
        if len(t.op_dofs) == 1:
            onesite.append(TermOneSiteForm(t.coef, t.op_dofs[0], t.op_keys[0]))
        else:
            general.append(t)
    return general, onesite


class PolynomialHamiltonian(HamiltonianMixin):
    """SOP operator over electronic-state pairs; compiles to a fused MPO.

    ``general[i][j]`` / ``onesite[i][j]`` hold :class:`TermProductForm`s for
    the |i⟩⟨j| block; ``coupleJ[i][j]`` is a scalar coupling (times the
    inter-basis overlap when bases differ).
    """

    def __init__(
        self,
        ndof: int,
        nstate: int = 1,
        name: str = "hamiltonian",
        matJ: Sequence[Sequence[float]] | None = None,
    ):
        super().__init__(name, nstate, ndof)
        self.general: list[list[list[TermProductForm]]] = [
            [[] for _ in range(nstate)] for _ in range(nstate)
        ]
        self.onesite: list[list[list[TermOneSiteForm]]] = [
            [[] for _ in range(nstate)] for _ in range(nstate)
        ]
        if matJ is not None:
            self.coupleJ = [list(row) for row in matJ]
        self._basinfo = None
        self._fused_cache: dict = {}

    # ------------------------------------------------------------ builders
    def set_HO_potential(self, basinfo, *, enable_onesite: bool = True) -> None:
        """H = Σ_d −d²/2 + (ω_d²/2)(q−q0)² per electronic state."""
        for istate in range(self.nstate):
            terms: list[TermProductForm] = []
            for idof in range(self.ndof):
                pbas = basinfo.get_primbas(istate, idof)
                q0 = pbas.origin_mwc
                w = pbas.freq_au
                terms.append(TermProductForm(-0.5, [idof], ["d^2"]))
                terms.append(TermProductForm(w**2 / 2, [idof], ["q^2"]))
                if q0 != 0.0:
                    terms.append(
                        TermProductForm(-w**2 * q0, [idof], ["q^1"])
                    )
                    self.coupleJ[istate][istate] += w**2 / 2 * q0**2
            terms = truncate_terms(terms)
            general, onesite = _extract_onesite(terms)
            if enable_onesite:
                self.onesite[istate][istate] += onesite
            else:
                self.general[istate][istate] += [
                    TermProductForm(t.coef, t.op_dofs, t.op_keys)
                    for t in onesite
                ]
            self.general[istate][istate] += general
        self._fused_cache.clear()

    def set_LVC(
        self,
        basinfo,
        first_order_coupling: dict[tuple[int, int], dict[int, float]],
    ) -> None:
        """Linear vibronic coupling: HO diabats + κ·Q one-site couplings."""
        self.set_HO_potential(basinfo, enable_onesite=True)
        for (i, j), coupling in first_order_coupling.items():
            for idof, coef in coupling.items():
                self.onesite[i][j].append(TermOneSiteForm(coef, idof, "q^1"))
        self._fused_cache.clear()

    def set_henon_heiles(
        self,
        omega: float,
        lam: float,
        f: int,
        omega_unit: str = "cm-1",
        lam_unit: str = "a.u.",
    ) -> list[list[TermProductForm]]:
        """Mass-weighted Henon–Heiles chain (see tests/test_henon_heiles)."""
        if omega_unit == "cm-1":
            omega = omega / _units.au_in_cm1
        elif omega_unit.lower() not in ("au", "a.u.", "hartree"):
            raise ValueError("omega_unit must be cm-1 or a.u.")
        if lam_unit == "cm-1":
            lam = lam / _units.au_in_cm1
        elif lam_unit.lower() not in ("au", "a.u.", "hartree"):
            raise ValueError("lam_unit must be cm-1 or a.u.")
        terms = []
        for idof in range(f):
            terms.append(TermProductForm(-0.5, [idof], ["d^2"]))
            terms.append(TermProductForm(omega**2 / 2, [idof], ["q^2"]))
        for idof in range(f - 1):
            terms.append(
                TermProductForm(
                    lam * omega**1.5, [idof, idof + 1], ["q^2", "q^1"]
                )
            )
            terms.append(
                TermProductForm(-lam * omega**1.5 / 3, [idof + 1], ["q^3"])
            )
        general, onesite = _extract_onesite(terms)
        self.general[0][0] += general
        self.onesite[0][0] += onesite
        self._fused_cache.clear()
        return [terms]

    def set_henon_heiles_2D_4th(self, lam: float = 0.2) -> list[list[TermProductForm]]:
        """Dimensionless 2-D quartic Henon–Heiles."""
        x, y = 0, 1
        terms = [
            TermProductForm(-0.5, [x], ["d^2"]),
            TermProductForm(-0.5, [y], ["d^2"]),
            TermProductForm(0.5, [x], ["q^2"]),
            TermProductForm(0.5, [y], ["q^2"]),
            TermProductForm(lam, [x, y], ["q^1", "q^2"]),
            TermProductForm(-lam / 3, [x], ["q^3"]),
            TermProductForm(lam**2 / 16, [x], ["q^4"]),
            TermProductForm(lam**2 / 16, [y], ["q^4"]),
            TermProductForm(lam**2 / 8, [x, y], ["q^2", "q^2"]),
        ]
        general, onesite = _extract_onesite(terms)
        self.general[0][0] += general
        self.onesite[0][0] += onesite
        self._fused_cache.clear()
        return [terms]

    # ---------------------------------------------------------- compilation
    def bind_basis(self, basinfo) -> None:
        """Attach the basis set (called by Model); enables MPO compilation."""
        self._basinfo = basinfo
        self._fused_cache.clear()

    def has_block(self, i: int, j: int) -> bool:
        return bool(
            self.general[i][j] or self.onesite[i][j] or self.coupleJ[i][j] != 0.0
        )

    def fused_mpo(
        self, phys_dims: list[int], cutoff: float = 1.0e-13
    ) -> list[list[list[np.ndarray] | None]]:
        """Compile all terms into one dense full-chain MPO per state pair."""
        if self._basinfo is None:
            raise RuntimeError(
                "PolynomialHamiltonian needs bind_basis(basinfo) before use"
            )
        key = (tuple(phys_dims), cutoff)
        if key in self._fused_cache:
            return self._fused_cache[key]
        bas = self._basinfo
        fused: list[list[list[np.ndarray] | None]] = [
            [None for _ in range(self.nstate)] for _ in range(self.nstate)
        ]
        for i in range(self.nstate):
            for j in range(self.nstate):
                if not self.has_block(i, j):
                    continue
                ovlps = [
                    op_matrix(
                        bas.get_primbas(i, d), bas.get_primbas(j, d), "ovlp"
                    )
                    for d in range(self.ndof)
                ]
                term_mpos = []
                for term in self.general[i][j] + self.onesite[i][j]:
                    cores = []
                    mode_ops = term.mode_ops
                    for d in range(self.ndof):
                        if d in mode_ops:
                            mat = op_matrix(
                                bas.get_primbas(i, d),
                                bas.get_primbas(j, d),
                                mode_ops[d],
                            )
                        else:
                            mat = ovlps[d]
                        cores.append(np.asarray(mat, complex)[None, :, :, None])
                    cores[0] = cores[0] * term.coef
                    term_mpos.append(cores)
                if self.coupleJ[i][j] != 0.0:
                    cores = [
                        np.asarray(m, complex)[None, :, :, None] for m in ovlps
                    ]
                    cores[0] = cores[0] * self.coupleJ[i][j]
                    term_mpos.append(cores)
                fused[i][j] = alg.mpo_sum(term_mpos, cutoff)
        self._fused_cache[key] = fused
        return fused

    def apply_backend(self, backend) -> None:
        """API parity no-op (the engine owns device placement)."""


def read_potential_nMR(
    potential_emu: dict[tuple[int, ...], float | complex],
    *,
    active_modes: list[int] | None = None,
    name: str = "hamiltonian",
    cut_off: float | None = None,
    dipole_emu: dict[tuple[int, ...], tuple[float, float, float]] | None = None,
    active_momentum: dict[int, float] | None | bool = None,
    div_factorial: bool = True,
    efield: tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> PolynomialHamiltonian:
    """Polynomial (nMR Taylor) force constants → SOP Hamiltonian.

    ``potential_emu[(1, 1, 2)]`` is ∂³V/∂Q₁²∂Q₂ in a.u. with 1-based DOF
    indices; each term gets 1/Π(orderₖ!) when ``div_factorial``.  With
    ``dipole_emu`` the μ·E operator is built instead (no kinetic terms) —
    the reference's convention for spectra workflows.
    """
    source = dipole_emu if dipole_emu is not None else potential_emu
    if active_modes is None:
        active_modes = sorted(
            {m for key in source.keys() for m in key}
        )
    pos = {mode: k for k, mode in enumerate(active_modes)}
    ndof = len(active_modes)
    scalar = 0.0

    k_map: dict[tuple[int, ...], float] = {}
    for key, val in source.items():
        if dipole_emu is not None:
            val = float(np.dot(np.asarray(val, float), efield))
        if key == ():
            scalar += val
            continue
        if not set(key) <= set(active_modes):
            continue
        powers = [0] * ndof
        for mode in key:
            powers[pos[mode]] += 1
        k_map[tuple(powers)] = val

    ham = PolynomialHamiltonian(ndof, 1, name, [[scalar]])
    terms: list[TermProductForm] = []
    if dipole_emu is None:
        if active_momentum is None:
            for d in range(ndof):
                terms.append(TermProductForm(-0.5, [d], ["d^2"]))
        elif isinstance(active_momentum, dict):
            for mode, coef in active_momentum.items():
                terms.append(TermProductForm(coef, [pos[mode]], ["d^2"]))
    for powers, val in k_map.items():
        dofs, keys, fac = [], [], 1.0
        for d, order in enumerate(powers):
            if order > 0:
                dofs.append(d)
                keys.append(f"q^{order}")
                if div_factorial:
                    fac /= math.factorial(order)
        terms.append(TermProductForm(fac * val, dofs, keys))
    if cut_off is not None:
        terms = truncate_terms(terms, cut_off=cut_off)
    general, onesite = _extract_onesite(terms)
    ham.general[0][0] += general
    ham.onesite[0][0] += onesite
    return ham
