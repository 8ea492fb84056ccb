"""Hamiltonian containers.

``TensorHamiltonian`` keeps the reference's construction API
(``PyTDSCF:pytdscf/hamiltonian_cls.py:618-752``: per-state-pair dicts
of ``TensorOperator`` for potential/kinetic, scalar ``()`` keys into
``coupleJ``) but compiles everything down to ONE fused dense MPO per state
pair (see ``mpo_algebra``).  The runtime engine therefore never sees term
keys, identity sentinels or complementary blocks — just a core list.
"""

from __future__ import annotations

from typing import Literal

import numpy as np

from pytdscf_torch.operators import mpo_algebra as alg
from pytdscf_torch.operators.tensor_op import TensorOperator


class HamiltonianMixin:
    """Common surface: name, nstate, ndof, scalar state-coupling matrix."""

    def __init__(self, name: str, nstate: int, ndof: int):
        self.name = name
        self.nstate = nstate
        self.ndof = ndof
        self.coupleJ = [[0.0 for _ in range(nstate)] for _ in range(nstate)]


def _flatten_key(key) -> tuple[int, ...]:
    flat: tuple[int, ...] = ()
    for k in key:
        flat += k if isinstance(k, tuple) else (k,)
    return flat


class TensorHamiltonian(HamiltonianMixin):
    """MPO-form operator between electronic-state pairs.

    Args:
        ndof: number of DOFs (= sites).
        potential: ``potential[i][j]`` is ``{legs_key: TensorOperator}`` for
            the (i, j) state pair, or a single dict for one state.  A ``()``
            key holds a scalar coupling.
        kinetic: same layout (typically state-independent d² terms).
        decompose_type / rate / bond_dimension: dense-tensor factorisation
            controls forwarded to :meth:`TensorOperator.decompose`.
        backend: kept for API parity ("torch" | "numpy"); fused cores are
            always built on host and shipped to the device by the engine.
    """

    def __init__(
        self,
        ndof: int,
        potential,
        name: str = "hamiltonian",
        kinetic=None,
        decompose_type: Literal["QRD", "SVD"] = "QRD",
        rate: float | None = None,
        bond_dimension: list[int] | int | None = None,
        backend: Literal["torch", "numpy"] = "torch",
    ):
        if isinstance(potential, dict):
            potential = [[potential]]
        if kinetic is not None and isinstance(kinetic, dict):
            kinetic = [[kinetic]]
        nstate = len(potential)
        super().__init__(name, nstate, ndof)
        self.backend = backend
        #: terms[i][j] = list of core-dicts {dof: core array}
        self.terms: list[list[list[dict[int, np.ndarray]]]] = [
            [[] for _ in range(nstate)] for _ in range(nstate)
        ]
        self._fused_cache: dict = {}

        for i in range(nstate):
            for j in range(nstate):
                pot_ij = potential[i][j] if potential[i] is not None else None
                if pot_ij is not None:
                    for key, tensor in pot_ij.items():
                        if key == ():
                            if not isinstance(tensor, (int, float, complex)):
                                raise ValueError(
                                    f"scalar term must be a number, got {type(tensor)}"
                                )
                            self.coupleJ[i][j] = tensor
                            continue
                        if not isinstance(tensor, TensorOperator):
                            raise TypeError(
                                f"potential[{i}][{j}][{key}] must be TensorOperator"
                            )
                        if _flatten_key(key) != tensor.legs:
                            raise ValueError(
                                f"potential key {key} inconsistent with legs {tensor.legs}"
                            )
                        tensor.decompose(
                            bond_dimension=bond_dimension,
                            decompose_type=decompose_type,
                            rate=rate,
                        )
                        self.terms[i][j].append(tensor.to_site_cores())
                if kinetic is not None and kinetic[i][j] is not None:
                    for key, tensor in kinetic[i][j].items():
                        if key == ():
                            self.coupleJ[i][j] += tensor
                            continue
                        tensor.decompose()
                        self.terms[i][j].append(tensor.to_site_cores())

    # ------------------------------------------------------------------
    def has_block(self, i: int, j: int) -> bool:
        return bool(self.terms[i][j]) or self.coupleJ[i][j] != 0.0

    def fused_mpo(
        self, phys_dims: list[int], cutoff: float = 1.0e-13
    ) -> list[list[list[np.ndarray] | None]]:
        """Fuse all terms into one dense full-chain MPO per state pair.

        ``phys_dims`` are the per-site physical dimensions of the MPS the
        operator will act on (the operator itself may cover only a subset of
        sites; identity cores fill the rest).  Results are cached.
        """
        key = (tuple(phys_dims), cutoff)
        if key in self._fused_cache:
            return self._fused_cache[key]
        if len(phys_dims) != self.ndof:
            raise ValueError(
                f"phys_dims has {len(phys_dims)} entries, expected ndof={self.ndof}"
            )
        fused: list[list[list[np.ndarray] | None]] = [
            [None for _ in range(self.nstate)] for _ in range(self.nstate)
        ]
        for i in range(self.nstate):
            for j in range(self.nstate):
                term_mpos = [
                    alg.extend_to_full_chain(site_cores, self.ndof, phys_dims)
                    for site_cores in self.terms[i][j]
                ]
                if self.coupleJ[i][j] != 0.0:
                    term_mpos.append(
                        alg.scalar_mpo(self.coupleJ[i][j], phys_dims)
                    )
                if term_mpos:
                    fused[i][j] = alg.mpo_sum(term_mpos, cutoff)
        self._fused_cache[key] = fused
        return fused

    # ------------------------------------------------------------------
    def project_subspace(self, subspace_inds: dict[int, tuple[int, ...]]):
        """Restrict physical legs at given sites to index subsets (Liouville)."""
        for i in range(self.nstate):
            for j in range(self.nstate):
                for site_cores in self.terms[i][j]:
                    for isite, p_inds in subspace_inds.items():
                        if isite not in site_cores:
                            continue
                        core = site_cores[isite]
                        if core.ndim == 3:
                            site_cores[isite] = core[:, list(p_inds), :]
                        else:
                            ket, bra = np.ix_(list(p_inds), list(p_inds))
                            site_cores[isite] = core[:, ket, bra, :]
        self._fused_cache.clear()
        self._subspace_inds = subspace_inds

    def interaction_picture(self, U: "TensorHamiltonian") -> None:
        """In-place H ← U†·H·U with a site-local (bond-1) unitary MPO
        (reference ``hamiltonian_cls.py:754-797``)."""
        if self.nstate != 1 or U.nstate != 1:
            raise NotImplementedError("interaction picture: one state only")
        u_sites: dict[int, np.ndarray] = {}
        for term in U.terms[0][0]:
            for site, core in term.items():
                if core.ndim == 3:
                    a, n, b = core.shape
                    mat = np.zeros((n, n), complex)
                    np.fill_diagonal(mat, core[0, :, 0])
                elif core.shape[0] == 1 and core.shape[-1] == 1:
                    mat = core[0, :, :, 0]
                else:
                    raise ValueError(
                        "interaction picture needs bond-1 unitary cores"
                    )
                u_sites[site] = np.asarray(mat)
        for term in self.terms[0][0]:
            for site, core in list(term.items()):
                if site not in u_sites:
                    continue
                u = u_sites[site]
                dense = core
                if dense.ndim == 3:
                    a, n, b = dense.shape
                    full = np.zeros((a, n, n, b), complex)
                    idx = np.arange(n)
                    full[:, idx, idx, :] = dense
                    dense = full
                # (U†HU)[N,M] = Σ conj(U[n,N]) H[n,m] U[m,M]
                term[site] = np.einsum(
                    "nN,anmb,mM->aNMb", u.conj(), dense, u, optimize=True
                )
        self._fused_cache.clear()

    def apply_backend(self, backend: Literal["torch", "numpy"]) -> None:
        """API-parity no-op: the engine owns device placement."""
        self.backend = backend
