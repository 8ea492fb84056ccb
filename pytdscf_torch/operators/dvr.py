"""Grid (DVR) operator construction: nMR PES, kinetic MPOs, full grids.

Functional parity with ``PyTDSCF:pytdscf/dvr_operator_cls.py:630-1417``
(`construct_nMR_recursive`, `construct_fulldimensional`,
`construct_kinetic_operator/mpo`, `PotentialFunction`,
`database_to_dataframe`), rebuilt on this package's MPO algebra:

* nMR component tensors are evaluated on DVR grids (from analytic functions,
  an ab-initio SQLite database, or a pandas DataFrame), inclusion–exclusion
  separated where the source stores raw totals, merged by leg-subspace, and
  compiled into ONE diagonal-core MPO by tree summation + SVD sweep
  compression (``mpo_algebra.mpo_sum``/``mpo_compress``) — replacing the
  reference's per-term ``merge_mpos``/``sweep_compress`` pipeline.
* The database reader is self-contained SQLite (the ASE package is not
  required; the on-disk format of an ASE SQLite database is stable).
"""

from __future__ import annotations

import itertools
import json
import math as _math
import sqlite3
from typing import Callable

import numpy as np

from pytdscf_torch.basis.abc import DVRPrimitivesMixin
from pytdscf_torch.operators import mpo_algebra as alg
from pytdscf_torch.operators.tensor_op import TensorOperator

# CODATA-2018 Hartree in eV (ASE stores energies in eV).
HARTREE_IN_EV = 27.211386245988
DEBYE_IN_EA = 0.2081943  # 1 Debye in e*Angstrom (ASE dipole unit)


# ------------------------------------------------------------- db helpers
def to_dbkey(indices: tuple[int, ...]) -> str:
    """Grid/DOF index tuple → database key string (``'p1_3.p4_0'`` style is
    NOT used; keys are comma-joined ints to stay orderable and compact)."""
    return "_".join(str(i) for i in indices)


def from_dbkey(key: str) -> tuple[int, ...]:
    if key == "":
        return ()
    return tuple(int(x) for x in str(key).split("_"))


def database_to_dataframe(db: str):
    """Read a grid-PES SQLite database into a pandas DataFrame.

    Rows carry ``grids`` (full grid-index tuple), ``dofs`` (displaced DOFs),
    ``energy`` [Hartree] and optionally ``dipole`` [Debye vector].
    Understands both this package's schema (``pytdscf_torch.ase_handler``) and
    ASE SQLite databases with ``grids``/``dofs`` key-value pairs.
    """
    import pandas as pd

    con = sqlite3.connect(db)
    try:
        tables = {
            r[0]
            for r in con.execute(
                "SELECT name FROM sqlite_master WHERE type='table'"
            )
        }
        rows = []
        if "grid_pes" in tables:  # native schema
            for grids, dofs, energy, dipole in con.execute(
                "SELECT grids, dofs, energy, dipole FROM grid_pes"
            ):
                rows.append(
                    {
                        "grids": from_dbkey(grids),
                        "dofs": from_dbkey(dofs),
                        "energy": energy,
                        "dipole": (
                            np.asarray(json.loads(dipole))
                            if dipole is not None
                            else None
                        ),
                    }
                )
        elif "systems" in tables:  # ASE schema
            for kvp, energy, dipole in con.execute(
                "SELECT key_value_pairs, energy, dipole FROM systems"
            ):
                kv = json.loads(kvp) if kvp else {}
                if "grids" not in kv:
                    continue
                dip = None
                if dipole is not None:
                    dip = np.frombuffer(dipole, dtype=np.float64) / DEBYE_IN_EA
                rows.append(
                    {
                        "grids": from_dbkey(kv["grids"]),
                        "dofs": from_dbkey(kv.get("dofs", "")),
                        "energy": (
                            energy / HARTREE_IN_EV if energy is not None else None
                        ),
                        "dipole": dip,
                    }
                )
        else:
            raise ValueError(f"unrecognised database schema in {db}")
    finally:
        con.close()
    df = pd.DataFrame(rows)
    df["distance"] = [len(d) for d in df["dofs"]]
    return df


# -------------------------------------------------------- potential wrapper
class PotentialFunction:
    """Callable V(Q_1..Q_f) built from a polynomial force-constant table.

    ``k_orig[(i, j, ...)]`` are derivatives ∂ⁿV/∂Q_i∂Q_j… at the reference
    geometry (the reference's mop convention,
    ``PyTDSCF:pytdscf/dvr_operator_cls.py:630-689``); the call
    evaluates the Taylor expansion  Σ k/(n₁!n₂!…) · ΠQᵢ  at mass-weighted
    displacements.
    """

    def __init__(
        self,
        k_orig: dict[tuple[int, ...], float],
        dofs: tuple[int, ...] | None = None,
        cut_off: float | None = None,
    ):
        self.terms: list[tuple[float, dict[int, int]]] = []
        for key, k in k_orig.items():
            if cut_off is not None and abs(k) < cut_off:
                continue
            powers: dict[int, int] = {}
            for idx in key:
                powers[idx] = powers.get(idx, 0) + 1
            if dofs is not None and any(d not in dofs for d in powers):
                continue
            fact = 1.0
            for p in powers.values():
                fact *= float(_math.factorial(p))
            self.terms.append((k / fact, powers))
        self.dofs = dofs

    def __call__(self, *qs: float) -> float:
        if self.dofs is None:
            coords = {i + 1: q for i, q in enumerate(qs)}
        else:
            coords = {d: q for d, q in zip(self.dofs, qs, strict=True)}
        val = 0.0
        for coef, powers in self.terms:
            term = coef
            for d, p in powers.items():
                term *= coords.get(d, 0.0) ** p
            val += term
        return val


# ------------------------------------------------------------ nMR builders
def _eval_func_components(
    dvr_prims, func, active_dofs, nMR
) -> tuple[float, dict[tuple[int, ...], TensorOperator]]:
    """Evaluate user-supplied nMR component functions on DVR grids."""
    const = float(func[()]()) if () in func else 0.0
    ops: dict[tuple[int, ...], TensorOperator] = {}
    for order in range(1, nMR + 1):
        for pair in itertools.combinations(active_dofs, order):
            if pair not in func:
                continue
            grids = [np.asarray(dvr_prims[p].get_grids()) for p in pair]
            shape = tuple(len(g) for g in grids)
            tensor = np.zeros(shape)
            for idx in itertools.product(*(range(s) for s in shape)):
                tensor[idx] = func[pair](*(g[i] for g, i in zip(grids, idx)))
            ops[pair] = TensorOperator(
                tensor=tensor, only_diag=True, legs=pair
            )
    return const, ops


def _eval_df_components(
    dvr_prims, df, active_dofs, nMR, ref_ene, dipole, efield
) -> tuple[float, dict[tuple[int, ...], TensorOperator]]:
    """Collect raw nMR totals from a DataFrame of grid energies/dipoles."""

    def value(row) -> float:
        if dipole:
            return float(np.inner(np.asarray(row["dipole"]), efield))
        return float(row["energy"])

    ref_rows = df[df["distance"] == 0]
    if len(ref_rows) == 0:
        raise ValueError("database has no reference (all-zero displacement) row")
    v0 = value(ref_rows.iloc[0])
    if ref_ene is None:
        ref_ene = v0
    const = v0 - ref_ene
    ops: dict[tuple[int, ...], TensorOperator] = {}
    for order in range(1, nMR + 1):
        for pair in itertools.combinations(active_dofs, order):
            # Raw totals V(q_pair, 0) - ref: grid points where some of the
            # pair's coordinates sit at zero are stored in LOWER-order rows
            # (the mesh deduplicates them), so fill from every subset row.
            sub = df[df["dofs"].apply(lambda d: set(d) <= set(pair))]
            if not (df["dofs"].apply(lambda d: tuple(d) == pair)).any():
                continue
            shape = tuple(dvr_prims[p].ngrid for p in pair)
            tensor = np.zeros(shape)
            for _, row in sub.iterrows():
                full = row["grids"]
                idx = tuple(full[p] for p in pair)
                tensor[idx] = value(row) - ref_ene
            ops[pair] = TensorOperator(tensor=tensor, only_diag=True, legs=pair)
    return const, _separate_inclusion_exclusion(const, ops)


def _separate_inclusion_exclusion(
    const: float, ops: dict[tuple[int, ...], TensorOperator]
) -> dict[tuple[int, ...], TensorOperator]:
    """Raw cut totals → proper nMR components.

    A tensor stored for legs L contains V(q_L, 0) − V(0); subtracting every
    proper-subset component (inclusion–exclusion over the subset lattice)
    leaves the genuine |L|-mode coupling term.
    """
    out: dict[tuple[int, ...], TensorOperator] = {}
    for legs in sorted(ops, key=len):
        tensor = np.array(ops[legs].tensor_orig, dtype=float)
        for r in range(1, len(legs)):
            for sub in itertools.combinations(legs, r):
                if sub not in out:
                    continue
                sub_t = out[sub].tensor_orig
                ax = tuple(legs.index(d) for d in sub)
                expand = [None] * len(legs)
                for k, a in enumerate(ax):
                    expand[a] = k
                # broadcast the subset tensor over the remaining axes
                view = sub_t
                for a in range(len(legs)):
                    if expand[a] is None:
                        view = np.expand_dims(view, a)
                tensor -= view
        out[legs] = TensorOperator(tensor=tensor, only_diag=True, legs=legs)
    return out


def _merge_subspace(
    ops: dict[tuple[int, ...], TensorOperator],
) -> dict[tuple[int, ...], TensorOperator]:
    """Fold any component whose legs are a subset of another into the
    superset tensor (fewer MPO keys → fewer summands), mirroring the
    reference's subspace merge (``dvr_operator_cls.py:1252-1304``)."""
    keys = sorted(ops, key=len, reverse=True)
    merged: dict[tuple[int, ...], TensorOperator] = {}
    absorbed: set[tuple[int, ...]] = set()
    for legs in keys:
        if legs in absorbed:
            continue
        tensor = np.array(ops[legs].tensor_orig, dtype=float)
        for sub_legs in keys:
            if sub_legs == legs or sub_legs in absorbed:
                continue
            if set(sub_legs) <= set(legs):
                sub_t = ops[sub_legs].tensor_orig
                view = sub_t
                for a, d in enumerate(legs):
                    if d not in sub_legs:
                        view = np.expand_dims(view, a)
                tensor = tensor + view
                absorbed.add(sub_legs)
        merged[legs] = TensorOperator(tensor=tensor, only_diag=True, legs=legs)
    return merged


def nmr_to_mpo(
    ops: dict[tuple[int, ...], TensorOperator],
    ngrids: list[int],
    scalar_term: float = 0.0,
    rate: float = 1.0,
    k: int = 200,
    nsweep: int = 1,
) -> list[np.ndarray]:
    """Sum diagonal nMR component MPOs into ONE compressed diagonal MPO."""
    nsite = len(ngrids)
    term_mpos = []
    for legs, op in ops.items():
        cores = op.decompose()
        site_cores = op.to_site_cores()
        term_mpos.append(
            alg.extend_to_full_chain_diag(site_cores, nsite, ngrids)
        )
    if scalar_term != 0.0:
        const_cores = [alg.identity_core_diag(n, 1) for n in ngrids]
        const_cores[0] = const_cores[0] * scalar_term
        term_mpos.append(const_cores)
    if not term_mpos:
        raise ValueError("no nMR components to build an MPO from")
    summed = alg.mpo_sum(term_mpos, cutoff=1.0e-13)
    return alg.mpo_balance(
        alg.mpo_compress(
            summed, cutoff=1.0e-13, max_bond=k, rate=rate, nsweep=nsweep
        )
    )


def construct_nMR_recursive(
    dvr_prims: list[DVRPrimitivesMixin],
    nMR: int = 3,
    ndof: int | None = None,
    func: dict[tuple[int, ...], Callable] | None = None,
    db: str | None = None,
    df=None,
    active_dofs: list[int] | None = None,
    zero_indices: list[int] | None = None,
    return_tensor: bool = False,
    include_const_in_mpo: bool = False,
    ref_ene: float | None = None,
    dipole: bool = False,
    efield: tuple[float, float, float] = (1.0, 1.0, 1.0),
    rate: float = 1.0,
    k: int = 200,
    nsweep: int = 1,
):
    """n-mode-representation PES → one diagonal-core MPO.

    Exactly one of ``func`` / ``db`` / ``df`` supplies the data:

    * ``func[{dofs}]`` — analytic nMR *components* (used as-is),
    * ``db`` — SQLite database of raw grid energies (inclusion–exclusion
      separation applied),
    * ``df`` — pandas DataFrame with columns grids/dofs/energy[/dipole].

    Returns a core list (or the merged component dict if ``return_tensor``).
    """
    if ndof is None:
        ndof = len(dvr_prims)
    if active_dofs is None:
        active_dofs = list(range(len(dvr_prims)))
    ngrids = [p.ngrid for p in dvr_prims]

    if func is not None and db is None and df is None:
        const, ops = _eval_func_components(dvr_prims, func, active_dofs, nMR)
    elif func is None and (db is not None or df is not None):
        if df is None:
            df = database_to_dataframe(db)
        const, ops = _eval_df_components(
            dvr_prims, df, active_dofs, nMR, ref_ene, dipole,
            np.asarray(efield),
        )
    else:
        raise ValueError("give exactly one of func=, db= or df=")

    merged = _merge_subspace(ops)
    if return_tensor:
        return merged
    scalar = const if include_const_in_mpo else 0.0
    return nmr_to_mpo(
        merged, ngrids, scalar_term=scalar, rate=rate, k=k, nsweep=nsweep
    )


def construct_fulldimensional(
    dvr_prims: list[DVRPrimitivesMixin],
    func: Callable | None = None,
    db: str | None = None,
    df=None,
    dipole: bool = False,
    efield: tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> dict[tuple[int, ...], TensorOperator]:
    """Full-dimensional grid PES as a single dense diagonal TensorOperator."""
    ngrids = [p.ngrid for p in dvr_prims]
    legs = tuple(range(len(dvr_prims)))
    tensor = np.zeros(tuple(ngrids))
    if func is not None:
        grids = [np.asarray(p.get_grids()) for p in dvr_prims]
        for idx in itertools.product(*(range(n) for n in ngrids)):
            tensor[idx] = func(*(g[i] for g, i in zip(grids, idx)))
    else:
        if df is None:
            if db is None:
                raise ValueError("give one of func=, db= or df=")
            df = database_to_dataframe(db)
        for _, row in df.iterrows():
            idx = tuple(row["grids"])
            if dipole:
                tensor[idx] = float(
                    np.inner(np.asarray(row["dipole"]), np.asarray(efield))
                )
            else:
                tensor[idx] = float(row["energy"])
    return {legs: TensorOperator(tensor=tensor, only_diag=True, legs=legs)}


# --------------------------------------------------------------- kinetic
def construct_kinetic_mpo(
    dvr_prims: list[DVRPrimitivesMixin], coefs: list[float] | None = None
) -> list[np.ndarray]:
    """Σᵢ −(cᵢ/2) d²/dQᵢ² as a bond-2 MPO (finite-state-automaton form).

    The automaton has two channels — "operator already placed" and "identity
    so far" — giving the minimal bond dimension 2 for a sum of one-site
    terms (reference form: ``dvr_operator_cls.py:1199-1252``).
    """
    ndof = len(dvr_prims)
    if coefs is None:
        coefs = [1.0] * ndof
    cores: list[np.ndarray] = []
    for i, (prim, coef) in enumerate(zip(dvr_prims, coefs, strict=True)):
        n = prim.ngrid
        t_op = -0.5 * coef * prim.get_2nd_derivative_matrix_dvr()
        left = 1 if i == 0 else 2
        right = 1 if i == ndof - 1 else 2
        core = np.zeros((left, n, n, right), dtype=np.complex128)
        if ndof == 1:
            core[0, :, :, 0] = t_op
        elif i == 0:
            core[0, :, :, 0] = t_op
            core[0, :, :, 1] = np.eye(n)
        elif i == ndof - 1:
            core[0, :, :, 0] = np.eye(n)
            core[1, :, :, 0] = t_op
        else:
            core[0, :, :, 0] = np.eye(n)
            core[1, :, :, 0] = t_op
            core[1, :, :, 1] = np.eye(n)
        cores.append(core)
    return cores


def construct_kinetic_operator(
    dvr_prims: list[DVRPrimitivesMixin],
    coefs: list[float] | None = None,
    forms: str = "mpo",
) -> dict[tuple, TensorOperator]:
    """Kinetic operator as {legs: TensorOperator}; 'mpo' or 'sop' forms."""
    ndof = len(dvr_prims)
    if coefs is None:
        coefs = [1.0] * ndof
    if forms.lower() == "mpo":
        key = tuple((i, i) for i in range(ndof))
        flat = tuple(x for i in range(ndof) for x in (i, i))
        return {
            key: TensorOperator(
                mpo=construct_kinetic_mpo(dvr_prims, coefs), legs=flat
            )
        }
    if forms.lower() == "sop":
        out = {}
        for i, (prim, coef) in enumerate(zip(dvr_prims, coefs, strict=True)):
            out[((i, i),)] = TensorOperator(
                tensor=-0.5 * coef * prim.get_2nd_derivative_matrix_dvr(),
                only_diag=False,
                legs=(i, i),
            )
        return out
    raise ValueError("forms must be 'mpo' or 'sop'")
