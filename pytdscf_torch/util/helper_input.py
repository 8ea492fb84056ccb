"""Model-input helpers for molecular-aggregate (exciton) models.

Parity target: ``PyTDSCF:pytdscf/util/helper_input.py`` —
``matJ_1D_exciton`` (:17), ``matJ_2D_exciton`` (:130),
``matJ_LH2_exciton`` (:171).  Each builds per-state primitive bases and
the electronic coupling matrix for an aggregate whose electronic states
are localised excitations.  Deviations from the reference (all
improvements over code paths that raise or NameError there):

* charge-transfer (CT) states are actually SUPPORTED here
  (``with_CT=True`` + ``s_hole``/``s_elec`` bases); the reference's CT
  branch raises ``NotImplmentedError`` [sic] while its matJ already
  carries the CT couplings (``deltaE``/``coupleE``/``coupleH``),
* ``ndof_per_site`` is a real parameter of the 2D/LH2 builders (the
  reference's 2D/LH2 helpers reference an undefined global and would
  ``NameError``).  The 1-D builder drops it: its third return slot
  carries ``statelist`` — which the CT feature needs — instead of the
  reference's ``ndof_per_sites`` (trivially ``[1] * ndof`` there),
* no stray ``print`` side effects.
"""

from __future__ import annotations

import math
from itertools import chain, permutations, product

import numpy as np


def _ndof_per_sites(ndof: int, ndof_per_site: int) -> list[int]:
    out = [ndof_per_site] * (ndof // ndof_per_site)
    if ndof % ndof_per_site:
        out.append(ndof % ndof_per_site)
    return out


def matJ_1D_exciton(
    nmol: int,
    nspf: int,
    s0: list,
    s1: list,
    coupleJ: float,
    *,
    deltaE: float = 0.0,
    coupleE: float = 0.0,
    coupleH: float = 0.0,
    with_CT: bool = False,
    s_hole: list | None = None,
    s_elec: list | None = None,
):
    """1-D aggregate: Frenkel-exciton states, optionally CT states.

    State ``(h, e)`` has the hole on molecule ``h`` and the electron on
    molecule ``e``; ``h == e`` is the Frenkel exciton (modes of that
    molecule use the excited-state basis ``s1``), ``h != e`` a CT state
    (hole molecule uses ``s_hole``, electron molecule ``s_elec``).
    Couplings: ⟨FE_i|H|FE_i±1⟩ = ``coupleJ``; ⟨CT|H|CT⟩ diagonal =
    ``deltaE``; hole resp. electron hops of one site couple with
    ``coupleH`` resp. ``coupleE`` (reference matJ block,
    ``helper_input.py:71-113``).

    Returns ``(prim_info, spf_info, statelist, matJ)``.
    """
    statelist = [(imol, imol) for imol in range(nmol)]
    if with_CT:
        if s_hole is None or s_elec is None:
            raise ValueError(
                "with_CT=True needs s_hole and s_elec primitive bases"
            )
        statelist += list(permutations(range(nmol), 2))

    prim_info = []
    for h, e in statelist:
        if h == e:
            per_mol = [s1 if x == h else s0 for x in range(nmol)]
        else:
            per_mol = [
                s_hole if x == h else s_elec if x == e else s0
                for x in range(nmol)
            ]
        prim_info.append(list(chain.from_iterable(per_mol)))

    matJ = []
    for h_i, e_i in statelist:
        row = []
        for h_j, e_j in statelist:
            fe_i, fe_j = h_i == e_i, h_j == e_j
            if fe_i and fe_j:
                row.append(coupleJ if abs(h_i - h_j) == 1 else 0.0)
            else:
                dh, de = abs(h_i - h_j), abs(e_i - e_j)
                if dh == 0 and de == 0:
                    row.append(deltaE)
                elif dh == 1 and de == 0:
                    row.append(coupleH)
                elif dh == 0 and de == 1:
                    row.append(coupleE)
                else:
                    row.append(0.0)
        matJ.append(row)

    spf_info = [[nspf for _ in row] for row in prim_info]
    return prim_info, spf_info, statelist, matJ


def matJ_2D_exciton(
    nmol_row: int,
    nmol_col: int,
    nspf: int,
    coupleJ: float,
    s0: list,
    s1: list,
    *,
    ndof_per_site: int = 1,
):
    """2-D rectangular Frenkel-exciton lattice, nearest-neighbour J.

    Reference: ``helper_input.py:130-167`` (its return convention:
    ``(matJ, prim_info, spf_info, ndof_per_sites)``).
    """
    statelist = list(product(range(nmol_row), range(nmol_col)))
    prim_info = [
        list(
            chain.from_iterable(
                s1 if (a, b) == st else s0 for a, b in statelist
            )
        )
        for st in statelist
    ]
    nstate = len(statelist)
    matJ = np.zeros((nstate, nstate))
    for ist, (ri, ci) in enumerate(statelist):
        for jst, (rj, cj) in enumerate(statelist):
            if abs(ri - rj) + abs(ci - cj) == 1:
                matJ[ist, jst] = coupleJ
    spf_info = [[nspf for _ in row] for row in prim_info]
    nsites = _ndof_per_sites(nmol_row * nmol_col, ndof_per_site)
    return matJ.tolist(), prim_info, spf_info, nsites


def matJ_LH2_exciton(
    nspf: int,
    *,
    omega_cm1: float = 203.3,
    facHS: float = 0.056,
    ndof_per_site: int = 1,
):
    """LH2 27-pigment single-mode exciton model.

    Reference: ``helper_input.py:171-250`` — B850 ring couplings in a
    3-pigment repeating unit (9 units, periodic), each diagonal shifted
    by the Huang–Rhys reorganisation ``omega·S``, pigments re-ordered
    outward from pigment 0 so strongly-coupled neighbours sit close on
    the MPS chain.  Returns ``(matJ, prim_info, spf_info,
    ndof_per_sites)`` with matJ in Hartree.
    """
    from pytdscf_torch import units
    from pytdscf_torch.basis import PrimBas_HO

    nmol = 27
    x = omega_cm1 * facHS
    miniJ = [
        [490 - x, 27, 3, -25],
        [690 - x, 307, -12, -51],
        [70 - x, -3, 237, -35],
    ]
    matJ = np.zeros((nmol, nmol))
    for i in range(0, nmol, 3):
        if i < 24:
            for k in range(3):
                matJ[i + k, i + k : i + k + 4] = miniJ[k]
        else:  # last unit wraps onto pigments 0..2
            for k in range(3):
                matJ[i + k, i + k : nmol] = miniJ[k][: nmol - i - k]
            matJ[0, 24:27] = [miniJ[0][3], miniJ[1][2], miniJ[2][1]]
            matJ[1, 25:27] = [miniJ[1][3], miniJ[2][2]]
            matJ[2, 26:27] = [miniJ[2][3]]
    matJ = np.triu(matJ) + np.triu(matJ, 1).T

    # re-order pigments outward from 0: 0, 1, 26, 2, 25, …
    order = [0]
    for i in range(1, (nmol + 1) // 2):
        order += [i, nmol - i]
    matJ = matJ[np.ix_(order, order)] / units.au_in_cm1

    gs = PrimBas_HO(0.0, omega_cm1, 8)
    qy = PrimBas_HO(math.sqrt(2 * facHS), omega_cm1, 8)
    prim_info = [
        [qy if imol == ist else gs for imol in range(nmol)]
        for ist in range(nmol)
    ]
    spf_info = [[nspf] * nmol for _ in range(nmol)]
    return (
        matJ.tolist(),
        prim_info,
        spf_info,
        _ndof_per_sites(nmol, ndof_per_site),
    )
