"""Least-squares quartic force field (QFF) from grid PES data.

Counterpart of ``PyTDSCF:pytdscf/util/grid2qff.py`` as a library:
fit nMR grid energies (1- to 3-mode cuts) to polynomial force constants
``k_orig`` by linear least squares.
"""

from __future__ import annotations

import itertools
from collections import defaultdict
from math import factorial

import numpy as np


def _monomials(dofs: tuple[int, ...], max_order: int):
    """All index tuples over ``dofs`` with every dof present, order ≤ max."""
    out = []
    for order in range(len(dofs), max_order + 1):
        for combo in itertools.combinations_with_replacement(dofs, order):
            if set(combo) == set(dofs):
                out.append(combo)
    return sorted(set(out))


def fit_qff(
    cuts: dict[tuple[int, ...], tuple[np.ndarray, np.ndarray]],
    max_order: int = 4,
) -> dict[tuple[int, ...], float]:
    """Fit k_orig from nMR energy cuts.

    ``cuts[(i,)] = (q_points (N,), energies (N,))`` for 1-mode cuts,
    ``cuts[(i, j)] = (q_points (N, 2), energies (N,))`` for 2-mode cuts with
    the LOWER-order contributions already subtracted (inclusion–exclusion
    components, as produced by the nMR machinery), etc.  Returns force
    constants with the k_orig convention (factorials NOT divided).
    """
    k_orig: dict[tuple[int, ...], float] = defaultdict(float)
    for dofs, (qs, es) in sorted(cuts.items(), key=lambda kv: len(kv[0])):
        qs = np.atleast_2d(np.asarray(qs, float))
        if qs.shape[0] == len(np.asarray(es)):
            pass
        else:
            qs = qs.T
        if qs.ndim == 1:
            qs = qs[:, None]
        if qs.shape[1] != len(dofs):
            qs = qs.reshape(len(es), len(dofs))
        es = np.asarray(es, float)
        terms = _monomials(tuple(dofs), max_order)
        design = np.empty((len(es), len(terms)))
        for c, key in enumerate(terms):
            col = np.ones(len(es))
            for d in key:
                col = col * qs[:, dofs.index(d)]
            fac = 1.0
            for n in [key.count(d) for d in set(key)]:
                fac /= factorial(n)
            design[:, c] = col * fac
        coef, *_ = np.linalg.lstsq(design, es, rcond=None)
        for key, c in zip(terms, coef):
            k_orig[tuple(sorted(key))] += c
    return dict(k_orig)
