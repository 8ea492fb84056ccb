"""Compressed PES / dipole-surface data tables.

A copy of the JAX package's ``potentials/_tables.py`` with two of its
tables, the butadiene (C4H6) local-mode surface and dipole
(``data/c4h6_local_potential.npz``, ``data/c4h6_local_dipole.npz``).
Upstream PyTDSCF ships them as generated Python modules
(``pytdscf/potentials/c4h6_local_potential.py``); here the same physical
data — Taylor force constants in Hartree atomic units, dipole derivatives
with 3-vector values, 1-based mode indices — is stored as compressed npz
(keys padded to the max order with −1) and rebuilt into the identical
``{tuple: float}`` / ``{tuple: [x, y, z]}`` dicts on load.
"""

from __future__ import annotations

import functools
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "data")

TABLES = ("c4h6_local_potential", "c4h6_local_dipole")


def _unpack_keys(karr: np.ndarray) -> list[tuple[int, ...]]:
    return [tuple(int(x) for x in row if x >= 0) for row in karr]


@functools.lru_cache(maxsize=None)
def load(table: str) -> dict:
    """Load one table → ``{"k_orig": {...}}`` and/or ``{"mu": {...}}``."""
    path = os.path.join(_DATA, f"{table}.npz")
    if not os.path.exists(path):
        raise KeyError(
            f"unknown potential table {table!r}; available: {TABLES}"
        )
    f = np.load(path)
    out: dict = {}
    if "k_keys" in f:
        out["k_orig"] = dict(
            zip(_unpack_keys(f["k_keys"]), f["k_vals"].tolist())
        )
    if "mu_keys" in f:
        out["mu"] = dict(
            zip(_unpack_keys(f["mu_keys"]), f["mu_vals"].tolist())
        )
    return out
