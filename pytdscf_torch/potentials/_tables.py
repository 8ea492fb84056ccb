"""Compressed PES / dipole-surface data tables.

The reference ships these as multi-megabyte generated Python modules
(``PyTDSCF:pytdscf/potentials/*.py``, e.g.
``c14h16_local_potential.py`` at ~2 MB); here the same physical data —
Taylor force constants in Hartree atomic units, dipole derivatives with
3-vector values, 1-based mode indices — is stored as compressed npz
(keys padded to the max order with −1) and rebuilt into the identical
``{tuple: float}`` / ``{tuple: [x, y, z]}`` dicts on load.
"""

from __future__ import annotations

import functools
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(__file__), "data")

TABLES = (
    "c2h4_potential",
    "c4h6_local_potential", "c4h6_local_dipole",
    "c6h8_local_potential", "c6h8_potential", "c6h8_local_dipole",
    "c8h10_local_potential", "c10h12_local_potential",
    "c12h14_local_potential", "c14h16_local_potential",
    "wat3_potential", "wat3_dipole", "wat6_potential", "wat6_dipole",
)


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
