"""Primitive integral tables: ⟨χ_m|op|χ_k⟩ per state pair and DOF.

API counterpart of the reference's ``PrimInts``
(``PyTDSCF:pytdscf/basis/_primints_cls.py:287-753``): a dict-like
container ``ints[(istate, jstate)][op_key][idof]`` of time-independent
primitive matrices, built once per model and picklable to a cache file
(the reference caches to ``ints_prim_file``).  The matrices themselves come
from :mod:`pytdscf_torch.basis.op_matrix` (exact ladder algebra +
Gauss–Hermite cross-basis overlaps; the JAX package's native C++ kernels,
an optional accelerator of the same integrals, are not copied).
"""

from __future__ import annotations

import pickle

import numpy as np

from pytdscf_torch.basis.op_matrix import op_matrix

DEFAULT_OPS = ("ovlp", "q^1", "q^2", "q^3", "q^4", "d^1", "d^2")


class PrimInts:
    """Build and hold primitive integral matrices for a model."""

    def __init__(self, model=None, op_keys=DEFAULT_OPS, *, tables=None):
        if tables is not None:
            self.tables = tables
            return
        if model is None:
            raise ValueError("give a model or tables")
        basinfo = model.basinfo
        nstate = basinfo.get_nstate()
        ndof = basinfo.get_ndof()
        self.tables: dict = {}
        for i in range(nstate):
            for j in range(nstate):
                per_op: dict[str, list[np.ndarray]] = {}
                for key in op_keys:
                    mats = []
                    for d in range(ndof):
                        try:
                            mats.append(
                                np.asarray(
                                    op_matrix(
                                        basinfo.get_primbas(i, d),
                                        basinfo.get_primbas(j, d),
                                        key,
                                    )
                                )
                            )
                        except (ValueError, NotImplementedError):
                            mats.append(None)
                    per_op[key] = mats
                self.tables[(i, j)] = per_op

    def __getitem__(self, statepair: tuple[int, int]):
        return self.tables[statepair]

    def op_keys(self) -> list[str]:
        first = next(iter(self.tables.values()))
        return list(first.keys())

    # ------------------------------------------------------------- cache
    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.tables, f)

    @classmethod
    def load(cls, path: str) -> "PrimInts":
        with open(path, "rb") as f:
            return cls(tables=pickle.load(f))
