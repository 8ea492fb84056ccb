"""TensorOperator: an n-mode operator tensor and its MPO factorisation.

API-parity target: ``PyTDSCF:pytdscf/dvr_operator_cls.py:40-629``
(construction from a dense grid tensor with ``legs`` metadata, or from a
pre-built core list via ``mpo=``; ``decompose()`` yields the core list).
The decomposition itself is a plain sequential QR/SVD train on host numpy.

Legs convention: ``legs[k]`` is the DOF index of the k-th tensor axis.
A DOF appearing once is a *diagonal* (grid) leg; appearing twice means the
core carries explicit bra/ket axes.  Example: ``legs=(0, 1, 2, 3, 3)`` has
diagonal cores on DOFs 0–2 and a general core on DOF 3.
"""

from __future__ import annotations

import pickle
from itertools import groupby
from typing import Literal

import numpy as np


class TensorOperator:
    """Operator tensor over a subset of DOFs, stored dense and/or as cores."""

    def __init__(
        self,
        *,
        shape: tuple[int, ...] | None = None,
        tensor: np.ndarray | None = None,
        only_diag: bool = False,
        legs: tuple[int, ...] | None = None,
        name: str | None = None,
        mpo: list[np.ndarray] | None = None,
    ) -> None:
        self.name = name
        self.tensor_orig: np.ndarray | None = None
        self.tensor_decomposed: list[np.ndarray] | None = None

        if mpo is not None:
            if not isinstance(mpo, list):
                raise TypeError("mpo must be a list of cores")
            only_diag = all(core.ndim == 3 for core in mpo)
            self.tensor_decomposed = [np.asarray(c) for c in mpo]
            shape = tuple(i for core in mpo for i in core.shape[1:-1])
            if legs is None:
                _legs: list[int] = []
                for i, core in enumerate(mpo):
                    if core.ndim == 3:
                        _legs.append(i)
                    elif core.ndim == 4:
                        _legs.extend([i, i])
                    else:
                        raise ValueError(f"core.ndim must be 3/4, got {core.ndim}")
                legs = tuple(_legs)
        elif tensor is not None:
            tensor = np.asarray(tensor)
            self.tensor_orig = tensor
            shape = tensor.shape
        elif shape is None:
            raise ValueError("give one of tensor=, mpo= or shape=")

        self.shape = tuple(shape)
        self.only_diag = only_diag
        if legs is None:
            if only_diag:
                legs = tuple(range(len(self.shape)))
            else:
                raise ValueError("legs is ambiguous; pass legs=")
        if len(legs) != len(self.shape):
            raise ValueError(
                f"tensor shape {self.shape} and legs {legs} are inconsistent"
            )
        self.legs = tuple(legs)

    # ------------------------------------------------------------------
    @property
    def dtype(self):
        if self.tensor_orig is not None:
            return self.tensor_orig.dtype
        return self.tensor_decomposed[0].dtype

    @property
    def sites(self) -> list[int]:
        """Ordered distinct DOFs this operator acts on."""
        return [k for k, _ in groupby(self.legs)]

    def _site_groups(self) -> list[tuple[int, bool]]:
        """Per-site (dof, is_general) in leg order."""
        out = []
        for dof, grp in groupby(self.legs):
            n = len(list(grp))
            if n == 1:
                out.append((dof, False))
            elif n == 2:
                out.append((dof, True))
            else:
                raise ValueError(f"DOF {dof} appears {n} times in legs")
        return out

    # ------------------------------------------------------------------
    def decompose(
        self,
        bond_dimension: list[int] | int | None = None,
        decompose_type: Literal["QRD", "SVD"] = "SVD",
        rate: float | None = None,
    ) -> list[np.ndarray]:
        """Factorise the dense tensor into a core train (cached).

        Returns cores per site: 3-rank ``(a, n, b)`` for diagonal legs,
        4-rank ``(a, n, n', b)`` for general legs.
        """
        if self.tensor_decomposed is not None:
            return self.tensor_decomposed

        groups = self._site_groups()
        # Axis dimension per site (bra·ket merged for general legs).
        dims: list[int] = []
        phys: list[tuple[int, ...]] = []
        ax = 0
        for _, is_general in groups:
            if is_general:
                dims.append(self.shape[ax] * self.shape[ax + 1])
                phys.append((self.shape[ax], self.shape[ax + 1]))
                ax += 2
            else:
                dims.append(self.shape[ax])
                phys.append((self.shape[ax],))
                ax += 1

        mat = np.asarray(self.tensor_orig, dtype=np.complex128).reshape(1, -1)
        cores: list[np.ndarray] = []
        left = 1
        for k, dim in enumerate(dims[:-1]):
            mat = mat.reshape(left * dim, -1)
            if decompose_type.upper() == "QRD":
                q, r = np.linalg.qr(mat)
                keep = q.shape[1]
                core, mat = q, r
            else:
                u, sig, vh = np.linalg.svd(mat, full_matrices=False)
                tol = 1.0e-13 * sig[0] if sig.size and sig[0] > 0 else 0.0
                if rate is not None:
                    csum = np.cumsum(sig**2)
                    keep = int(np.searchsorted(csum / csum[-1], rate) + 1)
                else:
                    keep = max(int(np.sum(sig > tol)), 1)
                if bond_dimension is not None:
                    bd = (
                        bond_dimension[k]
                        if isinstance(bond_dimension, list)
                        else bond_dimension
                    )
                    keep = min(keep, bd)
                core = u[:, :keep]
                mat = sig[:keep, None] * vh[:keep]
            cores.append(core.reshape(left, *phys[k], core.shape[1]))
            left = core.shape[1]
        cores.append(mat.reshape(left, *phys[-1], 1))
        self.tensor_decomposed = cores
        self.bond_dimension = [1] + [c.shape[-1] for c in cores]
        return cores

    def to_site_cores(self) -> dict[int, np.ndarray]:
        """Map DOF → core (after decomposition)."""
        cores = self.decompose()
        return {dof: core for (dof, _), core in zip(self._site_groups(), cores, strict=True)}

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @classmethod
    def load(cls, path: str) -> "TensorOperator":
        with open(path, "rb") as f:
            obj = pickle.load(f)
        if not isinstance(obj, cls):
            raise TypeError(f"{path} does not contain a TensorOperator")
        return obj

    def __repr__(self) -> str:
        return (
            f"TensorOperator(legs={self.legs}, shape={self.shape}, "
            f"only_diag={self.only_diag})"
        )
