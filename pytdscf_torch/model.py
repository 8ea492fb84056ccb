"""Model and basis-set information (user-facing configuration objects).

API parity: ``PyTDSCF:pytdscf/model_cls.py`` — ``Model(basinfo,
operators, bond_dim=…)`` with ``init_HartreeProduct`` /
``init_weight_ESTATE`` attributes, auto-wrapping of raw core-list MPOs, and
``BasInfo`` wrapping ``prim_info[istate][idof]``.
"""

from __future__ import annotations

import copy
from typing import Literal

import numpy as np

from pytdscf_torch.basis.abc import DVRPrimitivesMixin
from pytdscf_torch.basis.ho import PrimBas_HO
from pytdscf_torch.operators.hamiltonian import (
    HamiltonianMixin,
    TensorHamiltonian,
)
from pytdscf_torch.operators.tensor_op import TensorOperator


class BasInfo:
    """Wavefunction basis information: ``prim_info[istate][idof]``."""

    def __init__(self, prim_info, spf_info=None, ndof_per_sites=None):
        self.prim_info = copy.deepcopy(prim_info)
        self.is_DVR = any(
            isinstance(b, DVRPrimitivesMixin) for b in prim_info[0]
        )
        self.need_primints = any(
            isinstance(b, PrimBas_HO) for b in prim_info[0]
        )
        if spf_info is None:
            self.spf_info = [
                [len(self.prim_info[i][d]) for d in range(self.get_ndof())]
                for i in range(self.get_nstate())
            ]
            self.is_standard_method = True
        else:
            self.spf_info = copy.deepcopy(spf_info)
            self.is_standard_method = False
        if ndof_per_sites:
            raise NotImplementedError

    def get_nstate(self) -> int:
        return len(self.prim_info)

    def get_ndof(self) -> int:
        return len(self.prim_info[0])

    def get_primbas(self, istate: int, idof: int):
        return self.prim_info[istate][idof]

    def get_nspf(self, istate: int, idof: int) -> int:
        return self.spf_info[istate][idof]

    def get_nprim(self, istate: int, idof: int) -> int:
        return self.prim_info[istate][idof].nprim

    def get_ngrid(self, istate: int, idof: int) -> int:
        return self.get_nprim(istate, idof)

    def get_nspf_list(self, istate: int) -> list[int]:
        return [self.get_nspf(istate, d) for d in range(self.get_ndof())]


class Model:
    """Bundles basis info, operators and initial-state directives."""

    init_HartreeProduct: list[list[list[float]]] | None = None
    init_weight_ESTATE: list[float] | None = None
    init_weight_VIBSTATE: list[list[float]] | None = None
    init_weight_VIB_GS: float | None = None
    primbas_gs: list | None = None
    ints_prim_file: str | None = None

    def __init__(
        self,
        basinfo,
        operators,
        *,
        bond_dim: int | None = None,
        space: Literal["hilbert", "liouville"] = "hilbert",
        subspace_inds: dict[int, tuple[int, ...]] | None = None,
        one_gate_to_apply: TensorHamiltonian | None = None,
        kraus_op: dict | None = None,
        build_td_hamiltonian=None,
    ):
        if isinstance(basinfo, BasInfo):
            self.basinfo = basinfo
        elif isinstance(basinfo, list):
            if isinstance(basinfo[0], list):
                self.basinfo = BasInfo(prim_info=basinfo)
            else:
                self.basinfo = BasInfo(prim_info=[basinfo])
        else:
            raise TypeError("basinfo must be BasInfo or list")

        if isinstance(operators, (HamiltonianMixin, list)):
            operators = {"hamiltonian": operators}
        ops = self._wrap_operators(dict(operators))
        self.hamiltonian = ops.pop("hamiltonian")
        self.observables = ops
        for op in [self.hamiltonian, *self.observables.values()]:
            if hasattr(op, "bind_basis"):
                op.bind_basis(self.basinfo)
        self.build_td_hamiltonian = build_td_hamiltonian
        if self.hamiltonian.nstate != self.basinfo.get_nstate():
            raise ValueError(
                "nstate mismatch between Hamiltonian and BasInfo"
            )
        self.nstate = self.hamiltonian.nstate
        self.m_aux_max = bond_dim
        self.use_mpo = isinstance(self.hamiltonian, TensorHamiltonian)
        if space.lower() not in ("hilbert", "liouville"):
            raise ValueError(f"invalid space {space}")
        self.space = space.lower()
        self.one_gate_to_apply = one_gate_to_apply
        self.kraus_op = kraus_op
        if self.space == "liouville" and subspace_inds is not None:
            self.subspace_inds = subspace_inds
            self.hamiltonian.project_subspace(subspace_inds)
            for op in self.observables.values():
                op.project_subspace(subspace_inds)
            if one_gate_to_apply is not None:
                one_gate_to_apply.project_subspace(subspace_inds)
        else:
            self.subspace_inds = None

    # ------------------------------------------------------------------
    def _guess_leg_keys(self, mpo: list[np.ndarray]):
        if len(mpo) != self.get_ndof():
            raise ValueError(
                f"raw MPO length {len(mpo)} != ndof {self.get_ndof()}"
            )
        key = []
        for k, core in enumerate(mpo):
            if core.ndim == 3:
                key.append((k,))
            elif core.ndim == 4:
                key.append((k, k))
            else:
                raise ValueError(f"invalid core shape {core.shape}")
        return tuple(key)

    def _as_tensor_dict(self, op) -> dict:
        """Raw core list or {legs: TensorOperator} dict → potential dict."""
        if isinstance(op, dict):
            return op
        if isinstance(op, list):
            return {self._guess_leg_keys(op): TensorOperator(mpo=op)}
        raise TypeError(f"unsupported operator spec {type(op)}")

    def _wrap_operators(self, operators: dict) -> dict:
        out: dict = {}
        if "potential" in operators:
            pot = operators.pop("potential")
            kin = operators.pop("kinetic", None)
            if "hamiltonian" in operators:
                raise ValueError("cannot give both 'potential' and 'hamiltonian'")
            out["hamiltonian"] = TensorHamiltonian(
                ndof=self.get_ndof(),
                potential=self._as_tensor_dict(pot),
                kinetic=(
                    self._as_tensor_dict(kin) if kin is not None else None
                ),
                backend="numpy",
            )
        for name, op in operators.items():
            if isinstance(op, HamiltonianMixin):
                out[name] = op
            elif isinstance(op, (list, dict)):
                out[name] = TensorHamiltonian(
                    ndof=self.get_ndof(),
                    potential=self._as_tensor_dict(op),
                    kinetic=None,
                    backend="numpy",
                )
            else:
                raise TypeError(f"operator {name}: unsupported type {type(op)}")
        return out

    # ------------------------------------------------------------------
    def get_nstate(self) -> int:
        return self.basinfo.get_nstate()

    def get_ndof(self) -> int:
        return self.basinfo.get_ndof()

    def get_primbas(self, istate: int, idof: int):
        return self.basinfo.get_primbas(istate, idof)

    def get_nspf_list(self, istate: int) -> list[int]:
        return self.basinfo.get_nspf_list(istate)

    def apply_backend(self, backend) -> None:
        self.hamiltonian.apply_backend(backend)
        for op in self.observables.values():
            op.apply_backend(backend)
