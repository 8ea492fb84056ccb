"""Operator layer: tensor operators, MPO algebra, Hamiltonians."""

from pytdscf_torch.operators.dvr import (
    PotentialFunction,
    construct_fulldimensional,
    construct_kinetic_mpo,
    construct_kinetic_operator,
    construct_nMR_recursive,
    database_to_dataframe,
)
from pytdscf_torch.operators.hamiltonian import (
    HamiltonianMixin,
    TensorHamiltonian,
)
from pytdscf_torch.operators.tensor_op import TensorOperator

__all__ = [
    "HamiltonianMixin",
    "PotentialFunction",
    "TensorHamiltonian",
    "TensorOperator",
    "construct_fulldimensional",
    "construct_kinetic_mpo",
    "construct_kinetic_operator",
    "construct_nMR_recursive",
    "database_to_dataframe",
]
