"""Operator layer: tensor operators, MPO algebra, Hamiltonians."""

from pytdscf_torch.operators.hamiltonian import (
    HamiltonianMixin,
    TensorHamiltonian,
)
from pytdscf_torch.operators.tensor_op import TensorOperator

__all__ = ["HamiltonianMixin", "TensorHamiltonian", "TensorOperator"]
