"""Primitive bases used by the ported slice: boson Fock states and excitons."""

from pytdscf_torch.basis.boson import Boson, Exciton

__all__ = ["Boson", "Exciton"]
