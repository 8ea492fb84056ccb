"""Primitive basis package: DVR families, Fock-like bases, FBR primitives."""

from pytdscf_torch.basis.abc import DVRPrimitivesMixin
from pytdscf_torch.basis.boson import Boson, Exciton
from pytdscf_torch.basis.exponential import Exponential
from pytdscf_torch.basis.ho import HarmonicOscillator, PrimBas_HO
from pytdscf_torch.basis.sin import Sine

__all__ = [
    "DVRPrimitivesMixin",
    "HarmonicOscillator",
    "PrimBas_HO",
    "Sine",
    "Exponential",
    "Boson",
    "Exciton",
]
