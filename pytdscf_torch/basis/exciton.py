"""Exciton basis (re-exported from boson module for API parity)."""

from pytdscf_torch.basis.boson import Exciton

__all__ = ["Exciton"]
