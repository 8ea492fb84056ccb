"""Data shim: see pytdscf_torch/potentials/_tables.py (reference
pytdscf/potentials/wat6_dipole.py)."""
from pytdscf_torch.potentials._tables import load as _load

globals().update(_load("wat6_dipole"))
del _load
