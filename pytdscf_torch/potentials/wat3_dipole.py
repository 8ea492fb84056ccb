"""Data shim: see pytdscf_torch/potentials/_tables.py (reference
pytdscf/potentials/wat3_dipole.py)."""
from pytdscf_torch.potentials._tables import load as _load

globals().update(_load("wat3_dipole"))
del _load
