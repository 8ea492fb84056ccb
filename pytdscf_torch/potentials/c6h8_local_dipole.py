"""Data shim: see pytdscf_torch/potentials/_tables.py (reference
pytdscf/potentials/c6h8_local_dipole.py)."""
from pytdscf_torch.potentials._tables import load as _load

globals().update(_load("c6h8_local_dipole"))
del _load
