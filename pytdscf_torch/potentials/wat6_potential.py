"""Data shim: see pytdscf_torch/potentials/_tables.py (reference
pytdscf/potentials/wat6_potential.py)."""
from pytdscf_torch.potentials._tables import load as _load

globals().update(_load("wat6_potential"))
del _load
