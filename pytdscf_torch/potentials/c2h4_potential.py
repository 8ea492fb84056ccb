"""Data shim: see pytdscf_torch/potentials/_tables.py (reference
pytdscf/potentials/c2h4_potential.py)."""
from pytdscf_torch.potentials._tables import load as _load

globals().update(_load("c2h4_potential"))
del _load
