"""Data shim: see pytdscf_torch/potentials/_tables.py (reference
pytdscf/potentials/c14h16_local_potential.py)."""
from pytdscf_torch.potentials._tables import load as _load

globals().update(_load("c14h16_local_potential"))
del _load
