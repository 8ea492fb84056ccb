"""Data shim: see pytdscf_torch/potentials/_tables.py (reference
pytdscf/potentials/wat3_potential.py)."""
from pytdscf_torch.potentials._tables import load as _load

globals().update(_load("wat3_potential"))
del _load
