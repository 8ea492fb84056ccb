"""Carry engine state from the JAX package into the port.

Both sides meet in numpy: the JAX engine's ``to_numpy()`` gives the
per-state MPS cores and its Hamiltonian's ``fused_mpo(phys_dims)`` the
fused MPO cores.  :func:`from_numpy` builds a port engine holding exactly
that state on a given device; the port's ``TDVPEngine.to_numpy()`` gives
it back in the same layout.  This module imports no JAX: the caller hands
over the arrays.
"""

from __future__ import annotations

from pytdscf_torch.config import Config
from pytdscf_torch.mps.tdvp import TDVPEngine


class FusedMPO:
    """Fused MPO cores (``fused[i][j]``: list of (a, i, j, b) arrays or
    None) standing in for a Hamiltonian: the engine only calls
    ``fused_mpo``."""

    def __init__(self, fused):
        self.fused = fused

    def fused_mpo(self, phys_dims):
        return self.fused


def from_numpy(cores, fused, config: Config, device="cuda") -> TDVPEngine:
    """A port engine holding ``cores`` (per-state lists of (l, n, r) numpy
    arrays, centre at site 0) under the fused MPO ``fused``, on the card
    unless the caller asks for the CPU (without a card this raises)."""
    return TDVPEngine(cores, FusedMPO(fused), config, device)
