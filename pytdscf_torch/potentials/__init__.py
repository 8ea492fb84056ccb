"""Bundled polynomial PES / dipole-surface data tables.

Force constants are physical data (Taylor expansions of published ab-initio
surfaces, in Hartree-based atomic units with 1-based mode indices, matching
the mop convention consumed by
:func:`pytdscf_torch.operators.sop.read_potential_nMR`).
"""

from pytdscf_torch.potentials._tables import TABLES, load
from pytdscf_torch.potentials.ch2o import k_orig as ch2o_k_orig
from pytdscf_torch.potentials.ch2o import mu as ch2o_mu
from pytdscf_torch.potentials.h2o import k_orig as h2o_k_orig
from pytdscf_torch.potentials.h2o import mu as h2o_mu

__all__ = [
    "ch2o_k_orig", "ch2o_mu", "h2o_k_orig", "h2o_mu", "load", "TABLES",
]
