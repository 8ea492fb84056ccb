"""Built-in model builders (benchmark and regression systems)."""

from pytdscf_torch.models.holstein import singlet_fission_chain
from pytdscf_torch.models.radical_pair import (
    radical_pair_liouvillian,
    singlet_product_state,
)

__all__ = [
    "radical_pair_liouvillian",
    "singlet_fission_chain",
    "singlet_product_state",
]
