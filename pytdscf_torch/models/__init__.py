"""Built-in model builders (benchmark and regression systems)."""

from pytdscf_torch.models.holstein import singlet_fission_chain

__all__ = ["singlet_fission_chain"]
