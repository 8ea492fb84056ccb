"""Host-side utilities of the port (copies of the JAX package's):
reduced-density reader, format converters."""

from pytdscf_torch.util.read_nc import read_nc

__all__ = ["read_nc"]
