"""pytdscf_torch — tensor-train (MPS/MPO) quantum dynamics in PyTorch and CUDA.

The PyTorch port of the JAX package (its reference): projector-splitting 1-site TDVP of a
fixed-bond MPS under a fused MPO, with the Krylov exponential and the
gauge QR as hand-written CUDA kernels for Hopper (``csrc/``).  Each kernel
keeps a plain PyTorch version beside it, which runs for CPU tensors and
serves as its oracle.  The package imports no JAX.
"""

import torch

# The environment-block recursion compounds every contraction error over
# the chain, so float32 products must stay exact: no TF32 anywhere.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from pytdscf_torch import units  # noqa: E402
from pytdscf_torch.basis import Boson, Exciton  # noqa: E402
from pytdscf_torch.config import Config  # noqa: E402
from pytdscf_torch.operators.hamiltonian import TensorHamiltonian  # noqa: E402
from pytdscf_torch.operators.tensor_op import TensorOperator  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Boson",
    "Config",
    "Exciton",
    "TensorHamiltonian",
    "TensorOperator",
    "units",
]
