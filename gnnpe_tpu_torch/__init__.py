"""gnnpe_tpu_torch — the PyTorch/CUDA port of gnnpe_tpu for one NVIDIA
Hopper GPU.

The layout follows gnnpe_tpu module for module, so each file's
counterpart is found under the same path there.  Host-only numpy stages
(path enumeration, PDE, planning, the packed-index build, the binned
layout build, refinement) are re-exported from gnnpe_tpu; the device
stages and the PathGNN trainer are PyTorch on tensors, and the two
TPU kernels are hand-written CUDA: the neighbour-sum SpMM
(csrc/spmm_csr.cu) and the ELL gather-sum of the binned layout
(csrc/ell_gather_sum.cu).  This package imports torch and never jax.

Every function that creates tensors takes an explicit ``device``.
"""

from gnnpe_tpu_torch.config import Config, PEConfig, PGEConfig

__version__ = "0.1.0"

__all__ = ["Config", "PEConfig", "PGEConfig", "__version__"]
