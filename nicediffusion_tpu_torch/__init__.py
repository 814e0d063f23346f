"""nicediffusion_tpu_torch — the PyTorch and CUDA port of nicediffusion_tpu.

Class-conditional sampling with classifier-free guidance on one NVIDIA H100:
the UNet as torch ``nn.Module``s with the original reference's parameter
names, the DDPM/DDIM sampling chain, and two kernels written by hand for
Hopper (K1, fused-qkv attention in CUDA C++; K3, fused GroupNorm in Triton).
The JAX package stays the reference this package is tested against; this
package imports torch and numpy only.
"""

from .diffusion.process import Diffusion, LossType, VarType  # noqa: F401
from .models.unet import DiffusionModel  # noqa: F401

__version__ = "0.1.0"
