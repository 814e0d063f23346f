"""nicediffusion_tpu_torch — the PyTorch and CUDA port of nicediffusion_tpu.

Class-conditional sampling with classifier-free guidance and training on
one NVIDIA H100: the UNet as torch ``nn.Module``s with the original
reference's parameter names, the DDPM/DDIM sampling chain, the four training
losses, the Trainer (AdamW, EMA, accumulation, checkpoints) and its entry
point ``python -m nicediffusion_tpu_torch.scripts.train``, and three kernels
written by hand for Hopper (K1 and K2, fused-qkv attention forward and
backward in CUDA C++; K3, fused GroupNorm in Triton). ``device=None`` means
the CUDA card everywhere; the CPU has to be asked for. The JAX package
stays the reference this package is tested against; this package imports
torch and numpy only.
"""

from .diffusion.process import Diffusion, LossType, VarType  # noqa: F401
from .models.unet import DiffusionModel  # noqa: F401
from .training.trainer import Trainer  # noqa: F401

__version__ = "0.2.0"
