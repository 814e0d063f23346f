"""nicediffusion_tpu_torch — the PyTorch and CUDA port of nicediffusion_tpu.

Class-conditional sampling with classifier-free or classifier guidance and
training on one NVIDIA H100: the UNet, the super-resolution UNet, the noisy
classifier (EncoderUNet) and the Real-ESRGAN RRDBNet as torch ``nn.Module``s
with the original reference's (and basicsr's) parameter names, the
DDPM, DDIM and DPM-Solver++ sampling chains with v-prediction, dynamic
thresholding, the encoder cache and limited-interval guidance, static int8
serving (calibrate, freeze, serve), the four training losses, the Trainer
(AdamW, EMA, accumulation, checkpoints), guided and progressive distillation,
the serving daemon (``serving/``: ``SamplerService`` micro-batching requests
into one chain at a fixed batch, behind a stdlib HTTP front end), the entry
points ``python -m nicediffusion_tpu_torch.scripts.sample`` (with
``--upsample``), ``python -m nicediffusion_tpu_torch.scripts.train``,
``python -m nicediffusion_tpu_torch.scripts.distill``,
``python -m nicediffusion_tpu_torch.scripts.serve`` (the daemon) and
``python -m nicediffusion_tpu_torch.scripts.export`` (``.pt`` <-> ``.npz``
and the Trainer's checkpoints), and six kernels
written by hand for Hopper (K1, K2 and K5, attention forward and backward in
CUDA C++; K3, fused GroupNorm and its backward in CUDA C++; K4, fused
GroupNorm+SiLU+3x3 conv in CUDA C++, reached directly as in the JAX package;
the int8 conv, s8 x s8 -> s32 in CUDA C++). ``device=None`` means
the CUDA card everywhere; the CPU has to be asked for. The JAX package
stays the reference this package is tested against; this package imports
torch and numpy only.
"""

from .diffusion.process import Diffusion, LossType, VarType  # noqa: F401
from .models.classifier import EncoderUNet  # noqa: F401
from .models.unet import DiffusionModel  # noqa: F401
from .training.trainer import Trainer  # noqa: F401

__version__ = "0.4.0"
