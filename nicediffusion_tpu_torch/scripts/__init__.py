"""Entry points run as ``python -m nicediffusion_tpu_torch.scripts.<name>``."""
