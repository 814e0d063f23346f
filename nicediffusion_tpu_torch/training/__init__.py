"""Training: data pipelines and the Trainer (counterpart of nicediffusion_tpu/training)."""
