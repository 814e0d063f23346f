"""Hand-written kernels for Hopper, each beside its plain torch version.

K1, K2 and K5, attention forward and backward (CUDA C++, csrc/attention.cu
and csrc/attention_bwd.cu); K3, fused GroupNorm and its backward (CUDA
C++, csrc/groupnorm.cu); K4, fused GroupNorm+SiLU+3x3 conv (CUDA C++,
csrc/resblock.cu). Counterpart of
nicediffusion_tpu/ops/pallas/.
"""
