"""Hand-written kernels for Hopper, each beside its plain torch version.

K1, K2 and K5, attention forward and backward (CUDA C++, csrc/attention.cu
and csrc/attention_bwd.cu); K3, fused GroupNorm and its backward (CUDA
C++, csrc/groupnorm.cu); K4, fused GroupNorm+SiLU+3x3 conv (CUDA C++,
csrc/resblock.cu); the int8 conv of static int8 serving, s8 x s8 -> s32
(CUDA C++, csrc/int8conv.cu; XLA's in the JAX package); the bf16 conv and
dense product of sampling and serving, a fixed order of sums (CUDA C++,
csrc/bf16conv.cu; XLA's in the JAX package); the Winograd F(2x2, 3x3) conv
of a bf16 Winograd forward (CUDA C++, csrc/winograd.cu; an XLA composition
in the JAX package). Counterpart of
nicediffusion_tpu/ops/pallas/.
"""
