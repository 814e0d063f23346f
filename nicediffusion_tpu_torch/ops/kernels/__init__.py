"""Hand-written kernels for Hopper, each beside its plain torch version.

K1 fused-qkv attention (CUDA C++, csrc/attention.cu) and K3 fused GroupNorm
(Triton). Counterpart of nicediffusion_tpu/ops/pallas/.
"""
