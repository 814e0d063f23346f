"""Plain torch ops of the port and, under kernels/, its hand-written CUDA kernels."""
