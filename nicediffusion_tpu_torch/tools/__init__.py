"""The evaluation tools, counterparts of the JAX package's ``tools/``.

  * ``python -m nicediffusion_tpu_torch.tools.eval_nll``: the full-chain
    variational bound (bits/dim) of a checkpoint over real or synthetic
    images;
  * ``python -m nicediffusion_tpu_torch.tools.verify_checkpoint``: load,
    preset dispatch, structural match, parameter count, forward parity with
    the original PyTorch reference where it is importable, and a 2-step
    smoke sample, for one ``.pt``;
  * ``python -m nicediffusion_tpu_torch.tools.quality_eval``: trains the
    EMNIST-scale UNet and a noisy classifier on synthetic data, samples
    every lossy serving mode on the same draws and reports classifier
    accuracy, a logit Frechet distance and pixel deviations from the exact
    chain.

Each has a ``main(argv=None)`` that returns the exit code. Each runs on the
CUDA card unless asked for the CPU (``--cpu``, or ``QE_DEVICE=cpu`` for
quality_eval) and raises RuntimeError where there is no card.
"""
