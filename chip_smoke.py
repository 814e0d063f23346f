"""Smoke run of the PyTorch port (nicediffusion_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main paths at full width with random weights made from a
seed: class-conditional sampling with classifier-free guidance and training
at the ``openai_64`` preset, the sampling entry point with classifier
guidance at ``openai_128`` with its noisy classifier, the entry point's
fast-sampling configuration (DPM-Solver++, dynamic thresholding, the encoder
cache, limited-interval guidance, v-prediction) at ``openai_64``, static int8
serving (``--dtype int8``) at ``openai_64``, training at ``openai_128``,
the super-resolution UNet at ``openai_256`` widths, the ESRGAN stage
(``--upsample``), guided and progressive distillation at ``openai_64``, the
serving daemon (HTTP requests micro-batched into one chain) at
``openai_64`` in bf16 and int8, and data-parallel training, sampling and
serving at ``openai_64`` (two ranks sharing the card, one through torchrun),
tensor-parallel forwards and training at ``openai_64`` (two ranks
sharing the card, each with half the paired layers' channels), and
``DiffusionModel(winograd=True)`` at ``openai_64``, sampled and served. It
checks every hand-written kernel on the way:

  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: K1 with K5, K2, K3 (forward and backward), K4, the int8 conv,
     the bf16 conv and the Winograd conv (CUDA C++, one nvcc for sm_90a per
     source, started together) from the
     sources in this checkout; the registers and spills ptxas reports for
     each kernel (kept beside a cached build; a tensor-core instantiation
     that spills fails, and so does a library of K1/K5, K2, K4, the int8
     conv, the bf16 conv or the Winograd conv whose log names none; K3 has
     no wgmma, and any of its instantiations that spills fails), and the
     count of warpgroup multiplies in the machine code of those six
     libraries (cuobjdump -sass: HGMMA for the bf16 ones, any integer
     mnemonic, IGMMA, for the int8 conv), which must not be 0 in any: bf16
     K1, K2, K4 and K5 and the three convs run on the tensor cores (wgmma),
     f32 on the CUDA cores; each
     of the bf16 conv's six instances must also hold TMA loads (UTMALDG)
     and setmaxnreg (USETMAXREG): its producer warpgroup;
  3. each kernel against its plain torch version at every shape one
     forward of each main path gives it (found by hooks on plain-version
     forwards of ``openai_64``, of the train entry point's EMNIST model,
     whose shapes are ragged, at that recipe's batch of 468, of
     ``openai_128`` and its classifier at batch 4: head dims 128, 192 and
     256, the interleaved layout, the pool's N = 65, and of the
     super-resolution UNet at ``openai_256`` widths at batch 2: K3 at up to
     256 channels on 256x256 maps, K1 at C = 512 and 1024, and of
     ``openai_64`` again at model batch 128, the daemon's batch at serve
     batch 64 under CFG, where K3's plan of clusters and waves differs, and
     at batch 4, one of two data-parallel ranks' rows of a training step;
     K3 also at a tensor-parallel rank's out_norm shapes, C/2 channels in 16
     groups, its modulation rows views at an offset into the step
     embedding),
     f32 and bf16, with the
     JAX package's tolerances; its time per call in the path's compute
     type, per shape and summed over one forward, beside the plain
     version's and the library call's (K3 also with the route its plan
     takes, every row held in shared memory or some read twice, and the HBM
     bytes that moves; bf16 K3 is also held to K3_BF16_REL, which a planted
     fault, the scale handed over 5% high, must fail at every shape),
     host-timed (CUDA events around back-to-back calls, which read the
     host's launch rate for calls under about 40 us) and in device time (a
     CUDA graph of the calls replayed),
     the kernel and the library call also by torch.profiler (the kernels'
     own device time, without the gaps between launches); attention also
     in TFLOP/s of its two products and as
     a share of its bound; K1 at one N of 1024 for head dims 64 to 256, and
     with and without writing the row log-sum-exp. K5 runs at the
     ``openai_128`` shapes (and those of ``openai_128`` at one head) as
     strided views of a projection and as separate contiguous tensors, and at
     D = 16, N = 49; then, with the counts reset,
     it is called directly at those shapes and held bit for bit against K1
     (no model calls K5: these are the launches its entry reports); K1 (and
     in step 6 K2) also at head dims 24, 48 and 96, each on the build for
     the next one up, and at head dims 257 to 1024 (ABOVE_256) on the
     chunked build, the lse against torch.logsumexp and K5 equal to K1 bit
     for bit there; K1 timed at the attention shapes of ``openai_128`` at one
     head (head dims 512, 768 and 1024, model batch 8: the ``wide128`` path)
     with the chunked build's recompute factor and the library's kernel
     (which backend scaled_dot_product_attention picked) beside the bound;
  4. the full-width f32 model with kernels on against ``kernels=False``
     on one CFG forward (max abs <= 1e-3, the repo's parity bar);
  5. the slice: bf16, CFG w=0.8, DDPM with learned-interpolation variance
     respaced to 25 steps, answering 3 requests of 8 labels; the launch
     counters must show every attention and GroupNorm call went through the
     kernels; samples/s with kernels on and off; a torch.profiler breakdown
     of one sampling forward;
  5a. ``[winograd]``: ``DiffusionModel(winograd=True)`` at full-width
     ``openai_64`` on the same weights, its stride-1 3x3 convs (the stem and
     the 72 residual-block ones) through the Winograd conv (csrc/winograd.cu:
     F(2x2, 3x3), the transforms and 16 bf16 wgmma products fused, one launch
     a call, the positions split over a cluster of four blocks, a fixed order
     of sums; each shape's plan logged): the kernel against its plain version
     within BF16_CONV_TOL at every such conv shape at model batch 16 and 128
     and at the EMNIST model's 28, 14 and 7 maps; the f32 Winograd forward
     against the f32 direct model (1e-3); the bf16 forward and a DDIM-10 CFG
     chain kernels on and off against the f32 Winograd model; the main path
     (that chain through ``Diffusion.denoise`` and served batches, the plain
     versions refused) with its launch counts; one example's output bit for
     bit at other rows and batch sizes and through the daemon; the kernel's
     times over the 73 convs at model batch 16 and 128 beside its plain
     version, the bf16 conv and cuDNN at the same convs and the bound; a
     bf16 forward at model batch 128 with winograd on against off (busy ms,
     idle share, samples/s of a DDIM-10 chain of 64);
  5b. the full-width ``openai_128`` f32 forward, its classifier's logits and
     the guidance gradient, kernels on against ``kernels=False``; then the
     sampling entry point (``nicediffusion_tpu_torch.scripts.sample.main``)
     as a user calls it, on ``128x128_diffusion.pt`` and
     ``128x128_classifier.pt`` written to a temporary directory: bf16, the
     preset's 25 DDIM steps, classifier guidance, 2 samples of 4 images.
     The 8 files must be there under the per-class names, and the launch
     counts must equal what the two models' structure gives (K1 in the UNet
     and the classifier, K2 and K3 through the classifier's gradient);
     images/s with kernels on and off through the library on the same seed;
     a torch.profiler breakdown of one guided step;
  6. K2 (the attention backward) against its plain version and against
     autograd through the plain forward, f32 and bf16, both layouts, output
     pre-filled with NaN, with K1's row log-sum-exp handed over and without
     it, at every attention shape of a training step of both models (and of
     one data-parallel rank's ``openai_64`` step at batch 4), of the
     classifier's gradient and at a ragged N with head dims 128 and 192, of
     a training step of ``openai_128`` at one head (batch 2, timed, as K1's
     ``wide128``) and at head dims 257 to 1024 (ABOVE_256); bf16
     also to a relative error of dq, dk and dv per (example, head), which a
     planted fault (the lse handed over 0.05 too high) must fail at every
     shape; its times beside the plain version's and the library call's (the
     autograd backward of scaled_dot_product_attention, its device time from
     torch.profiler), K2 and the library's forward read by CUDA graph and by
     torch.profiler side by side;
  6b. K3's backward kernel against its plain version (the closed form, f32 to
     1e-5 of each output's largest element, bf16 to K3_BF16_REL per output,
     which the rstd handed over 5% high must fail at every shape, bit-equal
     across two runs) at every GroupNorm shape of an ``openai_64`` training
     step, of the EMNIST recipe, of an ``openai_128`` training step, of the
     classifier's gradient, of one data-parallel rank's ``openai_64``
     step at batch 4 and of a tensor-parallel rank's step at batch 8 (16
     groups on C/2); its times summed over one ``openai_64`` training step
     at batch 8, one guidance gradient at batch 4 and the ranks' steps, beside
     the plain version, the library's autograd backward of F.group_norm, the
     modulation and F.silu (by torch.profiler) and the bound;
  7. loss and every parameter's gradient of the full-width f32 model, and
     of the EMNIST model at batch 468, kernels on against ``kernels=False``;
  8. the training slice: (a) ``Trainer.train()`` on ``openai_64`` in bf16
     with remat and dropout, then ``save()``, ``restore`` into a fresh
     Trainer and ``sample()``; (b) the train entry point's EMNIST recipe at
     batch 468. Launch counts of K1, K2, K3 and K3's backward must equal
     what the model's structure gives; steps/s with kernels on and off; a torch.profiler
     breakdown of one training step by kernel group.

  9. K4 (fused GN+SiLU+3x3 conv; bf16 on the tensor cores) against its
     plain version, f32 and bf16, plain and AdaGN, output pre-filled with
     NaN, at every (H, C, F) a residual-block half of ``openai_64`` has at
     model batch 16 and at small ragged shapes; bf16 also to a relative
     error per example (K4_BF16_REL), which a planted fault (the weight
     flipped left-right) must fail at every shape; its times in bf16 per
     shape (host-timed, device time by graph and by torch.profiler, the
     statistics launch apart) beside the plain version, the library calls
     (F.group_norm, F.silu, F.conv2d) and the bound, summed over the halves
     of one forward it could stand for. No model calls K4 (as in the JAX
     package): with the counts reset it is then called once in place of each
     such half of one f32 and one bf16 ``openai_64`` forward, on the block's
     own input, parameters and modulation rows, and held against what the
     block computed (these are the launches its entry reports);
 10. the fast-sampling slice: the sampling entry point on
     ``64x64_diffusion.pt``, bf16, CFG, ``--sampler dpm++`` with 20 steps,
     ``--dynamic_thresholding 0.995 --encoder_cache 3 --guidance_interval 0.0
     0.6``, 2 samples of 8 labels; the batches its encoder and decoder saw and
     the K1 and K3 launch counts must equal what the levers' structure gives;
     one more chain with ``--prediction_type v``; images/s with and without
     the cache and the interval, in turns; an f32 chain with the levers,
     kernels on against ``kernels=False``;
 11. training ``openai_128`` (head dims 128, 192 and 256: K2's 32-row tiles):
     every parameter's f32 gradient kernels on against ``kernels=False``, then
     3 ``Trainer.train_step`` calls in bf16 with remat at batch 4, with the
     launch counts the structure gives, steps/s and peak memory;
 11b. ``[wide-heads]``: ``openai_128``'s widths at one head (head dims
     512, 768 and 1024, every attention call on the chunked build) on step
     11's weights: the f32 forward at model batch 8 kernels on against
     ``kernels=False`` (1e-3) and the bf16 one (finite, its distance read),
     the f32 loss and gradients (LOSS_TOL, GRAD_TOL), the sampling entry
     point in custom mode (bf16, a 5-step DDIM chain at batch 2) and one
     bf16 ``Trainer`` step with remat at batch 2, each with its launch counts
     held to the structure;
 12. static int8 (``[int8]``): (a) the int8 conv (s8 x s8 -> s32 wgmma,
     one launch a call, the quantize folded into its stagers) against its
     plain version (exact float64 sums) at every (H, W, C, F, k, stride) one
     int8 forward of ``openai_64`` and of the EMNIST model gives it (found by
     hooks), model batch 16, f32 and bf16 input: s32 sums and outputs
     bit-equal; its bf16 times per call (host-timed, by CUDA graph, by
     torch.profiler), in TOPS, beside the plain version, the bf16 F.conv2d it
     replaces and the bound (bytes over 3.35 TB/s or 2 MACs over 1,979 TOPS),
     summed over one forward, each call's route and tiles logged; the
     ``openai_64`` calls again at model batch 128, bf16, bit-equal and timed
     but for the plain version; (b) the sampling entry point on ``64x64_diffusion.pt`` with
     ``--dtype int8``, CFG 0.8, 25 DDIM steps, 2 requests of 8 labels,
     ``--int8_calibration`` first writing the file (the calibration chain
     drawn through the dynamic path), then reading it: the two runs' images
     bit-equal, the launch counts what the structure gives (every int8 conv
     call through the kernel, K1 and K3 as before); (c) int8 against bf16
     samples/s and the device's idle share at batch 8 and at batch 64
     (model batch 128), kernels on, in turns, and torch.profiler over one
     int8 forward at each must see exactly one int8conv.cu kernel per int8
     conv call (no quantize launch); (d) the max stack (frozen
     int8, encoder_cache 2, guidance_interval (0.1, 0.7)) finite and
     correlated above 0.9 with the exact bf16 chain;
 12b. the bf16 conv (``[conv]``, csrc/bf16conv.cu: bf16 wgmma, one launch
     a call, a fixed order of sums; a TMA producer warpgroup, an mbarrier
     ring, persistent blocks), the conv of every bf16 forward with grad
     mode off (sampling, serving, a teacher's forwards), which replaces cuDNN
     there so that a row's output does not depend on its batch: against its
     plain version within BF16_CONV_TOL at every conv shape and batch of the
     CONV_PATHS (``openai_64`` at model batch 16 and 128, ``openai_128``,
     ``sr256``, a tensor-parallel rank's shards, quality_eval's UNet at its
     three batches), with and without the bias; one example's output bit
     for bit alone and at rows of batches of 8 and 16; the filter tiles' bits
     equal; its times at model batch 16 and 128 beside the plain version,
     cuDNN's bf16 F.conv2d and the bound, with each shape's plan (route,
     filter tile, work units, persistent blocks). Every phase's launch counts hold
     its calls too (``conv``: each Conv2d of a bf16 forward with grad mode
     off);
 13. super-resolution (``[sr]``): the SuperResolutionModel at ``openai_256``
     widths (in_channels 6) with a 64x64 ``low_res``: its f32 forward at
     batch 2, kernels on against ``kernels=False`` (1e-3), then a bf16
     DDIM-25 chain through ``Diffusion.with_model_kwargs(low_res=...)``, its
     K1 and K3 launch counts and its time;
 14. ESRGAN (``[esrgan]``): the sampling entry point with ``--upsample`` on
     ``64x64_diffusion.pt``, 1 request of 4 labels, from a working directory
     whose ``models/RealESRGAN_x4plus.pth`` holds seeded random weights at
     the published width; the 256x256 files, no skip message, the stage's
     seconds per image;
 15. distillation (``[distill]``): (a) the loss and every student-parameter
     gradient of one GuidedDistiller and one ProgressiveDistiller step
     (var_weight 1.0) at ``openai_64`` in f32, batch 2, kernels on against
     ``kernels=False`` (LOSS_TOL, GRAD_TOL); (b) the distillation entry point
     on ``64x64_diffusion.pt``, bf16, ``--distill_guidance 0.8 --rounds 1
     --steps 50 --iterations 4 --batch_size 8 --var_weight 1.0``: the student
     ``.npz`` loads strictly, the sidecar holds 25 steps, guided, the
     teacher's odd indices; K1, K2, K3 and K3's backward launched as the
     structure gives (a guided step: a teacher forward at model batch 16
     without gradient, the student's forward and backward at 8; a halving
     step: two teacher forwards at 8 and the student's); steps/s of each
     stage with kernels on and off, peak memory, a torch.profiler breakdown
     of one step of each; (c) the sampling entry point on the student with
     the printed hint (25 forwards at batch 8 a request) against the
     teacher's CFG chain on the same labels (50 at model batch 16), images/s
     of both;
 16. the serving daemon (``[serve]``): (a) the serving entry point's
     ``build_service`` on ``64x64_diffusion.pt``, bf16, CFG 0.8, DDIM-25,
     serve batch 8, behind its HTTP front end: /healthz, 8 concurrent /sample
     requests of 1 to 3 labels in both encodings (packing, padding, requests
     that wait for a later batch), /stats and a bad request (400); K1 and K3
     launched (batches + warmup) x 25 x their count a forward, the plain
     versions (and cuDNN's conv) refused while it runs; (b) in f32 (TF32
     off), DDIM-10, a request alone and in the last row of a full batch to
     1e-5, that batch bit-equal to ``Diffusion.denoise`` on its start noise
     and step generator and within 1e-3 of ``kernels=False``; the same in
     bf16, bit for bit (max abs 0); (c) ``--dtype int8 --int8_calibration``
     on ``[int8]``'s file, one batch of 8, the int8 conv 25 x 91 a batch, and
     (b)'s position check on that int8 model, bit for bit; (d) samples/s, occupancy and p50/p95
     latency with 8 and 64 closed-loop HTTP clients at serve batch 8 and 64
     (at 64 one repeat, and first one full batch held bit for bit to
     ``Diffusion.denoise``), the counts reset before the clients and read
     after them, beside ``Diffusion.denoise`` in a loop, and the device idle
     share of one served batch and of one library chain at 8; and one served
     f32 batch at serve batch 64 (model batch 128, DDIM-10) within 1e-3 of
     ``kernels=False``;
 16b. the chain's CUDA graphs (``[graph]``): ``Diffusion.denoise`` replaying
     one captured graph a step (the default on the card) against
     ``cuda_graph=False`` at full-width ``openai_64``, bf16, bit for bit:
     DDPM-25 CFG chains at batch 8 and 64, the same at 64 on a frozen int8
     model, DPM++-20 with the encoder cache and the guidance interval, a
     ``winograd=True`` DDIM-10 chain, and one full served batch at serve
     batch 8 and 64 against the eager chain on its x_T and step generator;
     a replayed chain's launches equal the eager chain's (and steps x the
     calls a forward); samples/s and a step's device idle share of both
     modes. Every other phase that samples runs graphed, its launch counts
     exact (a capture's increments taken out, each replay's added);
 17. data parallelism (``[dp]``) at full-width ``openai_64`` on the weights of
     ``64x64_diffusion.pt``: (b) the train entry point through ``python -m
     torch.distributed.run --nproc_per_node 1`` (NCCL for CUDA tensors, 2
     steps at openai_64 widths, bf16, batch 8); then two ranks sharing the
     card over gloo (NCCL refuses two ranks on one device), started by
     ``parallel/dryrun.py::spawn_ranks`` under one timeout: (a)
     ``Trainer(distributed=True)``, remat, dropout 0, global batch 8 as 4 a
     rank, 2 steps in f32 and in bf16, each step held on rank 0 to a
     single-process Trainer on the whole batch (loss and gradient norm to
     LOSS_TOL, every parameter's reduced gradient to GRAD_TOL; f32 gated, bf16
     read); (c) ``scripts/sample.py --data_parallel`` at batch 16, DDIM-10 and
     DDPM-10, f32 and bf16, against the one-rank run at the same seed (f32:
     the saved uint8 images within 1 count; bf16 bit-equal), and each rank's f32
     forward at its model batch of 16 kernels on against ``kernels=False``;
     (d) ``scripts/serve.py --serve_data_parallel`` at serve batch 16: one
     HTTP request against the one-rank daemon (f32, DDIM-10, within 1e-3;
     bf16, DDIM-25, bit-equal) and samples/s of closed-loop clients for one rank
     and for two sharing the card. Each rank's K1, K2, K3 and K3 backward
     launches are held to the structure;
 18. tensor parallelism (``[tp]``) at full-width ``openai_64`` on the weights
     of ``64x64_diffusion.pt``: two gloo ranks sharing the card on a mesh of
     1 x 2 (the Megatron-paired layers' channels halved): (a) the forward at
     model batch 16, f32 held to one process at MODEL_TOL, bf16 read; (b)
     two ``Trainer(mesh=)`` steps (remat, dropout 0, batch 8) in f32, each
     held to a one-process Trainer on the same batch and draws (loss and grad
     norm to LOSS_TOL, every gathered gradient to GRAD_TOL), and in bf16
     (read); the replicated parameters and EMA bit-equal across the ranks;
     the checkpoint gathered whole, loaded strict into one process; (c) each
     rank's K1, K2, K3 and K3-backward launches held to the structure, the
     K3 calls at 16 groups counted apart; (d) the step's wall and device
     busy time and idle share, and the collectives' calls, bytes and seconds
     per forward and per step, read;
 19. the evaluation tools (``[tools]``), each through its entry point's
     ``main`` on the card: (a) ``eval_nll`` on a full-width ``openai_64``
     checkpoint of seeded random weights written as ``64x64_diffusion.pt``
     (the preset's model: 1000 classes, guidance off), bf16, 2 batches of 8:
     finite numbers, 25 chain steps, 16 images, 50 forwards' K1 and K3
     launches; its evaluation again in f32 with injected noise, kernels on
     against ``kernels=False``, total and prior bits/dim within 1e-3
     relative; (b) ``verify_checkpoint`` on that file: every executed check
     passes, 295,904,454 parameters, exit 0, the 2-step smoke sample's
     launches; the file with one tensor dropped: exit 1, "missing 1"; (c)
     ``quality_eval`` at its EMNIST harness in bf16 (100 + 20 training
     steps, 128 images a mode in two chunks, a 50-step chain, modes enc, gi,
     int8 and their max stack): every mode's line with the JAX tool's keys,
     finite, exact 0 from itself and every lever above 0, and K1, K2, K3,
     K3's backward and the int8 conv launched as the UNet's and the
     classifier's structure gives (training steps, every chain's encoder and
     decoder calls, the calibration, the classifier's logits). Steps 3, 6,
     6b and 12a also hold the kernels at the harness's shapes: its UNet at
     batch 256 in bf16 (and its int8 convs at model batch 256), its
     classifier at batch 256 in f32, whose GroupNorms hold 1 and 2 channels
     a group;
 20. ``[conv-cover]``: every (shape, batch, bias) the bf16 conv launched at
     in the run, the ``[dp]`` and ``[tp]`` ranks' included, that ``[conv]``
     did not hold, against its plain version at BF16_CONV_TOL.

Each kernel's time stands beside its bound: the larger of the bytes it must
move over 3.35 TB/s and its operations over the card's peak for their type
(989 TFLOP/s for bf16 products, 1,979 TOPS for int8 ones, 67 TFLOP/s for
f32 work, which the kernels do without TF32).

Then ranks the kernels by their device time against the library's (rule 2),
both sides read by torch.profiler, the CUDA graph's factor beside it, prints
a JSON line describing the kernels, then, as the last line,
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
so does a machine without a CUDA card. Imports nothing of JAX.
"""

import collections
import contextlib
import functools
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

F32_TOL = {"attention": dict(atol=2e-5, rtol=0), "groupnorm": dict(atol=1e-5, rtol=0)}
# bf16 GN outputs reach ~10, where one bf16 ulp is 0.06: the JAX package's
# bf16 GN gate carries rtol 1e-2 (tests/test_pallas.py:206)
BF16_TOL = {"attention": dict(atol=3e-2, rtol=0), "groupnorm": dict(atol=3e-2, rtol=1e-2)}
# K2: the f32 gate is K1's with |g| <= 1; bf16 results are rounded once more
# than K1's (ds before its products), hence the relative part
K2_F32_TOL = dict(atol=2e-5, rtol=0)
K2_BF16_TOL = dict(atol=3e-2, rtol=2e-2)
# K2 in bf16, beside K2_BF16_TOL: per element, that gate is about the size of a
# typical gradient element at N = 1024 (|g| <= 1, unit logits), so an error in
# proportion to the output can pass it. This gate scales with the output: the
# relative Frobenius error of each of dq, dk and dv in each (example, head)
# (k2_rel_err). An lse handed over 0.05 too high scales every p by 0.95 and
# reads about 0.05
K2_BF16_REL = 1e-2
# K4: the JAX package's f32 gate (tests/test_pallas_resblock.py:49). In bf16 the
# output is rounded once to bf16, one ulp of which is 0.03 for |out| in [4, 8);
# beyond that the relative part covers it
K4_F32_TOL = dict(atol=2e-5, rtol=2e-5)
K4_BF16_TOL = dict(atol=3e-2, rtol=1e-2)
# K4 in bf16, beside K4_BF16_TOL, whose fixed atol can hide an error in
# proportion to the output wherever the outputs are small: the relative
# Frobenius error of each example's output (k4_rel_err). The weight flipped
# left-right, what a halo shifted the wrong way gives, must fail it
K4_BF16_REL = 1e-2
# K3 and its backward in bf16, beside BF16_TOL["groupnorm"]: the relative
# Frobenius error of each example's output (of each output of the backward,
# the parameters' gradients as one) (k3_rel_err). The scale handed over 5% high
# (the forward) and the rstd handed over 5% high (the backward) must fail it
K3_BF16_REL = 1e-2
# the bf16 conv against its plain version: the same exact products summed in
# f32 in another order, each side rounded to bf16 before and after the bias,
# so an element may differ by a bf16 ulp of the sum and one of the output: at
# most two ulps of the output's largest magnitude, 2^-6 of it
BF16_CONV_TOL = 2.0 ** -6
# K1 and K2 at head dims between two builds (each runs on the next one up)
BETWEEN_BUILDS = (24, 48, 96)
# K1, K2 and K5 at head dims above 256 (the chunked build), each at one N:
# (head dim, N); 2 heads, so the two layouts differ. In bf16 N = 1200 (above
# the P-resident route's limit of 1152) runs the walk, the others the
# resident route
ABOVE_256 = ((257, 65), (300, 100), (320, 17), (384, 256), (512, 1024), (768, 64), (1024, 1024),
             (384, 1200))
# [wide-heads]: openai_128's widths at one head (head dims 512, 768, 1024)
WIDE_BATCH = 8  # the f32 and bf16 forwards' model batch
WIDE_TRAIN_BATCH = 2  # the Trainer step's and the sampling entry point's batch
WIDE_STEPS = 5  # the entry point's DDIM chain
MODEL_TOL = 1e-3
GRAD_TOL = 1e-3  # max |dgrad| <= GRAD_TOL * max |grad|, per parameter
LOSS_TOL = 1e-4  # |dloss| <= LOSS_TOL * max(1, |loss|)
SEED = 0
TRAIN_BATCH = 8
DP_WORLD = 2  # [dp]'s ranks on the one card: a rank trains on TRAIN_BATCH // DP_WORLD rows
TP_WORLD = 2  # [tp]'s model axis: two ranks sharing the card, each with half the channels
EMNIST_BATCH = 468  # the train entry point's recipe
GUIDED_BATCH = 4  # the classifier-guided openai_128 slice, and openai_128 training
FAST_BATCH = 8  # labels a chain of the fast-sampling slice
SR_BATCH = 2  # the super-resolution slice: images a chain
SR_LOW = 64  # its low-res input, upsampled 4x to openai_256's 256
# tools/quality_eval.py's batch: its training steps (the UNet's and the
# classifier's), its classifier's logits, and its sampling chunks of 128
# labels doubled by CFG
QE_BATCH = 256
HBM_BYTES_PER_S = 3.35e12
PROFILER_TRIES = 8  # profiled_ms: tries before a run with no device time fails
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def log(*args):
    print(*args, flush=True)


_PHASE_T0 = [time.perf_counter()]


def phase_done(name):
    """Log the wall seconds since the previous phase ended."""
    now = time.perf_counter()
    log(f"[time] {name}: {now - _PHASE_T0[0]:.1f} s")
    _PHASE_T0[0] = now


def time_ms(fn, iters=20, rounds=5):
    """Host-timed length of one call: CUDA events around ``iters``
    back-to-back calls, divided by ``iters``; the median of ``rounds`` such
    runs. A call shorter than its host-side launch cost is timed at the
    launch rate (``graph_ms`` gives its device time)."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)


def graph_ms(fn, iters=10, rounds=3):
    """Device time of one call: a CUDA graph of ``iters`` calls, captured
    after a warm-up on a side stream and replayed between CUDA events,
    divided by ``iters``; the median of ``rounds`` replays. Free of the
    host's launch cost, which sets ``time_ms`` for calls under about 40 us."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(per_call)


def profiled_ms(fn, iters=10, by_name=False):
    """Device time of one call by torch.profiler: the summed device time of
    the kernels that ``iters`` calls ran, divided by ``iters``. Unlike a CUDA
    graph replay it leaves out the gaps between launches, and it can read the
    library's autograd backward, which runs on autograd's own thread and
    which a graph cannot hold. With ``by_name`` also returns a dict of each
    kernel's share, by the profiler's kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a profiled run now and then records no device activity at all, up to three
    # in a row in one run of this script: up to seven more, each after a pause
    for attempt in range(PROFILER_TRIES):
        if attempt:
            time.sleep(0.1 * attempt)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        names = {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)}
        total = sum(names.values())
        if total > 0:
            if attempt:
                log(f"[profile] torch.profiler recorded device time at try {attempt + 1}")
            return (total, names) if by_name else total
    raise AssertionError(f"torch.profiler recorded no device time in {PROFILER_TRIES} tries")


def within(out, ref, tol):
    """Whether every element of ``out`` is finite and within atol + rtol*|ref|."""
    out, ref = out.float(), ref.float()
    return bool(torch.isfinite(out).all()
                and ((out - ref).abs() <= tol["atol"] + tol["rtol"] * ref.abs()).all())


def check(name, out, ref, tol):
    """max |out - ref|; raises if any element is outside atol + rtol*|ref|."""
    err = (out.float() - ref.float()).abs().max().item()
    if not within(out, ref, tol):
        raise AssertionError(f"{name}: max abs err {err:.3g} over {tol}")
    return err


def k2_rel_err(out, ref, heads, split_first):
    """The largest ||out - ref||_F / ||ref||_F over dq, dk and dv of every
    (example, head) of two (B, N, 3C) gradients laid out as their qkv."""
    from nicediffusion_tpu_torch.ops.kernels.attention import split_qkv

    worst = 0.0
    for o, r in zip(split_qkv(out.float(), heads, split_first),
                    split_qkv(ref.float(), heads, split_first)):
        rel = torch.linalg.vector_norm(o - r, dim=(2, 3)) / torch.linalg.vector_norm(r, dim=(2, 3))
        if not torch.isfinite(rel).all():
            return math.inf
        worst = max(worst, rel.max().item())
    return worst


def k3_rel_err(out, ref):
    """||out - ref||_F / ||ref||_F, the largest over the examples (dim 0) of a
    batched output, over the whole of a (C,) parameter gradient."""
    out, ref = out.double(), ref.double()
    if out.ndim == 1:
        rel = torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref)
    else:
        dims = tuple(range(1, out.ndim))
        rel = (torch.linalg.vector_norm(out - ref, dim=dims)
               / torch.linalg.vector_norm(ref, dim=dims))
    return rel.max().item() if torch.isfinite(rel).all() else math.inf


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return smi


# libraries whose bf16 kernels run on the tensor cores: each build log must
# name a wgmma instantiation, none may spill, and the machine code must hold
# warpgroup multiplies (HGMMA)
WGMMA_LIBS = {"attention": "K1/K5", "attention_bwd": "K2", "resblock": "K4",
              "int8conv": "the int8 conv", "bf16conv": "the bf16 conv",
              "winograd": "the Winograd conv"}
# the warpgroup multiplies each library must hold in its machine code: bf16
# ones (HGMMA), or for the int8 conv any integer one, whatever mnemonic
# cuobjdump prints for it (IGMMA on CUDA 12.8)
GMMA_SASS = {"attention": r"HGMMA", "attention_bwd": r"HGMMA", "resblock": r"HGMMA",
             "int8conv": r"(?!HGMMA|QGMMA)[A-Z]*GMMA", "bf16conv": r"HGMMA", "winograd": r"HGMMA"}
# libraries with no tensor-core kernel, none of whose instantiations may spill
# (no HGMMA gate applies to them)
NO_SPILL_LIBS = {"groupnorm": "K3"}
_ENTRY = re.compile(
    r"Compiling entry function '\S*?(attention_fwd_resident_wgmma|attention_bwd_resident_wgmma|"
    r"attention_bwd_delta|attention_fwd_chunked_wgmma|attention_fwd_chunked|"
    r"attention_bwd_dq_chunked_wgmma|attention_bwd_dkv_chunked_wgmma|attention_bwd_dq_chunked|"
    r"attention_bwd_dkv_chunked|attention_fwd_wgmma|attention_fwd|attention_bwd_dq_wgmma|"
    r"attention_bwd_dkv_wgmma|attention_bwd_dq|attention_bwd_dkv|gn_silu_conv3x3_wgmma|"
    r"gn_silu_conv3x3|group_stats|group_norm_fwd|group_norm_bwd|int8_conv_halo_wgmma|"
    r"int8_conv_row_wgmma|bf16_conv_halo_wgmma|bf16_conv_row_wgmma|winograd_conv_cluster_wgmma)"
    r"_kernel(I\S+|\S*)'")
_INT8_TYPES = {"0": "f32", "1": "bf16", "2": "s8"}


def build_report(name, nvcc_log):
    """The ptxas lines of one library's nvcc log (-Xptxas -v: "Compiling
    entry function '<mangled>'", a spill line, then "Used N registers" for
    each template instance), one line per kernel instance. Raises if a
    tensor-core (wgmma) instance spills, or if a library of WGMMA_LIBS names
    no wgmma instance, whose spills would then go unchecked; for a library
    of NO_SPILL_LIBS, if any instance spills or the log names none."""
    lines = []
    entry = spills = ""
    wgmma = False
    gated = name in NO_SPILL_LIBS
    checked = 0  # instantiations whose spills were read and gated
    for line in nvcc_log.splitlines():
        m = _ENTRY.search(line)
        if m:
            wgmma = m.group(1).endswith("wgmma")
            dt = "bf16" if wgmma or "bfloat16" in m.group(2) else "f32"
            dims = re.findall(r"Li(\d+)E", m.group(2))  # head dim, f32 own-tile rows; K4's NB
            if m.group(1).startswith("int8_conv"):  # <x type, 64-filter blocks>
                entry = (f"{m.group(1)} s8 x={_INT8_TYPES.get(dims[0], dims[0])}"
                         + (f" filters={64 * int(dims[1])}" if len(dims) > 1 else ""))
            elif m.group(1) == "winograd_conv_cluster_wgmma":  # <filter tile>
                entry = (f"{m.group(1)} bf16 filters={dims[0]}: 4 positions a block of a "
                         f"cluster of 4, 2 x m64n{dims[0]} a consumer")
            elif m.group(1).startswith("bf16_conv"):  # <64-filter blocks>
                entry = f"{m.group(1)} bf16" + (f" filters={64 * int(dims[0])}" if dims else "")
            elif m.group(1) == "gn_silu_conv3x3_wgmma":
                entry = f"{m.group(1)} {dt}" + (f" filters={64 * int(dims[0])}" if dims else "")
            elif m.group(1).startswith("group_norm"):
                entry = f"{m.group(1)} {dt}" + (f" vector={dims[0]}" if dims else "")
            elif "_resident" in m.group(1):  # head dims above 256, N <= 1152
                entry = f"{m.group(1)} bf16 P in shared memory, TMA producer"
            elif m.group(1) == "attention_bwd_delta":
                entry = f"{m.group(1)} bf16 in, f32 sums"
            elif "_chunked" in m.group(1):  # <output columns a block>: head dims above 256
                entry = f"{m.group(1)} {dt}" + (f" chunk={dims[0]}" if dims else "")
            else:
                entry = f"{m.group(1)} {dt}" + (f" hc={dims[0]}" if dims else "") + (
                    f" rows={dims[1]}" if len(dims) > 1 else "")
            exact = re.search(r"Lb([01])E", m.group(2))  # K2: the head dim is hc
            if m.group(1).startswith("attention_bwd") and exact:
                entry += " exact" if exact.group(1) == "1" else " (head dim below hc)"
            if (m.group(1) == "attention_bwd_dkv_wgmma" and dims and int(dims[0]) > 128
                    or m.group(1) == "attention_bwd_dkv_chunked_wgmma"):
                entry += " (dV and dK in separate blocks)"
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            lines.append(f"{entry}: {line.split(':', 1)[1].strip()}; {spills}")
            # a tensor-core kernel that spills holds its accumulators in local
            # memory; K3's keep their sums and coefficients in registers
            if (wgmma or gated) and not re.search(r"\b0 bytes spill stores", spills):
                raise AssertionError(f"{name}: {entry} spills: {spills}")
            checked += wgmma or gated
        elif "Function properties" in line:
            continue
        elif "wgmma" in line or "Performance Loss" in line:
            lines.append(f"ptxas: {line.strip()}")
    if name in WGMMA_LIBS and checked == 0:
        raise AssertionError(f"the {name} build log names no wgmma instantiation: its "
                             "spills were not checked")
    if gated and checked == 0:
        raise AssertionError(f"the {name} build log names no {NO_SPILL_LIBS[name]} "
                             "instantiation: its spills were not checked")
    return lines


def int8_sass_by_instance(sass):
    """The integer warpgroup multiplies in the machine code of each int8 conv
    instance (cuobjdump -sass prints a "Function : <mangled>" line before
    each), by route, input type and filter tile."""
    counts, current = collections.Counter(), None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*?(int8_conv_(?:halo|row)_wgmma)_kernelILi(\d)ELi(\d)E", line)
        if m:
            current = (f"{m.group(1)} s8 x={_INT8_TYPES.get(m.group(2), m.group(2))} "
                       f"filters={64 * int(m.group(3))}")
            counts[current] += 0
        elif current and re.search(rf"\b({GMMA_SASS['int8conv']})\.", line):
            counts[current] += 1
    return counts


# what the machine code of every bf16 conv instance must hold: warpgroup
# multiplies, TMA loads (its producer's tensor-map loads) and setmaxnreg
# (the producer's registers handed to the consumers)
BF16_CONV_SASS = ("HGMMA", "UTMALDG", "USETMAXREG")


def sass_by_instance(sass, pattern, name):
    """The BF16_CONV_SASS instructions in the machine code of each kernel
    whose "Function : <mangled>" line (cuobjdump -sass prints one before
    each) matches ``pattern``, keyed by ``name(match)``."""
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            m = re.search(pattern, line)
            current = name(m) if m else None
            if current:
                counts[current] = collections.Counter({op: 0 for op in BF16_CONV_SASS})
        elif current:
            for op in BF16_CONV_SASS:
                if re.search(rf"\b{op}\b", line):
                    counts[current][op] += 1
    return counts


def bf16_sass_by_instance(sass):
    """Each bf16 conv instance's counts, by route and filter tile."""
    return sass_by_instance(sass, r"(bf16_conv_(?:halo|row)_wgmma)_kernelILi(\d)E",
                            lambda m: f"{m.group(1)} bf16 filters={64 * int(m.group(2))}")


def winograd_sass_by_instance(sass):
    """Each Winograd conv instance's counts, by filter tile."""
    return sass_by_instance(sass, r"(winograd_conv_cluster_wgmma)_kernelILi(\d+)E",
                            lambda m: f"{m.group(1)} bf16 filters={m.group(2)}")


# the Winograd conv's instances: a filter tile of 64 and one of 128
WINOGRAD_INSTANCES = 2


# the P-resident attention kernels (head dims above 256): one in each of the
# attention libraries, each a TMA producer handing its registers over
RESIDENT_KERNELS = {"attention": "attention_fwd_resident_wgmma",
                    "attention_bwd": "attention_bwd_resident_wgmma"}


def resident_sass_by_instance(sass):
    """Each P-resident attention kernel's counts."""
    return sass_by_instance(sass, r"(attention_(?:fwd|bwd)_resident_wgmma)_kernel",
                            lambda m: m.group(1))


def phase_build():
    from nicediffusion_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    cuda_s = time.perf_counter() - t0
    for name, (nvcc_log, seconds) in _build.build_logs().items():
        gate = (f"; no wgmma here: no HGMMA gate, and no instantiation may spill"
                if name in NO_SPILL_LIBS else "")
        log(f"[build] {name}: " + (f"nvcc {seconds:.2f} s" if seconds else
                                   "cached build, with its nvcc log") + gate)
        for line in build_report(name, nvcc_log):
            log(f"[build]   {line}")
    # the bf16 kernels and the int8 conv must run on the tensor cores: count
    # the warpgroup multiplies (HGMMA; the integer ones for the int8 conv) in
    # each library's machine code
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for name, kernels in WGMMA_LIBS.items():
        sass = subprocess.run([cuobjdump, "-sass", str(_build.build(name)[0])],
                              capture_output=True, text=True, check=True).stdout
        found = collections.Counter(re.findall(rf"\b({GMMA_SASS[name]})\.", sass))
        log(f"[build] {name} library: {sum(found.values())} warpgroup multiplies in its SASS "
            f"{dict(found)}")
        if name == "int8conv":
            for instance, count in int8_sass_by_instance(sass).items():
                log(f"[build]   {instance}: {count} IGMMA")
        if name in RESIDENT_KERNELS:
            instances = resident_sass_by_instance(sass)
            for instance, ops in instances.items():
                log(f"[build]   {instance} (P in shared memory): " + ", ".join(
                    f"{ops[op]} {op}" for op in BF16_CONV_SASS))
                if not all(ops.values()):
                    raise AssertionError(f"{instance} lacks {[op for op in BF16_CONV_SASS if not ops[op]]}"
                                         " in its machine code: no TMA producer or no register "
                                         "handover")
            if list(instances) != [RESIDENT_KERNELS[name]]:
                raise AssertionError(f"the {name} library holds the P-resident kernels "
                                     f"{list(instances)}, not {RESIDENT_KERNELS[name]}")
        if name == "bf16conv":
            instances = bf16_sass_by_instance(sass)
            for instance, ops in instances.items():
                log(f"[build]   {instance}: " + ", ".join(f"{ops[op]} {op}"
                                                           for op in BF16_CONV_SASS))
                if not all(ops.values()):
                    raise AssertionError(f"the bf16 conv's {instance} lacks "
                                         f"{[op for op in BF16_CONV_SASS if not ops[op]]} in its "
                                         "machine code: no TMA producer or no register handover")
            if len(instances) != 6:
                raise AssertionError(f"the bf16 conv library holds {len(instances)} kernel "
                                     "instances, not 6 (two routes x three filter tiles)")
        if name == "winograd":
            instances = winograd_sass_by_instance(sass)
            for instance, ops in instances.items():
                log(f"[build]   {instance}: " + ", ".join(f"{ops[op]} {op}"
                                                           for op in BF16_CONV_SASS))
                if not all(ops.values()):
                    raise AssertionError(f"the Winograd conv's {instance} lacks "
                                         f"{[op for op in BF16_CONV_SASS if not ops[op]]} in its "
                                         "machine code: no TMA producer or no register handover")
            if len(instances) != WINOGRAD_INSTANCES:
                raise AssertionError(f"the Winograd conv library holds {len(instances)} kernel "
                                     f"instances, not {WINOGRAD_INSTANCES} (filter tiles 64, 128)")
        if not found:
            raise AssertionError(f"the {name} library holds no {GMMA_SASS[name]} instruction: "
                                 f"{kernels} is off the tensor cores")
    log(f"[build] K1, K2, K3, K4, the int8 conv, the bf16 conv and the Winograd conv ready in "
        f"{cuda_s:.2f} s (built side by side)")


def main_path_calls(model, dev):
    """Every GroupNorm and attention call of one forward of ``model``, as
    a Counter of call keys -> calls per forward. ``model`` runs with
    ``kernels=False``, so this launches no kernel."""
    from nicediffusion_tpu_torch.models.classifier import AttentionPool
    from nicediffusion_tpu_torch.models.unet import (
        AttentionBlock,
        DiffusionModel,
        GroupNormOp,
        SuperResolutionModel,
    )

    calls = collections.Counter()

    def gn_hook(mod, args):
        calls[("groupnorm", tuple(args[0].shape[1:]), mod.mode)] += 1

    def attn_hook(mod, args):
        _, h, w, c = args[0].shape
        calls[("attention", h * w, c, mod.heads, mod.split_qkv_first)] += 1

    def pool_hook(mod, args):  # tokens [mean | x], always the [q|k|v] layout
        _, h, w, c = args[0].shape
        calls[("attention", h * w + 1, c, mod.heads, True)] += 1

    hooks = [m.register_forward_pre_hook(gn_hook) for m in model.modules()
             if isinstance(m, GroupNormOp)]
    hooks += [m.register_forward_pre_hook(attn_hook) for m in model.modules()
              if isinstance(m, AttentionBlock)]
    hooks += [m.register_forward_pre_hook(pool_hook) for m in model.modules()
              if isinstance(m, AttentionPool)]
    x = torch.zeros(1, model.resolution, model.resolution, model.in_channels, device=dev)
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    with torch.inference_mode():
        if isinstance(model, SuperResolutionModel):  # the image and its low-res version
            x = x[..., :model.in_channels // 2]
            model(x, zero, low_res=torch.zeros(1, SR_LOW, SR_LOW, x.shape[-1], device=dev),
                  y=zero)
        elif isinstance(model, DiffusionModel):
            model(x, zero, zero)
        else:
            model(x, zero)
    for h in hooks:
        h.remove()
    return calls


def attention_bound_ms(b, n, c, tensors, products, dtype=torch.bfloat16):
    """(bytes ms, operations ms) of an attention kernel: ``tensors``
    (B, N, C)-sized tensors each moved once, ``products`` N x N x hc matrix
    products per head, at the tensor cores' peak in bf16 and at the f32 peak
    outside them in f32 (the f32 gate leaves no room for TF32)."""
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    return (tensors * b * n * c * dtype.itemsize / HBM_BYTES_PER_S * 1e3,
            products * 2 * b * n * n * c / peak * 1e3)


def groupnorm_bound_ms(b, h, w, c, dtype=torch.bfloat16):
    """(bytes ms, operations ms) of GroupNorm(+AdaGN)(+SiLU): x read and the
    output written once; about 12 f32 operations an element (statistics,
    normalise, affine, modulation, sigmoid) on the CUDA cores."""
    elems = b * h * w * c
    return (2 * elems * dtype.itemsize / HBM_BYTES_PER_S * 1e3,
            12 * elems / F32_FLOPS * 1e3)


class Tally:
    """Times summed over the calls of one forward or one step: host-timed
    (``time_ms``, back-to-back calls) and in device time read two ways: a CUDA
    graph replay (``graph_ms``; for the library's autograd backward, which a
    graph cannot hold, ``profiled_ms``) and torch.profiler (``profiled_ms``)
    for the kernel and its library call."""

    def __init__(self):
        self.ms = self.plain_ms = self.library_ms = 0.0
        self.device_ms = self.device_plain_ms = self.device_library_ms = 0.0
        self.profiler_ms = self.profiler_library_ms = 0.0
        self.bytes_ms = self.ops_ms = self.bound_ms = 0.0

    def add(self, count, ms, plain_ms, library_ms, bound, device, profiled):
        self.ms += count * ms
        self.plain_ms += count * plain_ms
        self.library_ms += count * library_ms
        self.device_ms += count * device[0]
        self.device_plain_ms += count * device[1]
        self.device_library_ms += count * device[2]
        self.profiler_ms += count * profiled[0]
        self.profiler_library_ms += count * profiled[1]
        self.bytes_ms += count * bound[0]
        self.ops_ms += count * bound[1]
        self.bound_ms += count * max(bound)

    @property
    def bound_by(self):
        return "bytes" if self.bytes_ms >= self.ops_ms else "operations"

    def fields(self):
        # a path whose plain version was not timed (its sums stay 0) reads null
        timed = self.plain_ms > 0 or self.device_plain_ms > 0
        return {"ms": self.ms, "plain_ms": self.plain_ms if timed else None,
                "bound_ms": self.bound_ms, "bound_by": self.bound_by,
                "library_ms": self.library_ms, "device_ms": self.device_ms,
                "device_plain_ms": self.device_plain_ms if timed else None,
                "device_library_ms": self.device_library_ms,
                "device_profiler_ms": self.profiler_ms,
                "device_profiler_library_ms": self.profiler_library_ms}

    def __str__(self):
        return (f"host-timed {self.ms:.4f} ms, plain {self.plain_ms:.4f} ms, library "
                f"{self.library_ms:.4f} ms; device time by graph {self.device_ms:.4f} ms, plain "
                f"{self.device_plain_ms:.4f} ms, library {self.device_library_ms:.4f} ms; by "
                f"torch.profiler {self.profiler_ms:.4f} ms, library "
                f"{self.profiler_library_ms:.4f} ms; bound {self.bound_ms:.4f} ms "
                f"({self.bound_by})")


def library_group_norm(x, sc, bi, es, esh, mode, groups=32):
    """The PyTorch calls that compute K3's function: F.group_norm on the
    channels-last view, then F.silu (and the AdaGN modulation between)."""
    y = F.group_norm(x.permute(0, 3, 1, 2), groups, sc, bi, 1e-5)
    if mode == "ada":
        y = y * (1.0 + es[:, :, None, None]) + esh[:, :, None, None]
    return y if mode == "plain" else F.silu(y)


def gn_key(key):
    """(h, w, c, mode, groups) of a GroupNorm call key: ``("groupnorm", (h,
    w, c), mode)`` at 32 groups, or with a fourth element, the groups of a
    tensor-parallel shard (``tp_path_calls``)."""
    _, (h, w, c), mode, *groups = key
    return h, w, c, mode, groups[0] if groups else 32


def modulation_rows(g, dev, dtype, b, c, groups):
    """AdaGN's (B, C) scale and shift rows as the model hands them to K3:
    the two halves of a (B, 2C) step embedding; for a shard at ``groups`` <
    32 (a model axis of tp = 32 // groups), the last rank's channels of a
    (B, 2 C tp) embedding, views at an offset into the rows."""
    tp = 32 // groups
    emb = (0.1 * torch.randn(b, 2, c * tp, generator=g, device=dev)).to(dtype)
    emb = emb[..., (tp - 1) * c:]
    return emb[:, 0], emb[:, 1]


# where a kernel call comes from: (batch, the path's compute type, basis of the sums)
PATHS = {
    "forward": (16, torch.bfloat16, "one openai_64 sampling forward at model batch 16"),
    "train": (TRAIN_BATCH, torch.bfloat16,
              f"one forward of an openai_64 training step at batch {TRAIN_BATCH}"),
    "emnist": (EMNIST_BATCH, torch.float32,
               f"one forward of the train entry point's EMNIST recipe at batch {EMNIST_BATCH}"),
    "unet128": (GUIDED_BATCH, torch.bfloat16,
                f"one openai_128 sampling forward at batch {GUIDED_BATCH}"),
    "cls128": (GUIDED_BATCH, torch.bfloat16,
               f"one forward of the openai_128 classifier at batch {GUIDED_BATCH}"),
    "sr256": (SR_BATCH, torch.bfloat16,
              f"one forward of the super-resolution UNet at openai_256 widths at batch "
              f"{SR_BATCH}"),
    "serve64": (128, torch.bfloat16,
                "one openai_64 forward of the daemon at serve batch 64 (model batch 128 "
                "under CFG)"),
    "dp_train": (TRAIN_BATCH // DP_WORLD, torch.bfloat16,
                 f"one forward of a data-parallel openai_64 training step on one of "
                 f"{DP_WORLD} ranks, {TRAIN_BATCH // DP_WORLD} rows a rank"),
    "tp": (16, torch.bfloat16,
           f"the channel-sharded out_norm calls of one openai_64 forward on one of {TP_WORLD} "
           f"tensor-parallel ranks at model batch 16 (C/{TP_WORLD} channels, "
           f"{32 // TP_WORLD} groups)"),
    "tp_train": (TRAIN_BATCH, torch.bfloat16,
                 f"the channel-sharded out_norm calls of a tensor-parallel openai_64 training "
                 f"step on one of {TP_WORLD} ranks at batch {TRAIN_BATCH}"),
    "qe_unet": (QE_BATCH, torch.bfloat16,
                f"one forward of quality_eval's UNet (EMNIST widths, 28 classes) at batch "
                f"{QE_BATCH}: a training step's, or a sampling step's at model batch {QE_BATCH} "
                f"under CFG"),
    "qe_cls": (QE_BATCH, torch.float32,
               f"one forward of quality_eval's classifier (f32; 32 and 64 channels in 32 "
               f"groups) at batch {QE_BATCH}"),
    "qe_int8": (QE_BATCH, torch.bfloat16,
                f"one int8 forward of quality_eval's UNet at model batch {QE_BATCH} (int8 "
                f"convs only)"),
    "verify64": (1, torch.float32,
                 "one openai_64 forward of verify_checkpoint's 2-step smoke sample at batch 1 "
                 "(guidance off)"),
    "qe_calib": (16, torch.bfloat16,
                 "one forward of quality_eval's UNet in its int8 calibration (8 labels under "
                 "CFG: model batch 16)"),
    "qe_gi": (QE_BATCH // 2, torch.bfloat16,
              f"one forward of quality_eval's UNet outside the guidance interval (a chunk of "
              f"{QE_BATCH // 2} labels, unguided)"),
    "qe_int8_gi": (QE_BATCH // 2, torch.bfloat16,
                   f"one int8 forward of quality_eval's UNet outside the guidance interval of "
                   f"its max stack at model batch {QE_BATCH // 2} (int8 convs only)"),
    "int8_serve": (128, torch.bfloat16,
                   "one openai_64 int8 sampling forward at batch 64 (model batch 128 under CFG; "
                   "int8 convs only)"),
    "wide128": (WIDE_BATCH, torch.bfloat16,
                f"the attention calls of one openai_128 forward at num_heads=1 (head dims 512, "
                f"768, 1024: the chunked build) at model batch {WIDE_BATCH}"),
    "wide128_train": (WIDE_TRAIN_BATCH, torch.bfloat16,
                      f"the attention calls of one openai_128 training step at num_heads=1 at "
                      f"batch {WIDE_TRAIN_BATCH}"),
}
# paths held against the plain version at their shapes and batch, not timed:
# the batches the tools give a model beside those of the timed paths (the
# int8 conv plans its tiles from the batch)
CHECKED_PATHS = ("verify64", "qe_calib", "qe_gi", "qe_int8_gi")
GUIDED_PATHS = ("unet128", "cls128")
# where K5 is held and timed as views of the projection, and called directly
# in place of K1 (no model calls it): the guided slice's models, and
# openai_128 at one head (the chunked build)
K5_PATHS = (*GUIDED_PATHS, "wide128")
# unet128: openai_128 training
K2_PATHS = ("train", "emnist", "cls128", "unet128", "dp_train", "qe_unet", "qe_cls",
            "wide128_train")
# the chunked build's output columns a block (csrc/attention.cu: kChunk;
# attention_bwd.cu: kChunkBf16, kChunkF32)
FWD_CHUNK = 256
BWD_CHUNK = {torch.bfloat16: 256, torch.float32: 128}


def recompute_factor(kernel, hd, dtype, n=None, pairs=None):
    """The matrix products an attention kernel makes over the fewest its
    function needs (K1 2, K2 5), from the head dim and, above 256 in bf16,
    the route the plan picks from N (and its split from the (batch, head)
    pairs): 1 below 257. The walk makes the products over all of D again for
    every output chunk: K1 S once per chunk and P V once in all; K2 S and dP
    for each chunk of dQ and of dK, S for each of dV (bf16: separate blocks)
    or S and dP for each chunk of dK and dV together (f32), and dQ, dK and dV
    once in all. The P-resident route makes K1's S once a (query tile, key
    tile) pair, K2's S three times and dP twice (dq, dk and dv blocks), each
    once more for every further part of a split."""
    if hd <= 256:
        return 1.0
    from nicediffusion_tpu_torch.ops.kernels import attention as k1

    if dtype == torch.bfloat16 and n is not None:
        plan = k1.chunked_attention_plan(n, hd, pairs, kernel)
        if plan["route"] == "resident":
            s = plan["split"]
            return (s + 1) / 2 if kernel == "K1" else (5 * s + 3) / 5
    if kernel == "K1":
        return (-(-hd // FWD_CHUNK) + 1) / 2
    chunks = -(-hd // BWD_CHUNK[dtype])
    per_chunk = 5 if dtype == torch.bfloat16 else 4
    return (per_chunk * chunks + 3) / 5


def route_of(kernel, n, hd, pairs, dtype):
    """'route (split s)' of an attention call above head dim 256."""
    from nicediffusion_tpu_torch.ops.kernels import attention as k1

    if dtype != torch.bfloat16:
        return "walk (f32)"
    plan = k1.chunked_attention_plan(n, hd, pairs, kernel)
    return f"{plan['route']} (split {plan['split']})"


def library_kernel(fn):
    """The kernel that takes most of the device time of ``fn`` (a library
    call) by torch.profiler: which backend it picked."""
    _, names = profiled_ms(fn, iters=3, by_name=True)
    name = max(names, key=names.get)
    return name if len(name) <= 90 else name[:87] + "..."


def rate(key, b, ms, bound):
    """', X TFLOP/s, Y% of bound' for an attention call (its two products,
    2 N^2 C flops each), '' for any other kernel."""
    if key[0] != "attention":
        return ""
    _, n, c, _, _ = key
    return (f", {4 * b * n * n * c / ms / 1e9:.2f} TFLOP/s, "
            f"{100 * max(bound) / ms:.1f}% of bound")


def check_mha(name, qkv, heads, split_first, dtype, tol):
    """K5 on strided views of ``qkv`` and on contiguous copies of them,
    against its plain version; the output pre-filled with NaN. Returns
    (max abs err, the views)."""
    from nicediffusion_tpu_torch.ops.kernels import attention as k1

    views = k1.split_qkv(qkv, heads, split_first)
    err = 0.0
    for q, k, v in (views, tuple(t.contiguous() for t in views)):
        out = torch.full(q.shape, float("nan"), dtype=dtype, device=q.device)
        k1.mha_attention(q, k, v, out=out)
        torch.cuda.synchronize()
        if torch.isnan(out).any():
            raise AssertionError(f"{name} {dtype}: output elements left unwritten")
        err = max(err, check(f"{name} {dtype}", out, k1.mha_attention_plain(q, k, v), tol))
    return err, views


def phase_kernels(dev, paths):
    """K1, K3 and K5 against their plain versions at every shape the main
    paths give them (``paths``: name in PATHS -> calls of one forward;
    sampling at model batch 16: 8 requests doubled by CFG; ``openai_64``
    training at batch 8; the entry point's EMNIST recipe at batch 468, whose
    N = 49 and 196 and 7x7 maps are ragged for the tiles; ``openai_128`` and
    its classifier at batch 4; the serving daemon at model batch 128; one
    rank's rows of a data-parallel ``openai_64`` training step, 4; the
    tools' models at their batches: quality_eval's UNet at 256, 128 and 16,
    its classifier at 256, verify_checkpoint's ``openai_64`` at 1;
    ``openai_128`` at one head, head dims 512 to 1024, at 8 and 2), in f32
    and bf16; times (CHECKED_PATHS: none) in each path's compute
    type per shape and summed per forward, beside the plain version, the
    library call and the bound (above 256 with the chunked build's recompute
    factor and the library's kernel). K5 runs at the attention shapes of
    K5_PATHS and at D = 16, N = 49; K1 also at head dims 24, 48 and 96, on
    the builds for 32, 64 and 128, and with K5 at ABOVE_256's head dims."""
    from nicediffusion_tpu_torch.ops.kernels import attention as k1
    from nicediffusion_tpu_torch.ops.kernels import groupnorm as k3

    g = torch.Generator(device=dev).manual_seed(SEED)
    kinds = ("attention", "groupnorm", "mha")
    errs = {(k, dt): 0.0 for k in kinds for dt in (torch.float32, torch.bfloat16)}
    # bf16 K3: the worst relative error per example, and the planted fault's
    k3_gates = {"max_rel_err_bf16": 0.0, "scale_high_min_rel_err": math.inf,
                "scale_high_cases": 0, "scale_high_passing_abs_gate": 0}
    routes = collections.Counter()  # (path, route) -> K3 calls per forward
    tallies = {(k, where): Tally() for k in kinds for where in PATHS}
    cases = [(key, n, where) for where, path_calls in paths.items()
             for key, n in sorted(path_calls.items(), key=str)]
    for key, per_call, where in cases:
        kind = key[0]
        b, timed_dtype, _ = PATHS[where]
        for dtype in (torch.float32, torch.bfloat16):
            tol = (F32_TOL if dtype == torch.float32 else BF16_TOL)[kind]
            if kind == "attention":
                _, n, c, heads, split_first = key
                qkv = torch.randn(b, n, 3 * c, generator=g, device=dev).to(dtype)
                layouts = (split_first, not split_first)
                runs = [((lambda sf=sf: k1.fused_qkv_attention(qkv, heads, sf)),
                         (lambda sf=sf: k1.fused_qkv_attention_plain(qkv, heads, sf)))
                        for sf in layouts]
                q, k, v = k1.split_qkv(qkv, heads, split_first)
                library = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
                bound = attention_bound_ms(b, n, c, tensors=4, products=2, dtype=dtype)
                name = f"K1 B={b} N={n} C={c} heads={heads}"
            else:
                h, w, c, mode, groups = gn_key(key)
                x = (2 * torch.randn(b, h, w, c, generator=g, device=dev) + 0.5).to(dtype)
                sc = torch.randn(c, generator=g, device=dev)
                bi = torch.randn(c, generator=g, device=dev)
                es, esh = modulation_rows(g, dev, dtype, b, c, groups)
                args = (x, sc, bi) + ((es, esh) if mode == "ada" else ())
                kw = dict(silu=mode != "plain", num_groups=groups)
                runs = [((lambda: k3.group_norm_fused(*args, **kw)),
                         (lambda: k3.group_norm_fused_plain(*args, **kw)))]
                lib_args = (x, sc.to(dtype), bi.to(dtype), es, esh, mode, groups)
                library = lambda: library_group_norm(*lib_args)  # noqa: E731
                bound = groupnorm_bound_ms(b, h, w, c, dtype)
                name = f"K3 {mode} {(b, h, w, c)}" + (f" {groups} groups" if groups != 32 else "")
            for kernel_fn, plain_fn in runs:
                out = kernel_fn()
                torch.cuda.synchronize()
                ref = plain_fn()
                err = check(f"{name} {dtype}", out, ref, tol)
                errs[kind, dtype] = max(errs[kind, dtype], err)
                if kind == "groupnorm" and dtype == torch.bfloat16:
                    rel = k3_rel_err(out, ref)
                    if rel > K3_BF16_REL:
                        raise AssertionError(f"{name} {dtype}: relative error {rel:.3g} over "
                                             f"{K3_BF16_REL}")
                    # the planted fault: the scale 5% high, what an rstd 5% high gives
                    bad = k3.group_norm_fused(x, sc * 1.05, *args[2:], **kw)
                    bad_rel = k3_rel_err(bad, ref)
                    if bad_rel <= K3_BF16_REL:
                        raise AssertionError(f"{name}: the scale 5% high reads {bad_rel:.3g}, "
                                             f"within K3_BF16_REL")
                    k3_gates["max_rel_err_bf16"] = max(k3_gates["max_rel_err_bf16"], rel)
                    k3_gates["scale_high_min_rel_err"] = min(
                        k3_gates["scale_high_min_rel_err"], bad_rel)
                    k3_gates["scale_high_cases"] += 1
                    k3_gates["scale_high_passing_abs_gate"] += within(bad, ref, tol)
            if dtype == timed_dtype and kind == "groupnorm":
                plan = k3.group_norm_plan((b, h, w, c), dtype, num_groups=groups)
                routes[where, plan["route"]] += per_call
                log(f"[kernels] {name} {dtype}: route {plan['route']}, HBM "
                    f"{plan['hbm_bytes'] / 1e6:.3f} MB (x and the output once: "
                    f"{2 * x.numel() * x.element_size() / 1e6:.3f}); "
                    + ", ".join(f"{k} {plan[k]}" for k in k3.PLAN_FIELDS))
            if dtype == timed_dtype and where not in CHECKED_PATHS:
                # host-timed: the main path's calls at full depth, the others' at K2's
                depth = {} if where == "forward" else dict(iters=10, rounds=3)
                ms, plain, lib = (time_ms(fn, **depth) for fn in (*runs[0], library))
                device = tuple(graph_ms(fn) for fn in (runs[0][0], runs[0][1], library))
                prof = (profiled_ms(runs[0][0]), profiled_ms(library))
                tallies[kind, where].add(per_call, ms, plain, lib, bound, device, prof)
                log(f"[kernels] {name} {dtype}, {per_call} per forward: {ms:.4f} ms"
                    f"{rate(key, b, ms, bound)}, plain {plain:.4f} ms, library {lib:.4f} ms; "
                    f"device time {device[0]:.4f} ms{rate(key, b, device[0], bound)}, plain "
                    f"{device[1]:.4f} ms, library {device[2]:.4f} ms; torch.profiler "
                    f"{prof[0]:.4f} ms, library {prof[1]:.4f} ms; bound {max(bound):.4f} ms")
                if kind == "attention" and c // heads > 256:
                    factor = recompute_factor("K1", c // heads, dtype, n, b * heads)
                    before = dict(k1.route_launches)
                    k1.fused_qkv_attention(qkv, heads, split_first)
                    torch.cuda.synchronize()
                    ran = {f"{kr[0]} {kr[1]}": v - before.get(kr, 0)
                           for kr, v in k1.route_launches.items() if v != before.get(kr, 0)}
                    log(f"[kernels] {name} {dtype}: head dim {c // heads} on the chunked build, "
                        f"route {route_of('K1', n, c // heads, b * heads, dtype)}, one call's "
                        f"launches by route {ran}; {factor:.2f}x the bound's products "
                        f"({factor * 2:.2f} N^2 D products of the 2 needed; bound with them "
                        f"{max(bound[0], factor * bound[1]):.4f} ms); the library ran "
                        f"{library_kernel(library)}")
            if kind == "attention" and where in K5_PATHS:
                name = f"K5 B={b} H={heads} N={n} D={c // heads}"
                err, views = check_mha(name, qkv, heads, split_first, dtype, tol)
                errs["mha", dtype] = max(errs["mha", dtype], err)
                if dtype == timed_dtype:
                    fns = (lambda: k1.mha_attention(*views),
                           lambda: k1.mha_attention_plain(*views))
                    ms, plain = (time_ms(fn) for fn in fns)
                    dev5 = tuple(graph_ms(fn) for fn in fns) + device[2:]
                    prof5 = (profiled_ms(fns[0]), prof[1])
                    tallies["mha", where].add(per_call, ms, plain, lib, bound, dev5, prof5)
                    log(f"[kernels] {name} {dtype} as views of the projection: {ms:.4f} ms"
                        f"{rate(key, b, ms, bound)}, plain {plain:.4f} ms, library {lib:.4f} "
                        f"ms; device time {dev5[0]:.4f} ms, plain {dev5[1]:.4f} ms, library "
                        f"{dev5[2]:.4f} ms; torch.profiler {prof5[0]:.4f} ms, library "
                        f"{prof5[1]:.4f} ms; bound {max(bound):.4f} ms")
    # a head dim under the smallest build and a ragged N (tests/test_pallas.py:18)
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn(2, 49, 3 * 2 * 16, generator=g, device=dev).to(dtype)
        tol = (F32_TOL if dtype == torch.float32 else BF16_TOL)["attention"]
        err, _ = check_mha("K5 B=2 H=2 N=49 D=16", qkv, 2, True, dtype, tol)
        errs["mha", dtype] = max(errs["mha", dtype], err)
    # K1 at head dims 24, 48 and 96 (--model_channels 96 --num_heads 4), each
    # on the build for the next one up, both layouts, the output pre-filled
    # with NaN (K2 at the same head dims: [k2])
    for n, hc in zip((256, 64, 100), BETWEEN_BUILDS):
        for dtype in (torch.float32, torch.bfloat16):
            tol = (F32_TOL if dtype == torch.float32 else BF16_TOL)["attention"]
            qkv = torch.randn(2, n, 3 * 4 * hc, generator=g, device=dev).to(dtype)
            for split_first in (True, False):
                out = torch.full((2, n, 4 * hc), float("nan"), dtype=dtype, device=dev)
                k1.fused_qkv_attention(qkv, 4, split_first, out=out)
                torch.cuda.synchronize()
                if torch.isnan(out).any():
                    raise AssertionError(f"K1 head dim {hc} {dtype}: elements left unwritten")
                err = check(f"K1 B=2 N={n} head dim {hc} (build {k1.head_dim_build(hc)}) "
                            f"{dtype}", out, k1.fused_qkv_attention_plain(qkv, 4, split_first),
                            tol)
                errs["attention", dtype] = max(errs["attention", dtype], err)
                log(f"[kernels] K1 B=2 N={n} 4 heads of {hc} on the build for "
                    f"{k1.head_dim_build(hc)}, {dtype}, split_first={split_first}: max abs err "
                    f"{err:.3g} vs plain (gate {tol})")
    # K1 and K5 at head dims above 256 (the chunked build), both layouts, the
    # outputs and the lse pre-filled with NaN; K5 on the views equal to K1
    # bit for bit (K2 at the same head dims: [k2])
    for hc, n in ABOVE_256:
        for dtype in (torch.float32, torch.bfloat16):
            tol = (F32_TOL if dtype == torch.float32 else BF16_TOL)["attention"]
            qkv = torch.randn(2, n, 3 * 2 * hc, generator=g, device=dev).to(dtype)
            for split_first in (True, False):
                out = torch.full((2, n, 2 * hc), float("nan"), dtype=dtype, device=dev)
                lse = torch.full((2, 2, n), float("nan"), device=dev)
                k1.fused_qkv_attention(qkv, 2, split_first, out=out, lse=lse)
                torch.cuda.synchronize()
                if torch.isnan(out).any() or torch.isnan(lse).any():
                    raise AssertionError(f"K1 head dim {hc} {dtype}: elements left unwritten")
                what = f"K1 B=2 N={n} 2 heads of {hc} {dtype} split_first={split_first}"
                err = check(what, out, k1.fused_qkv_attention_plain(qkv, 2, split_first), tol)
                errs["attention", dtype] = max(errs["attention", dtype], err)
                q, k, _ = k1.split_qkv(qkv.float(), 2, split_first)
                logits = torch.matmul(q, k.transpose(-1, -2)) * hc ** -0.5
                lse_err = check(f"{what} lse", lse, torch.logsumexp(logits, -1),
                                dict(atol=1e-4, rtol=1e-5))
                err5, views = check_mha(f"K5 B=2 H=2 N={n} D={hc}", qkv, 2, split_first, dtype,
                                        tol)
                errs["mha", dtype] = max(errs["mha", dtype], err5)
                if not torch.equal(k1.mha_attention(*views).transpose(1, 2).reshape(out.shape),
                                   out):
                    raise AssertionError(f"K5 differs from K1 at {what}")
                log(f"[kernels] {what} (build {k1.head_dim_build(hc)}): max abs err {err:.3g} "
                    f"vs plain (gate {tol}), lse {lse_err:.3g} vs torch.logsumexp; K5 {err5:.3g}, "
                    f"equal to K1 bit for bit")
    # head dims 64 to 256 at one N and 4 heads, beside the paths' own
    # shapes: the rate per operation of each build
    for hc in (64, 128, 192, 256):
        qkv = torch.randn(GUIDED_BATCH, 1024, 12 * hc, generator=g, device=dev).bfloat16()
        ms = graph_ms(lambda: k1.fused_qkv_attention(qkv, 4, True))
        tflops = 4 * GUIDED_BATCH * 1024**2 * 4 * hc / ms / 1e9
        log(f"[kernels] K1 at one N: B={GUIDED_BATCH} N=1024, 4 heads of {hc}, bf16: "
            f"{ms:.4f} ms of device time, {tflops:.2f} TFLOP/s of its two products")
    # what writing the row log-sum-exp for K2 costs K1, at the openai_64 UNet's
    # widest call at model batch 16, in turns
    qkv = torch.randn(16, 1024, 1152, generator=g, device=dev).bfloat16()
    lse = torch.empty(16, 6, 1024, device=dev)
    turns = {"without": [], "with": []}
    for which in ("without", "with", "with", "without"):
        buf = lse if which == "with" else None
        turns[which].append(graph_ms(lambda: k1.fused_qkv_attention(qkv, 6, True, lse=buf)))
    log(f"[kernels] K1 at qkv (16, 1024, 1152), 6 heads, bf16, device time in turns: without "
        f"the lse {turns['without']} ms, writing it {turns['with']} ms")
    for (kind, dtype), err in errs.items():
        log(f"[kernels] {kind} {dtype}: max abs err {err:.3g} vs plain")
    log(f"[kernels] K3 bf16: relative error per example at most "
        f"{k3_gates['max_rel_err_bf16']:.3g} (gate {K3_BF16_REL}); planted fault, the scale "
        f"5% high, in {k3_gates['scale_high_cases']} cases: at least "
        f"{k3_gates['scale_high_min_rel_err']:.3g}, failing K3_BF16_REL in all; "
        f"{k3_gates['scale_high_passing_abs_gate']} of them pass BF16_TOL alone")
    log(f"[kernels] K3 calls per forward by route: "
        + ", ".join(f"{where} {route} {n}" for (where, route), n in sorted(routes.items())))
    for (kind, where), tally in tallies.items():
        if ((kind == "mha" and where not in K5_PATHS) or where not in paths
                or where in CHECKED_PATHS or tally.bound_ms == 0):
            continue
        _, dtype, basis = PATHS[where]
        log(f"[kernels] {kind}, {dtype} calls of {basis}, each timed back to back: {tally}")
    return errs, tallies, k3_gates


def phase_mha_direct(dev, paths):
    """K5 called directly, as no model calls it: with the counts reset, one
    call for every attention call of one forward of each K5_PATHS model at
    its batch (``openai_128`` and its classifier at 4, ``openai_128`` at one
    head, on the chunked build, at 8) in bf16, on views of a projection; each
    result must equal K1's on the same projection bit for bit (they are one
    kernel). Returns the launch counts of these calls."""
    from nicediffusion_tpu_torch.ops.kernels import attention as k1

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    work = []
    for where in K5_PATHS:
        for key, per_call in sorted(paths[where].items(), key=str):
            if key[0] != "attention":
                continue
            _, n, c, heads, split_first = key
            qkv = torch.randn(PATHS[where][0], n, 3 * c, generator=g, device=dev).bfloat16()
            work.append((qkv, heads, split_first, per_call,
                         k1.fused_qkv_attention(qkv, heads, split_first)))
    reset_launches()
    for qkv, heads, split_first, per_call, fused in work:
        b, n, c = fused.shape
        for _ in range(per_call):
            out = k1.mha_attention(*k1.split_qkv(qkv, heads, split_first))
        if not torch.equal(out.transpose(1, 2).reshape(b, n, c), fused):
            raise AssertionError(f"K5 differs from K1 at qkv {tuple(qkv.shape)}, {heads} heads")
    torch.cuda.synchronize()
    launches = read_launches()
    routes = read_routes()
    log(f"[k5] {launches['mha']} direct calls at the attention shapes of one openai_128 and one "
        f"classifier forward, bf16, batch {GUIDED_BATCH}, and of one openai_128 forward at one "
        f"head (head dims 512, 768, 1024), batch {WIDE_BATCH}: each equal to K1 bit for bit; "
        f"above head dim 256 by route {routes}")
    return {**launches, **routes}


def randomize(model, seed):
    """Seeded fan-in-scaled weights with no leaf left at zero, so the
    zero-initialised output convs and projections take part."""
    g = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=g, device=p.device)
            if name.endswith("bias"):
                p.copy_(0.1 * noise)
            elif p.ndim == 1:  # GroupNorm weight
                p.copy_(1.0 + 0.1 * noise)
            elif name.startswith("class_embedding"):
                p.copy_(noise)
            else:
                p.copy_(noise / p[0].numel() ** 0.5)
            if not p.any():
                raise AssertionError(f"{name} left at zero")


def model_config(preset="openai_64"):
    from nicediffusion_tpu_torch.utils.config import MODEL_PRESETS

    cfg = dict(MODEL_PRESETS[preset])
    cfg["num_classes"] += 1  # CFG's null class
    return cfg


def phase_model(dev, off):
    """Full-width f32 CFG forward, kernels on against ``off`` (kernels=False)."""
    from nicediffusion_tpu_torch import DiffusionModel

    on = DiffusionModel(**model_config(), device=dev).eval()
    on.load_state_dict(off.state_dict(), strict=True)
    nparams = sum(p.numel() for p in on.parameters())

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(2, 64, 64, 3, generator=g, device=dev)
    x2 = torch.cat([x, x])
    t2 = torch.tensor([980, 500] * 2, device=dev)
    y2 = torch.tensor([207, 933, 0, 0], device=dev)
    with torch.inference_mode():
        a = on(x2, t2, y2)
        b = off(x2, t2, y2)
    torch.cuda.synchronize()
    err = check("f32 full-width CFG forward, kernels on vs off", a, b,
                dict(atol=MODEL_TOL, rtol=0))
    log(f"[model] openai_64 f32, {nparams} parameters, CFG forward at batch 2 "
        f"(model batch 4): kernels on vs off max abs {err:.3g} "
        f"(output max abs {b.abs().max().item():.3g})")
    del on, a, b
    torch.cuda.empty_cache()


def phase_slice(dev, state):
    from nicediffusion_tpu_torch import Diffusion, DiffusionModel
    from nicediffusion_tpu_torch.models.unet import AttentionBlock, GroupNormOp
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS

    cfg = model_config()
    dcfg = dict(DIFFUSION_PRESETS["openai_64"], rescaled_num_steps=25, use_ddim=False,
                guidance_method="classifier_free", guidance_strength=0.8)
    models = {}
    for kernels in (True, False):
        m = DiffusionModel(**cfg, dtype=torch.bfloat16, kernels=kernels, device=dev).eval()
        m.load_state_dict(state, strict=True)
        models[kernels] = (m, Diffusion(model=m, **dcfg))
    n_attn = sum(isinstance(m, AttentionBlock) for m in models[True][0].modules())
    n_gn = sum(isinstance(m, GroupNormOp) for m in models[True][0].modules())
    steps = models[True][1].rescaled_num_steps

    requests = [torch.arange(8, device=dev) * 97 % 1000 + 1 + i for i in range(3)]

    def answer(kernels, i):
        _, diff = models[kernels]
        g = torch.Generator(device=dev).manual_seed(1000 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = diff.denoise(g, y=requests[i], batch_size=8)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for kernels in (True, False):  # warm-up: cuDNN plans
        models[kernels][1].denoise(torch.Generator(device=dev).manual_seed(7),
                                   y=requests[0], batch_size=8, steps_to_do=2)
    torch.cuda.synchronize()

    reset_launches()
    seconds = {True: 0.0, False: 0.0}
    diffs = []
    for i in range(len(requests)):
        out, s_on = answer(True, i)
        seconds[True] += s_on
        if out.shape != (8, 64, 64, 3) or out.dtype != torch.float32:
            raise AssertionError(f"request {i}: output {tuple(out.shape)} {out.dtype}")
        if not torch.isfinite(out).all() or out.abs().max() > 1.0:
            raise AssertionError(f"request {i}: values not finite in [-1, 1]")
        ref, s_off = answer(False, i)
        seconds[False] += s_off
        diffs.append((out - ref).abs().max().item())
        log(f"[slice] request {i}: labels {requests[i].tolist()} -> {tuple(out.shape)}, "
            f"range [{out.min().item():.3f}, {out.max().item():.3f}]; "
            f"{s_on:.4f} s with kernels, {s_off:.4f} s without")
    launches = read_launches()
    calls = steps * len(requests)
    expect = {"attention": n_attn * calls, "attention_bwd": 0, "groupnorm": n_gn * calls,
              "groupnorm_bwd": 0, "mha": 0, "resblock": 0, "int8conv": 0,
              "conv": conv_per_call(models[True][0]) * calls}
    log(f"[slice] {calls} model calls at batch 16; launches {launches}, "
        f"expected {expect} ({n_attn} attention blocks, {n_gn} GroupNorm ops per call)")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    samples = 8 * len(requests)
    rate = {k: samples / v for k, v in seconds.items()}
    log(f"[slice] samples/s: kernels on {rate[True]:.4f}, kernels off {rate[False]:.4f} "
        f"(bf16, 25 DDPM steps, CFG, 8 samples per request)")
    log(f"[slice] kernels on vs off, final samples max abs diff per request "
        f"(bf16, 25 stochastic steps): {[round(d, 4) for d in diffs]}")

    # where the device time of one sampling forward goes: 8 labels doubled by CFG
    model = models[True][0]
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(16, model.resolution, model.resolution, model.in_channels, generator=g,
                    device=dev)
    t = torch.full((16,), 500, dtype=torch.long, device=dev)
    y = torch.cat([requests[0], torch.zeros_like(requests[0])])

    def forward():
        with torch.inference_mode():
            model(x, t, y)

    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    profile_steps(forward, "openai_64 sampling forward (bf16, model batch 16)", min(walls[1:]),
                  steps=3)
    return launches


def classifier_config():
    from nicediffusion_tpu_torch.utils.config import CLASSIFIER_PRESETS

    return dict(CLASSIFIER_PRESETS["openai_128"])


def guided_diffusion_config(classifier):
    """What the sampling entry point derives for ``128x128_diffusion.pt`` with
    ``--classifier_path``: the preset's 25 DDIM steps, classifier guidance
    at the preset's strength."""
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS

    return dict(DIFFUSION_PRESETS["openai_128"], guidance_method="classifier",
                classifier=classifier)


def phase_model_128(dev, unet_off, cls_off):
    """Full-width ``openai_128`` f32 forward (head dims 128, 192, 256), its
    classifier's logits and the guidance gradient (forward K1 and K3,
    backward K2 and K3's backward), kernels on against ``kernels=False``."""
    from nicediffusion_tpu_torch import Diffusion, DiffusionModel, EncoderUNet
    from nicediffusion_tpu_torch.utils.config import MODEL_PRESETS

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    x = torch.randn(2, 128, 128, 3, generator=g, device=dev)
    y = torch.tensor([207, 933], device=dev)

    on = DiffusionModel(**MODEL_PRESETS["openai_128"], device=dev).eval()
    on.load_state_dict(unet_off.state_dict(), strict=True)
    with torch.inference_mode():
        t = torch.tensor([980, 500], device=dev)
        a, b = on(x, t, y), unet_off(x, t, y)
    torch.cuda.synchronize()
    err = check("openai_128 f32 forward, kernels on vs off", a, b, dict(atol=MODEL_TOL, rtol=0))
    log(f"[model-128] openai_128 f32, {sum(p.numel() for p in on.parameters())} parameters, "
        f"forward at batch 2: kernels on vs off max abs {err:.3g} (output max abs "
        f"{b.abs().max().item():.3g})")
    del a, b

    cls_on = EncoderUNet(**classifier_config(), device=dev).eval()
    cls_on.load_state_dict(cls_off.state_dict(), strict=True)
    t = torch.tensor([24, 3], device=dev)  # the classifier sees the rescaled t
    with torch.inference_mode():
        la, lb = cls_on(x, t), cls_off(x, t)
    grads = [Diffusion(model=on, **guided_diffusion_config(c))._classifier_grad(x, t, y)
             for c in (cls_on, cls_off)]
    torch.cuda.synchronize()
    scale = lb.abs().max().item()
    lerr = check("classifier logits, kernels on vs off", la, lb,
                 dict(atol=MODEL_TOL * scale, rtol=0))
    gscale = grads[1].abs().max().item()
    gerr = check("classifier gradient, kernels on vs off", grads[0], grads[1],
                 dict(atol=MODEL_TOL * gscale, rtol=0))
    if grads[0].dtype != torch.float32 or not gscale > 0:
        raise AssertionError("the guidance gradient is not a non-zero f32 tensor")
    log(f"[model-128] classifier f32, {sum(p.numel() for p in cls_on.parameters())} "
        f"parameters, batch 2: logits on vs off max abs {lerr:.3g} of max {scale:.3g}; "
        f"grad log p(y|x) on vs off max abs {gerr:.3g} of max {gscale:.3g} "
        f"(gate {MODEL_TOL} of the largest)")
    del on, cls_on, grads
    torch.cuda.empty_cache()


def phase_sample_cli(dev, unet_state, cls_state, workdir):
    """The classifier-guided slice through the sampling entry point, as a
    user calls it, at full-width ``openai_128``: both state dicts are written
    to ``workdir`` under the names the preset dispatch reads, then
    ``main([...])`` samples 2 batches of 4 in bf16 over the preset's 25 DDIM
    steps. Then the same chains through the library with kernels on and off
    on the same seed, in turns, for images/s and the on/off difference, and
    a profile of one guided step."""
    from PIL import Image

    from nicediffusion_tpu_torch import Diffusion, DiffusionModel, EncoderUNet
    from nicediffusion_tpu_torch.models.classifier import AttentionPool
    from nicediffusion_tpu_torch.models.unet import AttentionBlock, GroupNormOp
    from nicediffusion_tpu_torch.scripts.sample import main as sample_main
    from nicediffusion_tpu_torch.utils.config import MODEL_PRESETS
    from nicediffusion_tpu_torch.utils.image import to_uint8

    model_path = os.path.join(workdir, "128x128_diffusion.pt")
    cls_path = os.path.join(workdir, "128x128_classifier.pt")
    torch.save(unet_state, model_path)
    torch.save(cls_state, cls_path)
    out_dir = os.path.join(workdir, "guided") + os.sep
    os.makedirs(out_dir)
    batch, labels_arg = GUIDED_BATCH, (3, 7)
    images = batch * len(labels_arg)

    reset_launches()
    t0 = time.perf_counter()
    samples = sample_main([
        "--model_path", model_path, "--classifier_path", cls_path,
        # the shared parser checks guidance against the flags before it reads
        # the preset, so a preset model is named conditional on the command line
        "--guidance_method", "classifier", "--num_classes", "1000",
        "--batch_size", str(batch), "--num_samples", str(len(labels_arg)),
        "--labels", "/".join(map(str, labels_arg)), "--save_path", out_dir, "--seed", "0", "-w",
    ])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_launches()

    expect_files = sorted(f"{lab}_sample{i}.jpg" for lab in labels_arg for i in range(batch))
    if sorted(os.listdir(out_dir)) != expect_files:
        raise AssertionError(f"files {sorted(os.listdir(out_dir))} != {expect_files}")
    for name in expect_files:
        with Image.open(out_dir + name) as img:
            if img.size != (128, 128) or img.mode != "RGB":
                raise AssertionError(f"{name}: {img.size} {img.mode}")
    for (_, out, labels), lab in zip(samples, labels_arg):
        if out.shape != (batch, 128, 128, 3) or labels.tolist() != [lab] * batch:
            raise AssertionError(f"sample of label {lab}: {out.shape}, labels {labels.tolist()}")
        if any(img.std() == 0 for img in out):
            raise AssertionError(f"sample of label {lab}: a constant image")

    models = {}
    for kernels in (True, False):
        m = DiffusionModel(**MODEL_PRESETS["openai_128"], dtype=torch.bfloat16,
                           kernels=kernels, device=dev).eval()
        m.load_state_dict(unet_state, strict=True)
        c = EncoderUNet(**classifier_config(), dtype=torch.bfloat16, kernels=kernels,
                        device=dev)
        c.load_state_dict(cls_state, strict=True)
        models[kernels] = Diffusion(model=m, **guided_diffusion_config(c))
    unet, cls = models[True].model, models[True].classifier

    def count(model, *types):
        return sum(isinstance(m, types) for m in model.modules())

    steps = models[True].rescaled_num_steps
    calls = steps * len(labels_arg)
    n_attn = (count(unet, AttentionBlock), count(cls, AttentionBlock, AttentionPool))
    n_gn = (count(unet, GroupNormOp), count(cls, GroupNormOp))
    # the classifier's forward takes its gradient (grad mode on): cuDNN's convs
    expect = {"attention": sum(n_attn) * calls, "attention_bwd": n_attn[1] * calls,
              "groupnorm": sum(n_gn) * calls, "groupnorm_bwd": n_gn[1] * calls, "mha": 0,
              "resblock": 0, "int8conv": 0, "conv": conv_per_call(unet) * calls}
    log(f"[guided] entry point, openai_128 + classifier, bf16, {steps} DDIM steps, "
        f"{len(labels_arg)} samples of {batch}: {images} files of 128x128 in {cli_s:.2f} s "
        f"(models built, checkpoints loaded and images saved inside that time); launches "
        f"{launches}, expected {expect} (per step: {n_attn[0]} K1 in the UNet, {n_attn[1]} K1 "
        f"and K2 in the classifier, {n_gn[0]} + {n_gn[1]} K3, {n_gn[1]} K3 backward)")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")

    timed_labels = labels_arg[:1]
    images = batch * len(timed_labels)

    def chains(kernels):
        """The entry point's first chain as it draws it: start noise, then
        the chain, from one generator."""
        diff = models[kernels]
        g = torch.Generator(device=dev).manual_seed(0)
        outs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for lab in timed_labels:
            data = torch.randn((batch, 128, 128, 3), generator=g, device=dev)
            y = torch.full((batch,), lab, dtype=torch.long, device=dev)
            outs.append(diff.denoise(g, x=data, y=y))
        torch.cuda.synchronize()
        return torch.stack(outs), time.perf_counter() - t0

    chains(False)  # warm-up of the plain path
    rates = {True: [], False: []}
    outs = {}
    for kernels in (True, False, False, True):
        outs[kernels], seconds = chains(kernels)
        rates[kernels].append(images / seconds)
    for kernels, out in outs.items():
        if not torch.isfinite(out).all() or out.abs().max() > 1.0:
            raise AssertionError(f"kernels={kernels}: samples not finite in [-1, 1]")
    cli = torch.stack([torch.from_numpy(s[1]) for s in samples[:len(timed_labels)]])
    same = (torch.from_numpy(to_uint8(outs[True].cpu().numpy())) == cli).float().mean().item()
    diff = (outs[True] - outs[False]).abs()
    log(f"[guided] images/s through the library, {images} images a reading: kernels on "
        f"{rates[True]}, kernels off {rates[False]} (bf16, {steps} DDIM steps, classifier "
        f"guidance, batch {batch})")
    log(f"[guided] the library chain with kernels on reproduces {same:.4f} of the uint8 pixels "
        f"of the entry point's first sample; kernels on vs off, final samples: max abs diff "
        f"{diff.max().item():.4f}, mean abs diff {diff.mean().item():.5f} (bf16, "
        f"{steps} guided steps)")

    # one guided step: the UNet forward, the classifier forward and its backward
    diff_on = models[True]
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((batch, 128, 128, 3), generator=g, device=dev)
    y = torch.full((batch,), 3, dtype=torch.long, device=dev)
    t = torch.full((batch,), steps // 2, dtype=torch.long, device=dev)

    def step():
        with torch.inference_mode():
            diff_on.ddim_step(x, t, g, y)

    def timed(fn, n=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    def unet_forward():
        with torch.inference_mode():
            unet(x, t, y)

    def cls_forward():
        with torch.inference_mode():
            cls(x, t)

    def guidance_grad():
        diff_on._classifier_grad(x, t, y)

    step_ms, unet_ms, fwd_ms = timed(step), timed(unet_forward), timed(cls_forward)
    grad_ms = timed(guidance_grad)
    log(f"[guided] one guided DDIM step at batch {batch}, bf16, host clock around "
        f"synchronised runs: {step_ms:.3f} ms; the UNet forward alone {unet_ms:.3f} ms, the "
        f"classifier forward alone {fwd_ms:.3f} ms, the guidance gradient (classifier forward "
        f"and backward) {grad_ms:.3f} ms: the backward is {(grad_ms - fwd_ms) / step_ms:.3f} "
        f"of the step's wall time")
    busy = profile_steps(step, "guided DDIM step", unprofiled_ms=step_ms, steps=3)
    # the backward's kernels run on autograd's thread, outside any range of the
    # caller's: its device time is the gradient's less the forward's
    grad_busy = profile_steps(guidance_grad, "guidance gradient", grad_ms, steps=3, detail=False)
    fwd_busy = profile_steps(cls_forward, "classifier forward", fwd_ms, steps=3, detail=False)
    if busy and grad_busy and fwd_busy:
        log(f"[profile] the classifier's backward: device {grad_busy - fwd_busy:.3f} ms, "
            f"{(grad_busy - fwd_busy) / busy:.3f} of the guided step's busy time")
    return launches


def phase_kernels_bwd(dev, paths):
    """K2 against its plain version and against autograd through the plain
    forward, at every attention shape of one ``openai_64`` training step
    (batch 8), of one step of the entry point's EMNIST recipe (batch 468,
    ragged N = 196 and 49) and of one guidance gradient through the
    ``openai_128`` classifier (batch 4, the interleaved layout, the pool's
    N = 65), of one ``openai_128`` training step (batch 4: head dims 128, 192
    and 256), at N = 100 with head dims 128 and 192, and at head dims 24, 48
    and 96 (between two builds: each on the next one up); both layouts,
    f32 and bf16, random cotangent with |g| <= 1, output pre-filled with
    NaN. The forward output and the row log-sum-exp come from K1, and K2 runs
    with that lse handed over (as the autograd Function runs it) and without
    it (the wrapper then launches K1 for it). bf16 is held to K2_BF16_TOL and
    to K2_BF16_REL; a planted fault, the lse handed over 0.05 too high, must
    fail K2_BF16_REL at every shape. Times in each path's compute type summed
    over one step, host-timed and in device time, beside the plain version,
    the library call (the autograd backward of scaled_dot_product_attention;
    its device time from torch.profiler) and the bound; K2 and the library's
    forward are also read by torch.profiler, so the two device-time methods
    stand side by side."""
    from nicediffusion_tpu_torch.ops.kernels import attention as k1

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    auto_err = rel_err = 0.0
    fault_rel, fault_passes_tol, faults = math.inf, 0, 0
    tallies = {where: Tally() for where in K2_PATHS}
    no_lse = {where: 0.0 for where in K2_PATHS}  # device ms summed, K2 making its own lse
    # device ms summed over a step, each call read both ways: K2 and the
    # library's forward by a CUDA graph and by torch.profiler, the library's
    # backward by torch.profiler
    yard = {where: collections.Counter() for where in K2_PATHS}
    cases = [(key, n, where) for where in K2_PATHS
             for key, n in sorted(paths[where].items(), key=str) if key[0] == "attention"]
    # a ragged N at head dims 128 and 192, which no model has; head dims 24,
    # 48 and 96 (--model_channels 96 --num_heads 4), between two builds
    cases += [(("attention", 100, 256, 2, True), 0, None),
              (("attention", 100, 384, 2, True), 0, None)]
    cases += [(("attention", n, 4 * hc, 4, True), 0, None)
              for n, hc in zip((256, 64, 100), BETWEEN_BUILDS)]
    # head dims above 256 (the chunked build), 2 heads
    cases += [(("attention", n, 2 * hc, 2, True), 0, None) for hc, n in ABOVE_256]
    for (_, n, c, heads, split_first), per_step, where in cases:
        b, timed_dtype, _ = PATHS[where] if where else (4, None, None)
        name = f"K2 B={b} N={n} C={c} heads={heads}"
        for dtype in (torch.float32, torch.bfloat16):
            tol = K2_F32_TOL if dtype == torch.float32 else K2_BF16_TOL
            qkv = torch.randn(b, n, 3 * c, generator=g, device=dev).to(dtype)
            cot = (2 * torch.rand(b, n, c, generator=g, device=dev) - 1).to(dtype)
            lse = torch.empty(b, heads, n, device=dev)
            for sf in (split_first, not split_first):
                o = k1.fused_qkv_attention(qkv, heads, sf, lse=lse)
                ref = k1.fused_qkv_attention_bwd_plain(qkv, cot, o, heads, sf)
                for handed in (lse, None):
                    out = torch.full_like(qkv, float("nan"))
                    res = k1.fused_qkv_attention_bwd(qkv, cot, o, heads, sf, lse=handed, out=out)
                    torch.cuda.synchronize()
                    made = "handed over" if handed is lse else "made"
                    how = f"{dtype} split_first={sf} lse {made}"
                    if res is not out or torch.isnan(out).any():
                        raise AssertionError(f"{name} {how}: output elements left unwritten")
                    errs[dtype] = max(errs[dtype], check(f"{name} {how}", out, ref, tol))
                    if dtype == torch.bfloat16:
                        rel = k2_rel_err(out, ref, heads, sf)
                        if rel > K2_BF16_REL:
                            raise AssertionError(f"{name} {how}: relative error {rel:.3g} of dq, "
                                                 f"dk or dv over {K2_BF16_REL}")
                        rel_err = max(rel_err, rel)
                if dtype == torch.bfloat16:
                    # the planted fault: every p 5% low
                    bad = k1.fused_qkv_attention_bwd(qkv, cot, o, heads, sf, lse=lse + 0.05)
                    rel = k2_rel_err(bad, ref, heads, sf)
                    if rel <= K2_BF16_REL:
                        raise AssertionError(f"{name} split_first={sf}: an lse 0.05 too high "
                                             f"reads {rel:.3g}, within K2_BF16_REL")
                    fault_rel, faults = min(fault_rel, rel), faults + 1
                    fault_passes_tol += within(bad, ref, tol)
                if dtype == torch.float32:
                    leaf = qkv.clone().requires_grad_(True)
                    auto, = torch.autograd.grad(
                        k1.fused_qkv_attention_plain(leaf, heads, sf), leaf, cot)
                    auto_err = max(auto_err, check(f"{name} vs autograd split_first={sf}",
                                                   out, auto, tol))
            if dtype == timed_dtype:
                o = k1.fused_qkv_attention(qkv, heads, split_first, lse=lse)
                q, k, v = (t.detach().requires_grad_(True)
                           for t in k1.split_qkv(qkv, heads, split_first))
                lib_out = F.scaled_dot_product_attention(q, k, v)
                lib_cot = cot.reshape(b, n, heads, c // heads).transpose(1, 2)
                fns = (lambda: k1.fused_qkv_attention_bwd(qkv, cot, o, heads, split_first,
                                                          lse=lse),
                       lambda: k1.fused_qkv_attention_bwd_plain(qkv, cot, o, heads, split_first))
                library = lambda: torch.autograd.grad(  # noqa: E731
                    lib_out, (q, k, v), lib_cot, retain_graph=True)

                def library_forward():
                    with torch.no_grad():
                        return F.scaled_dot_product_attention(q, k, v)

                depth = dict(iters=10, rounds=3)
                ms, plain, lib = (time_ms(fn, **depth) for fn in (*fns, library))
                device = (graph_ms(fns[0]), graph_ms(fns[1]), profiled_ms(library))
                own = graph_ms(lambda: k1.fused_qkv_attention_bwd(qkv, cot, o, heads,
                                                                  split_first))
                no_lse[where] += per_step * own
                read = {"k2_graph": device[0], "k2_profiler": profiled_ms(fns[0]),
                        "library_profiler": device[2], "forward_graph": graph_ms(library_forward),
                        "forward_profiler": profiled_ms(library_forward)}
                yard[where].update({key: per_step * v for key, v in read.items()})
                bound = attention_bound_ms(b, n, c, tensors=8, products=5, dtype=dtype)
                tallies[where].add(per_step, ms, plain, lib, bound, device,
                                   (read["k2_profiler"], device[2]))
                log(f"[k2] {name} {dtype}, {per_step} per step: {ms:.4f} ms, plain "
                    f"{plain:.4f} ms, library {lib:.4f} ms; device time {device[0]:.4f} ms "
                    f"({5 * 2 * b * n * n * c / device[0] / 1e9:.2f} TFLOP/s of the five "
                    f"products), without the lse handed over {own:.4f} ms, plain "
                    f"{device[1]:.4f} ms, library {device[2]:.4f} ms; bound "
                    f"{max(bound):.4f} ms; torch.profiler: K2 {read['k2_profiler']:.4f} ms, "
                    f"the library's forward {read['forward_profiler']:.4f} ms "
                    f"(graph {read['forward_graph']:.4f})")
                hd = c // heads
                if hd > 256:
                    factor = recompute_factor("K2", hd, dtype, n, b * heads)
                    before = dict(k1.route_launches)
                    fns[0]()
                    torch.cuda.synchronize()
                    ran = {f"{kr[0]} {kr[1]}": v - before.get(kr, 0)
                           for kr, v in k1.route_launches.items() if v != before.get(kr, 0)}
                    log(f"[k2] {name} {dtype}: head dim {hd} on the chunked build, route "
                        f"{route_of('K2', n, hd, b * heads, dtype)}, one call's launches by "
                        f"route {ran}; {factor:.2f}x the bound's products ({factor * 5:.2f} "
                        f"N^2 D products of the 5 needed; bound with them "
                        f"{max(bound[0], factor * bound[1]):.4f} ms); the library's backward "
                        f"ran {library_kernel(library)}")
    log(f"[k2] max abs err vs plain: f32 {errs[torch.float32]:.3g}, bf16 "
        f"{errs[torch.bfloat16]:.3g}; f32 vs autograd of the plain forward {auto_err:.3g}; "
        f"bf16 relative error of dq, dk and dv per (example, head) {rel_err:.3g} (gate "
        f"{K2_BF16_REL})")
    log(f"[k2] planted fault, the lse handed over 0.05 too high, in {faults} bf16 cases: "
        f"relative error at least {fault_rel:.3g}, failing K2_BF16_REL in all; "
        f"{fault_passes_tol} of them pass K2_BF16_TOL alone")
    for where, tally in tallies.items():
        _, dtype, basis = PATHS[where]
        y = yard[where]
        log(f"[k2] {dtype} calls of the backward of {basis}: {tally}; device time without the "
            f"lse handed over (K2 with its own K1 launch) {no_lse[where]:.4f} ms")
        log(f"[k2-yardstick] {basis}: K2 {y['k2_graph']:.4f} ms by CUDA graph, "
            f"{y['k2_profiler']:.4f} by torch.profiler (graph / profiler "
            f"{y['k2_graph'] / y['k2_profiler']:.3f}); the library's forward "
            f"{y['forward_graph']:.4f} and {y['forward_profiler']:.4f} "
            f"({y['forward_graph'] / y['forward_profiler']:.3f}); K2 over the library's "
            f"backward, both by torch.profiler, {y['k2_profiler'] / y['library_profiler']:.2f}x"
            f" (K2 by graph: {y['k2_graph'] / y['library_profiler']:.2f}x)")
    return errs, tallies, dict(yard["train"])


def groupnorm_bwd_bound_ms(b, h, w, c, dtype=torch.bfloat16):
    """(bytes ms, operations ms) of K3's backward: x and the cotangent read
    and dx written once; about 25 f32 operations an element (the forward's
    recompute, SiLU's derivative, two sums, dx) on the CUDA cores."""
    elems = b * h * w * c
    return (3 * elems * dtype.itemsize / HBM_BYTES_PER_S * 1e3,
            25 * elems / F32_FLOPS * 1e3)


def library_group_norm_grad(x, sc, bi, es, esh, mode, cot, groups=32):
    """The library's autograd backward of ``library_group_norm`` in x's dtype
    (F.group_norm, the modulation, F.silu), for every input, as a callable
    that reruns it on one recorded graph."""
    leaves = [t.detach().to(x.dtype).requires_grad_(True) for t in (x, sc, bi)]
    leaves += [t.detach().clone().requires_grad_(True) for t in (es, esh)] if mode == "ada" else []
    out = library_group_norm(*leaves[:3], *(leaves[3:] or (None, None)), mode, groups)
    lib_cot = cot.permute(0, 3, 1, 2)
    return lambda: torch.autograd.grad(out, leaves, lib_cot, retain_graph=True)


# unet128: openai_128 training
K3_BWD_PATHS = ("train", "cls128", "emnist", "unet128", "dp_train", "tp_train", "qe_unet",
                "qe_cls")
K3_BWD_TIMED = ("train", "cls128", "dp_train", "tp_train", "qe_unet", "qe_cls")


def phase_k3_bwd(dev, paths):
    """K3's backward kernel against its plain version at every GroupNorm
    shape of one ``openai_64`` training step (batch 8), of the classifier's
    guidance gradient (batch 4), of the EMNIST recipe (batch 468) and of an
    ``openai_128`` training step (batch 4) and of one rank's data-parallel
    ``openai_64`` step (batch 4), f32 and bf16, the mean and rstd
    from K3's forward: f32 to 1e-5 of each output's largest element, bf16 to
    K3_BF16_REL per example and output, two runs bit-equal; a planted fault,
    the rstd handed over 5% high, must fail K3_BF16_REL at every shape. Times
    in bf16 summed over the ``openai_64`` step, the guidance gradient and the
    data-parallel rank's step:
    host-timed, device time by CUDA graph and by torch.profiler, beside the
    plain version, the library's autograd backward (torch.profiler) and the
    bound."""
    from nicediffusion_tpu_torch.ops.kernels import groupnorm as k3

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    gates = {"max_rel_err_bf16": 0.0, "rstd_high_min_rel_err": math.inf, "rstd_high_cases": 0,
             "rstd_high_passing_abs_gate": 0}
    tallies = {where: Tally() for where in K3_BWD_TIMED}
    routes = collections.Counter()
    names = ("dx", "dscale", "dbias", "demb_scale", "demb_shift")
    for where in K3_BWD_PATHS:
        b, timed_dtype, _ = PATHS[where]
        keys = sorted((k, n) for k, n in paths[where].items() if k[0] == "groupnorm")
        for key, per_step in keys:
            h, w, c, mode, groups = gn_key(key)
            gk = dict(silu=mode != "plain", num_groups=groups)
            name = f"K3 backward {mode} {(b, h, w, c)}" + (
                f" {groups} groups" if groups != 32 else "")
            for dtype in (torch.float32, torch.bfloat16):
                x = (2 * torch.randn(b, h, w, c, generator=g, device=dev) + 0.5).to(dtype)
                sc = torch.randn(c, generator=g, device=dev)
                bi = torch.randn(c, generator=g, device=dev)
                rows = modulation_rows(g, dev, dtype, b, c, groups)
                es, esh = rows if mode == "ada" else (None, None)
                cot = torch.randn(b, h, w, c, generator=g, device=dev).to(dtype)
                args = (x, sc, bi, es, esh, cot)
                _, mean, rstd = k3.group_norm_fused_with_stats(*args[:5], **gk)
                got = k3.group_norm_fused_bwd(*args, mean, rstd, **gk)
                again = k3.group_norm_fused_bwd(*args, mean, rstd, **gk)
                ref = k3.group_norm_fused_bwd_plain(*args, **gk)
                torch.cuda.synchronize()
                for out_name, a, a2, r in zip(names, got, again, ref):
                    if r is None:
                        continue
                    if not torch.equal(a, a2):
                        raise AssertionError(f"{name} {dtype}: {out_name} differs between runs")
                    err = (a.float() - r.float()).abs().max().item()
                    scale = r.float().abs().max().item()
                    if dtype == torch.float32:
                        if not err <= 1e-5 * scale:
                            raise AssertionError(f"{name} f32 {out_name}: max abs err {err:.3g} "
                                                 f"over 1e-5 of {scale:.3g}")
                        errs[dtype] = max(errs[dtype], err / scale)
                    else:
                        rel = k3_rel_err(a, r)
                        if rel > K3_BF16_REL:
                            raise AssertionError(f"{name} bf16 {out_name}: relative error "
                                                 f"{rel:.3g} over {K3_BF16_REL}")
                        errs[dtype] = max(errs[dtype], err)
                        gates["max_rel_err_bf16"] = max(gates["max_rel_err_bf16"], rel)
                if dtype == torch.bfloat16:
                    bad = k3.group_norm_fused_bwd(*args, mean, rstd * 1.05, **gk)
                    pairs = [(a, r) for a, r in zip(bad, ref) if r is not None]
                    bad_rel = max(k3_rel_err(a, r) for a, r in pairs)
                    if bad_rel <= K3_BF16_REL:
                        raise AssertionError(f"{name}: the rstd 5% high reads {bad_rel:.3g}, "
                                             f"within K3_BF16_REL")
                    gates["rstd_high_min_rel_err"] = min(gates["rstd_high_min_rel_err"], bad_rel)
                    gates["rstd_high_cases"] += 1
                    gates["rstd_high_passing_abs_gate"] += all(
                        within(a, r, BF16_TOL["groupnorm"]) for a, r in pairs)
                if dtype != timed_dtype or where not in K3_BWD_TIMED:
                    continue
                fns = (lambda: k3.group_norm_fused_bwd(*args, mean, rstd, **gk),
                       lambda: k3.group_norm_fused_bwd_plain(*args, **gk))
                library = library_group_norm_grad(*args[:5], mode, cot, groups)
                depth = dict(iters=10, rounds=3)
                ms, plain, lib = (time_ms(fn, **depth) for fn in (*fns, library))
                device = (graph_ms(fns[0]), graph_ms(fns[1]), profiled_ms(library))
                prof = (profiled_ms(fns[0]), device[2])
                bound = groupnorm_bwd_bound_ms(b, h, w, c, dtype)
                tallies[where].add(per_step, ms, plain, lib, bound, device, prof)
                plan = k3.group_norm_plan((b, h, w, c), dtype, num_groups=groups, backward=True)
                routes[where, plan["route"]] += per_step
                log(f"[k3-bwd] {name} {dtype}, {per_step} per step: device time "
                    f"{device[0]:.4f} ms by graph, {prof[0]:.4f} by torch.profiler, host-timed "
                    f"{ms:.4f}; plain {device[1]:.4f} (host {plain:.4f}); library backward "
                    f"{device[2]:.4f} by torch.profiler (host {lib:.4f}); bound "
                    f"{max(bound):.4f} ms; route {plan['route']}, HBM "
                    f"{plan['hbm_bytes'] / 1e6:.3f} MB (x, dy and dx once: "
                    f"{3 * x.numel() * x.element_size() / 1e6:.3f}); "
                    + ", ".join(f"{k} {plan[k]}" for k in k3.PLAN_FIELDS))
    log(f"[k3-bwd] f32: every output within {errs[torch.float32]:.3g} of its largest element "
        f"(gate 1e-5); bf16: max abs err {errs[torch.bfloat16]:.3g}, relative error per "
        f"example and output at most {gates['max_rel_err_bf16']:.3g} (gate {K3_BF16_REL}); two "
        f"runs bit-equal at every shape")
    log(f"[k3-bwd] planted fault, the rstd handed over 5% high, in {gates['rstd_high_cases']} "
        f"bf16 cases: relative error at least {gates['rstd_high_min_rel_err']:.3g}, failing "
        f"K3_BF16_REL in all; {gates['rstd_high_passing_abs_gate']} of them pass "
        f"BF16_TOL['groupnorm'] alone")
    log(f"[k3-bwd] calls per step by route: "
        + ", ".join(f"{where} {route} {n}" for (where, route), n in sorted(routes.items())))
    for where, tally in tallies.items():
        _, dtype, basis = PATHS[where]
        log(f"[k3-bwd] {dtype} calls of the backward of {basis}: {tally}")
    return errs, tallies, gates


def phase_grads(dev, off, preset="openai_64", batch=4, cfg=None):
    """Loss and every parameter's gradient of the f32 model of ``preset``
    (or of ``cfg``, with ``preset``'s diffusion) on one fixed batch (HYBRID
    loss, injected t and noise; both models in ``eval()`` mode, so no
    dropout): kernels on against ``off`` (kernels=False, the same remat
    setting)."""
    from nicediffusion_tpu_torch import Diffusion, DiffusionModel
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS

    cfg = dict(cfg or model_config(preset), num_classes=off.num_classes)
    on = DiffusionModel(**cfg, use_remat=off.use_remat, device=dev).eval()
    on.load_state_dict(off.state_dict(), strict=True)
    dcfg = dict(DIFFUSION_PRESETS[preset], rescaled_num_steps=1000,
                guidance_method="classifier_free")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    shape = (batch, cfg["resolution"], cfg["resolution"], cfg["in_channels"])
    x0 = torch.rand(shape, generator=g, device=dev) * 2 - 1
    noise = torch.randn(shape, generator=g, device=dev)
    # t = 0 (the decoder's likelihood term), both ends, and class 0 (the null class)
    t = torch.tensor([0, 3, 500, 999], device=dev).repeat(batch // 4)
    y = (torch.tensor([207, 0, 933, 1000], device=dev).repeat(batch // 4)
         % cfg["num_classes"])

    def loss_and_grads(model):
        loss = Diffusion(model=model, **dcfg).loss(x0, t, y=y, noise=noise).mean()
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return loss.item(), grads

    loss_off, grads_off = loss_and_grads(off)
    loss_on, grads_on = loss_and_grads(on)
    torch.cuda.synchronize()
    if not abs(loss_on - loss_off) <= LOSS_TOL * max(1.0, abs(loss_off)):
        raise AssertionError(f"loss with kernels {loss_on} vs without {loss_off}")
    worst, worst_name = 0.0, ""
    for (name, _), a, b in zip(on.named_parameters(), grads_on, grads_off):
        scale = b.abs().max().item()
        rel = (a - b).abs().max().item() / scale if scale else float("inf")
        if not rel <= GRAD_TOL:
            raise AssertionError(f"gradient of {name}: max abs diff {rel:.3g} of its max |grad|")
        if rel > worst:
            worst, worst_name = rel, name
    what = preset if cfg.get("num_heads") != 1 else f"{preset} at num_heads=1"
    log(f"[grads] {what} f32, HYBRID loss at batch {batch}: loss {loss_on:.6f} with kernels, "
        f"{loss_off:.6f} without; {len(grads_on)} gradients, worst max |diff| / max |grad| "
        f"{worst:.3g} ({worst_name}), gate {GRAD_TOL}")
    del on, grads_on, grads_off
    torch.cuda.empty_cache()


def block_counts(model):
    """(attention blocks, GroupNorm ops inside rematerialised blocks,
    GroupNorm ops outside them) of a model."""
    from nicediffusion_tpu_torch.models.unet import AttentionBlock, GroupNormOp, ResidualBlock

    n_attn = sum(isinstance(m, AttentionBlock) for m in model.modules())
    n_gn = sum(isinstance(m, GroupNormOp) for m in model.modules())
    inside = sum(isinstance(m, GroupNormOp)
                 for block in model.modules()
                 if isinstance(block, (AttentionBlock, ResidualBlock))
                 for m in block.modules())
    return n_attn, inside, n_gn - inside


def kernel_counters():
    from nicediffusion_tpu_torch.ops.kernels import attention as k1
    from nicediffusion_tpu_torch.ops.kernels import conv as kc
    from nicediffusion_tpu_torch.ops.kernels import groupnorm as k3
    from nicediffusion_tpu_torch.ops.kernels import int8conv as k8
    from nicediffusion_tpu_torch.ops.kernels import resblock as k4

    return {"attention": k1.fused_qkv_attention, "attention_bwd": k1.fused_qkv_attention_bwd,
            "groupnorm": k3.group_norm_fused, "groupnorm_bwd": k3.group_norm_fused_bwd,
            "mha": k1.mha_attention,
            "resblock": k4.gn_silu_conv3x3, "int8conv": k8.int8_conv_nhwc,
            "conv": kc.conv_nhwc}


def reset_launches():
    from nicediffusion_tpu_torch.ops.kernels import attention as k1

    for fn in kernel_counters().values():
        fn.launches = 0
    k1.route_launches.clear()


def read_routes():
    """The attention launches at head dims above 256 by kernel and route
    since the last reset_launches: {"K1 resident": n, ...}."""
    from nicediffusion_tpu_torch.ops.kernels import attention as k1

    return {f"{kernel} {route}": n for (kernel, route), n in sorted(k1.route_launches.items())}


def read_launches():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def conv_per_call(model, dtype=None, part=None, recording=False):
    """bf16 conv launches of one forward of ``model`` (or of ``part``, a
    module or tuple of modules of it) with grad mode off: each Conv2d once
    in a bf16 (``dtype``, default the model's) ``kernels=True`` model, the
    int8 convs only while they record their calibration (else their own
    kernel or the dynamic path); 0 otherwise."""
    from nicediffusion_tpu_torch.models.unet import Conv2d, Int8Conv, WinogradConv

    if (dtype or model.dtype) != torch.bfloat16 or not model.kernels:
        return 0
    parts = part if isinstance(part, tuple) else (part or model,)
    return sum(isinstance(m, Conv2d) and not isinstance(m, WinogradConv)
               and (recording or not isinstance(m, Int8Conv))
               for p in parts for m in p.modules())


def expect_train_launches(model, steps, sample_calls=0):
    """Launches the structure gives: with remat every block's forward runs
    twice in a step (forward and recompute) and its backward once; every
    GroupNorm's backward runs once a step. The training steps take cuDNN's
    convs (grad mode on), the ``sample_calls`` forwards (grad mode off) the
    bf16 conv."""
    n_attn, gn_in, gn_out = block_counts(model)
    twice = 2 if model.use_remat else 1
    return {"attention": n_attn * (steps * twice + sample_calls),
            "attention_bwd": n_attn * steps,
            "groupnorm": steps * (gn_in * twice + gn_out) + (gn_in + gn_out) * sample_calls,
            "groupnorm_bwd": steps * (gn_in + gn_out), "mha": 0, "resblock": 0, "int8conv": 0,
            "conv": conv_per_call(model) * sample_calls}


def metrics_rows(path):
    """The rows of a Trainer's JSONL metrics file; raises unless every loss
    and gradient norm is finite."""
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    for row in rows:
        if not (math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"])):
            raise AssertionError(f"metrics row not finite: {row}")
    return rows


# device time of a training step by kernel name: first match wins
KERNEL_GROUPS = (
    ("K2 attention backward", ("attention_bwd",)),
    ("K1 attention forward", ("attention_fwd_kernel", "attention_fwd_wgmma")),
    ("K3 GroupNorm backward", ("group_norm_bwd",)),
    ("K3 GroupNorm forward", ("group_norm_fwd",)),
    ("int8 conv", ("int8_conv",)),
    ("Winograd conv", ("winograd_conv",)),
    ("bf16 conv", ("bf16_conv",)),
    ("conv backward (cuDNN dgrad/wgrad)", ("dgrad", "wgrad", "bwd")),
    ("conv forward (cuDNN fprop)", ("fprop", "conv", "xmma", "cudnn")),
    ("matrix products (dense layers)", ("gemm", "cutlass", "cublas")),
    ("reductions", ("reduce",)),
    ("AdamW and EMA (multi-tensor)", ("multi_tensor", "foreach")),
    ("elementwise and copies", ("elementwise", "vectorized", "copy", "fill", "cat", "index")),
)


def profile_steps(step, what, unprofiled_ms, steps=2, detail=True):
    """torch.profiler over ``steps`` calls of ``step`` (one ``what``): device
    time by kernel group, and the device and host time of K3's backward
    nodes (its kernel and the sum of the parameters' rows). The device idle share
    is the busy time against ``unprofiled_ms``, the wall time of a step
    measured in this run with the profiler off; host times read under the
    profiler are inflated by it. Returns the device's busy ms per step (None
    if the profiler recorded no device time); ``detail=False`` logs that
    alone."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    groups = collections.Counter()
    launches = collections.Counter()
    other = collections.Counter()
    gn_bwd = None
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):  # a range over kernels counted below
                continue
            name = e.key.lower()
            group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)), "other")
            groups[group] += e.self_device_time_total / 1e3 / steps
            launches[group] += e.count / steps
            if group == "other":
                other[e.key[:60]] += e.self_device_time_total / 1e3 / steps
        elif "_GroupNormFusedBackward" in e.key and "evaluate_function" in e.key:
            gn_bwd = (e.device_time_total / 1e3 / steps, e.cpu_time_total / 1e3 / steps)
    busy = sum(groups.values())
    if busy <= 0:
        log(f"[profile] torch.profiler recorded no device time: the breakdown of one {what} "
            "is not measured")
        return None
    if not detail:
        log(f"[profile] one {what} (mean of {steps}): device busy {busy:.3f} ms; wall "
            f"{unprofiled_ms:.3f} ms with the profiler off, device idle share "
            f"{1 - busy / unprofiled_ms:.3f}")
        return busy
    log(f"[profile] one {what} (mean of {steps}): device busy {busy:.3f} ms; wall "
        f"{unprofiled_ms:.3f} ms with the profiler off (the fastest kernels-on reading of "
        f"this run), device idle share {1 - busy / unprofiled_ms:.3f}; wall {wall_ms:.3f} ms "
        f"under the profiler, idle share {1 - busy / wall_ms:.3f}")
    for group, ms in groups.most_common():
        log(f"[profile]   {group}: {ms:.3f} ms ({ms / busy:.3f} of busy), "
            f"{launches[group]:.0f} launches")
    log(f"[profile]   largest of 'other': "
        f"{[(name, round(ms, 3)) for name, ms in other.most_common(4)]}")
    if gn_bwd:
        log(f"[profile]   K3's backward nodes (the backward kernel and the sum of the "
            f"parameters' rows; their kernels are counted in the groups above): device "
            f"{gn_bwd[0]:.3f} ms, host {gn_bwd[1]:.3f} ms per step (host time under the "
            f"profiler, which inflates it)")
    return busy


def phase_train(dev, state, workdir):
    """The training slice. (a) openai_64 with the null class, bf16 compute,
    remat on, dropout 0.05, HYBRID loss, batch 8, synthetic data:
    Trainer.train() for 4 steps (which saves), restore into a fresh Trainer,
    then Trainer.sample(4); steps/s with kernels on and off. (b) the train
    entry point's own EMNIST recipe at batch 468 for 3 steps."""
    from nicediffusion_tpu_torch import DiffusionModel, Trainer
    from nicediffusion_tpu_torch.scripts.train import main as train_main
    from nicediffusion_tpu_torch.training.data import synthetic_batches
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS

    cfg = model_config()
    dcfg = dict(DIFFUSION_PRESETS["openai_64"], guidance_method="classifier_free")
    steps = 4

    def make_trainer(kernels, **kw):
        model = DiffusionModel(**cfg, dtype=torch.bfloat16, use_remat=True, kernels=kernels,
                               device=dev)
        model.load_state_dict(state, strict=True)
        loader = synthetic_batches(TRAIN_BATCH, cfg["resolution"], cfg["in_channels"],
                                   cfg["num_classes"], seed=SEED)
        return Trainer(model, dcfg, loader, iterations=steps, batch_size=TRAIN_BATCH,
                       lr=1e-4, weight_decay=1e-3, ema_rate=0.99, seed=SEED, print_every=1,
                       **kw)

    ckpt = os.path.join(workdir, "openai_64")
    metrics = os.path.join(workdir, "openai_64.jsonl")
    trainer = make_trainer(True, checkpoint_dir=ckpt, metrics_path=metrics)
    reset_launches()
    trainer.train()
    torch.cuda.synchronize()
    launches_a = read_launches()
    expect = expect_train_launches(trainer.model, steps)
    log(f"[train] openai_64 bf16 remat batch {TRAIN_BATCH}, {steps} steps: launches "
        f"{launches_a}, expected {expect}")
    if launches_a != expect:
        raise AssertionError(f"launch counts {launches_a} != {expect}")
    rows = metrics_rows(metrics)
    log(f"[train] losses {[round(r['loss'], 5) for r in rows]}, grad norms "
        f"{[round(r['grad_norm'], 4) for r in rows]}")
    if len(rows) != steps or trainer.step != steps:
        raise AssertionError(f"{len(rows)} metric rows and step {trainer.step} after {steps} steps")
    moved = ema_moved = differ = 0
    for name, p in trainer.model.named_parameters():
        e = trainer.ema_model.get_parameter(name)
        moved += not torch.equal(p, state[name])
        ema_moved += not torch.equal(e, state[name])
        differ += not torch.equal(p, e)
    total = len(state)
    log(f"[train] of {total} parameters: {moved} moved, {ema_moved} EMA copies moved, "
        f"{differ} differ from their EMA copy")
    if not moved == ema_moved == differ == total:
        raise AssertionError("some parameter or EMA copy did not move")

    # the saved step_4 restores into a fresh Trainer with equal tensors
    fresh = make_trainer(True, checkpoint_dir=ckpt, resume_step="auto")
    if fresh.step != steps:
        raise AssertionError(f"restored step {fresh.step}")
    pairs = list(zip(trainer.model.state_dict().items(), fresh.model.state_dict().values()))
    pairs += list(zip(trainer.ema_model.state_dict().items(), fresh.ema_model.state_dict().values()))
    for (name, a), b in pairs:
        if not torch.equal(a, b):
            raise AssertionError(f"{name} differs after restore")
    for i, st in trainer.optimizer.state_dict()["state"].items():
        for key, a in st.items():
            if not torch.equal(a, fresh.optimizer.state_dict()["state"][i][key]):
                raise AssertionError(f"optimizer state {i}.{key} differs after restore")
    log(f"[train] step_{steps} restored into a fresh Trainer: model, EMA and AdamW state equal")
    del fresh
    torch.cuda.empty_cache()

    reset_launches()
    t0 = time.perf_counter()
    images = trainer.sample(4)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    launches_s = read_launches()
    chain = trainer.sampling_diffusion.rescaled_num_steps
    expect = expect_train_launches(trainer.model, 0, sample_calls=chain)
    log(f"[train] Trainer.sample(4): {images.shape} {images.dtype} in {sample_s:.2f} s over the "
        f"forced {chain}-step chain; launches {launches_s}, expected {expect}")
    if images.shape != (4, 64, 64, 3) or str(images.dtype) != "uint8" or launches_s != expect:
        raise AssertionError("in-training sampling gave the wrong shape, type or launch counts")

    # steps/s, kernels on and off, in turns within this run
    def timed_steps(tr, n=2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            batch, labels = next(tr.loader)
            tr.train_step(batch, labels)
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    off = make_trainer(False, checkpoint_dir=os.path.join(workdir, "off"))
    timed_steps(off, 1)  # warm-up
    rates = {True: [], False: []}
    for kernels, tr in ((True, trainer), (False, off), (False, off), (True, trainer)):
        rates[kernels].append(timed_steps(tr))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train] steps/s, 2 steps a reading: kernels on {rates[True]}, kernels off "
        f"{rates[False]} (openai_64, bf16, remat, batch {TRAIN_BATCH}); peak device memory "
        f"{peak:.2f} GiB")
    profile_steps(lambda: trainer.train_step(*next(trainer.loader)), "training step",
                  unprofiled_ms=1e3 / max(rates[True]))
    del trainer, off
    torch.cuda.empty_cache()

    # (b) the entry point's own recipe: EMNIST preset + null class, batch 468,
    # f32. The entry point itself turns TF32 off for f32 compute: hand it
    # PyTorch's default and see that it did.
    torch.backends.cudnn.allow_tf32 = True
    reset_launches()
    metrics_b = os.path.join(workdir, "emnist.jsonl")
    t0 = time.perf_counter()
    emnist = train_main([
        "--synthetic", "--iterations", "3", "-w", "--print_every", "1",
        "--checkpoint_dir", os.path.join(workdir, "emnist"), "--metrics_path", metrics_b,
        "--samples_dir", os.path.join(workdir, "samples"),
    ])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches_b = read_launches()
    expect = expect_train_launches(emnist.model, 3)
    rows = metrics_rows(metrics_b)
    log(f"[train] entry point, EMNIST recipe at batch {emnist.batch_size} on {emnist.device}, "
        f"f32 (TF32 in cuDNN {torch.backends.cudnn.allow_tf32}, in cuBLAS "
        f"{torch.backends.cuda.matmul.allow_tf32}): 3 steps and the save in {seconds:.2f} s, "
        f"losses {[round(r['loss'], 5) for r in rows]}; launches {launches_b}, expected {expect}")
    if (launches_b != expect or emnist.device.type != "cuda"
            or emnist.batch_size != EMNIST_BATCH):
        raise AssertionError("the entry point's launch counts, device or batch are off")
    # the zero-initialised output convs left zero in both copies
    for name, p in emnist.model.named_parameters():
        e = emnist.ema_model.get_parameter(name)
        if not p.any() or not e.any() or torch.equal(p, e):
            raise AssertionError(f"entry point: {name} or its EMA copy did not move")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the entry point left TF32 on for f32 compute")
    if emnist.latest_checkpoint_step() != 3:
        raise AssertionError("the entry point left no step_3 checkpoint")
    return {"train_openai_64": launches_a, "train_sample": launches_s, "train_emnist": launches_b}


def resblock_halves(model, dev):
    """The residual-block halves of one forward of ``model`` that K4 could
    stand for, as a Counter of (H, C, F, ada) -> halves per forward: every
    ``in_norm -> in_conv`` without an in-block resample between them, and
    every ``out_norm -> out_conv`` (AdaGN when the model uses it)."""
    from nicediffusion_tpu_torch.models.unet import ResidualBlock

    halves = collections.Counter()

    def hook(mod, args, out):
        h_in, h_out = args[0].shape[1], out.shape[1]
        c_in, c_out = mod.in_conv.weight.shape[1], mod.in_conv.weight.shape[0]
        if not (mod.upsample or mod.downsample):
            halves[(h_in, c_in, c_out, False)] += 1
        halves[(h_out, c_out, c_out, mod.use_adaptive_gn)] += 1

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, ResidualBlock)]
    x = torch.zeros(1, model.resolution, model.resolution, model.in_channels, device=dev)
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    with torch.inference_mode():
        model(x, zero, zero)
    for h in hooks:
        h.remove()
    return halves


def resblock_bound_ms(b, h, w, c, f, dtype):
    """(bytes ms, operations ms) of K4: x read, the output written and the
    weights read once; 2 * 9 * C * F operations an output pixel at the
    tensor cores' peak in bf16 and at the f32 peak in f32, plus about 12 f32
    operations an input element for the normalisation and SiLU."""
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    pixels = b * h * w
    bytes_moved = (pixels * (c + f) + 9 * c * f) * dtype.itemsize + 4 * (2 * c + f)
    return (bytes_moved / HBM_BYTES_PER_S * 1e3,
            (2 * 9 * c * f * pixels / peak + 12 * pixels * c / F32_FLOPS) * 1e3)


def resblock_inputs(g, dev, dtype, b, h, w, c, f, ada):
    """x, the GN affine, an (F, C, 3, 3) weight scaled by its fan-in, a bias
    and, for AdaGN, modulation rows as the two halves of one (B, 2C) tensor
    (the model's ``emb.chunk(2)``)."""
    x = (2 * torch.randn(b, h, w, c, generator=g, device=dev) + 0.5).to(dtype)
    gamma = 1.0 + 0.2 * torch.randn(c, generator=g, device=dev)
    beta = 0.1 * torch.randn(c, generator=g, device=dev)
    weight = torch.randn(f, c, 3, 3, generator=g, device=dev) / (9 * c) ** 0.5
    bias = 0.1 * torch.randn(f, generator=g, device=dev)
    emb = (0.3 * torch.randn(b, 2 * c, generator=g, device=dev)).to(dtype)
    return (x, gamma, beta, weight, bias) + (tuple(emb.chunk(2, dim=-1)) if ada else ())


def library_gn_silu_conv(x, gamma, beta, weight, bias, es=None, eb=None, groups=32):
    """The PyTorch calls that compute K4's function in x's dtype:
    F.group_norm on the channels-last view, the AdaGN modulation, F.silu,
    then F.conv2d (cuDNN)."""
    y = F.group_norm(x.permute(0, 3, 1, 2), groups, gamma, beta, 1e-5)
    if es is not None:
        y = y * (1.0 + es[:, :, None, None]) + eb[:, :, None, None]
    return F.conv2d(F.silu(y), weight, bias, padding=1).permute(0, 2, 3, 1)


def k4_rel_err(out, ref):
    """The largest ||out - ref||_F / ||ref||_F over the examples of two
    (B, H, W, F) outputs."""
    out, ref = out.double(), ref.double()
    rel = (torch.linalg.vector_norm(out - ref, dim=(1, 2, 3))
           / torch.linalg.vector_norm(ref, dim=(1, 2, 3)))
    return rel.max().item() if torch.isfinite(rel).all() else math.inf


def check_resblock(name, args, groups, dtype):
    """K4 into an output pre-filled with NaN, against its plain version with
    the reference convolution summed in float64 (cuDNN's f32 conv is itself
    up to 1.9e-5 off at the 8x8 and 16x16 maps, which would eat the gate);
    bf16 also to K4_BF16_REL. Returns (max abs err, relative error, out, ref)."""
    from nicediffusion_tpu_torch.ops.kernels import resblock as k4

    x, weight = args[0], args[3]
    out = torch.full(x.shape[:3] + weight.shape[:1], float("nan"), dtype=dtype, device=x.device)
    k4.gn_silu_conv3x3(*args, num_groups=groups, out=out)
    torch.cuda.synchronize()
    if torch.isnan(out).any():
        raise AssertionError(f"{name} {dtype}: output elements left unwritten")
    ref = k4.gn_silu_conv3x3_plain(*args, num_groups=groups, conv_dtype=torch.float64)
    err = check(f"{name} {dtype}", out, ref,
                K4_F32_TOL if dtype == torch.float32 else K4_BF16_TOL)
    rel = k4_rel_err(out, ref)
    if dtype == torch.bfloat16 and rel > K4_BF16_REL:
        raise AssertionError(f"{name} {dtype}: relative error {rel:.3g} over {K4_BF16_REL}")
    return err, rel, out, ref


def phase_resblock(dev, halves):
    """K4 against its plain version at every (H, C, F) of ``halves`` (one
    ``openai_64`` forward) at model batch 16, plain and AdaGN, f32 and bf16,
    and at small ragged shapes; bf16 also to K4_BF16_REL, and a planted
    fault, the weight flipped left-right, must fail that gate at every
    shape. bf16 times of each half (host-timed, device time by CUDA graph and
    by torch.profiler, the statistics launch apart) beside plain, library
    and bound, summed over the forward's halves. The timed calls reuse one
    weight tensor, so they hold no repack of it (the first call made it)."""
    from nicediffusion_tpu_torch.ops.kernels import resblock as k4

    b = PATHS["forward"][0]
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    rel_err = 0.0
    fault_rel, fault_passes_tol, faults = math.inf, 0, 0
    cudnn_f32 = {"plain": 0.0, "kernel": 0.0}  # against the plain version with cuDNN's f32 conv
    tally = Tally()
    stats_ms = 0.0  # the statistics launch, by torch.profiler, summed over the halves

    def bf16_fault(name, args, ref, groups):
        nonlocal fault_rel, fault_passes_tol, faults
        flipped = (*args[:3], args[3].flip(-1), *args[4:])
        bad = k4.gn_silu_conv3x3(*flipped, num_groups=groups)
        rel = k4_rel_err(bad, ref)
        if rel <= K4_BF16_REL:
            raise AssertionError(f"{name}: the weight flipped left-right reads {rel:.3g}, within "
                                 f"K4_BF16_REL")
        fault_rel, faults = min(fault_rel, rel), faults + 1
        fault_passes_tol += within(bad, ref, K4_BF16_TOL)

    for h, c, f in sorted({key[:3] for key in halves}):
        for dtype in (torch.float32, torch.bfloat16):
            for ada in (False, True):
                args = resblock_inputs(g, dev, dtype, b, h, h, c, f, ada)
                name = f"K4 {'ada' if ada else 'plain'} x {(b, h, h, c)} -> {f}"
                err, rel, out, ref = check_resblock(name, args, 32, dtype)
                errs[dtype] = max(errs[dtype], err)
                if dtype == torch.float32:
                    plain32 = k4.gn_silu_conv3x3_plain(*args)
                    for key, other in (("plain", ref), ("kernel", out)):
                        gap = (plain32 - other).abs().max().item()
                        cudnn_f32[key] = max(cudnn_f32[key], gap)
                    continue
                rel_err = max(rel_err, rel)
                bf16_fault(name, args, ref, 32)
                per_forward = halves.get((h, c, f, ada), 0)
                if not per_forward:
                    continue
                del out, ref
                lib_args = tuple(t.to(dtype) for t in args)
                fns = (lambda: k4.gn_silu_conv3x3(*args),
                       lambda: k4.gn_silu_conv3x3_plain(*args),
                       lambda: library_gn_silu_conv(*lib_args))
                ms, plain, lib = (time_ms(fn, iters=5, rounds=3) for fn in fns)
                device = tuple(graph_ms(fn, iters=5) for fn in fns)
                kernel_prof, by_name = profiled_ms(fns[0], by_name=True)
                stats = sum(v for k, v in by_name.items() if "group_stats" in k)
                prof = (kernel_prof, profiled_ms(fns[2]))
                bound = resblock_bound_ms(b, h, h, c, f, dtype)
                tally.add(per_forward, ms, plain, lib, bound, device, prof)
                stats_ms += per_forward * stats
                flop = 2 * 9 * c * f * b * h * h
                log(f"[k4] {name} {dtype}, {per_forward} per forward: device time {device[0]:.4f} "
                    f"ms by graph ({flop / device[0] / 1e9:.2f} TFLOP/s), {prof[0]:.4f} by "
                    f"torch.profiler ({flop / prof[0] / 1e9:.2f} TFLOP/s; the statistics launch "
                    f"{stats:.4f}), host-timed {ms:.4f}; plain {device[1]:.4f} (host {plain:.4f});"
                    f" library {device[2]:.4f} by graph, {prof[1]:.4f} by torch.profiler (host "
                    f"{lib:.4f}); bound {max(bound):.4f} ms")
    # tests/test_pallas_resblock.py:23, and ragged maps, channel and filter counts
    for shape, f, groups in (((2, 8, 8, 32), 64, 8), ((1, 16, 16, 64), 32, 32),
                             ((3, 4, 4, 96), 96, 32), ((2, 7, 7, 96), 40, 32),
                             ((2, 28, 14, 64), 3, 32), ((1, 9, 17, 40), 130, 8)):
        for dtype in (torch.float32, torch.bfloat16):
            for ada in (False, True):
                args = resblock_inputs(g, dev, dtype, *shape, f, ada)
                name = f"K4 {'ada' if ada else 'plain'} x {shape} -> {f}, {groups} groups"
                err, rel, _, ref = check_resblock(name, args, groups, dtype)
                errs[dtype] = max(errs[dtype], err)
                if dtype == torch.bfloat16:
                    rel_err = max(rel_err, rel)
                    bf16_fault(name, args, ref, groups)
    log(f"[k4] max abs err vs plain (its convolution summed in float64): f32 "
        f"{errs[torch.float32]:.3g} (gate {K4_F32_TOL}), bf16 {errs[torch.bfloat16]:.3g} "
        f"(gate {K4_BF16_TOL}); bf16 relative error per example {rel_err:.3g} (gate "
        f"{K4_BF16_REL})")
    log(f"[k4] planted fault, the weight flipped left-right, in {faults} bf16 cases: relative "
        f"error at least {fault_rel:.3g}, failing K4_BF16_REL in all; {fault_passes_tol} of them "
        f"pass K4_BF16_TOL alone")
    log(f"[k4] f32 at the openai_64 shapes, with cuDNN's f32 convolution (no TF32) in the plain "
        f"version instead: that plain version is {cudnn_f32['plain']:.3g} off the float64-summed "
        f"one, and K4 is {cudnn_f32['kernel']:.3g} off it (not gated: it measures the library's "
        f"choice of algorithm)")
    log(f"[k4] bf16 calls of the {sum(halves.values())} residual-block halves of "
        f"{PATHS['forward'][2]} that K4 could stand for, each timed back to back: {tally}; the "
        f"statistics launch {stats_ms:.4f} ms by torch.profiler "
        f"({stats_ms / tally.profiler_ms:.3f} of K4)")
    return errs, tally, {"max_rel_err_bf16": rel_err, "flipped_weight_min_rel_err": fault_rel,
                         "flipped_weight_cases": faults,
                         "flipped_weight_passing_abs_gate": fault_passes_tol,
                         "statistics_profiler_ms": stats_ms}


def phase_resblock_direct(dev, off, dtype):
    """K4 called directly, as no model calls it: one forward of ``off``
    (``openai_64``, kernels=False; for bf16 a bf16 copy of it) at batch 2
    records each residual block's input, modulation rows and what its
    ``in_conv`` and ``out_conv`` gave; then, with the counts reset, K4 is
    called once for every half it could stand for, on the block's own
    parameters, and held against the block's result: f32 to MODEL_TOL, bf16
    to K4_BF16_REL. Returns the launch counts of these calls."""
    from nicediffusion_tpu_torch import DiffusionModel
    from nicediffusion_tpu_torch.models.unet import ResidualBlock
    from nicediffusion_tpu_torch.ops.kernels import resblock as k4

    model = off
    if dtype == torch.bfloat16:
        model = DiffusionModel(**model_config(), dtype=dtype, kernels=False, device=dev).eval()
        model.load_state_dict(off.state_dict())
    seen = {}

    def keep(block, key):
        def hook(mod, args, out):
            seen.setdefault(block, {})[key] = (args, out)
        return hook

    hooks = []
    for block in (m for m in model.modules() if isinstance(m, ResidualBlock)):
        for key in ("in_norm", "in_conv", "out_norm", "out_conv"):
            hooks.append(getattr(block, key).register_forward_hook(keep(block, key)))
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    x = torch.randn(2, model.resolution, model.resolution, model.in_channels, generator=g,
                    device=dev)
    with torch.inference_mode():
        model(x, torch.tensor([980, 500], device=dev), torch.tensor([207, 0], device=dev))
    for h in hooks:
        h.remove()

    reset_launches()
    worst, halves = 0.0, 0
    with torch.inference_mode():
        for block, rec in seen.items():
            work = []
            if not (block.upsample or block.downsample):
                work.append((block.in_norm, block.in_conv, rec["in_norm"][0], rec["in_conv"][1]))
            work.append((block.out_norm, block.out_conv, rec["out_norm"][0], rec["out_conv"][1]))
            for norm, conv, norm_args, ref in work:
                out = k4.gn_silu_conv3x3(norm_args[0], norm.weight, norm.bias, conv.weight,
                                         conv.bias, *norm_args[1:], num_groups=norm.num_groups,
                                         eps=norm.eps)
                name = f"K4 for {tuple(norm_args[0].shape)} {dtype} -> {conv.weight.shape[0]}"
                if out.dtype != dtype or ref.dtype != dtype:
                    raise AssertionError(f"{name}: out {out.dtype}, the block's {ref.dtype}")
                if dtype == torch.float32:
                    worst = max(worst, check(name, out, ref, dict(atol=MODEL_TOL, rtol=0)))
                else:
                    rel = k4_rel_err(out, ref)
                    if rel > K4_BF16_REL:
                        raise AssertionError(f"{name}: relative error {rel:.3g} over "
                                             f"{K4_BF16_REL}")
                    worst = max(worst, rel)
                halves += 1
    torch.cuda.synchronize()
    launches = read_launches()
    gate = (f"max abs {worst:.3g} (gate {MODEL_TOL})" if dtype == torch.float32 else
            f"relative error per example at most {worst:.3g} (gate {K4_BF16_REL})")
    log(f"[k4] {launches['resblock']} direct calls in place of the residual-block halves of one "
        f"{dtype} openai_64 forward at batch 2 ({len(seen)} blocks), on each block's own input, "
        f"parameters and modulation rows, against what the blocks computed: {gate}")
    if launches["resblock"] != halves or not halves:
        raise AssertionError(f"{launches['resblock']} K4 launches for {halves} halves")
    if model is not off:
        del model
        torch.cuda.empty_cache()
    return launches


def phase_fast(dev, state, workdir):
    """The fast-sampling slice through the sampling entry point at
    full-width ``openai_64``: ``state`` is written to ``workdir`` under the
    name the preset dispatch reads, then ``main([...])`` samples 2 batches of
    8 labels in bf16 with CFG, DPM-Solver++ over 20 steps, dynamic
    thresholding, the encoder cache (k = 3) and guidance limited to the
    cleaner 0.6 of the chain. The batches the model's encoder and decoder
    saw and the launch counts must be what that structure gives. Then one
    chain with ``--prediction_type v``, images/s through the library with
    and without the two levers in turns, and an f32 chain with the levers,
    kernels on against ``kernels=False``."""
    from nicediffusion_tpu_torch import Diffusion, DiffusionModel
    from nicediffusion_tpu_torch.diffusion import graphs
    from nicediffusion_tpu_torch.models.unet import AttentionBlock, GroupNormOp
    from nicediffusion_tpu_torch.scripts.sample import main as sample_main
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS

    model_path = os.path.join(workdir, "64x64_diffusion.pt")
    torch.save(state, model_path)
    steps, k, interval = 20, 3, (0.0, 0.6)
    labels_arg = (3, 7)
    common = [
        "--model_path", model_path, "--guidance_method", "classifier_free",
        "--guidance_strength", "0.8", "--num_classes", str(model_config()["num_classes"]),
        "--batch_size", str(FAST_BATCH), "--sampler", "dpm++", "--rescaled_num_steps", str(steps),
        "--dynamic_thresholding", "0.995", "--seed", "0", "-w",
    ]

    # the batches every encode and decode call of the entry point's model sees
    seen = {"encode": [], "decode": []}
    originals = {name: getattr(DiffusionModel, name) for name in seen}

    def recording(name):
        def method(self, first, *args, **kw):
            seen[name].append(first.shape[0])
            return originals[name](self, first, *args, **kw)
        return method

    out_dir = os.path.join(workdir, "fast") + os.sep
    os.makedirs(out_dir)
    for name in seen:
        setattr(DiffusionModel, name, recording(name))
    # a replayed step runs no Python: the graphs add a step's calls at each replay
    tallies = [(seen, name) for name in seen]
    graphs.TALLIES.extend(tallies)
    try:
        reset_launches()
        t0 = time.perf_counter()
        samples = sample_main(common + [
            "--num_samples", str(len(labels_arg)), "--labels", "/".join(map(str, labels_arg)),
            "--save_path", out_dir, "--encoder_cache", str(k),
            "--guidance_interval", *map(str, interval)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        for name, fn in originals.items():
            setattr(DiffusionModel, name, fn)
        for t in tallies:
            graphs.TALLIES.remove(t)

    expect_files = sorted(f"{lab}_sample{i}.jpg" for lab in labels_arg for i in range(FAST_BATCH))
    if sorted(os.listdir(out_dir)) != expect_files:
        raise AssertionError(f"files {sorted(os.listdir(out_dir))} != {expect_files}")
    for (_, out, labels), lab in zip(samples, labels_arg):
        if (out.shape != (FAST_BATCH, 64, 64, 3) or str(out.dtype) != "uint8"
                or labels.tolist() != [lab] * FAST_BATCH or any(img.std() == 0 for img in out)):
            raise AssertionError(f"sample of label {lab}: {out.shape} {out.dtype}")

    # what the structure gives: groups of k from t = steps - 1 down, the tail
    # steps % k uncached; a group is guided iff any of its steps is in [lo, hi)
    lo, hi = (round(f * steps) for f in interval)
    chain = list(range(steps - 1, -1, -1))
    head = steps - steps % k
    groups = [chain[i:i + k] for i in range(0, head, k)] + [[t] for t in chain[head:]]
    enc, dec = [], []
    for group in groups:
        batch = FAST_BATCH * (2 if any(lo <= t < hi for t in group) else 1)
        enc.append(batch)
        dec += [batch] * len(group)
    model = DiffusionModel(**model_config(), dtype=torch.bfloat16, device=dev).eval()
    model.load_state_dict(state, strict=True)

    def count(part, kind):
        return sum(isinstance(m, kind) for m in part.modules())

    decoder = (model.middle_block, model.upsampling, model.out)
    attn = (count(model.downsampling, AttentionBlock),
            sum(count(p, AttentionBlock) for p in decoder))
    gn = (count(model.downsampling, GroupNormOp), sum(count(p, GroupNormOp) for p in decoder))
    n = len(labels_arg)
    conv = (conv_per_call(model, part=model.downsampling),
            conv_per_call(model, part=decoder))
    expect = {"attention": n * (len(enc) * attn[0] + len(dec) * attn[1]), "attention_bwd": 0,
              "groupnorm": n * (len(enc) * gn[0] + len(dec) * gn[1]), "groupnorm_bwd": 0,
              "mha": 0, "resblock": 0, "int8conv": 0,
              "conv": n * (len(enc) * conv[0] + len(dec) * conv[1])}
    log(f"[fast] entry point, openai_64, bf16, CFG, DPM++ {steps} steps, dynamic thresholding, "
        f"encoder cache {k}, guidance in {interval}: {len(expect_files)} files of 64x64 in "
        f"{cli_s:.2f} s (model built, checkpoint loaded, images saved inside that time); per "
        f"chain {len(enc)} encoder calls at batches {enc} and {len(dec)} decoder calls, "
        f"{dec.count(FAST_BATCH)} of them unguided at batch {FAST_BATCH}; launches {launches}, "
        f"expected {expect} (encoder {attn[0]} K1 + {gn[0]} K3, decoder {attn[1]} + {gn[1]})")
    if seen["encode"] != enc * n or seen["decode"] != dec * n:
        raise AssertionError(f"encoder batches {seen['encode']}, decoder batches {seen['decode']}")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")

    # the same weights read as a v-model: one chain through the entry point
    v_dir = os.path.join(workdir, "fast_v") + os.sep
    os.makedirs(v_dir)
    v_samples = sample_main(common + [
        "--num_samples", "1", "--labels", "3", "--save_path", v_dir, "--prediction_type", "v",
        "--encoder_cache", str(k), "--guidance_interval", *map(str, interval)])
    if (len(os.listdir(v_dir)) != FAST_BATCH or v_samples[0][1].shape != (FAST_BATCH, 64, 64, 3)
            or any(img.std() == 0 for img in v_samples[0][1])):
        raise AssertionError("the v-prediction chain gave the wrong files or a constant image")
    log(f"[fast] --prediction_type v: {FAST_BATCH} files, pixel range "
        f"[{v_samples[0][1].min()}, {v_samples[0][1].max()}]")

    # images/s with and without the levers, through the library, in turns
    dcfg = dict(DIFFUSION_PRESETS["openai_64"], rescaled_num_steps=steps, sampler="dpm++",
                clip_x="dynamic", dynamic_threshold=0.995, guidance_method="classifier_free",
                guidance_strength=0.8)
    diff = Diffusion(model=model, **dcfg)
    y = torch.arange(FAST_BATCH, device=dev) * 97 % 1000 + 1

    def chain_rate(levers, n_chains=2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_chains):
            out = diff.denoise(torch.Generator(device=dev).manual_seed(i), y=y,
                               batch_size=FAST_BATCH, **levers)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all() or out.abs().max() > 1.0:
            raise AssertionError(f"chain with {levers}: values not finite in [-1, 1]")
        return n_chains * FAST_BATCH / (time.perf_counter() - t0), out

    levers = dict(encoder_cache=k, guidance_interval=interval)
    rates = {"levers": [], "plain": []}
    outs = {}
    for which in ("levers", "plain", "plain", "levers"):
        rate, outs[which] = chain_rate(levers if which == "levers" else {})
        rates[which].append(rate)
    gap = (outs["levers"] - outs["plain"]).abs()
    log(f"[fast] images/s through the library, 2 chains of {FAST_BATCH} a reading: with the "
        f"cache and the interval {rates['levers']}, without {rates['plain']} (bf16, DPM++ "
        f"{steps} steps, dynamic thresholding, CFG); the levers are lossy: final samples differ "
        f"by max {gap.max().item():.4f}, mean {gap.mean().item():.5f} on random weights")
    del model, diff

    # f32, the levers on: kernels on against kernels=False
    f32 = {}
    for kernels in (True, False):
        m = DiffusionModel(**model_config(), kernels=kernels, device=dev).eval()
        m.load_state_dict(state, strict=True)
        d = Diffusion(model=m, **dict(dcfg, rescaled_num_steps=8))
        f32[kernels] = d.denoise(torch.Generator(device=dev).manual_seed(3), y=y[:2],
                                 batch_size=2, **levers)
        del m, d
    torch.cuda.synchronize()
    err = check("f32 fast chain, kernels on vs off", f32[True], f32[False],
                dict(atol=MODEL_TOL, rtol=0))
    log(f"[fast] f32, DPM++ 8 steps with the cache and the interval, batch 2: kernels on vs off "
        f"max abs {err:.3g} (gate {MODEL_TOL})")
    torch.cuda.empty_cache()
    return launches


def phase_train_128(dev, off):
    """Training at full-width ``openai_128`` (head dims 128, 192 and 256: the
    path that runs K2's 32-row tiles). ``off`` is the f32 model with
    kernels=False and remat: first every parameter's gradient, kernels on
    against off; then a ``Trainer`` in bf16 with remat and dropout at batch
    4 takes 3 steps on one synthetic batch with fixed t and noise, so the
    losses can be compared."""
    from nicediffusion_tpu_torch import DiffusionModel, Trainer
    from nicediffusion_tpu_torch.training.data import synthetic_batches
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS, MODEL_PRESETS

    phase_grads(dev, off, "openai_128", GUIDED_BATCH)

    cfg = dict(MODEL_PRESETS["openai_128"])
    dcfg = dict(DIFFUSION_PRESETS["openai_128"], rescaled_num_steps=1000, guidance_method=None)
    model = DiffusionModel(**cfg, dtype=torch.bfloat16, use_remat=True, device=dev)
    model.load_state_dict(off.state_dict(), strict=True)
    nparams = sum(p.numel() for p in model.parameters())
    loader = synthetic_batches(GUIDED_BATCH, cfg["resolution"], cfg["in_channels"],
                               cfg["num_classes"], seed=SEED)
    # at lr 1e-4 the second step on these random weights overshoots (the loss goes
    # 1.33, 2.29, 1.02); at 1e-5 it falls at every step
    trainer = Trainer(model, dcfg, loader, iterations=3, batch_size=GUIDED_BATCH, lr=1e-5,
                      weight_decay=1e-3, ema_rate=0.99, seed=SEED)
    batch, labels = next(loader)
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    t = torch.tensor([10, 300, 600, 990], device=dev)
    noise = torch.randn(batch.shape, generator=g, device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, seconds = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, labels, t=t, noise=noise)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
        if not (math.isfinite(losses[-1]) and math.isfinite(metrics["grad_norm"].item())):
            raise AssertionError(f"step {len(losses)}: loss or gradient norm not finite")
    launches = read_launches()
    expect = expect_train_launches(trainer.model, 3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train-128] openai_128, {nparams} parameters, bf16, remat, batch {GUIDED_BATCH}, 3 "
        f"steps on one batch with fixed t and noise: losses {[round(v, 5) for v in losses]}, "
        f"seconds a step {[round(v, 4) for v in seconds]} (the first holds cuDNN's "
        f"warm-up), steps/s over the last two {2 / sum(seconds[1:]):.4f}; peak device memory "
        f"{peak:.2f} GiB; launches {launches}, expected {expect}")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")
    # falling or steady (dropout draws a new mask each step, which moves the loss a little)
    if not losses[-1] <= losses[0]:
        raise AssertionError(f"the loss rose over 3 steps on one batch: {losses}")
    step_ms = min(seconds[1:]) * 1e3
    profile_steps(lambda: trainer.train_step(batch, labels, t=t, noise=noise),
                  "openai_128 training step", unprofiled_ms=step_ms, steps=2, detail=False)
    del trainer, model
    torch.cuda.empty_cache()
    return launches


def wide_config():
    """openai_128's widths at one head: 1 head over 512, 768 and 1024
    channels at 32x32, 16x16 and 8x8 (head dims 512, 768 and 1024). The
    number of heads changes no parameter's shape, so the preset's weights
    load as they are."""
    from nicediffusion_tpu_torch.utils.config import MODEL_PRESETS

    return dict(MODEL_PRESETS["openai_128"], num_heads=1)


def phase_wide_heads(dev, state):
    """[wide-heads]: every attention call on the chunked build. The
    ``openai_128`` widths at one head (wide_config) on ``state``, the
    weights of [model-128]'s ``openai_128``, through the entry points a user
    calls: (a) the f32 forward at model batch WIDE_BATCH, kernels on against
    ``kernels=False`` (MODEL_TOL), and the bf16 forward (finite, its distance
    from kernels off read); (b) loss and every gradient of the f32 model,
    kernels on against off (phase_grads: LOSS_TOL, GRAD_TOL); (c) the
    sampling entry point in custom mode, bf16, a WIDE_STEPS-step DDIM chain of
    WIDE_TRAIN_BATCH images (files there, images finite and not constant);
    (d) one ``Trainer`` step in bf16 with remat at batch WIDE_TRAIN_BATCH,
    its loss and gradient norm finite. The launch counts of (a), (c) and (d)
    are held to the structure: K1 once per attention call (twice a block in
    a remat step), K2 once per attention block a step. Returns their sum."""
    from PIL import Image

    from nicediffusion_tpu_torch import DiffusionModel, Trainer
    from nicediffusion_tpu_torch.models.unet import AttentionBlock, GroupNormOp
    from nicediffusion_tpu_torch.scripts.sample import main as sample_main
    from nicediffusion_tpu_torch.training.data import synthetic_batches
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS

    cfg = wide_config()
    total = collections.Counter()
    t0 = time.perf_counter()

    def held(what, launches, expect, routes=None):
        """the launch counts, and those of each route above head dim 256:
        every bf16 call on the P-resident route (no N here exceeds its
        limit), every f32 one on the walk"""
        ran = read_routes()
        log(f"[wide-heads] {what}: launches {launches}, expected {expect}; by route {ran}, "
            f"expected {routes}")
        if launches != expect or ran != routes:
            raise AssertionError(f"[wide-heads] {what}: launch counts {launches}, {ran} != "
                                 f"{expect}, {routes}")
        total.update(launches)
        total.update(ran)

    # (a) the forwards, kernels on against off
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    x = torch.randn(WIDE_BATCH, cfg["resolution"], cfg["resolution"], cfg["in_channels"],
                    generator=g, device=dev)
    t = torch.randint(0, 1000, (WIDE_BATCH,), generator=g, device=dev)
    y = torch.randint(0, cfg["num_classes"], (WIDE_BATCH,), generator=g, device=dev)
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for kernels in (False, True):
            model = DiffusionModel(**cfg, dtype=dtype, kernels=kernels, device=dev).eval()
            model.load_state_dict(state, strict=True)
            reset_launches()
            with torch.inference_mode():
                outs[dtype, kernels] = model(x, t, y).float()
            torch.cuda.synchronize()
            if kernels:
                # one forward's launches; in bf16 also the entry point's, a step
                n_attn = sum(isinstance(m, AttentionBlock) for m in model.modules())
                n_gn = sum(isinstance(m, GroupNormOp) for m in model.modules())
                per_forward = {"attention": n_attn, "attention_bwd": 0, "groupnorm": n_gn,
                               "groupnorm_bwd": 0, "mha": 0, "resblock": 0, "int8conv": 0,
                               "conv": conv_per_call(model)}
                route = "resident" if dtype == torch.bfloat16 else "walk"
                held(f"{dtype} forward at model batch {WIDE_BATCH}", read_launches(), per_forward,
                     {f"K1 {route}": n_attn})
            del model
        out, ref = outs[dtype, True], outs[dtype, False]
        if out.shape != (WIDE_BATCH, cfg["resolution"], cfg["resolution"],
                         cfg["out_channels"]) or not torch.isfinite(out).all():
            raise AssertionError(f"[wide-heads] {dtype} forward: {tuple(out.shape)}, or not finite")
        if dtype == torch.float32:
            err = check("[wide-heads] f32 forward, kernels on vs off", out, ref,
                        dict(atol=MODEL_TOL, rtol=0))
        else:
            err = (out - ref).abs().max().item()
        log(f"[wide-heads] openai_128 widths at num_heads=1, {dtype} forward at model batch "
            f"{WIDE_BATCH}: kernels on vs off max abs {err:.3g} (output max abs "
            f"{ref.abs().max().item():.3g}" + (f"; gate {MODEL_TOL})" if dtype == torch.float32
                                               else "; read, bf16)"))
    # (b) the f32 loss and gradients, kernels on against off
    off = DiffusionModel(**cfg, kernels=False, device=dev).eval()
    off.load_state_dict(state, strict=True)
    phase_grads(dev, off, "openai_128", 4, cfg=cfg)
    del off, outs
    torch.cuda.empty_cache()
    log(f"[wide-heads] (a) and (b) took {time.perf_counter() - t0:.1f} s")

    # (c) the sampling entry point in custom mode
    t1 = time.perf_counter()
    dcfg = DIFFUSION_PRESETS["openai_128"]
    with tempfile.TemporaryDirectory() as workdir:
        model_path = os.path.join(workdir, "wide128.pt")
        torch.save(state, model_path)
        out_dir = os.path.join(workdir, "wide") + os.sep
        os.makedirs(out_dir)
        label = 207
        reset_launches()
        samples = sample_main([
            "--model_path", model_path, "--custom",
            "--resolution", str(cfg["resolution"]),
            "--model_channels", str(cfg["model_channels"]),
            "--channel_mult", "/".join(map(str, cfg["channel_mult"])),
            "--num_res_blocks", str(cfg["num_res_blocks"]),
            "--attention_resolutions", "/".join(map(str, cfg["attention_resolutions"])),
            "--num_heads", "1", "--num_classes", str(cfg["num_classes"]),
            "--split_qkv_first", "--resblock_updown", "--use_adaptive_gn",
            "--rescaled_num_steps", str(WIDE_STEPS), "--use_ddim",
            "--beta_schedule", dcfg["beta_schedule"],
            "--sampling_var_type", dcfg["sampling_var_type"],
            "--batch_size", str(WIDE_TRAIN_BATCH), "--num_samples", "1",
            "--labels", str(label), "--save_path", out_dir, "--seed", "0",
        ])
        torch.cuda.synchronize()
        files = sorted(os.listdir(out_dir))
        expect_files = [f"{label}_sample{i}.jpg" for i in range(WIDE_TRAIN_BATCH)]
        if files != expect_files:
            raise AssertionError(f"[wide-heads] files {files} != {expect_files}")
        for name in files:
            with Image.open(out_dir + name) as img:
                if img.size != (cfg["resolution"],) * 2:
                    raise AssertionError(f"[wide-heads] {name}: {img.size}")
    (_, images, labels), = samples
    if images.shape != (WIDE_TRAIN_BATCH, cfg["resolution"], cfg["resolution"], 3) or any(
            img.std() == 0 for img in images):
        raise AssertionError(f"[wide-heads] samples {images.shape}, or a constant image")
    held(f"the sampling entry point, bf16, DDIM {WIDE_STEPS} steps at batch {WIDE_TRAIN_BATCH}",
         read_launches(), {k: n * WIDE_STEPS for k, n in per_forward.items()},
         {"K1 resident": per_forward["attention"] * WIDE_STEPS})
    log(f"[wide-heads] (c) {WIDE_TRAIN_BATCH} images of label {label} through the sampling "
        f"entry point (custom mode) in {time.perf_counter() - t1:.1f} s")

    # (d) one Trainer step, bf16, remat
    t2 = time.perf_counter()
    model = DiffusionModel(**cfg, dtype=torch.bfloat16, use_remat=True, device=dev)
    model.load_state_dict(state, strict=True)
    loader = synthetic_batches(WIDE_TRAIN_BATCH, cfg["resolution"], cfg["in_channels"],
                               cfg["num_classes"], seed=SEED)
    trainer = Trainer(model, dict(dcfg, rescaled_num_steps=1000, guidance_method=None), loader,
                      iterations=1, batch_size=WIDE_TRAIN_BATCH, lr=1e-5, weight_decay=1e-3,
                      ema_rate=0.99, seed=SEED)
    batch, batch_labels = next(loader)
    reset_launches()
    metrics = trainer.train_step(batch, batch_labels)
    torch.cuda.synchronize()
    loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
    if not (math.isfinite(loss) and math.isfinite(norm)):
        raise AssertionError(f"[wide-heads] Trainer step: loss {loss}, gradient norm {norm}")
    expect = expect_train_launches(trainer.model, 1)
    held(f"one Trainer step, bf16, remat, batch {WIDE_TRAIN_BATCH}", read_launches(), expect,
         {"K1 resident": expect["attention"], "K2 resident": expect["attention_bwd"]})
    log(f"[wide-heads] (d) one Trainer step: loss {loss:.5f}, gradient norm {norm:.4g}, "
        f"{time.perf_counter() - t2:.1f} s with the model's set-up")
    del trainer, model
    torch.cuda.empty_cache()
    return dict(total)


INT8_OPS = 1979e12  # int8 tensor-core operations a second, dense
INT8_SERVE_BATCH = 64  # bench.py's batch: model batch 128 under CFG


def int8_conv_calls(model, cfg, dev):
    """Every int8 conv call of one forward of ``cfg``'s quantized model, as a
    Counter of (H, W, C, F, k, stride) -> calls per forward: hooks on the
    layers of the float ``model`` (kernels=False; shapes only) that the
    quantized model makes int8 (its int8_layers' names)."""
    from nicediffusion_tpu_torch import DiffusionModel

    names = DiffusionModel(**cfg, quantized=True, device="meta").int8_layers()
    modules = dict(model.named_modules())
    calls = collections.Counter()

    def hook(mod, args):
        _, h, w, c = args[0].shape
        f, _, k, _ = mod.weight.shape
        calls[(h, w, c, f, k, mod.stride)] += 1

    hooks = [modules[name].register_forward_pre_hook(hook) for name in names]
    x = torch.zeros(1, model.resolution, model.resolution, model.in_channels, device=dev)
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    with torch.inference_mode():
        model(x, zero, zero)
    for h in hooks:
        h.remove()
    if sum(calls.values()) != len(names):
        raise AssertionError(f"{sum(calls.values())} int8 conv calls for {len(names)} layers")
    return calls


def int8_bound_ms(b, h, w, c, f, k, stride, xbytes=2, obytes=2):
    """(bytes ms, operations ms) of the int8 conv: x read once (in its float
    type), the int8 weights once, the output written once; 2 k^2 C F
    operations an output pixel at the int8 tensor-core peak."""
    pixels = b * ((h - 1) // stride + 1) * ((w - 1) // stride + 1)
    bytes_moved = b * h * w * c * xbytes + f * k * k * c + pixels * f * obytes + 8 * f
    return bytes_moved / HBM_BYTES_PER_S * 1e3, 2 * pixels * f * k * k * c / INT8_OPS * 1e3


def library_conv_bf16(x, weight, bias, stride):
    """What int8 serving replaces: the port's bf16 Conv2d, F.conv2d (cuDNN)
    on the channels-last view, permuted back."""
    k = weight.shape[-1]
    return F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride,
                    padding=k // 2).permute(0, 2, 3, 1).contiguous()


def int8_inputs(g, dev, b, h, w, c, f, k, xdtype):
    """x (a few values past the static scale's range, so some clip at
    +-127), int8 weights (F, k, k, C), inv_act, deq and a bias."""
    x = (2.0 * torch.randn(b, h, w, c, generator=g, device=dev)).to(xdtype)
    kq = torch.randint(-127, 128, (f, k, k, c), generator=g, device=dev, dtype=torch.int8)
    inv_act = torch.tensor(127.0 / 6.0, device=dev)
    deq = 1e-4 * (1.0 + torch.rand(f, generator=g, device=dev))
    bias = 0.1 * torch.randn(f, generator=g, device=dev)
    return x, kq, inv_act, deq, bias


def phase_int8_kernel(dev, calls64, calls_emnist, calls_qe):
    """The int8 conv against its plain version (exact float64 sums) at every
    (H, W, C, F, k, stride) one int8 forward of ``openai_64`` and of the
    EMNIST model gives it, at model batch 16, and one int8 forward of
    quality_eval's UNet (``calls_qe``) at model batch ``QE_BATCH`` and at
    half of it (checked, not timed), f32 and bf16 input: the s32 sums and the outputs bit-equal. bf16 times of the
    ``openai_64`` calls and of quality_eval's (host-timed, by CUDA graph and
    by torch.profiler) beside the plain version, the bf16 F.conv2d the int8
    path replaces and the bound, summed over one forward; TOPS per call.
    The ``openai_64`` calls again at model batch 128 (``int8_serve``: serve
    batch 64 under CFG, the int8 served path's batch), bf16 x only, bit-equal
    and timed the same ways but for the plain version (float64 sums at that
    batch would take most of the phase). Each line names the route and tiles
    ``int8_conv_plan`` gives the call. Returns (the ``openai_64`` tally,
    quality_eval's tally, the serve batch's tally, cases, errors)."""
    from nicediffusion_tpu_torch.ops.kernels import int8conv as k8

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    tallies = {"forward": Tally(), "qe_int8": Tally(), "int8_serve": Tally()}
    checked = 0
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}  # max |out - plain| by input type
    cases = [(PATHS["forward"][0], key, "forward", calls64.get(key, 0))
             for key in sorted(set(calls64) | set(calls_emnist))]
    cases += [(PATHS["qe_int8"][0], key, "qe_int8", n) for key, n in sorted(calls_qe.items())]
    # checked, not timed: the max stack's unguided steps at half the batch
    cases += [(PATHS["qe_int8_gi"][0], key, "qe_int8_gi", 0) for key in sorted(calls_qe)]
    cases += [(PATHS["int8_serve"][0], key, "int8_serve", n) for key, n in sorted(calls64.items())]
    for b, key, where, per_forward in cases:
        h, w, c, f, k, stride = key
        serve = where == "int8_serve"
        for xdtype in (torch.bfloat16,) if serve else (torch.float32, torch.bfloat16):
            x, kq, inv_act, deq, bias = int8_inputs(g, dev, b, h, w, c, f, k, xdtype)
            out, sums = k8.int8_conv_nhwc(x, kq, inv_act, deq, bias, stride, xdtype, raw=True)
            torch.cuda.synchronize()
            ref, ref_sums = k8.int8_conv_plain(x, kq, inv_act, deq, bias, stride, xdtype,
                                               raw=True)
            if not torch.equal(sums, ref_sums):
                bad = (sums != ref_sums).sum().item()
                raise AssertionError(f"int8 conv {key} batch {b} {xdtype}: {bad} s32 sums "
                                     f"differ")
            errs[xdtype] = max(errs[xdtype], (out.float() - ref.float()).abs().max().item())
            if not torch.equal(out, ref):
                raise AssertionError(f"int8 conv {key} batch {b} {xdtype}: outputs differ by "
                                     f"{errs[xdtype]:.3g}")
            checked += 1
        if not per_forward:
            continue
        del out, sums, ref, ref_sums
        weight = torch.randn(f, c, k, k, generator=g, device=dev, dtype=torch.bfloat16)
        lib_bias = bias.to(torch.bfloat16)
        fns = (lambda: k8.int8_conv_nhwc(x, kq, inv_act, deq, bias, stride),
               lambda: k8.int8_conv_plain(x, kq, inv_act, deq, bias, stride),
               lambda: library_conv_bf16(x, weight, lib_bias, stride))
        ms = time_ms(fns[0], iters=10, rounds=3)
        plain = 0.0 if serve else time_ms(fns[1], iters=2, rounds=1)
        lib = time_ms(fns[2], iters=10, rounds=3)
        device = (graph_ms(fns[0]), 0.0 if serve else graph_ms(fns[1], iters=2, rounds=1),
                  graph_ms(fns[2]))
        prof = (profiled_ms(fns[0]), profiled_ms(fns[2]))
        bound = int8_bound_ms(b, h, w, c, f, k, stride)
        tallies[where].add(per_forward, ms, plain, lib, bound, device, prof)
        ops = 2 * b * ((h - 1) // stride + 1) * ((w - 1) // stride + 1) * f * k * k * c
        route, tile, step = k8.int8_conv_plan(b, h, w, c, f, k, stride, torch.bfloat16)
        log(f"[int8] conv {(b, h, w, c)} -> {f}, {k}x{k}, stride {stride}, bf16, {per_forward} "
            f"per forward, {route} route, {tile} filters x {step} channels a step: device time "
            f"{device[0]:.4f} ms by graph ({ops / device[0] / 1e9:.1f} TOPS), {prof[0]:.4f} by "
            f"torch.profiler ({ops / prof[0] / 1e9:.1f} TOPS), host-timed {ms:.4f}; "
            + ("plain not timed at this batch; " if serve else
               f"plain {device[1]:.4f} (host {plain:.4f}); ")
            + f"bf16 F.conv2d {device[2]:.4f} by graph, {prof[1]:.4f} by torch.profiler (host "
            f"{lib:.4f}); bound {max(bound):.4f} ms "
            f"({'bytes' if bound[0] >= bound[1] else 'operations'})")
    log(f"[int8] the int8 conv at {checked} (shape, batch, input type) cases of one openai_64 "
        f"and one EMNIST int8 forward at model batch {PATHS['forward'][0]} and one int8 "
        f"forward of quality_eval's UNet at model batch {PATHS['qe_int8'][0]} and "
        f"{PATHS['qe_int8_gi'][0]}: s32 sums and "
        f"outputs bit-equal to the plain version (exact float64 sums, the same f32 epilogue)")
    for where, calls in (("forward", calls64), ("qe_int8", calls_qe), ("int8_serve", calls64)):
        b = PATHS[where][0]
        ops = 2 * sum(n * b * ((h - 1) // s + 1) * ((w - 1) // s + 1) * f * k * k * c
                      for (h, w, c, f, k, s), n in calls.items())
        t = tallies[where]
        log(f"[int8] bf16 calls of {PATHS[where][2]}'s {sum(calls.values())} int8 convs, "
            f"each timed back to back: {t}"
            + (" (plain not timed at this batch)" if where == "int8_serve" else "")
            + f"; {ops / t.profiler_ms / 1e9:.1f} TOPS by torch.profiler, "
            f"{ops / t.device_ms / 1e9:.1f} by graph; the kernel at "
            f"{t.bound_ms / t.device_ms:.3f} of its bound by graph; cuDNN bf16 / int8 conv "
            f"{t.device_library_ms / t.device_ms:.3f} by graph, "
            f"{t.profiler_library_ms / t.profiler_ms:.3f} by torch.profiler")
    return tallies["forward"], tallies["qe_int8"], tallies["int8_serve"], checked, errs


def conv_calls(model, dev, tp=1):
    """Every Conv2d call of one forward of ``model`` (kernels=False; shapes
    only), as a Counter of (H, W, C, F, k, stride) -> calls per forward. With
    ``tp`` > 1, the calls of one tensor-parallel rank in their place: a
    weight the sharding table cuts on dim 0 (column-parallel, ``in_conv``)
    has F / tp filters, on dim 1 (row-parallel, ``out_conv``) C / tp
    channels; ``model`` runs unsharded."""
    from nicediffusion_tpu_torch.models.unet import Conv2d, SuperResolutionModel
    from nicediffusion_tpu_torch.parallel.sharding import unet_param_shard_dims

    calls = collections.Counter()
    dims = unet_param_shard_dims(model, tp)

    def hook(name, mod, args):
        _, h, w, c = args[0].shape
        f, _, k, _ = mod.weight.shape
        cut = dims[f"{name}.weight"]
        f, c = (f // tp if cut == 0 else f), (c // tp if cut == 1 else c)
        calls[(h, w, c, f, k, mod.stride)] += 1

    hooks = [m.register_forward_pre_hook(functools.partial(hook, name))
             for name, m in model.named_modules() if isinstance(m, Conv2d)]
    x = torch.zeros(1, model.resolution, model.resolution, model.in_channels, device=dev)
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    with torch.inference_mode():
        if isinstance(model, SuperResolutionModel):
            x = x[..., :model.in_channels // 2]
            model(x, zero, low_res=torch.zeros(1, SR_LOW, SR_LOW, x.shape[-1], device=dev),
                  y=zero)
        else:
            model(x, zero, zero)
    for h in hooks:
        h.remove()
    if sum(calls.values()) != len(hooks):
        raise AssertionError(f"{sum(calls.values())} conv calls for {len(hooks)} Conv2d layers")
    return calls


# every (B, H, W, C, F, k, stride, bias or not) the bf16 conv launched at in
# this run: this process's and the [dp] and [tp] ranks'. [conv-cover] holds
# each that [conv] did not against the plain version.
CONV_SHAPES = set()


def record_conv_shapes():
    """Make the bf16 conv's launch add each call's shape to CONV_SHAPES (its
    launch count stays the wrapper's own), once per process."""
    from nicediffusion_tpu_torch.ops.kernels import conv as kc

    launch = kc._launch
    if getattr(launch, "records", False):
        return

    def recording(x, weight, bias, stride, *rest):
        CONV_SHAPES.add((*x.shape, weight.shape[0], weight.shape[-1], stride, bias is not None))
        return launch(x, weight, bias, stride, *rest)

    recording.records = True
    kc._launch = recording


def bf16_conv_bound_ms(b, h, w, c, f, k, stride):
    """(bytes ms, operations ms) of the bf16 conv: x, the bf16 weights and
    the bias read once, the output written once; 2 k^2 C F operations an
    output pixel at the bf16 tensor-core peak."""
    pixels = b * ((h - 1) // stride + 1) * ((w - 1) // stride + 1)
    bytes_moved = 2 * (b * h * w * c + f * k * k * c + pixels * f + f)
    return bytes_moved / HBM_BYTES_PER_S * 1e3, 2 * pixels * f * k * k * c / BF16_FLOPS * 1e3


def conv_inputs(g, dev, b, h, w, c, f, k):
    """bf16 x, a fan-in-scaled f32 (F, C, k, k) weight (the model's
    parameter; the wrapper casts it) and a bias."""
    x = torch.randn(b, h, w, c, generator=g, device=dev).bfloat16()
    weight = torch.randn(f, c, k, k, generator=g, device=dev) / (c * k * k) ** 0.5
    return x, weight, 0.1 * torch.randn(f, generator=g, device=dev)


# the paths whose bf16 forwards [conv] holds the bf16 conv at, each at its
# own batch: openai_64 sampling at model batch 16 and serving at 128, the
# guided openai_128 and SR slices, a tensor-parallel rank's forward (its
# shards), and quality_eval's UNet at its three batches
CONV_PATHS = ("forward", "serve64", "unet128", "sr256", "tp", "qe_unet", "qe_calib", "qe_gi")


def phase_conv(dev, calls):
    """``[conv]``: the bf16 conv (csrc/bf16conv.cu) against its plain version
    at every conv shape and batch of the CONV_PATHS (``calls``: path ->
    conv_calls; a shape two paths share at one batch once), with the bias
    and without (the row-parallel half of a tensor-parallel block): within
    BF16_CONV_TOL of the output's largest magnitude. At every ``openai_64``
    shape one example's output bit-identical alone, in rows 3 and 7 of a
    batch of 8 and rows 0 and 15 of a batch of 16, among random batch mates
    and among zeros; where F takes more than one filter tile, the tiles' bits
    equal. Times of the ``openai_64`` convs at model batch 16 and 128
    (host-timed, by CUDA graph, by torch.profiler; the weight's cast into the
    kernel's layout inside the call, as the model calls it) beside the plain
    version (at 16), cuDNN's bf16 F.conv2d, the conv the kernel replaces, and
    the bound, summed over one forward. Returns (tallies by batch, max abs
    error, max error relative to the output's largest magnitude, the gates'
    counts, the (B, H, W, C, F, k, stride, bias) cases held)."""
    from nicediffusion_tpu_torch.ops.kernels import conv as kc

    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    err = rel = 0.0
    invariant = tiles_equal = 0
    held = set()
    for where in CONV_PATHS:
        b = PATHS[where][0]
        new = 0
        for (h, w, c, f, k, stride) in sorted(calls[where]):
            if (b, h, w, c, f, k, stride, True) in held:
                continue
            for with_bias in (True, False):
                e, scale = conv_against_plain(g, dev, (b, h, w, c, f, k, stride, with_bias),
                                              f"[conv] {where}")
                err, rel = max(err, e), max(rel, e / scale)
                held.add((b, h, w, c, f, k, stride, with_bias))
                new += 1
        log(f"[conv] {where} ({PATHS[where][2]}): {new} new (shape, bias) cases within "
            f"{BF16_CONV_TOL} of the output's largest magnitude")
    log(f"[conv] the bf16 conv at {len(held)} cases (every conv shape and batch of "
        f"{', '.join(CONV_PATHS)}, with and without the bias) against its plain version (f32 "
        f"sums of the exact products, example by example): max abs err {err:.3g}, at most "
        f"{rel:.3g} of the output's largest magnitude (gate {BF16_CONV_TOL})")

    for (h, w, c, f, k, stride) in sorted(calls["forward"]):
        x0, weight, bias = conv_inputs(g, dev, 1, h, w, c, f, k)
        ref = kc.conv_nhwc(x0, weight, bias, stride)[0]
        for batch, row, mates in ((8, 3, "random"), (8, 7, "zeros"), (16, 0, "zeros"),
                                  (16, 15, "random")):
            x = (torch.randn(batch, h, w, c, generator=g, device=dev).bfloat16()
                 if mates == "random" else
                 torch.zeros(batch, h, w, c, dtype=torch.bfloat16, device=dev))
            x[row] = x0[0]
            if not torch.equal(kc.conv_nhwc(x, weight, bias, stride)[row], ref):
                raise AssertionError(f"[conv] {(h, w, c)} -> {f}, {k}x{k} stride {stride}: one "
                                     f"example's output moves at row {row} of {batch} among "
                                     f"{mates}")
            invariant += 1
        tiles = [t for t in kc.FILTER_TILES if f % t == 0]
        if len(tiles) > 1:
            x = torch.randn(16, h, w, c, generator=g, device=dev).bfloat16()
            outs = [kc.conv_nhwc(x, weight, bias, stride, filter_tile=t) for t in tiles]
            if not all(torch.equal(outs[0], o) for o in outs[1:]):
                raise AssertionError(f"[conv] {(h, w, c)} -> {f}: filter tiles {tiles} give "
                                     f"other bits")
            tiles_equal += 1
    log(f"[conv] one example's output bit-identical alone and in {invariant} (batch, row, "
        f"mates) cases at the {len(calls['forward'])} openai_64 conv shapes; the filter tiles "
        f"(wgmma m64n64, m64n128, m64n192) give the same bits at the {tiles_equal} shapes whose F "
        f"takes more than one")

    tallies = {}
    for b in (PATHS["forward"][0], PATHS["serve64"][0]):
        tally = tallies[b] = Tally()
        plain_timed = b == PATHS["forward"][0]
        for (h, w, c, f, k, stride), per_forward in sorted(calls["forward"].items()):
            x, weight, bias = conv_inputs(g, dev, b, h, w, c, f, k)
            lib_w, lib_b = weight.bfloat16(), bias.bfloat16()
            fns = (lambda: kc.conv_nhwc(x, weight, bias, stride),
                   lambda: kc.conv_nhwc_plain(x, weight, bias, stride),
                   lambda: library_conv_bf16(x, lib_w, lib_b, stride))
            ms = time_ms(fns[0], iters=10, rounds=3)
            plain = time_ms(fns[1], iters=2, rounds=1) if plain_timed else 0.0
            lib = time_ms(fns[2], iters=10, rounds=3)
            device = (graph_ms(fns[0]), graph_ms(fns[1], iters=2, rounds=1) if plain_timed
                      else 0.0, graph_ms(fns[2]))
            prof = (profiled_ms(fns[0]), profiled_ms(fns[2]))
            bound = bf16_conv_bound_ms(b, h, w, c, f, k, stride)
            tally.add(per_forward, ms, plain, lib, bound, device, prof)
            ops = 2 * b * ((h - 1) // stride + 1) * ((w - 1) // stride + 1) * f * k * k * c
            route, tile = kc.conv_nhwc_plan(h, w, k, stride, f)
            units = kc.conv_nhwc_units(b, h, w, k, stride, f, tile)
            blocks = min(units, torch.cuda.get_device_properties(dev).multi_processor_count)
            log(f"[conv] {(b, h, w, c)} -> {f}, {k}x{k}, stride {stride}, {per_forward} per "
                f"forward, plan: {route} route, {tile} filters a unit, {units} units on {blocks} "
                f"persistent blocks: device time {device[0]:.4f} ms "
                f"by graph ({ops / device[0] / 1e9:.1f} TFLOP/s), {prof[0]:.4f} by "
                f"torch.profiler, host-timed {ms:.4f}; "
                + (f"plain {device[1]:.4f} (host {plain:.4f}); " if plain_timed else "")
                + f"cuDNN bf16 F.conv2d {device[2]:.4f} by graph, {prof[1]:.4f} by "
                f"torch.profiler (host {lib:.4f}); bound {max(bound):.4f} ms "
                f"({'bytes' if bound[0] >= bound[1] else 'operations'})")
            del x
        ops = 2 * sum(n * b * ((h - 1) // s + 1) * ((w - 1) // s + 1) * f * k * k * c
                      for (h, w, c, f, k, s), n in calls["forward"].items())
        log(f"[conv] bf16 conv, the {sum(calls['forward'].values())} convs of one openai_64 "
            f"forward at model batch {b}, each timed back to back: {tally}"
            + ("" if plain_timed else " (plain not timed at this batch)")
            + f"; {ops / tally.device_ms / 1e9:.1f} TFLOP/s by graph; the kernel at "
            f"{tally.bound_ms / tally.device_ms:.3f} of its bound by graph; cuDNN / bf16 conv "
            f"{tally.device_library_ms / tally.device_ms:.3f} by graph, "
            f"{tally.profiler_library_ms / tally.profiler_ms:.3f} by torch.profiler")
    return tallies, err, rel, {"batch_invariant_cases": invariant,
                               "filter_tile_shapes_bit_equal": tiles_equal}, held


def conv_against_plain(g, dev, case, what):
    """The bf16 conv against its plain version at ``case`` = (B, H, W, C, F,
    k, stride, bias or not) on seeded inputs; raises past BF16_CONV_TOL of
    the output's largest magnitude. Returns (max abs err, that magnitude)."""
    from nicediffusion_tpu_torch.ops.kernels import conv as kc

    b, h, w, c, f, k, stride, with_bias = case
    x, weight, bias = conv_inputs(g, dev, b, h, w, c, f, k)
    bias = bias if with_bias else None
    out = kc.conv_nhwc(x, weight, bias, stride)
    torch.cuda.synchronize()
    ref = kc.conv_nhwc_plain(x, weight, bias, stride)
    e = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not e <= BF16_CONV_TOL * scale:
        raise AssertionError(f"{what} {(b, h, w, c)} -> {f}, {k}x{k} stride {stride}, "
                             f"{'with' if with_bias else 'no'} bias: max abs err {e:.3g} over "
                             f"{BF16_CONV_TOL} x {scale:.3g}")
    return e, scale


def phase_conv_cover(dev, held):
    """``[conv-cover]``: every (shape, batch, bias) the bf16 conv launched at
    in this run (CONV_SHAPES: this process's paths and the [dp] and [tp]
    ranks') that [conv] did not hold (``held``), against its plain version at
    the same gate. Returns (cases launched, cases held here, max abs err, max
    relative err)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    err = rel = 0.0
    todo = sorted(CONV_SHAPES - held)
    for case in todo:
        e, scale = conv_against_plain(g, dev, case, "[conv-cover]")
        err, rel = max(err, e), max(rel, e / scale)
    log(f"[conv-cover] the bf16 conv launched at {len(CONV_SHAPES)} (B, H, W, C, F, k, stride, "
        f"bias) cases in this run; [conv] held {len(CONV_SHAPES & held)} of them, the other "
        f"{len(todo)} held now against the plain version: "
        + (f"max abs err {err:.3g}, at most {rel:.3g} of the output's largest magnitude "
           f"(gate {BF16_CONV_TOL})" if todo else "none left")
        + f"; batches {sorted({case[0] for case in CONV_SHAPES})}")
    return len(CONV_SHAPES), len(todo), err, rel


# the model batches of [winograd]'s timings: a sampling forward's, and a
# forward of serve batch 64 under CFG
WINOGRAD_BATCHES = (16, 128)
WINOGRAD_STEPS = 10  # [winograd]'s DDIM chains
WINOGRAD_CHAIN_BATCH = 64  # images a chain in the on/off reading at model batch 128
# the bf16 Winograd model kernels on and off, each against the f32 Winograd
# model: the kernel changes only the order of M's f32 sums (and K1, K3 and
# the bf16 conv theirs), so its relative error may exceed the plain
# versions' by little; a fault in V, U, the products or A^T M A would move
# every output by far more
WINOGRAD_BF16_SLACK = 1.5


def winograd_calls(model, dev):
    """Every WinogradConv call of one forward of ``model`` (kernels=False;
    shapes only), as a Counter of (H, W, C, F) -> calls per forward."""
    from nicediffusion_tpu_torch.models.unet import WinogradConv

    calls = collections.Counter()

    def hook(mod, args):
        _, h, w, c = args[0].shape
        calls[(h, w, c, mod.weight.shape[0])] += 1

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, WinogradConv)]
    x = torch.zeros(1, model.resolution, model.resolution, model.in_channels, device=dev)
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    with torch.inference_mode():
        model(x, zero, zero if model.conditional else None)
    for h in hooks:
        h.remove()
    if sum(calls.values()) != len(hooks):
        raise AssertionError(f"{sum(calls.values())} Winograd calls for {len(hooks)} layers")
    return calls


def winograd_bound_ms(b, h, w, c, f):
    """(bytes ms, operations ms) of the Winograd conv: x, U (16 F C bf16) and
    the f32 bias read once, the output written once; 2 x 16 C F operations a
    4x4 tile (four outputs) at the bf16 tensor-core peak."""
    tiles = b * -(-h // 2) * -(-w // 2)
    bytes_moved = 2 * (b * h * w * c + 16 * f * c + b * h * w * f) + 4 * f
    return bytes_moved / HBM_BYTES_PER_S * 1e3, 2 * 16 * tiles * c * f / BF16_FLOPS * 1e3


def winograd_inputs(g, dev, b, h, w, c, f):
    """bf16 x, a fan-in-scaled (F, C, 3, 3) weight in bf16 (the model casts
    its parameter so before the transform), its U and an f32 bias."""
    from nicediffusion_tpu_torch.ops.winograd import transform_weights_3x3

    x = torch.randn(b, h, w, c, generator=g, device=dev).bfloat16()
    weight = (torch.randn(f, c, 3, 3, generator=g, device=dev) / (9 * c) ** 0.5).bfloat16()
    return x, weight, transform_weights_3x3(weight), 0.1 * torch.randn(f, generator=g, device=dev)


def winograd_against_plain(g, dev, case, what):
    """The Winograd conv against its plain version at ``case`` = (B, H, W, C,
    F, bias or not) on seeded inputs. The same V and U, exact products, f32
    sums over C in another order, one rounding to bf16 after the bias: one
    bf16 ulp of the output and f32 noise, inside BF16_CONV_TOL of the
    output's largest magnitude, past which it raises. Returns (max abs err,
    that magnitude)."""
    from nicediffusion_tpu_torch.ops.kernels import winograd as kw

    b, h, w, c, f, with_bias = case
    x, _, u, bias = winograd_inputs(g, dev, b, h, w, c, f)
    bias = bias if with_bias else None
    out = kw.winograd_conv_nhwc(x, u, bias)
    torch.cuda.synchronize()
    ref = kw.winograd_conv_nhwc_plain(x, u, bias)
    e = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not (bool(torch.isfinite(out).all()) and e <= BF16_CONV_TOL * scale):
        raise AssertionError(f"{what} {(b, h, w, c)} -> {f}, {'with' if with_bias else 'no'} "
                             f"bias: max abs err {e:.3g} over {BF16_CONV_TOL} x {scale:.3g}")
    return e, scale


def rel_err(out, ref):
    """||out - ref||_F / ||ref||_F in float64; inf if out is not finite."""
    out, ref = out.double(), ref.double()
    if not torch.isfinite(out).all():
        return math.inf
    return (torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref)).item()


def phase_winograd(dev, state):
    """``[winograd]``: ``DiffusionModel(winograd=True)`` at full-width
    ``openai_64`` on ``state`` (its 72 residual-block 3x3 convs and the stem
    through csrc/winograd.cu in bf16 with grad mode off). (a) The kernel
    against its plain version (BF16_CONV_TOL) at every Winograd conv shape
    of ``openai_64`` at model batch 16 and 128 and of the EMNIST model (28,
    14 and 7 maps) at 16, with the bias, and at 16 without for
    ``openai_64``. (b) The f32 Winograd forward (the plain function on the
    card, TF32 off) against the f32 direct model (MODEL_TOL); the bf16
    forward and a DDIM-10 CFG chain
    kernels on and off, each against the f32 Winograd model (the kernels'
    relative error at most WINOGRAD_BF16_SLACK times the plain versions').
    (c) The main path with every count reset: that chain through
    ``Diffusion.denoise`` and the served batches of ``serve_positions``
    (plain versions refused), each Winograd conv through the kernel; one
    example's output bit for bit alone at row 0 among zeros, at rows 7 and
    15 of 16 and row 3 of 8, and through the daemon. (d) The kernel's times
    over the 73 convs at model batch 16 and 128 (host-timed, by CUDA graph,
    by torch.profiler), beside its plain version (the XLA composition's
    method, on the card), the bf16 conv at the same convs (csrc/bf16conv.cu,
    as the direct model calls it), cuDNN's bf16 F.conv2d and the bound. (e)
    A bf16 forward at model batch 128, winograd on against off: device busy
    ms, wall, idle share (in turns), and samples/s of a DDIM-10 chain of 64
    images. U made once a weight (WinogradConv keeps it) in (b), (c) and (e);
    (d) reads what making it each call would cost.
    Returns (kernel tallies by batch, max abs err, max err relative to the
    output's largest magnitude, readings, the main path's launches)."""
    from nicediffusion_tpu_torch import Diffusion, DiffusionModel
    from nicediffusion_tpu_torch.models.unet import AttentionBlock, GroupNormOp, WinogradConv
    from nicediffusion_tpu_torch.ops.kernels import conv as kc
    from nicediffusion_tpu_torch.ops.kernels import winograd as kw
    from nicediffusion_tpu_torch.ops.winograd import transform_weights_3x3
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS

    t_start = time.perf_counter()

    def took(part):
        log(f"[winograd] {part} took {time.perf_counter() - t_start:.1f} s from the phase's start")

    cfg = model_config()
    meta = torch.device("meta")
    calls = winograd_calls(DiffusionModel(**cfg, winograd=True, kernels=False,
                                          device=meta).eval(), meta)
    emnist = winograd_calls(DiffusionModel(**model_config("EMNIST"), winograd=True,
                                           kernels=False, device=meta).eval(), meta)
    n_win = sum(calls.values())
    g = torch.Generator(device=dev).manual_seed(SEED + 20)

    # each shape's plan (filter tile, cluster, blocks): the batch plays no part
    b16, b128 = WINOGRAD_BATCHES
    for h, w, c, f in sorted(set(calls) | set(emnist)):
        plan = kw.winograd_conv_plan(h, w, c, f)
        log(f"[winograd] plan {(h, w, c, f)}: {plan['filters']} filters x {plan['tiles']} tiles "
            f"a unit, a cluster of {plan['cluster']} blocks, {plan['steps']} steps; " + ", ".join(
                f"{kw.winograd_conv_units(b, h, w, c, f)} blocks at model batch {b}"
                for b in (WINOGRAD_BATCHES if (h, w, c, f) in calls else (b16,))))

    # (a) the kernel against its plain version
    cases = {(b, *shape, True) for b in WINOGRAD_BATCHES for shape in calls}
    cases |= {(b16, *shape, False) for shape in calls}
    cases |= {(b16, *shape, True) for shape in emnist}
    err = rel = 0.0
    for case in sorted(cases):
        e, scale = winograd_against_plain(g, dev, case, "[winograd]")
        err, rel = max(err, e), max(rel, e / scale)
    log(f"[winograd] the Winograd conv at {len(cases)} (B, H, W, C, F, bias) cases (the "
        f"{len(calls)} shapes of openai_64's {n_win} Winograd convs at model batch {b16} and "
        f"{b128}, EMNIST's {len(emnist)} at 28, 14 and 7 at {b16}) against its plain version: "
        f"max abs err {err:.3g}, at most {rel:.3g} of the output's largest magnitude (gate "
        f"{BF16_CONV_TOL})")
    took("(a)")

    def make(dtype, kernels=True, winograd=True):
        m = DiffusionModel(**cfg, dtype=dtype, kernels=kernels, winograd=winograd,
                           device=dev).eval()
        m.load_state_dict(state, strict=True)
        return m

    # (b) f32 Winograd against the direct model; bf16 kernels on and off
    x = torch.randn(b16, 64, 64, 3, generator=g, device=dev)
    t = torch.randint(0, 1000, (b16,), generator=g, device=dev)
    y = torch.randint(0, cfg["num_classes"], (b16,), generator=g, device=dev)
    wf32, on, direct = make(torch.float32), make(torch.bfloat16), make(torch.float32,
                                                                       winograd=False)
    n_wconv = sum(isinstance(m, WinogradConv) for m in on.modules())
    if n_wconv != n_win:
        raise AssertionError(f"{n_wconv} WinogradConv layers, {n_win} Winograd calls")
    with torch.inference_mode():
        ref = wf32(x, t, y)
        e_f32 = (ref - direct(x, t, y)).abs().max().item()
    del direct
    off = make(torch.bfloat16, kernels=False)
    with torch.inference_mode():
        out_on, out_off = on(x, t, y), off(x, t, y)
    log(f"[winograd] f32 forward at model batch {b16} (TF32 off): Winograd against the direct "
        f"model max abs diff {e_f32:.3g} (gate {MODEL_TOL})")
    if not e_f32 <= MODEL_TOL:
        raise AssertionError(f"[winograd] the f32 Winograd forward is {e_f32:.3g} from the "
                             f"direct one")
    fwd = {"on": rel_err(out_on, ref), "off": rel_err(out_off, ref)}
    dcfg = dict(DIFFUSION_PRESETS["openai_64"], rescaled_num_steps=WINOGRAD_STEPS,
                use_ddim=True, ddim_eta=0.0, guidance_method="classifier_free",
                guidance_strength=0.8)
    labels = torch.arange(8, device=dev) * 97 % 1000 + 1

    def chain(model, batch=8, seed=11):
        return Diffusion(model=model, **dcfg).denoise(
            torch.Generator(device=dev).manual_seed(seed), y=labels.repeat(batch // 8),
            batch_size=batch)

    chain(on, seed=3).cpu()  # warm-up (cuDNN plans of the direct convs)
    torch.cuda.synchronize()
    reset_launches()
    kw.winograd_conv_nhwc.launches = 0
    chain_on = chain(on)
    with plain_versions_refused():
        pos, rerun, served, _, _, again = serve_positions(Diffusion(model=on, **dcfg), dev)
    torch.cuda.synchronize()
    launches = {**read_launches(), "winograd": kw.winograd_conv_nhwc.launches}
    # the chain, serve_positions' three served batches and its Diffusion.denoise
    forwards = WINOGRAD_STEPS * (1 + 3 + 1)
    n_attn = sum(isinstance(m, AttentionBlock) for m in on.modules())
    n_gn = sum(isinstance(m, GroupNormOp) for m in on.modules())
    expect = {"attention": n_attn * forwards, "attention_bwd": 0, "groupnorm": n_gn * forwards,
              "groupnorm_bwd": 0, "mha": 0, "resblock": 0, "int8conv": 0,
              "conv": conv_per_call(on) * forwards, "winograd": n_win * forwards}
    log(f"[winograd] main path (a DDIM-{WINOGRAD_STEPS} CFG chain of 8 through "
        f"Diffusion.denoise, then serve_positions' three served batches of 8 and its chain, "
        f"{forwards} forwards at model batch {b16}, the plain versions refused while serving): "
        f"launches "
        f"{launches}, expected {expect}")
    if launches != expect:
        raise AssertionError(f"[winograd] launch counts {launches} != {expect}")
    bit = torch.equal(served, again)
    log(f"[winograd] served bf16 Winograd: one request alone against the same (seed, label) in "
        f"the last row of a full batch: max abs diff {pos:.6g} (gate 0); alone again "
        f"{rerun:.6g} (gate 0); the served batch against Diffusion.denoise: "
        f"{'bit-equal' if bit else 'DIFFERENT'}")
    if pos != 0 or rerun != 0 or not bit:
        raise AssertionError("[winograd] bf16 Winograd serving is not batch-position independent")
    with torch.inference_mode():
        chains = {"on": chain_on.float(), "off": chain(off).float(), "f32": chain(wf32)}
    for name in ("on", "off"):
        if chains[name].shape != (8, 64, 64, 3) or not chains[name].abs().max() <= 1.0:
            raise AssertionError(f"[winograd] the {name} chain: {tuple(chains[name].shape)}, "
                                 f"values not finite in [-1, 1]")
    chn = {k: rel_err(chains[k], chains["f32"]) for k in ("on", "off")}
    log(f"[winograd] bf16 against the f32 Winograd model, relative Frobenius error: forward at "
        f"model batch {b16} kernels on {fwd['on']:.4g}, off {fwd['off']:.4g}; DDIM-"
        f"{WINOGRAD_STEPS} chain on {chn['on']:.4g}, off {chn['off']:.4g}; on against off: "
        f"forward {rel_err(out_on, out_off):.4g}, chain "
        f"{rel_err(chains['on'], chains['off']):.4g} (gate: on at most {WINOGRAD_BF16_SLACK} "
        f"x off)")
    if not (fwd["on"] <= WINOGRAD_BF16_SLACK * fwd["off"]
            and chn["on"] <= WINOGRAD_BF16_SLACK * chn["off"]):
        raise AssertionError(f"[winograd] bf16 kernels on {fwd}, {chn}: past "
                             f"{WINOGRAD_BF16_SLACK} x kernels off")
    del off, wf32
    torch.cuda.empty_cache()

    # one example's output bit for bit at other rows and batch sizes
    target = (torch.randn(1, 64, 64, 3, generator=g, device=dev), torch.tensor([417], device=dev),
              torch.tensor([42], device=dev))

    def at_row(batch, row, mates):
        if mates == "zeros":
            xb = torch.zeros(batch, 64, 64, 3, device=dev)
            tb = torch.zeros(batch, dtype=torch.long, device=dev)
            yb = torch.zeros(batch, dtype=torch.long, device=dev)
        else:
            xb = torch.randn(batch, 64, 64, 3, generator=g, device=dev)
            tb = torch.randint(0, 1000, (batch,), generator=g, device=dev)
            yb = torch.randint(0, cfg["num_classes"], (batch,), generator=g, device=dev)
        xb[row], tb[row], yb[row] = target[0][0], target[1][0], target[2][0]
        with torch.inference_mode():
            return on(xb, tb, yb)[row]

    alone = at_row(16, 0, "zeros")
    rows = {(batch, row): torch.equal(alone, at_row(batch, row, "random"))
            for batch, row in ((16, 7), (16, 15), (8, 3))}
    log(f"[winograd] one example's bf16 forward at row 0 among zeros against rows 7 and 15 of "
        f"16 and row 3 of 8 among random batch mates: {rows} (gate: all bit-equal)")
    if not all(rows.values()):
        raise AssertionError(f"[winograd] one example's output moves with its row: {rows}")
    took("(b), (c)")

    # (d) times over the 73 convs
    def conv_fns(x, weight, u, bias):
        """the four ways to one conv: the kernel (U made), its plain version,
        cuDNN, and the bf16 conv as the direct model calls it (its f32
        weight cast in the call, the bias rounded to bf16 as flax does)"""
        wparam, bias_bf16 = weight.float(), bias.bfloat16()
        return {"kernel": lambda: kw.winograd_conv_nhwc(x, u, bias),
                "plain": lambda: kw.winograd_conv_nhwc_plain(x, u, bias),
                "library": lambda: library_conv_bf16(x, weight, bias_bf16, 1),
                "direct": lambda: kc.conv_nhwc(x, wparam, bias, 1)}

    winograd_layers = [m for m in on.modules() if isinstance(m, WinogradConv)]
    make_u = graph_ms(lambda: [transform_weights_3x3(m.weight.bfloat16()) for m in
                               winograd_layers], iters=1, rounds=3)
    tallies, direct = {}, {}
    for b in WINOGRAD_BATCHES:
        tally, dt = tallies[b], direct[b] = Tally(), Tally()
        runs = {"kernel": [], "library": [], "direct": []}
        for (h, w, c, f), n in sorted(calls.items()):
            fns = conv_fns(*winograd_inputs(g, dev, b, h, w, c, f))
            host = {k: time_ms(fn, iters=1, rounds=2) if k == "plain"
                    else time_ms(fn, iters=5, rounds=3) for k, fn in fns.items()}
            graph = {k: graph_ms(fn, iters=1, rounds=1) if k == "plain"
                     else graph_ms(fn, iters=5, rounds=3) for k, fn in fns.items()}
            for k in runs:
                runs[k].append((fns[k], n))
            bound = winograd_bound_ms(b, h, w, c, f)
            tally.add(n, host["kernel"], host["plain"], host["library"], bound,
                      (graph["kernel"], graph["plain"], graph["library"]), (0.0, 0.0))
            dt.add(n, host["direct"], 0.0, host["library"], bf16_conv_bound_ms(b, h, w, c, f, 3, 1),
                   (graph["direct"], 0.0, graph["library"]), (0.0, 0.0))
            ops = 2 * 16 * b * -(-h // 2) * -(-w // 2) * c * f
            log(f"[winograd] {(b, h, w, c)} -> {f}, {n} per forward, "
                f"{kw.winograd_conv_units(b, h, w, c, f)} blocks: kernel {graph['kernel']:.4f} "
                f"ms by graph ({ops / graph['kernel'] / 1e9:.1f} TFLOP/s), host "
                f"{host['kernel']:.4f}; plain {graph['plain']:.4f} (host {host['plain']:.4f}); "
                f"bf16 conv {graph['direct']:.4f}; cuDNN bf16 F.conv2d {graph['library']:.4f}; "
                f"bound {max(bound):.4f} ms ({'bytes' if bound[0] >= bound[1] else 'operations'})")

        def one_forward(kind):
            return lambda: [fn() for fn, n in runs[kind] for _ in range(n)]

        tally.profiler_ms = profiled_ms(one_forward("kernel"), iters=2)
        tally.profiler_library_ms = dt.profiler_library_ms = profiled_ms(one_forward("library"),
                                                                         iters=2)
        dt.profiler_ms = profiled_ms(one_forward("direct"), iters=2)
        del runs
        log(f"[winograd] Winograd conv, the {n_win} Winograd convs of one openai_64 forward at "
            f"model batch {b}, each timed back to back: {tally}; the kernel at "
            f"{tally.bound_ms / tally.device_ms:.3f} of its bound by graph; bf16 conv at the same "
            f"convs by graph {dt.device_ms:.4f} ms, by torch.profiler {dt.profiler_ms:.4f}, "
            f"host-timed {dt.ms:.4f} (bound {dt.bound_ms:.4f}); Winograd / bf16 conv "
            f"{tally.device_ms / dt.device_ms:.3f} by graph, "
            f"{tally.profiler_ms / dt.profiler_ms:.3f} by torch.profiler; Winograd / cuDNN "
            f"{tally.device_ms / tally.device_library_ms:.3f} by graph, "
            f"{tally.profiler_ms / tally.profiler_library_ms:.3f} by torch.profiler")
    log(f"[winograd] U of the {n_win} layers (cast and transform, elementwise), what each "
        f"forward would cost if WinogradConv did not keep it: {make_u:.4f} ms by graph")
    took("(d)")

    # (e) a bf16 forward at model batch 128, winograd on against off
    models = {"on": on, "off": make(torch.bfloat16, winograd=False)}
    xb = torch.randn(b128, 64, 64, 3, generator=g, device=dev)
    tb = torch.randint(0, 1000, (b128,), generator=g, device=dev)
    yb = torch.randint(0, cfg["num_classes"], (b128,), generator=g, device=dev)
    forward_128 = {}
    for name in ("off", "on", "on", "off"):  # in turns
        model = models[name]

        def fwd128(model=model):
            with torch.inference_mode():
                model(xb, tb, yb)

        wall = time_ms(fwd128, iters=2, rounds=2)
        busy = profiled_ms(fwd128, iters=1)
        read = {"busy_ms": busy, "wall_ms": wall, "idle": 1 - busy / wall}
        if name not in forward_128:  # one chain each
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                chain(model, WINOGRAD_CHAIN_BATCH, seed=5)
            torch.cuda.synchronize()
            read["samples_per_s"] = WINOGRAD_CHAIN_BATCH / (time.perf_counter() - t0)
        forward_128.setdefault(name, []).append(read)
    for name, reads in forward_128.items():
        def each(key, fmt):
            return ", ".join(format(r[key], fmt) for r in reads)

        log(f"[winograd] bf16 openai_64 forward at model batch {b128}, winograd {name} (two "
            f"turns of off, on, on, off): device busy {each('busy_ms', '.3f')} ms, wall "
            f"{each('wall_ms', '.3f')} ms, idle share {each('idle', '.3f')}; a DDIM-"
            f"{WINOGRAD_STEPS} CFG chain of {WINOGRAD_CHAIN_BATCH} (in the first turn): "
            f"{reads[0]['samples_per_s']:.4f} samples/s")
    del models, on
    torch.cuda.empty_cache()
    took("(e)")
    readings = {"convs_per_forward": n_win, "f32_against_direct_max_abs": e_f32,
                "bf16_forward_rel_err": fwd,
                "bf16_chain_rel_err": chn, "rows_bit_equal": len(rows),
                "served_position_diff": pos, "cases_held": len(cases),
                "transform_ms_per_forward": make_u,
                "direct_bf16_conv_same_convs": {b: direct[b].fields() for b in direct},
                "forward_model_batch_128": forward_128}
    return tallies, err, rel, readings, launches


def int8_forward_kernels(forward, n_int8, model_batch):
    """The gate that the int8 conv is one launch a call: torch.profiler over
    one int8 forward must see exactly ``n_int8`` kernels of int8conv.cu (any
    kernel named for the int8 conv or a quantize pass), each one of the two
    routes' convs, and no other launch of that library."""
    from torch.profiler import ProfilerActivity, profile

    names = []
    for _ in range(PROFILER_TRIES):  # a profiled run now and then records no device activity
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            forward()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    ours = [n for n in names if "int8_conv" in n or "quantize" in n]
    routes = collections.Counter("halo" if "int8_conv_halo_wgmma" in n else
                                 "row" if "int8_conv_row_wgmma" in n else n[:60] for n in ours)
    log(f"[int8] torch.profiler over one int8 forward at model batch {model_batch}: "
        f"{len(names)} kernels, {len(ours)} of int8conv.cu ({dict(routes)}) for {n_int8} int8 "
        f"conv calls")
    if len(ours) != n_int8 or set(routes) - {"halo", "row"}:
        raise AssertionError(f"one int8 forward launched {dict(routes)} from int8conv.cu for "
                             f"{n_int8} int8 convs: not one conv kernel a call")


def phase_int8(dev, state, workdir, n_int8):
    """Static int8 serving through the sampling entry point at full-width
    ``openai_64``: ``--dtype int8``, CFG w = 0.8, 25 DDIM steps, 2 requests
    of 8 labels, ``--int8_calibration`` first writing the file (the
    calibration chain drawn through the dynamic path), then reading it; the
    two runs' images must be bit-equal and the launch counts what the
    structure gives (every int8 conv call through the kernel, K1 and K3 as
    on every path). Then int8 against bf16 samples/s and the device's idle
    share at the requests' batch and at batch 64, and the max stack: frozen
    int8, encoder_cache 2 and guidance_interval (0.1, 0.7), against the
    exact bf16 chain."""
    from nicediffusion_tpu_torch import Diffusion, DiffusionModel
    from nicediffusion_tpu_torch.models.unet import AttentionBlock, GroupNormOp
    from nicediffusion_tpu_torch.scripts.sample import main as sample_main
    from nicediffusion_tpu_torch.utils.checkpoint import load_calibration
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS

    model_path = os.path.join(workdir, "64x64_diffusion.pt")
    if not os.path.exists(model_path):
        torch.save(state, model_path)
    calib_path = os.path.join(workdir, "int8_calibration.npz")
    batch, labels_arg = FAST_BATCH, (3, 7)
    common = ["--model_path", model_path, "--guidance_method", "classifier_free",
              "--guidance_strength", "0.8", "--num_classes", str(model_config()["num_classes"]),
              "--batch_size", str(batch), "--num_samples", str(len(labels_arg)), "--labels",
              "/".join(map(str, labels_arg)), "--seed", "0", "--dtype", "int8",
              "--int8_calibration", calib_path, "-w"]
    model = DiffusionModel(**model_config(), dtype=torch.bfloat16, quantized=True,
                           device=dev).eval()
    model.load_state_dict(state, strict=True)
    n_attn = sum(isinstance(m, AttentionBlock) for m in model.modules())
    n_gn = sum(isinstance(m, GroupNormOp) for m in model.modules())
    if len(model.int8_layers()) != n_int8:
        raise AssertionError(f"{len(model.int8_layers())} int8 layers, {n_int8} int8 conv calls")
    dcfg = dict(DIFFUSION_PRESETS["openai_64"], guidance_method="classifier_free",
                guidance_strength=0.8)
    steps = Diffusion(model=model, **dcfg).rescaled_num_steps
    points = len({int(round(i * (steps - 1) / 5)) for i in range(6)})  # calibration_inputs'
    runs = []
    total = collections.Counter()
    for i, what in enumerate(("calibrates and writes", "reads")):
        out_dir = os.path.join(workdir, f"int8_{i}") + os.sep
        os.makedirs(out_dir)
        reset_launches()
        t0 = time.perf_counter()
        samples = sample_main(common + ["--save_path", out_dir])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        served = steps * len(labels_arg)  # the requests' model calls
        drawn = steps if i == 0 else 0  # the calibration chain, the dynamic int8 path
        recorded = points if i == 0 else 0  # float forwards that record the absmax
        expect = {"attention": n_attn * (served + drawn + recorded), "attention_bwd": 0,
                  "groupnorm": n_gn * (served + drawn + recorded), "groupnorm_bwd": 0,
                  "mha": 0, "resblock": 0, "int8conv": n_int8 * (served + drawn),
                  # the float convs (stem, head) of every call, and while the
                  # calibration records, the int8 layers' float convs too
                  "conv": conv_per_call(model) * (served + drawn)
                  + conv_per_call(model, recording=True) * recorded}
        files = sorted(os.listdir(out_dir))
        expect_files = sorted(f"{lab}_sample{j}.jpg" for lab in labels_arg for j in range(batch))
        log(f"[int8] entry point, openai_64 --dtype int8, CFG 0.8, {steps} DDIM steps, "
            f"{len(labels_arg)} requests of {batch}, --int8_calibration {what} the file: "
            f"{len(files)} files in {seconds:.2f} s (model built, checkpoint loaded"
            f"{', calibration chain drawn and recorded' if i == 0 else ', calibration read'}, "
            f"images saved inside that time); launches {launches}, expected {expect} "
            f"({n_int8} int8 convs, {n_attn} K1, {n_gn} K3 a call; {served} served calls"
            + (f", {drawn} of the calibration draw, {recorded} recording" if i == 0 else "")
            + ")")
        if files != expect_files or launches != expect:
            raise AssertionError(f"int8 entry point: files {files}, launches {launches}")
        for (_, out, labels), lab in zip(samples, labels_arg):
            if (out.shape != (batch, 64, 64, 3) or labels.tolist() != [lab] * batch
                    or any(img.std() == 0 for img in out)):
                raise AssertionError(f"int8 sample of label {lab}: {out.shape}")
        runs.append(samples)
        total.update(launches)
        if not os.path.exists(calib_path):
            raise AssertionError("--int8_calibration wrote no file")
    for (_, a, _), (_, b, _) in zip(*runs):
        if not (a == b).all():
            raise AssertionError("the run that read the calibration gave other images than "
                                 "the run that wrote it")
    log(f"[int8] the two runs' {2 * batch} images are bit-equal")

    # int8 against bf16, kernels on both, in turns, through the library
    model.freeze_int8(load_calibration(calib_path, dev))
    bf16 = DiffusionModel(**model_config(), dtype=torch.bfloat16, device=dev).eval()
    bf16.load_state_dict(state, strict=True)
    diffs = {"int8": Diffusion(model=model, **dcfg), "bf16": Diffusion(model=bf16, **dcfg)}
    rates = {}
    for b in (batch, INT8_SERVE_BATCH):
        y = torch.arange(b, device=dev) * 97 % 1000 + 1

        def chain(which, **levers):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = diffs[which].denoise(torch.Generator(device=dev).manual_seed(5), y=y,
                                       batch_size=b, **levers)
            torch.cuda.synchronize()
            return out, b / (time.perf_counter() - t0)

        chain("int8"), chain("bf16")  # warm-up: cuDNN plans at this batch
        got = {"int8": [], "bf16": []}
        outs = {}
        for which in ("int8", "bf16", "bf16", "int8"):
            outs[which], r = chain(which)
            got[which].append(r)
        corr = torch.corrcoef(torch.stack([outs["int8"].flatten(),
                                           outs["bf16"].flatten()]))[0, 1].item()
        if not torch.isfinite(outs["int8"]).all() or outs["int8"].abs().max() > 1.0:
            raise AssertionError(f"int8 chain at batch {b}: values not finite in [-1, 1]")
        rates[b] = got
        log(f"[int8] samples/s at batch {b} (model batch {2 * b}), CFG 0.8, {steps} DDIM "
            f"steps, kernels on, in turns: int8 {got['int8']}, bf16 {got['bf16']}; final "
            f"samples int8 against bf16: corrcoef {corr:.4f}")
        x = torch.randn(2 * b, 64, 64, 3, generator=torch.Generator(device=dev).manual_seed(6),
                        device=dev)
        t = torch.full((2 * b,), 500, dtype=torch.long, device=dev)
        yy = torch.cat([y, torch.zeros_like(y)])
        for which, m in (("int8", model), ("bf16", bf16)):
            def forward(m=m):
                with torch.inference_mode():
                    m(x, t, yy)

            walls = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                forward()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            profile_steps(forward, f"openai_64 {which} sampling forward (model batch {2 * b})",
                          min(walls[1:]), steps=2, detail=b == INT8_SERVE_BATCH)
            if which == "int8":
                int8_forward_kernels(forward, n_int8, 2 * b)
        if b == batch:
            # one forward, int8 against bf16: the correlation bar of the JAX
            # package's quantized-forward tests (tests/test_quant.py); their
            # max |diff| / std bar (0.35) is for a 2 x 16 x 16 x 2 output, and
            # the largest of these 393,216 differences sits further out in the
            # tail, so it is read, not gated
            with torch.inference_mode():
                q8, ref = model(x, t, yy), bf16(x, t, yy)
            fwd_corr = torch.corrcoef(torch.stack([q8.flatten(), ref.flatten()]))[0, 1].item()
            fwd_err = ((q8 - ref).abs().max() / ref.std()).item()
            log(f"[int8] one forward at model batch {2 * b}, t = 500, int8 against bf16: "
                f"corrcoef {fwd_corr:.6f} (gate 0.99); max |diff| / std {fwd_err:.4f}")
            if not fwd_corr > 0.99:
                raise AssertionError(f"the int8 forward strays from the bf16 one: {fwd_corr}")
            # the max stack: frozen int8, the encoder cache and limited guidance
            stacked, _ = chain("int8", encoder_cache=2, guidance_interval=(0.1, 0.7))
            levers_bf16, _ = chain("bf16", encoder_cache=2, guidance_interval=(0.1, 0.7))
            exact, _ = chain("bf16")

            def corr(a, c):
                return torch.corrcoef(torch.stack([a.flatten(), c.flatten()]))[0, 1].item()

            log(f"[int8] max stack (int8, encoder_cache 2, guidance_interval (0.1, 0.7)) at "
                f"batch {b}: finite in [-1, 1]; corrcoef with the exact bf16 chain "
                f"{corr(stacked, exact):.4f} (the bf16 chain with the same levers "
                f"{corr(levers_bf16, exact):.4f}, the int8 chain without them "
                f"{corr(outs['int8'], exact):.4f}: a {steps}-step chain of random weights "
                f"carries small differences far, so this is read, not gated)")
            if not torch.isfinite(stacked).all() or stacked.abs().max() > 1.0:
                raise AssertionError("the max stack: values not finite in [-1, 1]")
    del model, bf16, diffs
    torch.cuda.empty_cache()
    return dict(total), rates


# ---------------------------------------------------------------------------
# super-resolution, ESRGAN and distillation
# ---------------------------------------------------------------------------

def sr_config():
    """The super-resolution UNet at the ``openai_256`` preset's widths, its
    input the noisy 256x256 image and the 64x64 low-res image upsampled to it
    (in_channels doubled, as the JAX package takes it)."""
    from nicediffusion_tpu_torch.utils.config import MODEL_PRESETS

    return dict(MODEL_PRESETS["openai_256"], in_channels=6)


def phase_sr(dev, off):
    """``[sr]``: ``off`` is the f32 SuperResolutionModel (kernels=False).
    Its forward at batch 2 with a 64x64 ``low_res``, kernels on against off;
    then a bf16 DDIM-25 chain (the preset's diffusion) driven through
    ``Diffusion.with_model_kwargs(low_res=...)``, its K1 and K3 launch counts
    against the structure and its time."""
    from nicediffusion_tpu_torch import Diffusion
    from nicediffusion_tpu_torch.models.unet import SuperResolutionModel
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS

    cfg = sr_config()
    res = cfg["resolution"]
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    low = torch.rand(SR_BATCH, SR_LOW, SR_LOW, 3, generator=g, device=dev) * 2 - 1
    x = torch.randn(SR_BATCH, res, res, 3, generator=g, device=dev)
    t = torch.tensor([980, 500], device=dev)
    y = torch.tensor([207, 933], device=dev)
    on = SuperResolutionModel(**cfg, device=dev).eval()
    on.load_state_dict(off.state_dict(), strict=True)
    nparams = sum(p.numel() for p in on.parameters())
    with torch.inference_mode():
        a = on(x, t, low_res=low, y=y)
        b = off(x, t, low_res=low, y=y)
    torch.cuda.synchronize()
    err = check("f32 SR forward, kernels on vs off", a, b, dict(atol=MODEL_TOL, rtol=0))
    log(f"[sr] SuperResolutionModel at openai_256 widths (in_channels 6), {nparams} parameters, "
        f"f32 forward at batch {SR_BATCH}, low_res {SR_LOW}x{SR_LOW} -> {res}x{res}: kernels on "
        f"vs off max abs {err:.3g} (gate {MODEL_TOL}; output max abs {b.abs().max().item():.3g})")
    del on, a, b
    torch.cuda.empty_cache()

    model = SuperResolutionModel(**cfg, dtype=torch.bfloat16, device=dev).eval()
    model.load_state_dict(off.state_dict(), strict=True)
    diff = Diffusion(model=model, **DIFFUSION_PRESETS["openai_256"]).with_model_kwargs(low_res=low)
    steps = diff.rescaled_num_steps
    n_attn, gn_in, gn_out = block_counts(model)
    expect = {"attention": n_attn * steps, "attention_bwd": 0, "groupnorm": (gn_in + gn_out) * steps,
              "groupnorm_bwd": 0, "mha": 0, "resblock": 0, "int8conv": 0,
              "conv": conv_per_call(model) * steps}
    secs = []
    for i in range(2):  # the first chain warms cuDNN's plans up
        start = torch.randn(SR_BATCH, res, res, 3, generator=g, device=dev)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = diff.denoise(g, x=start, y=y)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = read_launches()
        if launches != expect:
            raise AssertionError(f"SR chain launch counts {launches} != {expect}")
    if (out.shape != (SR_BATCH, res, res, 3) or not torch.isfinite(out).all()
            or out.abs().max() > 1.0):
        raise AssertionError(f"SR chain output {tuple(out.shape)} not finite in [-1, 1]")
    log(f"[sr] bf16 DDIM {steps} steps, batch {SR_BATCH}, through with_model_kwargs(low_res=): "
        f"{secs[1]:.3f} s a chain ({secs[0]:.3f} s the first), {SR_BATCH / secs[1]:.4f} images/s; "
        f"launches {launches}, expected {expect} ({n_attn} attention blocks, "
        f"{gn_in + gn_out} GroupNorms a forward)")
    t_last = torch.full((SR_BATCH,), steps - 1, dtype=torch.long, device=dev)

    @torch.inference_mode()
    def sr_step():
        diff.ddim_step(start, t_last, g, y=y)

    profile_steps(sr_step, "SR DDIM step (its model call at batch 2)",
                  unprofiled_ms=1e3 * secs[1] / steps)
    del model, diff
    torch.cuda.empty_cache()
    return launches


def phase_esrgan(dev, workdir):
    """``[esrgan]``: the sampling entry point with ``--upsample`` on the
    ``64x64_diffusion.pt`` that ``[fast]`` wrote, 1 request of 4 labels, run
    from a working directory whose ``models/RealESRGAN_x4plus.pth`` holds
    seeded random weights at the published width under basicsr's names
    inside ``{"params_ema": ...}``. The 256x256 files must be there and the
    skip message must not print; the ESRGAN stage is timed per image."""
    import contextlib
    import io

    from PIL import Image

    from nicediffusion_tpu_torch import DiffusionModel
    from nicediffusion_tpu_torch.models import rrdb
    from nicediffusion_tpu_torch.scripts.sample import main as sample_main

    root = os.path.join(workdir, "esrgan")
    os.makedirs(os.path.join(root, "models"))
    torch.manual_seed(SEED)  # the module initialisers draw from the global RNG
    net = rrdb.RRDBNet(device="cpu")
    nparams = sum(p.numel() for p in net.parameters())
    torch.save({"params_ema": net.state_dict()},
               os.path.join(root, "models", "RealESRGAN_x4plus.pth"))
    del net
    timed = []
    inner = rrdb.esrgan_upsample_batches

    def timing(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inner(*args, **kw)
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
        return res

    out_dir = os.path.join(root, "out") + os.sep
    os.makedirs(out_dir)
    cwd, buf = os.getcwd(), io.StringIO()
    rrdb.esrgan_upsample_batches = timing
    os.chdir(root)
    try:
        reset_launches()
        with contextlib.redirect_stdout(buf):
            samples = sample_main([
                "--model_path", os.path.join(workdir, "64x64_diffusion.pt"), "--num_classes",
                str(model_config()["num_classes"]), "--batch_size", "4", "--num_samples", "1",
                "--labels", "3", "--save_path", out_dir, "--upsample", "--seed", "0", "-w"])
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        os.chdir(cwd)
        rrdb.esrgan_upsample_batches = inner
    text = buf.getvalue()
    if "Skipping" in text or "Upsampling to 256x256" not in text:
        raise AssertionError(f"--upsample did not run the ESRGAN stage: {text[-400:]}")
    names = sorted(os.listdir(out_dir))
    sizes = {Image.open(out_dir + n).size for n in names}
    shown, out, _ = samples[0]
    if (len(names) != 4 or sizes != {(256, 256)} or out.shape != (4, 256, 256, 3)
            or shown.shape != out.shape or out.std() == 0):
        raise AssertionError(f"--upsample files {names} of sizes {sizes}, output {out.shape}")
    model = DiffusionModel(**model_config(), device="meta")
    n_attn, gn_in, gn_out = block_counts(model)
    steps = 25  # the openai_64 preset's chain
    expect = {"attention": n_attn * steps, "attention_bwd": 0, "groupnorm": (gn_in + gn_out) * steps,
              "groupnorm_bwd": 0, "mha": 0, "resblock": 0, "int8conv": 0,
              "conv": conv_per_call(model, torch.bfloat16) * steps}
    if launches != expect:
        raise AssertionError(f"--upsample launch counts {launches} != {expect}")
    log(f"[esrgan] entry point with --upsample, openai_64 bf16 DDIM {steps}, 4 labels, ESRGAN at "
        f"the published width ({nparams} parameters, f32): {len(names)} files of 256x256; the "
        f"ESRGAN stage {timed[0]:.3f} s, {timed[0] / 4:.4f} s per image (model built and "
        f"weights read inside that time); launches {launches} (the UNet's chain: ESRGAN runs "
        f"no hand-written kernel)")
    return launches


def distill_grads(dev, state):
    """``[distill]`` (a): the loss and every student-parameter gradient of
    one GuidedDistiller step (w 0.8) and one ProgressiveDistiller step, both
    with var_weight 1.0, at ``openai_64`` full width in f32, batch 2,
    injected j and noise: kernels on against ``kernels=False``, loss to
    LOSS_TOL of itself, each gradient to GRAD_TOL of its largest element."""
    from nicediffusion_tpu_torch import DiffusionModel
    from nicediffusion_tpu_torch.training.distill import GuidedDistiller, ProgressiveDistiller
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS

    cfg = model_config()
    dcfg = dict(DIFFUSION_PRESETS["openai_64"], rescaled_num_steps=50)
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    x0 = torch.rand(2, 64, 64, 3, generator=g, device=dev) * 2 - 1
    noise = torch.randn(2, 64, 64, 3, generator=g, device=dev)
    y = torch.tensor([207, 933], device=dev)
    stages = {
        "guided": (lambda m: GuidedDistiller(m, state, dcfg, iter(()), 1, guidance_strength=0.8,
                                             var_weight=1.0),
                   torch.tensor([3, 41], device=dev)),
        "progressive": (lambda m: ProgressiveDistiller(m, state, dcfg, iter(()), 1,
                                                       var_weight=1.0),
                        torch.tensor([0, 24], device=dev)),
    }
    for stage, (make, j) in stages.items():
        res = {}
        for kernels in (True, False):
            dist = make(DiffusionModel(**cfg, kernels=kernels, device=dev))
            loss_eps, loss_var = dist._losses(x0, y, j, noise)
            loss = loss_eps + loss_var
            grads = torch.autograd.grad(loss, dist._params)
            names = [n for n, _ in dist.model.named_parameters()]
            res[kernels] = (loss.item(), loss_var.item(), grads)
            del dist, loss, loss_eps, loss_var
        (loss_on, var_on, grads_on), (loss_off, var_off, grads_off) = res[True], res[False]
        if not abs(loss_on - loss_off) <= LOSS_TOL * max(1.0, abs(loss_off)):
            raise AssertionError(f"{stage} distill loss with kernels {loss_on} vs {loss_off}")
        worst, worst_name = 0.0, ""
        for name, a, b in zip(names, grads_on, grads_off):
            scale = b.abs().max().item()
            diff = (a - b).abs().max().item()
            rel = diff / scale if scale else (0.0 if diff == 0 else math.inf)
            if not rel <= GRAD_TOL:
                raise AssertionError(f"{stage} distill gradient of {name}: {rel:.3g} of its max")
            if rel > worst:
                worst, worst_name = rel, name
        log(f"[distill] {stage} step, openai_64 f32, batch 2, var_weight 1.0: loss {loss_on:.6f} "
            f"with kernels (variance term {var_on:.6g}), {loss_off:.6f} without "
            f"({var_off:.6g}); {len(names)} gradients, worst max |diff| / max |grad| "
            f"{worst:.3g} ({worst_name}), gate {GRAD_TOL}")
        del res, grads_on, grads_off
        torch.cuda.empty_cache()


def phase_distill(dev, state, workdir):
    """``[distill]``: (a) ``distill_grads``; (b) the distillation entry point
    on the ``64x64_diffusion.pt`` that ``[fast]`` wrote, bf16, guided stage
    (w 0.8) then one halving round from 50 steps, 4 iterations each at batch
    8, var_weight 1.0: the student ``.npz`` loads strictly, the sidecar holds
    the nested grid, the launch counts are the structure's; steps/s of each
    stage with kernels on and off, peak memory, a torch.profiler breakdown
    of one step of each; (c) the sampling entry point on the student with
    the printed hint against the teacher's CFG chain on the same labels:
    model calls and their batches counted by a hook on the forward,
    images/s of both."""
    import contextlib
    import io

    from nicediffusion_tpu_torch import Diffusion, DiffusionModel
    from nicediffusion_tpu_torch.diffusion import graphs
    from nicediffusion_tpu_torch.scripts.distill import main as distill_main
    from nicediffusion_tpu_torch.scripts.sample import main as sample_main
    from nicediffusion_tpu_torch.training.distill import GuidedDistiller, ProgressiveDistiller
    from nicediffusion_tpu_torch.utils.checkpoint import load_state_dict
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS

    distill_grads(dev, state)
    cfg = model_config()
    ncls = str(cfg["num_classes"])
    model_path = os.path.join(workdir, "64x64_diffusion.pt")
    student_path = os.path.join(workdir, "64x64_distilled.npz")
    teacher_steps, iters = 50, 4
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        sidecar = distill_main([
            "--model_path", model_path, "--num_classes", ncls, "--distill_guidance", "0.8",
            "--rounds", "1", "--steps", str(teacher_steps), "--iterations", str(iters),
            "--batch_size", str(TRAIN_BATCH), "--var_weight", "1.0", "--save_path", student_path,
            "-w"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"[distill] entry point: {line}")
    student = DiffusionModel(**cfg, dtype=torch.bfloat16, device=dev).eval()
    student.load_state_dict(load_state_dict(student_path, dev), strict=True)
    # a guided step: one teacher forward (model batch 16, no gradient), the
    # student's forward and backward; a halving step: two teacher forwards
    expect = expect_train_launches(student, 2 * iters, sample_calls=iters * 1 + iters * 2)
    grid = Diffusion(model=None, **dict(DIFFUSION_PRESETS["openai_64"],
                                        rescaled_num_steps=teacher_steps), device=dev)
    odd = grid.timestep_map.tolist()[1::2]
    log(f"[distill] entry point, openai_64 bf16, guided (w 0.8) then one halving round "
        f"{teacher_steps} -> {sidecar['steps']} steps, {iters} iterations each at batch "
        f"{TRAIN_BATCH}, var_weight 1.0: {cli_s:.2f} s (model built, weights read and written "
        f"inside that time), peak device memory {peak:.2f} GiB; sidecar {sidecar}; launches "
        f"{launches}, expected {expect}")
    if (sidecar["steps"] != 25 or sidecar["guided"] is not True
            or sidecar["timestep_indices"] != odd):
        raise AssertionError(f"sidecar {sidecar}: want 25 steps, guided, the indices {odd}")
    if launches != expect:
        raise AssertionError(f"distillation launch counts {launches} != {expect}")
    by_path = {"distill_cli_openai_64": launches}

    # steps/s of each stage, kernels on and off in turns; a profile of one step
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    x0 = torch.rand(TRAIN_BATCH, 64, 64, 3, generator=g, device=dev) * 2 - 1
    labels = torch.randint(1, cfg["num_classes"], (TRAIN_BATCH,), generator=g, device=dev)
    dcfg = dict(DIFFUSION_PRESETS["openai_64"], rescaled_num_steps=teacher_steps)
    for stage in ("guided", "progressive"):
        def make(kernels):
            m = DiffusionModel(**cfg, dtype=torch.bfloat16, kernels=kernels, device=dev)
            kw = dict(model=m, teacher_params=state, diffusion_args=dcfg, dataloader=iter(()),
                      iterations=iters, var_weight=1.0, seed=SEED)
            if stage == "guided":
                return GuidedDistiller(**kw, guidance_strength=0.8)
            return ProgressiveDistiller(**kw)

        dists = {True: make(True), False: make(False)}

        def timed_steps(dist, n=3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                dist.train_step(x0, labels)
            torch.cuda.synchronize()
            return n / (time.perf_counter() - t0)

        for dist in dists.values():
            timed_steps(dist, 1)  # warm-up
        rates = {True: [], False: []}
        for kernels in (True, False, False, True):
            rates[kernels].append(timed_steps(dists[kernels]))
        log(f"[distill] {stage} stage steps/s, openai_64 bf16, batch {TRAIN_BATCH}, 3 steps a "
            f"reading: kernels on {rates[True]}, kernels off {rates[False]}")
        profile_steps(lambda: dists[True].train_step(x0, labels), f"{stage} distillation step",
                      unprofiled_ms=1e3 / max(rates[True]))
        del dists
        torch.cuda.empty_cache()

    # (c) the student with the printed hint against the teacher's CFG chain
    hint = text[text.index("Sample with:\n") + len("Sample with:\n"):]
    hint = hint.splitlines()[0].split("#")[0].split()
    calls, chains = [], []
    forward, denoise = DiffusionModel.forward, Diffusion.denoise

    def counting(self, x, *args, **kw):
        calls.append(x.shape[0])
        return forward(self, x, *args, **kw)

    def timing(self, *args, **kw):  # the chain alone, without the command's set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = denoise(self, *args, **kw)
        torch.cuda.synchronize()
        chains.append(time.perf_counter() - t0)
        return out

    runs = {"student": ["--model_path", student_path, *hint],
            "teacher": ["--model_path", model_path, "--guidance_method", "classifier_free",
                        "--guidance_strength", "0.8", "--rescaled_num_steps", str(teacher_steps)]}
    seen = {}
    DiffusionModel.forward, Diffusion.denoise = counting, timing
    # a replayed step runs no Python: the graphs add a step's forwards at each replay
    tally = ({"calls": calls}, "calls")
    graphs.TALLIES.append(tally)
    try:
        for who, flags in runs.items():
            out_dir = os.path.join(workdir, f"distill_{who}") + os.sep
            os.makedirs(out_dir)
            calls.clear()
            chains.clear()
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            samples = sample_main(flags + ["--num_classes", ncls, "--batch_size", str(FAST_BATCH),
                                           "--num_samples", "2", "--labels", "3/7", "--save_path",
                                           out_dir, "--seed", "0"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            by_path[f"sample_cli_openai_64_{who}"] = read_launches()
            seen[who] = (list(calls), secs, list(chains))
            if (len(os.listdir(out_dir)) != 2 * FAST_BATCH
                    or any(out.shape != (FAST_BATCH, 64, 64, 3) for _, out, _ in samples)):
                raise AssertionError(f"{who} sampling gave the wrong files or shapes")
    finally:
        DiffusionModel.forward, Diffusion.denoise = forward, denoise
        graphs.TALLIES.remove(tally)
    want = {"student": [FAST_BATCH] * 2 * 25, "teacher": [2 * FAST_BATCH] * 2 * teacher_steps}
    for who, (got, secs, chain_s) in seen.items():
        log(f"[distill] sampling entry point, {who} ({' '.join(runs[who][2:])}): 2 requests of "
            f"{FAST_BATCH} labels, {len(got)} model forwards at batches {sorted(set(got))}; "
            f"the chains {[round(c, 4) for c in chain_s]} s, {FAST_BATCH / chain_s[-1]:.4f} "
            f"images/s over the second; the command {secs:.2f} s (model built, weights read, "
            f"images saved; a structural check, not a claim)")
        if got != want[who]:
            raise AssertionError(f"{who}: forwards at batches {got}, want {want[who]}")
    return by_path


# ---------------------------------------------------------------------------
# the serving daemon
# ---------------------------------------------------------------------------

SERVE_STEPS = 25  # the openai_64 preset's DDIM eta=0 chain
# (serve batch = closed-loop clients, rounds each, repeats, linger ms)
SERVE_LOAD = ((8, 6, 1, 20.0), (64, 3, 1, 100.0))


def http_json(url, body=None, timeout=600):
    """GET ``url`` (or POST ``body`` as JSON) and return the decoded reply."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def check_reply(payload, n, what):
    from nicediffusion_tpu_torch.serving import decode_images

    images = decode_images(payload)
    if payload["shape"] != [n, 64, 64, 3] or images.shape != (n, 64, 64, 3):
        raise AssertionError(f"{what}: shape {payload['shape']}, decoded {images.shape}")
    if not (abs(images).max() <= 1.0):  # also false on a NaN
        raise AssertionError(f"{what}: values not finite in [-1, 1]")
    return images


@contextlib.contextmanager
def plain_versions_refused():
    """While the block runs, the plain versions the model would take with
    kernels=False (attention, GroupNorm, the int8 conv, cuDNN's conv, the
    Winograd function) and the bf16 and Winograd convs' plain versions
    raise."""
    from nicediffusion_tpu_torch.models import unet
    from nicediffusion_tpu_torch.ops import attention, groupnorm, quant
    from nicediffusion_tpu_torch.ops.kernels import conv, winograd

    def refuse(*args, **kw):
        raise AssertionError("a plain version ran on the served path")

    saved = [(attention, "fused_qkv_attention_plain"), (groupnorm, "_plain_group_norm"),
             (quant, "int8_conv_plain"), (conv, "conv_nhwc_plain"), (F, "conv2d"),
             (unet, "winograd_conv_3x3"), (winograd, "winograd_conv_nhwc_plain")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    for mod, name, _ in saved:
        setattr(mod, name, refuse)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@contextlib.contextmanager
def http_front(service):
    """``make_server(port=0)`` over ``service`` on a thread; yields its base
    URL."""
    import threading

    from nicediffusion_tpu_torch.serving import make_server

    server = make_server(service, port=0, request_timeout=600)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address
    try:
        yield f"http://{host}:{port}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def closed_loop(base, clients, rounds, seed0):
    """``clients`` threads each send ``rounds`` one-label requests back to
    back; returns (each request's latency in s, the wall s of the whole)."""
    from concurrent.futures import ThreadPoolExecutor

    def client(i):
        lat = []
        for r in range(rounds):
            body = {"labels": [(97 * i + r) % 1000 + 1], "seed": seed0 + rounds * i + r,
                    "encoding": "b64npz"}
            t0 = time.perf_counter()
            check_reply(http_json(f"{base}/sample", body), 1, f"client {i} request {r}")
            lat.append(time.perf_counter() - t0)
        return lat

    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        lats = [x for lat in pool.map(client, range(clients)) for x in lat]
    return lats, time.perf_counter() - t0


def traced_busy_ms(fn, logdir):
    """Run ``fn`` once under ``utils/profiling.trace`` and return the summed
    device time of the kernels it recorded. A run that records none is
    tried again, as in ``profiled_ms``; after PROFILER_TRIES such runs it
    fails."""
    from nicediffusion_tpu_torch.utils.profiling import trace

    for attempt in range(PROFILER_TRIES):
        if attempt:
            time.sleep(0.1 * attempt)
        with trace(logdir) as prof:
            fn()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)) / 1e3
        if busy > 0:
            if attempt:
                log(f"[profile] torch.profiler recorded device time at try {attempt + 1}")
            return busy
    raise AssertionError(f"torch.profiler recorded no device time in {PROFILER_TRIES} tries")


def serve_expect(model, calls, int8=False, dtype=None):
    """The launches of ``calls`` forwards of ``model`` (computing in
    ``dtype``, default its own) with grad mode off; ``int8``: frozen."""
    from nicediffusion_tpu_torch.models.unet import AttentionBlock, GroupNormOp

    n_attn = sum(isinstance(m, AttentionBlock) for m in model.modules())
    n_gn = sum(isinstance(m, GroupNormOp) for m in model.modules())
    n_int8 = len(model.int8_layers()) if int8 else 0
    return {"attention": n_attn * calls, "attention_bwd": 0, "groupnorm": n_gn * calls,
            "groupnorm_bwd": 0, "mha": 0, "resblock": 0, "int8conv": n_int8 * calls,
            "conv": conv_per_call(model, dtype) * calls}


def library_rates(diffusion, dev, batch, chains):
    """samples/s of ``chains`` calls of Diffusion.denoise at ``batch``, each
    synchronised."""
    y = torch.arange(batch, device=dev) * 97 % 1000 + 1
    rates = []
    for i in range(chains):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(50 + i)
        diffusion.denoise(gen, y=y, batch_size=batch)
        torch.cuda.synchronize()
        rates.append(batch / (time.perf_counter() - t0))
    return rates


def serve_load(svc, dev, batch, rounds, repeats, smi):
    """``batch`` closed-loop HTTP clients of ``svc`` (serve batch ``batch``),
    ``rounds`` one-label requests each, ``repeats`` times behind one front
    end, between two chains of the library path at the same batch. Each
    repeat reads samples/s (over its wall and over its served batches' own
    seconds), occupancy and p50/p95 latency. The counts are set to 0 just
    before the first repeat and read just after the last, and must equal
    (served batches) x SERVE_STEPS x each kernel's calls a forward. Returns
    (the readings, those launch counts)."""
    linger = svc.config.linger_ms
    lib = library_rates(svc.diffusion, dev, batch, 1)
    runs = []
    first = svc.stats()
    reset_launches()
    with http_front(svc) as base:
        for i in range(repeats):
            before = svc.stats()
            lats, wall = closed_loop(base, batch, rounds, seed0=1000 * batch + 100 * i)
            after = svc.stats()
            served = {k: after[k] - before[k]
                      for k in ("samples", "batches", "padded_rows", "sample_seconds")}
            runs.append({
                "requests": len(lats), "samples_per_s": len(lats) / wall,
                "served_batch_samples_per_s": served["samples"] / served["sample_seconds"],
                "occupancy": served["samples"] / (served["samples"] + served["padded_rows"]),
                "batches": served["batches"],
                "chain_s": served["sample_seconds"] / served["batches"],
                "p50_s": statistics.median(lats),
                "p95_s": statistics.quantiles(lats, n=20)[18]})
            log(f"[serve] serve batch {batch}, {batch} closed-loop HTTP clients x {rounds} "
                f"one-label requests, linger {linger} ms, repeat {i + 1} of {repeats} ({smi}): "
                f"{runs[-1]['samples_per_s']:.4f} samples/s over the wall ({len(lats)} requests "
                f"in {wall:.3f} s), {runs[-1]['served_batch_samples_per_s']:.4f} over the "
                f"served batches' own seconds ({served['batches']} batches, "
                f"{runs[-1]['chain_s']:.4f} s each), occupancy {runs[-1]['occupancy']:.4f}; "
                f"latency p50 {runs[-1]['p50_s']:.4f} s, p95 {runs[-1]['p95_s']:.4f} s")
    torch.cuda.synchronize()
    launches = read_launches()
    batches = svc.stats()["batches"] - first["batches"]
    expect = serve_expect(svc.diffusion.model, batches * SERVE_STEPS)
    lib += library_rates(svc.diffusion, dev, batch, 1)
    last = svc.stats()
    r = {"clients": batch, "rounds": rounds, "repeats": runs, "linger_ms": linger,
         "full_batch_samples_per_s": batch * batches / (last["sample_seconds"]
                                                        - first["sample_seconds"]),
         "library_samples_per_s": lib, "launches": launches}
    log(f"[serve] serve batch {batch} over {repeats} repeats ({smi}): samples/s over the wall "
        f"{[round(x['samples_per_s'], 4) for x in runs]}, occupancy "
        f"{[round(x['occupancy'], 4) for x in runs]}, p95 "
        f"{[round(x['p95_s'], 4) for x in runs]} s; a full batch "
        f"{r['full_batch_samples_per_s']:.4f} samples/s; the library path (Diffusion.denoise "
        f"at batch {batch}, before and after) {[round(x, 4) for x in lib]} samples/s; "
        f"launches {launches}, expected {expect} ({batches} served batches x {SERVE_STEPS})")
    if launches != expect:
        raise AssertionError(f"[serve] serve batch {batch}: launches {launches} != {expect}")
    return r, launches


def serve_positions(diff, dev):
    """A SamplerService (serve batch 8) over ``diff``: one request served
    alone (batch 0, padded), then the same (seed, label) in the last row of
    a full batch (batch 1), then alone again (batch 2). Returns (max abs
    difference of the first two, of the two served alone, the full batch as
    served, its x_T and labels on the card, Diffusion.denoise of them with
    batch 1's step generator)."""
    import numpy as np

    from nicediffusion_tpu_torch.serving import SamplerService, ServingConfig

    target = (417, 42)  # (label, seed)
    rows = [(int(j * 97 % 1000 + 1), j) for j in range(7)] + [target]
    with SamplerService(diff, ServingConfig(serve_batch=8, linger_ms=200.0), device=dev) as s:
        alone = s.sample(labels=[target[0]], seed=target[1], timeout=600)
        futs = [s.submit(labels=[lab], seed=seed) for lab, seed in rows]
        full = [f.result(timeout=600) for f in futs]
        repeat = s.sample(labels=[target[0]], seed=target[1], timeout=600)
        st = s.stats()
        if st["batches"] != 3 or st["padded_rows"] != 14:
            raise AssertionError(f"[serve] the position check's batches: {st}")
        x = torch.cat([s._draw_x(seed, 1) for _, seed in rows]).to(dev)
        y = torch.tensor([lab for lab, _ in rows]).to(dev)
        again = diff.denoise(s._step_generator(1), x=x, y=y, batch_size=8).float().cpu()
    pos, rerun = float(abs(alone - full[-1]).max()), float(abs(alone - repeat).max())
    return pos, rerun, torch.from_numpy(np.concatenate(full)), x, y, again


def phase_serve(dev, state, workdir, smi):
    """``[serve]``: the serving daemon at full-width ``openai_64``.
    (a) ``scripts/serve.py::build_service`` on ``64x64_diffusion.pt``, bf16,
    CFG 0.8, DDIM-25, serve batch 8 (the kernels built and the chain run once
    by its warmup), behind ``make_server(port=0)``: /healthz, 8 concurrent
    /sample POSTs of 1 to 3 labels (17 rows, both encodings: packing,
    padding, requests that wait for a later batch), /stats, one bad request
    (400); K1, K3 and the bf16 conv launched (batches + warmup) x 25 x their
    count a forward, the plain versions (and cuDNN's conv) refused. (b) f32
    (TF32 off), DDIM-10: a request served alone and again in the last row of
    a full batch, held to 1e-5; that batch equal bit for bit to
    ``Diffusion.denoise`` on its x_T and step generator, and within 1e-3 of
    the kernels=False model; bf16 the same, bit for bit (max abs 0), the
    plain versions refused. (c) ``--dtype int8 --int8_calibration`` on the
    file ``[int8]`` wrote: one batch of 8, the int8 conv 25 x 91 a batch; then
    (b)'s position check on that frozen int8 model, bit for bit. (d) samples/s,
    occupancy, p50/p95 latency with closed-loop HTTP clients at serve batch 8
    and 64 (one repeat at 64), with the launches counted over the clients'
    requests and held to the structure, beside ``Diffusion.denoise`` in a
    loop; at 64 first one full batch (model batch 128) held bit for bit to
    ``Diffusion.denoise`` on its x_T and step generator ([kernels] holds K1
    and K3 against their plain versions at that batch's shapes); the device
    idle share of one served batch and of one library chain at 8 by
    torch.profiler."""
    import urllib.error
    from concurrent.futures import ThreadPoolExecutor

    from nicediffusion_tpu_torch import Diffusion, DiffusionModel
    from nicediffusion_tpu_torch.scripts.serve import build_service
    from nicediffusion_tpu_torch.serving import SamplerService, ServingConfig
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS

    t_part = [time.perf_counter()]

    def part_done(name):
        now = time.perf_counter()
        log(f"[serve] {name} took {now - t_part[0]:.1f} s")
        t_part[0] = now

    model_path = os.path.join(workdir, "64x64_diffusion.pt")
    if not os.path.exists(model_path):
        torch.save(state, model_path)
    calib_path = os.path.join(workdir, "int8_calibration.npz")
    if not os.path.exists(calib_path):
        raise AssertionError("[serve] needs the calibration file [int8] wrote")
    cfg = model_config()
    common = ["--model_path", model_path, "--guidance_method", "classifier_free",
              "--guidance_strength", "0.8", "--num_classes", str(cfg["num_classes"]),
              "--seed", "0"]
    by_path = {}

    # (a) the entry point behind HTTP, a concurrent burst
    reset_launches()
    with plain_versions_refused():
        batch, _, _, linger = SERVE_LOAD[0]
        svc, _ = build_service(common + ["--batch_size", str(batch), "--linger_ms", str(linger)])
        if svc.diffusion.rescaled_num_steps != SERVE_STEPS or svc.diffusion.sampler != "ddim":
            raise AssertionError(f"[serve] chain: {svc.diffusion.sampler}, "
                                 f"{svc.diffusion.rescaled_num_steps} steps")
        with http_front(svc) as base:
            health = http_json(f"{base}/healthz")
            if health != {"ok": True, "warm": True}:
                raise AssertionError(f"/healthz after the warmup: {health}")
            sizes = (3, 2, 3, 1, 2, 3, 1, 2)
            bodies = [{"labels": [(131 * i + j) % 1000 + 1 for j in range(n)], "seed": 100 + i,
                       "encoding": ("b64npz", "list")[i % 2]} for i, n in enumerate(sizes)]

            def post(body):
                t0 = time.perf_counter()
                payload = http_json(f"{base}/sample", body)
                return payload, time.perf_counter() - t0

            with ThreadPoolExecutor(len(bodies)) as pool:
                replies = list(pool.map(post, bodies))
            for i, ((payload, _), body) in enumerate(zip(replies, bodies)):
                check_reply(payload, len(body["labels"]), f"burst request {i}")
            stats = http_json(f"{base}/stats")
            try:
                http_json(f"{base}/sample", {"labels": [5000]})
                raise AssertionError("a label out of range got no 400")
            except urllib.error.HTTPError as e:
                if e.code != 400:
                    raise AssertionError(f"a label out of range got {e.code}, not 400")
        launches = read_launches()
    rows, b = sum(sizes), stats["batches"]
    expect = serve_expect(svc.diffusion.model, (b + 1) * SERVE_STEPS)
    log(f"[serve] entry point, openai_64 bf16, CFG 0.8, DDIM-{SERVE_STEPS}, serve batch 8, "
        f"{len(sizes)} concurrent requests of {list(sizes)} labels ({rows} rows, both "
        f"encodings): {b} batches, {stats['padded_rows']} padded rows, occupancy "
        f"{stats['occupancy']:.4f}; latencies {[round(s, 3) for _, s in replies]} s; "
        f"400 on a bad label; launches {launches}, expected {expect} ((batches + warmup) x "
        f"{SERVE_STEPS} forwards at model batch 16)")
    if (stats["requests"] != len(sizes) or stats["samples"] != rows or b < 3
            or stats["padded_rows"] != batch * b - rows or not stats["warm"]):
        raise AssertionError(f"[serve] stats {stats}")
    if launches != expect:
        raise AssertionError(f"[serve] launches {launches} != {expect}")
    by_path["serve_openai_64_bf16"] = launches

    part_done("(a)")

    # (d) at serve batch 8: closed-loop clients, the library path, idle shares
    readings = {}
    with plain_versions_refused():
        readings["8"], by_path["serve_openai_64_bf16_b8_load"] = serve_load(
            svc, dev, *SERVE_LOAD[0][:3], smi)
    # one served batch of 8 rows and one library chain at 8 under torch.profiler,
    # each against the median of 3 walls with the profiler off
    diffusion = svc.diffusion
    y8 = torch.arange(8, device=dev) * 97 % 1000 + 1
    walls = []
    for _ in range(3):
        before = svc.stats()["sample_seconds"]
        svc.sample(labels=y8.tolist(), seed=7, timeout=600)
        walls.append((svc.stats()["sample_seconds"] - before) * 1e3)
    served_ms = statistics.median(walls)
    served_busy = traced_busy_ms(lambda: svc.sample(labels=y8.tolist(), seed=7, timeout=600),
                                 os.path.join(workdir, "serve_trace"))
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diffusion.denoise(torch.Generator(device=dev).manual_seed(7), y=y8, batch_size=8)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    lib_ms = statistics.median(walls)
    lib_busy = traced_busy_ms(
        lambda: diffusion.denoise(torch.Generator(device=dev).manual_seed(7), y=y8,
                                  batch_size=8),
        os.path.join(workdir, "serve_trace"))
    idle, lib_idle = 1 - served_busy / served_ms, 1 - lib_busy / lib_ms
    readings["8"].update(idle_share=idle, library_idle_share=lib_idle)
    log(f"[serve] one served batch of 8 ({smi}): device busy {served_busy:.3f} ms of "
        f"{served_ms:.3f} ms (the median of 3 with the profiler off), idle share "
        f"{idle:.4f}; one library chain at 8: busy {lib_busy:.3f} of {lib_ms:.3f} ms "
        f"(the median of 3), idle share {lib_idle:.4f}")
    svc.close()
    del svc, diffusion
    torch.cuda.empty_cache()
    part_done("(d) at serve batch 8")

    # (b) batch-position independence, and the service against Diffusion.denoise
    dcfg = dict(DIFFUSION_PRESETS["openai_64"], rescaled_num_steps=10,
                guidance_method="classifier_free", guidance_strength=0.8)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        m = DiffusionModel(**cfg, dtype=dtype, device=dev).eval()
        m.load_state_dict(state, strict=True)
        diff = Diffusion(model=m, **dcfg)
        if dtype == torch.bfloat16:
            # every conv through the bf16 conv (its plain version and cuDNN's
            # refused), K1 and K3 at the served batch's one shape
            with plain_versions_refused():
                pos, rerun, served, x, y, again = serve_positions(diff, dev)
            bit = torch.equal(served, again)
            readings["position_bf16"] = {"alone_against_full_batch": pos, "alone_again": rerun,
                                         "served_equals_denoise": bit}
            log(f"[serve] {name}, DDIM-10, CFG 0.8: one request alone (a padded batch) against "
                f"the same (seed, label) in the last row of a full batch: max abs diff "
                f"{pos:.6g} (gate 0); alone against alone again: {rerun:.6g} (gate 0); the "
                f"served batch against Diffusion.denoise on its x_T and step generator: "
                f"{'bit-equal' if bit else 'DIFFERENT'}")
            if pos != 0 or rerun != 0 or not bit:
                raise AssertionError("[serve] bf16 serving is not batch-position independent")
            break
        pos, rerun, served, x, y, again = serve_positions(diff, dev)
        off = DiffusionModel(**cfg, kernels=False, device=dev).eval()
        off.load_state_dict(state, strict=True)
        plain = Diffusion(model=off, **dcfg).denoise(
            torch.Generator(device=dev).manual_seed(0), x=x, y=y, batch_size=8).float().cpu()
        err_off = (served - plain).abs().max().item()
        bit = torch.equal(served, again)
        log(f"[serve] {name} (TF32 off), DDIM-10, CFG 0.8: one request alone against the same "
            f"(seed, label) in the last row of a full batch: max abs diff {pos:.6g} (gate "
            f"1e-5), alone against alone again {rerun:.6g}; the served batch against "
            f"Diffusion.denoise on its x_T and step generator: "
            f"{'bit-equal' if bit else 'DIFFERENT'}; against kernels=False: max abs "
            f"{err_off:.3g} (gate {MODEL_TOL})")
        if not pos <= 1e-5 or not rerun <= 1e-5 or not bit or not err_off <= MODEL_TOL:
            raise AssertionError("[serve] the f32 service adds more than packing")
        del m, off, diff, plain
        torch.cuda.empty_cache()
    del m, diff
    torch.cuda.empty_cache()
    part_done("(b)")

    # (c) int8 through the daemon: the calibration loaded, one batch of 8
    reset_launches()
    with plain_versions_refused():
        svc, _ = build_service(common + ["--batch_size", "8", "--dtype", "int8",
                                         "--int8_calibration", calib_path])
        with svc:
            futs = [svc.submit(labels=[int(j * 37 % 1000 + 1) for j in range(n)], seed=200 + n)
                    for n in (3, 3, 2)]
            outs = [f.result(timeout=600) for f in futs]
            st = svc.stats()
            launches = read_launches()
            expect = serve_expect(svc.diffusion.model, (st["batches"] + 1) * SERVE_STEPS, True)
    log(f"[serve] entry point --dtype int8 --int8_calibration (read), serve batch 8, "
        f"requests of 3, 3 and 2 labels: {st['batches']} batch, {st['padded_rows']} padded "
        f"rows; launches {launches}, expected {expect} ((batch + warmup) x {SERVE_STEPS})")
    if st["batches"] != 1 or st["padded_rows"] != 0 or launches != expect:
        raise AssertionError(f"[serve] int8: stats {st}, launches {launches}")
    for o, n in zip(outs, (3, 3, 2)):
        if o.shape != (n, 64, 64, 3) or not (abs(o).max() <= 1.0):
            raise AssertionError(f"[serve] int8 reply {o.shape}")
    # the int8 daemon's batch-position reading beside bf16's: the same chain
    # as (b) on the frozen int8 model (exact s32 sums, the float convs on the
    # bf16 conv)
    with plain_versions_refused():
        pos, rerun, served, x, y, again = serve_positions(
            Diffusion(model=svc.diffusion.model, **dcfg), dev)
    bit = torch.equal(served, again)
    readings["position_int8"] = {"alone_against_full_batch": pos, "alone_again": rerun,
                                 "served_equals_denoise": bit}
    log(f"[serve] int8 (frozen, the calibration read), DDIM-10, CFG 0.8: one request alone "
        f"against the same (seed, label) in the last row of a full batch: max abs diff "
        f"{pos:.6g} (gate 0); alone against alone again: {rerun:.6g} (gate 0); the served batch "
        f"against Diffusion.denoise: {'bit-equal' if bit else 'DIFFERENT'}")
    if pos != 0 or rerun != 0 or not bit:
        raise AssertionError("[serve] int8 serving is not batch-position independent")
    by_path["serve_openai_64_int8"] = launches
    del svc
    torch.cuda.empty_cache()
    part_done("(c)")

    # the daemon's batch at 64 (model batch 128 under CFG: a K3 plan no other
    # phase reaches) in f32, DDIM-10: one served batch against kernels=False
    batch = SERVE_LOAD[1][0]
    on = DiffusionModel(**cfg, device=dev).eval()
    on.load_state_dict(state, strict=True)
    off = DiffusionModel(**cfg, kernels=False, device=dev).eval()
    off.load_state_dict(state, strict=True)
    labels = [int(j * 89 % 1000 + 1) for j in range(batch)]
    with SamplerService(Diffusion(model=on, **dcfg), ServingConfig(serve_batch=batch),
                        device=dev) as s:
        served = torch.from_numpy(s.sample(labels=labels, seed=65, timeout=600))
        x, y, gen = s._draw_x(65, batch).to(dev), torch.tensor(labels).to(dev), \
            s._step_generator(0)
    plain = Diffusion(model=off, **dcfg).denoise(gen, x=x, y=y, batch_size=batch).float().cpu()
    err_off = (served - plain).abs().max().item()
    log(f"[serve] f32 (TF32 off), DDIM-10, CFG 0.8, serve batch {batch} (model batch "
        f"{2 * batch}): one served batch against kernels=False on its x_T and step generator, "
        f"max abs {err_off:.3g} (gate {MODEL_TOL})")
    if not err_off <= MODEL_TOL:
        raise AssertionError(f"[serve] serve batch {batch}: kernels on against off {err_off}")
    del on, off, served, plain, x, y
    torch.cuda.empty_cache()
    part_done(f"(b) at serve batch {batch}")

    # (d) at serve batch 64: one full batch held to Diffusion.denoise, then the
    # closed-loop clients
    batch, rounds, repeats, linger = SERVE_LOAD[1]
    with plain_versions_refused():
        svc, _ = build_service(common + ["--batch_size", str(batch), "--linger_ms", str(linger)])
        with svc:
            labels = [int(j * 97 % 1000 + 1) for j in range(batch)]
            served = torch.from_numpy(svc.sample(labels=labels, seed=64, timeout=600))
            st = svc.stats()
            x, y = svc._draw_x(64, batch).to(dev), torch.tensor(labels).to(dev)
            again = svc.diffusion.denoise(svc._step_generator(0), x=x, y=y,
                                          batch_size=batch).float().cpu()
            bit = torch.equal(served, again)
            log(f"[serve] serve batch {batch} (model batch {2 * batch} under CFG), bf16, one "
                f"request of {batch} labels: {st['batches']} batch, {st['padded_rows']} padded "
                f"rows; against Diffusion.denoise on its x_T and step generator: "
                f"{'bit-equal' if bit else 'DIFFERENT'}; finite in [-1, 1]: "
                f"{bool(served.abs().max() <= 1.0)}")
            if st["batches"] != 1 or st["padded_rows"] != 0 or not bit or not (
                    served.abs().max() <= 1.0):
                raise AssertionError(f"[serve] serve batch {batch}: the full batch, stats {st}")
            del x, y, served, again
            readings[str(batch)], by_path["serve_openai_64_bf16_b64"] = serve_load(
                svc, dev, batch, rounds, repeats, smi)
    del svc
    torch.cuda.empty_cache()
    part_done(f"(d) at serve batch {batch}")
    return by_path, readings



# ---------------------------------------------------------------------------
# [graph]: the chain's CUDA graphs (diffusion/graphs.py) against its eager loop
# ---------------------------------------------------------------------------

GRAPH_STEPS = 25  # the DDPM CFG chains, as [slice]'s
GRAPH_BATCHES = (8, 64)  # images a chain: model batch 16 (host-bound) and 128
GRAPH_PROFILE_STEPS = 5  # the chain under torch.profiler for a step's idle share


def phase_graph(dev, state, smi):
    """``[graph]``: ``Diffusion.denoise`` replaying one CUDA graph a step
    (the default on the card) against ``cuda_graph=False`` (the eager loop)
    at full-width ``openai_64`` in bf16. Bit for bit, with the generator
    left in the same state: DDPM-25 CFG chains at batch 8 and 64, the same
    at 64 on a frozen int8 model, DPM++-20 with ``encoder_cache=2`` and
    ``guidance_interval=(0.1, 0.7)`` at 8, a ``winograd=True`` DDIM-10 chain
    at 8, and one full served batch at serve batch 8 and 64 (DDIM-25) against
    ``denoise(cuda_graph=False)`` on its x_T and step generator. The launches
    of a graphed chain whose keys were captured already (every step a
    replay) equal the eager chain's and, for the DDPM chains, steps x each
    kernel's calls a forward. samples/s of both modes in turns (graph, eager,
    eager, graph) and the device idle share a step (a chain of
    GRAPH_PROFILE_STEPS steps under torch.profiler against its wall with the
    profiler off) for the bf16 DDPM chains and the served batches. Returns
    (launches by path, readings)."""
    from nicediffusion_tpu_torch import Diffusion, DiffusionModel
    from nicediffusion_tpu_torch.ops.kernels import winograd as kw
    from nicediffusion_tpu_torch.serving import SamplerService, ServingConfig
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS

    cfg = model_config()
    ddpm = dict(DIFFUSION_PRESETS["openai_64"], rescaled_num_steps=GRAPH_STEPS, use_ddim=False,
                guidance_method="classifier_free", guidance_strength=0.8)
    by_path, readings = {}, {}

    def bf16_model(**kw_model):
        m = DiffusionModel(**cfg, dtype=torch.bfloat16, device=dev, **kw_model).eval()
        m.load_state_dict(state, strict=True)
        return m

    def labels(batch):
        return torch.arange(batch, device=dev) * 97 % 1000 + 1

    def chain(diff, seed, batch, cuda_graph, **levers):
        g = torch.Generator(device=dev).manual_seed(seed)
        out = diff.denoise(g, y=labels(batch), batch_size=batch, cuda_graph=cuda_graph, **levers)
        torch.cuda.synchronize()
        return out, g.get_state()

    def counted(fn):
        reset_launches()
        kw.winograd_conv_nhwc.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {**read_launches(), "winograd": kw.winograd_conv_nhwc.launches}

    def same(what, diff, batch, expect=None, **levers):
        """Graphed (its keys' first steps eager, then captured) against the
        eager loop, then graphed again (every step a replay): the same bits
        and generator state, and the replayed chain's launches the eager
        chain's."""
        graphed = chain(diff, 1, batch, None, **levers)
        eager, eager_launches = counted(lambda: chain(diff, 1, batch, False, **levers))
        again, replayed_launches = counted(lambda: chain(diff, 1, batch, None, **levers))
        bits = all(torch.equal(a[0], eager[0]) and torch.equal(a[1], eager[1])
                   for a in (graphed, again))
        log(f"[graph] {what}, batch {batch}: graph against eager "
            f"{'bit-equal' if bits else 'DIFFERENT'} (the generator's end state too), "
            f"{len(diff._graphs.graphs)} keys captured; a replayed chain's launches "
            f"{replayed_launches}, the eager chain's {eager_launches}"
            + (f", expected {expect}" if expect else ""))
        if not bits or not torch.isfinite(eager[0]).all() or not eager[0].abs().max() <= 1.0:
            raise AssertionError(f"[graph] {what}: graph against eager, or values out of range")
        if replayed_launches != eager_launches or (expect and replayed_launches != expect):
            raise AssertionError(f"[graph] {what}: launches {replayed_launches} != "
                                 f"{eager_launches} (expected {expect})")
        return replayed_launches

    def speed(what, diff, batch, key):
        """samples/s of whole chains in turns and a step's idle share, both
        modes."""
        rates = {"graph": [], "eager": []}
        for mode in ("graph", "eager", "eager", "graph"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chain(diff, 4, batch, None if mode == "graph" else False)
            rates[mode].append(batch / (time.perf_counter() - t0))
        idle = {}
        for mode in ("graph", "eager"):
            cg = None if mode == "graph" else False

            def short():
                g = torch.Generator(device=dev).manual_seed(5)
                diff.denoise(g, y=labels(batch), batch_size=batch, cuda_graph=cg,
                             steps_to_do=GRAPH_PROFILE_STEPS)

            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                short()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            wall = statistics.median(walls)
            busy = profile_steps(short, f"{what} chain of {GRAPH_PROFILE_STEPS} steps, {mode}, "
                                 f"batch {batch}", wall, steps=1, detail=False)
            idle[mode] = {"wall_ms_per_step": wall / GRAPH_PROFILE_STEPS,
                          "busy_ms_per_step": None if busy is None
                          else busy / GRAPH_PROFILE_STEPS,
                          "idle_share": None if busy is None else 1 - busy / wall}
        readings[key] = {"samples_per_s": rates, "per_step": idle}
        log(f"[graph] {what}, batch {batch} ({smi}): samples/s graph {rates['graph']}, eager "
            f"{rates['eager']} (whole chains, in turns); a step: graph "
            f"{json.dumps(idle['graph'])}, eager {json.dumps(idle['eager'])}")

    # DDPM-25 CFG, bf16, at batch 8 and 64
    model = bf16_model()
    diff = Diffusion(model=model, **ddpm)
    for batch in GRAPH_BATCHES:
        expect = {**serve_expect(model, GRAPH_STEPS), "winograd": 0}
        by_path[f"graph_openai_64_bf16_b{batch}"] = same(f"bf16 DDPM-{GRAPH_STEPS} CFG", diff,
                                                          batch, expect)
        speed(f"bf16 DDPM-{GRAPH_STEPS} CFG", diff, batch, f"bf16_b{batch}")
    # DPM++-20 with the encoder cache and the guidance interval
    fast = Diffusion(model=model, **dict(ddpm, rescaled_num_steps=20, sampler="dpm++"))
    by_path["graph_openai_64_dpmpp_levers"] = same(
        "bf16 DPM++-20, encoder_cache 2, guidance_interval (0.1, 0.7)", fast, GRAPH_BATCHES[0],
        encoder_cache=2, guidance_interval=(0.1, 0.7))

    # one full served batch at serve batch 8 and 64 (DDIM-25, the preset's
    # chain): the daemon's warmup captures; its served rows against the eager
    # chain on its x_T and step generator; full served batches in both modes
    serve_cfg = dict(DIFFUSION_PRESETS["openai_64"], guidance_method="classifier_free",
                     guidance_strength=0.8)
    for batch in GRAPH_BATCHES:
        d = Diffusion(model=model, **serve_cfg)
        rows = [int(j * 89 % 1000 + 1) for j in range(batch)]
        with SamplerService(d, ServingConfig(serve_batch=batch), device=dev) as svc:
            svc.warmup()
            served = torch.from_numpy(svc.sample(labels=rows, seed=90 + batch, timeout=600))
            x, y = svc._draw_x(90 + batch, batch).to(dev), torch.tensor(rows).to(dev)
            ref = d.denoise(svc._step_generator(0), x=x, y=y, batch_size=batch,
                            cuda_graph=False).float().cpu()
            bits = torch.equal(served, ref)
            secs = {"graph": [], "eager": []}
            for mode in ("graph", "eager", "eager", "graph"):
                if mode == "eager":  # the daemon's chain on the eager loop
                    d.denoise = functools.partial(Diffusion.denoise, d, cuda_graph=False)
                else:
                    d.__dict__.pop("denoise", None)
                before = svc.stats()["sample_seconds"]
                svc.sample(labels=rows, seed=7, timeout=600)
                secs[mode].append(svc.stats()["sample_seconds"] - before)
            idle = {}
            for mode in ("graph", "eager"):
                if mode == "eager":
                    d.denoise = functools.partial(Diffusion.denoise, d, cuda_graph=False)
                else:
                    d.__dict__.pop("denoise", None)
                served_ms = 1e3 * min(secs[mode])
                busy = profile_steps(lambda: svc.sample(labels=rows, seed=7, timeout=600),
                                     f"served batch of {batch}, {mode}", served_ms, steps=1,
                                     detail=False)
                idle[mode] = {"busy_ms": busy, "served_ms": served_ms,
                              "idle_share": None if busy is None else 1 - busy / served_ms}
            d.__dict__.pop("denoise", None)
        rate = {m: [batch / s for s in v] for m, v in secs.items()}
        readings[f"serve_b{batch}"] = {"samples_per_s": rate, "served_batch": idle,
                                       "served_equals_eager_denoise": bits}
        log(f"[graph] served batch at serve batch {batch} (DDIM-{SERVE_STEPS}, CFG 0.8, bf16; "
            f"{smi}): against denoise(cuda_graph=False) on its x_T and step generator "
            f"{'bit-equal' if bits else 'DIFFERENT'}; samples/s over a full served batch's own "
            f"seconds graph {rate['graph']}, eager {rate['eager']}; one served batch under "
            f"torch.profiler: graph {json.dumps(idle['graph'])}, eager "
            f"{json.dumps(idle['eager'])} (busy against the faster unprofiled batch's wall)")
        if not bits:
            raise AssertionError(f"[graph] serve batch {batch}: served rows differ from denoise")
        del d, svc, served, ref, x, y
    del model, diff, fast
    torch.cuda.empty_cache()

    # the same DDPM chain at 64 on a frozen int8 model (calibrated here on
    # three model batches of 16 along the chain)
    m8 = bf16_model(quantized=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    with torch.no_grad(), m8.calibrating():
        for ts in (999, 500, 20):
            m8(torch.randn(16, 64, 64, 3, generator=g, device=dev), torch.full((16,), ts, device=dev),
               torch.cat([labels(8), torch.zeros_like(labels(8))]))
    m8.freeze_int8(m8.int8_calibration())
    d8 = Diffusion(model=m8, **ddpm)
    batch = GRAPH_BATCHES[1]
    by_path["graph_openai_64_int8_b64"] = same(
        f"int8 (frozen) DDPM-{GRAPH_STEPS} CFG", d8, batch,
        {**serve_expect(m8, GRAPH_STEPS, int8=True), "winograd": 0})
    del m8, d8
    torch.cuda.empty_cache()

    # a winograd=True DDIM-10 chain
    mw = bf16_model(winograd=True)
    dw = Diffusion(model=mw, **dict(ddpm, rescaled_num_steps=10, use_ddim=True, ddim_eta=0.0))
    by_path["graph_openai_64_winograd"] = same("winograd=True bf16 DDIM-10 CFG", dw,
                                               GRAPH_BATCHES[0])
    del mw, dw
    torch.cuda.empty_cache()
    return by_path, readings

# ---------------------------------------------------------------------------
# [dp]: data parallelism. Two gloo ranks share the one card (NCCL refuses two
# ranks on one device); one rank goes through torchrun and NCCL.
# ---------------------------------------------------------------------------

DP_TRAIN_STEPS = 2
DP_SAMPLE_BATCH = 16  # 8 rows a rank; under CFG a rank's model batch is 16
DP_SAMPLE_STEPS = 10
DP_SERVE_CLIENTS = (16, 2)  # closed-loop clients, requests each, at serve batch 16
DP_TIMEOUT_S = 480.0  # the group of two ranks: parts (a), (c) and (d)
DP_TORCHRUN_TIMEOUT_S = 240.0
# f32 on two ranks against one: the saved uint8 images within 1 count (a
# float difference can flip a rounding), the served images in [-1, 1] within
# the repo's parity bar
DP_IMAGE_TOL = 1
DP_SERVE_TOL = MODEL_TOL
# bf16 two ranks against one: the same bits (no bf16 kernel's order of sums
# reads the batch: the bf16 conv, K1, K3's forward; cuBLAS's dense products
# move no row, tools/find_batch_variance.py)
DP_BF16_TOL = 0
# the train entry point's EMNIST recipe at openai_64's widths (its images
# keep EMNIST's one channel)
OPENAI_64_WIDTHS = ["--resolution", "64", "--model_channels", "192", "--channel_mult",
                    "1/2/3/4", "--num_res_blocks", "3", "--attention_resolutions", "32/16/8",
                    "--num_head_channels", "64"]


def dp_draws(step, cfg, steps):
    """A global training batch and its injected draws, from a CPU generator
    seeded by the step: the same on every rank and in the parent."""
    g = torch.Generator().manual_seed(1000 + step)
    res, ch = cfg["resolution"], cfg["in_channels"]
    return dict(batch=torch.rand((TRAIN_BATCH, res, res, ch), generator=g) * 2 - 1,
                labels=torch.randint(1, cfg["num_classes"], (TRAIN_BATCH,), generator=g),
                t=torch.randint(0, steps, (TRAIN_BATCH,), generator=g),
                noise=torch.randn((TRAIN_BATCH, res, res, ch), generator=g),
                drop=torch.rand((TRAIN_BATCH,), generator=g) < 0.1)


def dp_sample_argv(model_flags, out_dir, sampler, dtype):
    os.makedirs(out_dir, exist_ok=True)
    return [*model_flags, "--guidance_method", "classifier_free", "--guidance_strength", "0.8",
            "--batch_size", str(DP_SAMPLE_BATCH), "--num_samples", "1", "--save_path",
            out_dir + "/", "--seed", "3", "--sampler", sampler, "--rescaled_num_steps",
            str(DP_SAMPLE_STEPS), "--dtype", dtype]


def dp_serve_argv(model_flags, dtype):
    extra = ["--dtype", "float32", "--rescaled_num_steps", str(DP_SAMPLE_STEPS)] \
        if dtype == "float32" else []
    return [*model_flags, "--guidance_method", "classifier_free", "--guidance_strength", "0.8",
            "--seed", "0", "--batch_size", str(DP_SAMPLE_BATCH), "--linger_ms", "100", *extra]


def dp_request(cfg):
    return {"labels": [(97 * j) % (cfg["num_classes"] - 1) + 1 for j in range(DP_SAMPLE_BATCH)],
            "seed": 21, "encoding": "b64npz"}


def dp_train_part(dev, cfg, state, r, n):
    """(a) on one rank: DP_TRAIN_STEPS data-parallel steps (remat, dropout 0,
    global batch TRAIN_BATCH, this rank's rows of injected draws) in f32 and
    in bf16; on rank 0 beside each step the same step of a single-process
    Trainer on the whole batch, with the loss, the gradient norm and every
    parameter's gradient as the update sees it (after the reduce) held to it:
    LOSS_TOL, GRAD_TOL, gated in f32 (raises), read in bf16. Returns, by
    dtype, the worst errors and this rank's launches over its DP steps."""
    from nicediffusion_tpu_torch import DiffusionModel, Trainer
    from nicediffusion_tpu_torch.parallel import shard_rows
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS

    dcfg = dict(DIFFUSION_PRESETS["openai_64"], guidance_method="classifier_free")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        def trainer(distributed):
            model = DiffusionModel(**dict(cfg, dropout=0.0), use_remat=True, device=dev,
                                   dtype=None if dtype == torch.float32 else dtype)
            model.load_state_dict(state, strict=True)
            tr = Trainer(model, dcfg, iter(()), iterations=0, batch_size=TRAIN_BATCH, lr=1e-4,
                         weight_decay=1e-3, ema_rate=0.99, seed=SEED, distributed=distributed)
            reduce = tr._reduce
            tr.reduce_s = []

            def record(grads, loss):  # the gradients the update sees, and the reduce's time
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                grads, loss = reduce(grads, loss)
                torch.cuda.synchronize()
                tr.reduce_s.append(time.perf_counter() - t0)
                tr.grads = [g.detach().clone() for g in grads]
                return grads, loss

            tr._reduce = record
            return tr

        dp = trainer(True)
        one = trainer(False) if r == 0 else None
        launches = collections.Counter()
        worst = {"loss": 0.0, "grad_norm": 0.0, "grad": 0.0, "grad_name": ""}
        losses, step_s, one_s = [], [], []
        for i in range(DP_TRAIN_STEPS):
            d = {k: v.to(dev) for k, v in dp_draws(i, cfg, dp.train_diffusion.rescaled_num_steps)
                 .items()}
            reset_launches()
            t0 = time.perf_counter()
            m = dp.train_step(**{k: shard_rows(v, r, n) for k, v in d.items()})
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            launches.update(read_launches())
            loss, norm = m["loss"].item(), m["grad_norm"].item()
            if not (math.isfinite(loss) and math.isfinite(norm)):
                raise AssertionError(f"[dp] (a) rank {r} step {i}: loss {loss}, norm {norm}")
            losses.append(loss)
            if one is None:
                continue
            t0 = time.perf_counter()
            m1 = one.train_step(**d)
            loss1, norm1 = m1["loss"].item(), m1["grad_norm"].item()
            one_s.append(time.perf_counter() - t0)
            worst["loss"] = max(worst["loss"], abs(loss - loss1) / max(1.0, abs(loss1)))
            worst["grad_norm"] = max(worst["grad_norm"], abs(norm - norm1) / max(1.0, abs(norm1)))
            for (name, _), a, b in zip(dp.model.named_parameters(), dp.grads, one.grads):
                scale = b.abs().max().item()
                rel = (a - b).abs().max().item() / scale if scale else float("inf")
                if rel > worst["grad"]:
                    worst["grad"], worst["grad_name"] = rel, name
            one.grads = None
        expect = expect_train_launches(dp.model, DP_TRAIN_STEPS)
        name = str(dtype).removeprefix("torch.")
        out[name] = {"worst": worst, "losses": losses, "launches": dict(launches),
                     "expect": expect, "step_s": step_s, "reduce_s": dp.reduce_s,
                     "one_process_step_s": one_s}
        if dict(launches) != expect:
            raise AssertionError(f"[dp] (a) {name} rank {r}: launches {dict(launches)} != {expect}")
        if one is not None and dtype == torch.float32 and not (
                worst["loss"] <= LOSS_TOL and worst["grad_norm"] <= LOSS_TOL
                and worst["grad"] <= GRAD_TOL):
            raise AssertionError(f"[dp] (a) f32: two ranks against one process {worst} (gates: "
                                 f"loss and norm {LOSS_TOL}, gradients {GRAD_TOL})")
        del dp, one
        torch.cuda.empty_cache()
    return out


def dp_sample_part(dev, cfg, state, work, model_flags, r, n):
    """(c) on one rank: the sampling entry point with --data_parallel, DDIM
    and DDPM, f32 and bf16 (rank 0 saves the uint8 images it gathered), this
    rank's launches over the four runs; then this rank's f32 forward at its
    model batch, kernels on against off."""
    import numpy as np

    from nicediffusion_tpu_torch import DiffusionModel
    from nicediffusion_tpu_torch.scripts.sample import main as sample_main

    launches = collections.Counter()
    for sampler in ("ddim", "ddpm"):
        for dtype in ("float32", "bfloat16"):
            argv = dp_sample_argv(model_flags, os.path.join(work, f"dp_{sampler}_{dtype}"),
                                  sampler, dtype)
            reset_launches()
            samples = sample_main(argv + ["--data_parallel"])
            torch.cuda.synchronize()
            launches.update(read_launches())
            # the ranks share one card: hand the run's graph pool back to it
            torch.cuda.empty_cache()
            if r == 0:
                np.save(os.path.join(work, f"dp_{sampler}_{dtype}.npy"), samples[0][1])
            elif samples:
                raise AssertionError(f"[dp] (c) rank {r} returned samples")
    b = 2 * DP_SAMPLE_BATCH // n  # this rank's model batch under CFG
    on = DiffusionModel(**cfg, device=dev).eval()
    on.load_state_dict(state, strict=True)
    off = DiffusionModel(**cfg, kernels=False, device=dev).eval()
    off.load_state_dict(state, strict=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 10 + r)
    res, ch = cfg["resolution"], cfg["in_channels"]
    x = torch.randn(b, res, res, ch, generator=g, device=dev)
    t = torch.randint(0, 1000, (b,), generator=g, device=dev)
    y = torch.randint(0, cfg["num_classes"], (b,), generator=g, device=dev)
    with torch.inference_mode():
        err = (on(x, t, y) - off(x, t, y)).abs().max().item()
    if not err <= MODEL_TOL:
        raise AssertionError(f"[dp] (c) rank {r}: f32 forward at model batch {b}, kernels on "
                             f"against off, max abs {err}")
    return {"launches": dict(launches), "forward_err": err, "model_batch": b}


def dp_serve_part(dev, work, model_flags, cfg, r):
    """(d) on one rank: the serving entry point with --serve_data_parallel at
    serve batch DP_SAMPLE_BATCH, f32 (DDIM-10) then bf16 (the preset's
    DDIM-25). Rank 0 serves HTTP: one request of DP_SAMPLE_BATCH labels
    (reply saved), in bf16 then closed-loop clients; the other ranks
    follow(). This rank's launches by dtype, rank 0's batches and rates."""
    import numpy as np

    from nicediffusion_tpu_torch.scripts.serve import build_service

    out = {}
    for dtype in ("float32", "bfloat16"):
        reset_launches()
        svc, _ = build_service(dp_serve_argv(model_flags, dtype) + ["--serve_data_parallel"])
        steps = svc.diffusion.rescaled_num_steps
        if r:
            svc.follow()
            torch.cuda.synchronize()
            out[dtype] = {"launches": read_launches(), "steps": steps}
            del svc
            torch.cuda.empty_cache()
            continue
        with svc, http_front(svc) as base:
            images = check_reply(http_json(f"{base}/sample", dp_request(cfg)), DP_SAMPLE_BATCH,
                                 f"[dp] (d) {dtype}")
            np.save(os.path.join(work, f"dp_serve_{dtype}.npy"), images)
            part = {}
            if dtype == "bfloat16":
                part = dp_closed_loop(svc, base)
            stats = svc.stats()
        torch.cuda.synchronize()
        out[dtype] = {"launches": read_launches(), "steps": steps, "batches": stats["batches"],
                      **part}
        del svc
        torch.cuda.empty_cache()
    return out


def dp_closed_loop(svc, base):
    clients, rounds = DP_SERVE_CLIENTS
    before = svc.stats()
    lats, wall = closed_loop(base, clients, rounds, seed0=5000)
    after = svc.stats()
    served = after["samples"] - before["samples"]
    return {"samples_per_s": len(lats) / wall, "p50_s": statistics.median(lats),
            "occupancy": served / (served + after["padded_rows"] - before["padded_rows"]),
            "load_batches": after["batches"] - before["batches"]}


def dp_rank(work, model_path, cfg, model_flags):
    """One rank of ``[dp]``'s group (started by parallel/dryrun.py::spawn_ranks,
    two ranks on one card over gloo): parts (a), (c) and (d) in turn, on the
    card. A rank that sees no card raises: nothing of [dp] runs on the CPU."""
    from nicediffusion_tpu_torch.parallel import rank, world

    r, n = rank(), world()
    if not torch.cuda.is_available():
        raise RuntimeError(f"[dp] rank {r} sees no CUDA device")
    record_conv_shapes()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    state = torch.load(model_path, map_location=dev, weights_only=True)
    times = {}
    t0 = time.perf_counter()
    out = {"train": dp_train_part(dev, cfg, state, r, n)}
    times["a"] = time.perf_counter() - t0
    out["sample"] = dp_sample_part(dev, cfg, state, work, model_flags, r, n)
    times["c"] = time.perf_counter() - t0 - times["a"]
    del state
    out["serve"] = dp_serve_part(dev, work, model_flags, cfg, r)
    times["d"] = time.perf_counter() - t0 - times["a"] - times["c"]
    out["seconds"] = times
    out["conv_shapes"] = sorted(CONV_SHAPES)
    return out


def run_group(cmd, timeout_s, env):
    """Run ``cmd`` in a session of its own; on timeout kill the whole
    session (torchrun's agent and its workers). Returns (exit code, output)."""
    import signal

    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{cmd[:6]} outlasted {timeout_s} s:\n{out[-4000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return proc.returncode, out


def dp_torchrun(workdir):
    """(b) the train entry point through torchrun on one rank: NCCL for the
    CUDA tensors, the real environment, an all-reduce of one rank."""
    root = os.path.dirname(os.path.abspath(__file__))
    metrics = os.path.join(workdir, "dp_torchrun.jsonl")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", "-m", "nicediffusion_tpu_torch.scripts.train", "--synthetic", "--iterations",
           str(DP_TRAIN_STEPS), "-w", "--print_every", "1", "--batch_size", str(TRAIN_BATCH),
           *OPENAI_64_WIDTHS, "--checkpoint_dir", os.path.join(workdir, "dp_torchrun"),
           "--metrics_path", metrics, "--samples_dir", os.path.join(workdir, "dp_samples"),
           "--use_fp16"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    t0 = time.perf_counter()
    rc, out = run_group(cmd, DP_TORCHRUN_TIMEOUT_S, env)
    seconds = time.perf_counter() - t0
    line = next((ln for ln in out.splitlines() if ln.startswith("Data-parallel training:")), "")
    if rc != 0 or " on cuda:0," not in line or "backends: cuda nccl, cpu gloo" not in line:
        raise AssertionError(f"[dp] (b) torchrun exit {rc}, '{line}':\n{out[-4000:]}")
    rows = metrics_rows(metrics)
    if len(rows) != DP_TRAIN_STEPS:
        raise AssertionError(f"[dp] (b) {len(rows)} metric rows")
    return line, rows, seconds


def phase_dp(dev, workdir, smi):
    """``[dp]``: data parallelism at full-width ``openai_64``, the weights the
    parent wrote (``64x64_diffusion.pt``), two gloo ranks sharing the card.
    (a) training (``Trainer(distributed=True)``, held to one process on rank
    0); (b) the train entry point through ``torch.distributed.run`` on one
    NCCL rank; (c) ``scripts/sample.py --data_parallel``, DDIM-10 and
    DDPM-10, f32 and bf16, against the one-rank run at the same seed (f32
    gated on the saved uint8 images, bf16 read), each rank's f32 forward at
    its batch kernels on against off; (d) ``scripts/serve.py
    --serve_data_parallel`` at serve batch 16: one HTTP request against the
    one-rank daemon (f32 gated, bf16 read), samples/s of closed-loop clients
    for one rank and for two sharing the card. Every rank's launches are
    counted against the structure. Returns the paths' launches (both ranks
    summed) and the readings."""
    import numpy as np

    from nicediffusion_tpu_torch import DiffusionModel
    from nicediffusion_tpu_torch.parallel.dryrun import spawn_ranks
    from nicediffusion_tpu_torch.scripts.sample import main as sample_main
    from nicediffusion_tpu_torch.scripts.serve import build_service

    cfg = model_config()
    model_path = os.path.join(workdir, "64x64_diffusion.pt")
    model_flags = ["--model_path", model_path, "--num_classes", str(cfg["num_classes"])]
    t_part = [time.perf_counter()]

    def part_done(name):
        now = time.perf_counter()
        log(f"[dp] {name} took {now - t_part[0]:.1f} s")
        t_part[0] = now

    # (b) one NCCL rank through the launcher
    line, rows, seconds = dp_torchrun(workdir)
    log(f"[dp] (b) torchrun --nproc_per_node 1, the train entry point at openai_64 widths "
        f"(EMNIST's one channel), bf16, batch {TRAIN_BATCH}, {DP_TRAIN_STEPS} steps in "
        f"{seconds:.1f} s with the launch: '{line}'; losses "
        f"{[round(r['loss'], 5) for r in rows]}, grad norms "
        f"{[round(r['grad_norm'], 4) for r in rows]}")
    part_done("(b)")

    # the one-rank references of (c) and (d), in this process
    one = {}
    for sampler in ("ddim", "ddpm"):
        for dtype in ("float32", "bfloat16"):
            samples = sample_main(dp_sample_argv(
                model_flags, os.path.join(workdir, f"one_{sampler}_{dtype}"), sampler, dtype))
            one[sampler, dtype] = samples[0][1]
    serve_one = {}
    for dtype in ("float32", "bfloat16"):
        svc, _ = build_service(dp_serve_argv(model_flags, dtype))
        with svc, http_front(svc) as base:
            serve_one[dtype] = check_reply(http_json(f"{base}/sample", dp_request(cfg)),
                                           DP_SAMPLE_BATCH, f"[dp] one rank {dtype}")
            if dtype == "bfloat16":
                serve_one["load"] = dp_closed_loop(svc, base)
        del svc
    torch.cuda.empty_cache()
    part_done("one-rank references of (c) and (d)")

    # (a), (c), (d) on two ranks sharing the card
    got = spawn_ranks("chip_smoke:dp_rank", DP_WORLD,
                      dict(work=workdir, model_path=model_path, cfg=cfg, model_flags=model_flags),
                      timeout_s=DP_TIMEOUT_S, one_device=True,
                      pythonpath=(os.path.dirname(os.path.abspath(__file__)),))
    CONV_SHAPES.update(tuple(case) for res in got for case in res["conv_shapes"])
    log(f"[dp] two ranks on one card (gloo): seconds by part of rank 0 "
        f"{ {k: round(v, 1) for k, v in got[0]['seconds'].items()} }")
    part_done("(a), (c), (d) on two ranks")
    readings = {"device": smi}
    meta = DiffusionModel(**cfg, device="meta")
    nparams = sum(p.numel() for p in meta.parameters())

    # (a)
    for dtype in ("float32", "bfloat16"):
        w = got[0]["train"][dtype]["worst"]
        readings[f"train_{dtype}"] = w
        log(f"[dp] (a) openai_64 {dtype}, remat, dropout 0, global batch {TRAIN_BATCH} as "
            f"{TRAIN_BATCH // DP_WORLD} a rank, {DP_TRAIN_STEPS} steps, two ranks against one "
            f"process: worst loss {w['loss']:.3g}, grad norm {w['grad_norm']:.3g} (relative), "
            f"gradient {w['grad']:.3g} of its largest element ({w['grad_name']}); "
            + (f"gated at LOSS_TOL {LOSS_TOL}, GRAD_TOL {GRAD_TOL}" if dtype == "float32"
               else "read") + f"; losses {[round(x, 5) for x in got[0]['train'][dtype]['losses']]}"
            f"; launches a rank {[g['train'][dtype]['launches'] for g in got]}")
        t = got[0]["train"][dtype]
        readings[f"train_{dtype}_seconds"] = {k: t[k] for k in
                                              ("step_s", "reduce_s", "one_process_step_s")}
        log(f"[dp] (a) {dtype} ({smi}): rank 0's DP steps {[round(x, 4) for x in t['step_s']]} s, "
            f"of which the gradient all-reduce over gloo ({nparams / 1e6:.1f}M f32 gradients "
            f"staged through the host, 25 MB buckets) {[round(x, 4) for x in t['reduce_s']]} s; "
            f"one process at the "
            f"global batch on the same card {[round(x, 4) for x in t['one_process_step_s']]} s")
        if got[0]["train"][dtype]["losses"] != got[1]["train"][dtype]["losses"]:
            raise AssertionError("[dp] (a) the ranks saw different losses")

    # (c)
    for (sampler, dtype), ref in one.items():
        dp = np.load(os.path.join(workdir, f"dp_{sampler}_{dtype}.npy"))
        diff = int(np.abs(dp.astype(int) - ref.astype(int)).max())
        names = sorted(os.listdir(os.path.join(workdir, f"dp_{sampler}_{dtype}")))
        same = names == sorted(os.listdir(os.path.join(workdir, f"one_{sampler}_{dtype}")))
        readings[f"sample_{sampler}_{dtype}_max_count_diff"] = diff
        log(f"[dp] (c) --data_parallel, {sampler.upper()}-{DP_SAMPLE_STEPS}, {dtype}, batch "
            f"{DP_SAMPLE_BATCH} as {DP_SAMPLE_BATCH // DP_WORLD} a rank: the uint8 images against "
            f"one rank's at the same seed, max {diff} counts, "
            f"{float((dp != ref).mean()):.4%} of values differ; {len(names)} files, names "
            f"{'the same' if same else 'DIFFERENT'}"
            + f" (gate {DP_IMAGE_TOL if dtype == 'float32' else DP_BF16_TOL})")
        if not same or dp.shape != ref.shape or diff > (DP_IMAGE_TOL if dtype == "float32"
                                                        else DP_BF16_TOL):
            raise AssertionError(f"[dp] (c) {sampler} {dtype}: {diff} counts, names {same}")
    log(f"[dp] (c) each rank's f32 forward at model batch {got[0]['sample']['model_batch']}, "
        f"kernels on against off: max abs {[g['sample']['forward_err'] for g in got]} (gate "
        f"{MODEL_TOL})")

    # (d)
    for dtype in ("float32", "bfloat16"):
        dp = np.load(os.path.join(workdir, f"dp_serve_{dtype}.npy"))
        err = float(np.abs(dp - serve_one[dtype]).max())
        readings[f"serve_{dtype}_max_abs"] = err
        log(f"[dp] (d) --serve_data_parallel, serve batch {DP_SAMPLE_BATCH}, {dtype}, DDIM-"
            f"{got[0]['serve'][dtype]['steps']}: one HTTP request of {DP_SAMPLE_BATCH} labels "
            f"against the one-rank daemon, max abs {err:.6g}"
            + f" (gate {DP_SERVE_TOL if dtype == 'float32' else DP_BF16_TOL})")
        if not err <= (DP_SERVE_TOL if dtype == "float32" else DP_BF16_TOL):
            raise AssertionError(f"[dp] (d) {dtype} two ranks against one: {err}")
    two, single = got[0]["serve"]["bfloat16"], serve_one["load"]
    readings["serve_load"] = {"one_rank": single, "two_ranks": {
        k: two[k] for k in ("samples_per_s", "p50_s", "occupancy", "load_batches")}}
    log(f"[dp] (d) bf16 DDIM-25 at serve batch {DP_SAMPLE_BATCH}, {DP_SERVE_CLIENTS[0]} "
        f"closed-loop clients x {DP_SERVE_CLIENTS[1]} one-label requests, linger 100 ms ({smi}): "
        f"one rank {single['samples_per_s']:.4f} samples/s (p50 {single['p50_s']:.4f} s, "
        f"occupancy {single['occupancy']:.4f}), two ranks sharing the card "
        f"{two['samples_per_s']:.4f} (p50 {two['p50_s']:.4f} s, occupancy "
        f"{two['occupancy']:.4f}); a finding, not a claim")

    # every rank's launches against the structure
    by_path = {}
    for path, per_rank, expect in (
            ("dp_train_openai_64", [g["train"][d]["launches"] for g in got
                                    for d in ("float32", "bfloat16")],
             got[0]["train"]["float32"]["expect"]),
            # DDIM and DDPM in f32, then in bf16 (the bf16 conv)
            ("dp_sample_openai_64", [g["sample"]["launches"] for g in got],
             dict(serve_expect(meta, 4 * DP_SAMPLE_STEPS),
                  conv=serve_expect(meta, 2 * DP_SAMPLE_STEPS, dtype=torch.bfloat16)["conv"])),
            ("dp_serve_openai_64", [g["serve"][d]["launches"] for g in got
                                    for d in ("float32", "bfloat16")], None)):
        total = collections.Counter()
        for launches in per_rank:
            total.update(launches)
        by_path[path] = dict(total)
        if expect is not None and any(x != expect for x in per_rank):
            raise AssertionError(f"[dp] {path}: launches {per_rank}, expected {expect} a run")
    for dtype in ("float32", "bfloat16"):
        s = got[0]["serve"][dtype]
        expect = serve_expect(meta, (s["batches"] + 1) * s["steps"], dtype=getattr(torch, dtype))
        runs = [g["serve"][dtype]["launches"] for g in got]
        log(f"[dp] (d) {dtype}: {s['batches']} served batches and the warmup a rank; launches "
            f"a rank {runs}, expected {expect}")
        if any(x != expect for x in runs):
            raise AssertionError(f"[dp] (d) {dtype} launches {runs} != {expect}")
    return by_path, readings


# ---------------------------------------------------------------------------
# [tp]: tensor parallelism. Two gloo ranks share the one card, each holding
# half of every paired layer's channels (a mesh of 1 x 2).
# ---------------------------------------------------------------------------

TP_FORWARD_BATCH = 16  # model batch: 8 requests under CFG
TP_TRAIN_STEPS = 2
TP_TIMEOUT_S = 300.0


def tp_path_calls(model, dev, tp=TP_WORLD):
    """The GroupNorm calls a tensor-parallel rank makes in place of the
    unsharded ones: the out_norm of every residual block the sharding table
    pairs, at C / tp channels and 32 / tp groups (key ``("groupnorm", (h, w,
    c / tp), mode, groups)``), as a Counter of calls per forward. ``model``
    runs unsharded with ``kernels=False``; no kernel launches."""
    from nicediffusion_tpu_torch.models.unet import ResidualBlock
    from nicediffusion_tpu_torch.parallel.sharding import unet_param_shard_dims

    dims = unet_param_shard_dims(model, tp)
    calls = collections.Counter()

    def hook(mod, args):
        _, h, w, c = args[0].shape
        calls[("groupnorm", (h, w, c // tp), mod.mode, mod.num_groups // tp)] += 1

    hooks = [m.out_norm.register_forward_pre_hook(hook) for name, m in model.named_modules()
             if isinstance(m, ResidualBlock) and dims[f"{name}.in_conv.weight"] == 0]
    x = torch.zeros(1, model.resolution, model.resolution, model.in_channels, device=dev)
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    with torch.inference_mode():
        model(x, zero, zero)
    for h in hooks:
        h.remove()
    return calls


def _state_digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for name in sorted(tensors):
        t = tensors[name].detach().float().contiguous().cpu()
        h.update(name.encode() + t.numpy().tobytes())
    return h.hexdigest()


def _collectives(stats):
    """The tensor-parallel collectives stats holds, as JSON."""
    return {f"{k}.{ph}": {"calls": n, "bytes": stats.bytes[k, ph],
                          "seconds": stats.seconds.get((k, ph), 0.0)}
            for (k, ph), n in sorted(stats.counts.items())}


def tp_forward_part(dev, cfg, state, mesh, r):
    """(a) on one rank: the tensor-parallel forward at model batch
    TP_FORWARD_BATCH in f32 (TF32 off) and bf16, the same inputs on both
    ranks; on rank 0 the one-process forward on the same inputs beside it
    (f32 gated at MODEL_TOL, bf16 read). This rank's launches, the K3 calls
    at 32 / tp groups counted apart, then a second forward with the
    collectives timed."""
    from nicediffusion_tpu_torch import DiffusionModel
    from nicediffusion_tpu_torch.models.unet import GroupNormOp
    from nicediffusion_tpu_torch.parallel.tensor import stats

    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    res, ch, b = cfg["resolution"], cfg["in_channels"], TP_FORWARD_BATCH
    x = torch.randn(b, res, res, ch, generator=g, device=dev)
    t = torch.randint(0, 1000, (b,), generator=g, device=dev)
    y = torch.randint(0, cfg["num_classes"], (b,), generator=g, device=dev)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        kw = {} if dtype == torch.float32 else {"dtype": dtype}
        model = DiffusionModel(**cfg, device=dev, **kw).eval()
        model.load_state_dict(state, strict=True)
        model.shard_(mesh)
        sharded = [0]
        hooks = [m.register_forward_pre_hook(lambda *_: sharded.__setitem__(0, sharded[0] + 1))
                 for m in model.modules() if isinstance(m, GroupNormOp) and m.num_groups != 32]
        reset_launches()
        with torch.inference_mode():
            h = model(x, t, y)
        torch.cuda.synchronize()
        part = {"launches": read_launches(), "sharded_k3": sharded[0]}
        for hk in hooks:
            hk.remove()
        stats.reset()
        stats.timed = True
        t0 = time.perf_counter()
        with torch.inference_mode():
            model(x, t, y)
        torch.cuda.synchronize()
        part["wall_s"] = time.perf_counter() - t0
        stats.timed = False
        part["collectives"] = _collectives(stats)
        if not (h.shape == (b, res, res, cfg["out_channels"]) and torch.isfinite(h).all()):
            raise AssertionError(f"[tp] (a) {name} rank {r}: {tuple(h.shape)}, finite "
                                 f"{bool(torch.isfinite(h).all())}")
        if r == 0:
            one = DiffusionModel(**cfg, device=dev, **kw).eval()
            one.load_state_dict(state, strict=True)
            with torch.inference_mode():
                ref = one(x, t, y)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one(x, t, y)
                torch.cuda.synchronize()
            part["one_process_wall_s"] = time.perf_counter() - t0
            part["max_abs"] = (h.float() - ref.float()).abs().max().item()
            del one, ref
            if dtype == torch.float32 and not part["max_abs"] <= MODEL_TOL:
                raise AssertionError(f"[tp] (a) f32 forward on two ranks against one process: "
                                     f"max abs {part['max_abs']} (gate {MODEL_TOL})")
        out[name] = part
        del model, h
        torch.cuda.empty_cache()
    return out


def tp_train_part(dev, cfg, state, mesh, r, work):
    """(b) on one rank: TP_TRAIN_STEPS steps of ``Trainer(mesh=)`` (remat,
    dropout 0, batch TRAIN_BATCH, injected draws, the same on both ranks) in
    f32 and bf16; on rank 0 each step beside a one-process Trainer on the
    same batch and draws: loss and grad norm (LOSS_TOL) and every gathered
    gradient (GRAD_TOL), gated in f32, read in bf16. Then, by dtype, the
    digest of this rank's replicated parameters and EMA (the parent holds the
    ranks' equal), one step with the collectives timed and one with rank 0's
    device time traced; in f32 the checkpoint (gathered whole to rank 0, which
    loads it strict into one process and holds it equal to the gathered
    state)."""
    from torch.profiler import ProfilerActivity, profile

    from nicediffusion_tpu_torch import DiffusionModel, Trainer
    from nicediffusion_tpu_torch.models.unet import GroupNormOp
    from nicediffusion_tpu_torch.parallel.sharding import gather_params, gather_tensor
    from nicediffusion_tpu_torch.parallel.tensor import stats
    from nicediffusion_tpu_torch.utils.config import DIFFUSION_PRESETS

    dcfg = dict(DIFFUSION_PRESETS["openai_64"], guidance_method="classifier_free")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")

        def trainer(m):
            model = DiffusionModel(**dict(cfg, dropout=0.0), use_remat=True, device=dev,
                                   dtype=None if dtype == torch.float32 else dtype)
            model.load_state_dict(state, strict=True)
            tr = Trainer(model, dcfg, iter(()), iterations=0, batch_size=TRAIN_BATCH, lr=1e-4,
                         weight_decay=1e-3, ema_rate=0.99, seed=SEED, mesh=m,
                         checkpoint_dir=os.path.join(work, f"tp_ckpt_{name}"))
            reduce, tr.record, tr.pre_reduce, tr.reduce_s = tr._reduce, True, None, []

            def record(grads, loss):  # the gradients the update sees, gathered whole
                if tr.tp is not None and tr.pre_reduce is None:  # the replicated ones, once
                    tr.pre_reduce = {n: _state_digest({n: gr})[:12]
                                     for n, gr in zip(tr._names, grads) if tr._dims[n] is None}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                grads, loss = reduce(grads, loss)
                torch.cuda.synchronize()
                tr.reduce_s.append(time.perf_counter() - t0)
                if tr.record:
                    tr.grads = [gather_tensor(gr.detach(), tr._dims.get(n), tr.tp)
                                if tr.tp else gr.detach().clone()
                                for n, gr in zip(tr._names, grads)]
                return grads, loss

            tr._reduce = record
            return tr

        tp = trainer(mesh)
        one = trainer(None) if r == 0 else None
        sharded = [0]
        hooks = [m.register_forward_pre_hook(lambda *_: sharded.__setitem__(0, sharded[0] + 1))
                 for m in tp.model.modules() if isinstance(m, GroupNormOp) and m.num_groups != 32]
        n_sharded = len(hooks)
        launches = collections.Counter()
        worst = {"loss": 0.0, "grad_norm": 0.0, "grad": 0.0, "grad_name": ""}
        losses, step_s, one_s = [], [], []
        steps = tp.train_diffusion.rescaled_num_steps
        for i in range(TP_TRAIN_STEPS):
            d = {k: v.to(dev) for k, v in dp_draws(i, cfg, steps).items()}
            reset_launches()
            t0 = time.perf_counter()
            m = tp.train_step(**d)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            launches.update(read_launches())
            loss, norm = m["loss"].item(), m["grad_norm"].item()
            if not (math.isfinite(loss) and math.isfinite(norm)):
                raise AssertionError(f"[tp] (b) rank {r} step {i}: loss {loss}, norm {norm}")
            losses.append(loss)
            if one is None:
                continue
            t0 = time.perf_counter()
            m1 = one.train_step(**d)
            loss1, norm1 = m1["loss"].item(), m1["grad_norm"].item()
            one_s.append(time.perf_counter() - t0)
            worst["loss"] = max(worst["loss"], abs(loss - loss1) / max(1.0, abs(loss1)))
            worst["grad_norm"] = max(worst["grad_norm"], abs(norm - norm1) / max(1.0, abs(norm1)))
            for pname, a, b in zip(tp._names, tp.grads, one.grads):
                scale = b.abs().max().item()
                rel = (a - b).abs().max().item() / scale if scale else float("inf")
                if rel > worst["grad"]:
                    worst["grad"], worst["grad_name"] = rel, pname
        for hk in hooks:
            hk.remove()
        expect = expect_train_launches(tp.model, TP_TRAIN_STEPS)
        part = {"worst": worst, "losses": losses, "launches": dict(launches), "expect": expect,
                "sharded_k3": sharded[0],
                "sharded_k3_expect": n_sharded * TP_TRAIN_STEPS * (2 if tp.model.use_remat else 1),
                "step_s": step_s, "one_process_step_s": one_s, "reduce_s": tp.reduce_s}
        if dict(launches) != expect or part["sharded_k3"] != part["sharded_k3_expect"]:
            raise AssertionError(f"[tp] (b) {name} rank {r}: launches {dict(launches)} != "
                                 f"{expect}, or K3 at 32/tp groups {part['sharded_k3']} != "
                                 f"{part['sharded_k3_expect']}")
        if one is not None and dtype == torch.float32 and not (
                worst["loss"] <= LOSS_TOL and worst["grad_norm"] <= LOSS_TOL
                and worst["grad"] <= GRAD_TOL):
            raise AssertionError(f"[tp] (b) f32: two ranks against one process {worst} (gates: "
                                 f"loss and norm {LOSS_TOL}, gradients {GRAD_TOL})")
        del one
        tp.record = False
        tp.grads = None
        rep = {f"model.{k}": v for k, v in tp.model.named_parameters() if tp._dims[k] is None}
        rep.update({f"ema.{k}": v for k, v in tp.ema_model.named_parameters()
                    if tp._dims[k] is None})
        part["replicated_digests"] = {k: _state_digest({k: v})[:12] for k, v in rep.items()}
        part["first_replicated_grads"] = tp.pre_reduce
        # readings: one step with the collectives timed, one with the device traced
        d = {k: v.to(dev) for k, v in dp_draws(TP_TRAIN_STEPS, cfg, steps).items()}
        stats.reset()
        stats.timed = True
        t0 = time.perf_counter()
        tp.train_step(**d)
        torch.cuda.synchronize()
        part["timed_step_s"] = time.perf_counter() - t0
        stats.timed = False
        part["collectives"] = _collectives(stats)
        d = {k: v.to(dev) for k, v in dp_draws(TP_TRAIN_STEPS + 1, cfg, steps).items()}
        t0 = time.perf_counter()
        if r == 0:  # one try: a retry would leave the other rank's collectives waiting
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                tp.train_step(**d)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)) / 1e6
            part["traced_step"] = {"wall_s": wall, "busy_s": busy,
                                   "idle_share": 1 - busy / wall if busy > 0 else None}
        else:
            tp.train_step(**d)
            torch.cuda.synchronize()
        if dtype == torch.float32:
            tp.save(tp.step)
            whole = gather_params(tp.model.state_dict(), mesh, tp._dims)
            if r == 0:
                saved = torch.load(tp._ckpt_path(tp.step), map_location=dev, weights_only=True)
                check = DiffusionModel(**cfg, device=dev)
                check.load_state_dict(saved["model"], strict=True)
                check.load_state_dict(saved["ema"], strict=True)
                diff = [k for k, v in saved["model"].items() if not torch.equal(v, whole[k])]
                if diff or saved["step"] != tp.step:
                    raise AssertionError(f"[tp] (b) checkpoint: {diff[:4]} differ from the "
                                         f"gathered state, step {saved['step']}")
                part["checkpoint"] = {"tensors": len(saved["model"]), "step": saved["step"]}
                del check, saved
            del whole
        out[name] = part
        del tp
        torch.cuda.empty_cache()
    return out


def tp_rank(work, model_path, cfg):
    """One rank of ``[tp]``'s group (started by parallel/dryrun.py::spawn_ranks,
    two ranks on one card over gloo, a mesh of 1 x TP_WORLD): parts (a) and
    (b) on the card. A rank that sees no card raises: nothing of [tp] runs on
    the CPU."""
    from nicediffusion_tpu_torch.parallel import rank
    from nicediffusion_tpu_torch.parallel.mesh import make_mesh

    r = rank()
    if not torch.cuda.is_available():
        raise RuntimeError(f"[tp] rank {r} sees no CUDA device")
    record_conv_shapes()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    state = torch.load(model_path, map_location=dev, weights_only=True)
    mesh = make_mesh(1, TP_WORLD)
    t0 = time.perf_counter()
    out = {"forward": tp_forward_part(dev, cfg, state, mesh, r)}
    t1 = time.perf_counter()
    out["train"] = tp_train_part(dev, cfg, state, mesh, r, work)
    out["seconds"] = {"a": t1 - t0, "b": time.perf_counter() - t1}
    out["conv_shapes"] = sorted(CONV_SHAPES)
    return out


def _fmt_collectives(coll):
    return ", ".join(f"{k} {v['calls']} x, {v['bytes'] / 1e9:.4f} GB, {v['seconds']:.4f} s"
                     for k, v in coll.items())


def phase_tp(dev, workdir, smi, n_sharded):
    """``[tp]``: tensor parallelism at full-width ``openai_64``, the weights
    of ``64x64_diffusion.pt``, two gloo ranks sharing the card on a mesh of
    1 x 2 (tp_rank): (a) the forward at model batch 16, f32 held to one
    process at MODEL_TOL, bf16 read; (b) two ``Trainer(mesh=)`` steps in f32
    (held to one process at LOSS_TOL and GRAD_TOL) and bf16 (read), the
    replicated parameters and EMA bit-equal across the ranks, the checkpoint
    whole; (c) every rank's K1, K2, K3 and K3-backward launches against the
    structure, the K3 calls at 16 groups apart (``n_sharded`` a forward);
    (d) readings: the step's wall and device busy time and idle share, the
    collectives' calls, bytes and seconds per forward and per step. Returns
    the paths' launches (both ranks summed) and the readings."""
    from nicediffusion_tpu_torch import DiffusionModel
    from nicediffusion_tpu_torch.parallel.dryrun import spawn_ranks

    cfg = model_config()
    meta = DiffusionModel(**cfg, device="meta")
    got = spawn_ranks("chip_smoke:tp_rank", TP_WORLD,
                      dict(work=workdir, model_path=os.path.join(workdir, "64x64_diffusion.pt"),
                           cfg=cfg),
                      timeout_s=TP_TIMEOUT_S, one_device=True,
                      pythonpath=(os.path.dirname(os.path.abspath(__file__)),))
    CONV_SHAPES.update(tuple(case) for res in got for case in res["conv_shapes"])
    log(f"[tp] two ranks on one card (gloo), tp={TP_WORLD}: seconds by part of rank 0 "
        f"{ {k: round(v, 1) for k, v in got[0]['seconds'].items()} }")
    readings = {"device": smi}
    by_path = {"tp_forward_openai_64": collections.Counter(),
               "tp_train_openai_64": collections.Counter()}
    for dtype in ("float32", "bfloat16"):
        expect_fwd = serve_expect(meta, 1, dtype=getattr(torch, dtype))
        a = got[0]["forward"][dtype]
        runs = [g["forward"][dtype] for g in got]
        for run in runs:
            by_path["tp_forward_openai_64"].update(run["launches"])
        if any(x["launches"] != expect_fwd or x["sharded_k3"] != n_sharded for x in runs):
            raise AssertionError(f"[tp] (c) forward {dtype}: launches "
                                 f"{[(x['launches'], x['sharded_k3']) for x in runs]}, expected "
                                 f"{expect_fwd} with {n_sharded} K3 calls at 32/tp groups")
        readings[f"forward_{dtype}"] = {k: a[k] for k in
                                        ("max_abs", "wall_s", "one_process_wall_s", "collectives")}
        log(f"[tp] (a) openai_64 forward {dtype}, model batch {TP_FORWARD_BATCH}, two ranks "
            f"against one process: max abs {a['max_abs']:.6g}"
            + (f" (gate {MODEL_TOL})" if dtype == "float32" else " (read)")
            + f"; launches a rank {a['launches']['attention']} K1, {a['launches']['groupnorm']} "
            f"K3 of which {a['sharded_k3']} at {32 // TP_WORLD} groups")
        log(f"[tp] (d) forward {dtype} ({smi}): {a['wall_s']:.4f} s on rank 0 with the "
            f"collectives timed, one process {a['one_process_wall_s']:.4f} s; collectives "
            f"{_fmt_collectives(a['collectives'])}")
    for dtype in ("float32", "bfloat16"):
        t = got[0]["train"][dtype]
        w = t["worst"]
        runs = [g["train"][dtype] for g in got]
        for run in runs:
            by_path["tp_train_openai_64"].update(run["launches"])
        first = [run["first_replicated_grads"] for run in runs]
        apart = sorted(k for k in first[0] if first[0][k] != first[1][k])
        log(f"[tp] (b) {dtype}: before the model-group mean of the first step, {len(apart)} of "
            f"{len(first[0])} replicated gradients differ between the ranks bit for bit "
            f"{apart[:8]}")
        digests = [run["replicated_digests"] for run in runs]
        differ = sorted(k for k in digests[0] if digests[0][k] != digests[1][k])
        readings[f"train_{dtype}"] = {k: t[k] for k in (
            "worst", "losses", "step_s", "one_process_step_s", "reduce_s", "timed_step_s",
            "collectives", "traced_step")}
        log(f"[tp] (b) openai_64 {dtype}, remat, dropout 0, batch {TRAIN_BATCH}, "
            f"{TP_TRAIN_STEPS} steps, two ranks against one process: worst loss "
            f"{w['loss']:.3g}, grad norm {w['grad_norm']:.3g} (relative), gradient "
            f"{w['grad']:.3g} of its largest element ({w['grad_name']}); "
            + (f"gated at LOSS_TOL {LOSS_TOL}, GRAD_TOL {GRAD_TOL}" if dtype == "float32"
               else "read") + f"; losses {[round(x, 5) for x in t['losses']]}; replicated "
            f"parameters and EMA differing between the ranks: {len(differ)}; launches a rank "
            f"{[run['launches'] for run in runs]} (expected {t['expect']}), K3 at "
            f"{32 // TP_WORLD} groups {t['sharded_k3']} (expected {t['sharded_k3_expect']})")
        if differ:
            raise AssertionError(f"[tp] (b) {dtype}: {len(differ)} replicated parameters and EMA "
                                 f"differ between the ranks: {differ[:8]}")
        if len({tuple(run["losses"]) for run in runs}) != 1:
            raise AssertionError(f"[tp] (b) {dtype}: the ranks saw different losses")
        tr = t["traced_step"]
        log(f"[tp] (d) step {dtype} ({smi}): rank 0 {[round(x, 4) for x in t['step_s']]} s, one "
            f"process on the same card {[round(x, 4) for x in t['one_process_step_s']]} s; the "
            f"trainer's reduce (the replicated gradients' model-group mean) "
            f"{[round(x, 4) for x in t['reduce_s'][:TP_TRAIN_STEPS]]} s; "
            f"with the collectives timed {t['timed_step_s']:.4f} s: "
            f"{_fmt_collectives(t['collectives'])}; traced step: wall {tr['wall_s']:.4f} s, "
            f"rank 0's device busy {tr['busy_s']:.4f} s, idle share "
            + (f"{tr['idle_share']:.4f}" if tr["idle_share"] is not None else "not measured"))
    ck = got[0]["train"]["float32"]["checkpoint"]
    log(f"[tp] (b) checkpoint at step {ck['step']}: {ck['tensors']} tensors gathered whole to "
        f"rank 0, loaded strict into one process, equal to the gathered state")
    return {k: dict(v) for k, v in by_path.items()}, readings


# ---------------------------------------------------------------------------
# [tools]: the evaluation tools (nicediffusion_tpu_torch/tools/)
# ---------------------------------------------------------------------------

TOOLS_NLL_BATCH, TOOLS_NLL_BATCHES = 8, 2
OPENAI_64_PARAMS = 295_904_454  # the published count verify_checkpoint holds the file to
TOOLS_NLL_TOL = 1e-3  # total_bpd and prior_bpd, kernels on against off, relative
# tools/quality_eval.py's knobs for [tools] (c): its EMNIST harness at 100
# UNet and 20 classifier steps (the gates read keys, finiteness and the
# levers' deviations from the exact chain, not quality; the EMA, at 0.9999,
# must move far enough from the zero-initialised output layers for the
# guidance interval to move a sample in f32), 128 images a mode in two chunks of 64 for the
# statistics, a 50-step DDPM chain, the encoder cache, the guidance interval,
# int8 and their max stack
QE_SMOKE_ENV = {"QE_TRAIN_STEPS": "100", "QE_CLS_STEPS": "20", "QE_EVAL_N": "128",
                "QE_CHUNK": "64", "QE_SAMPLE_STEPS": "50", "QE_MODES": "enc,gi,int8",
                "QE_BATCH": str(QE_BATCH)}
QE_MODE_KEYS = ("classifier_acc", "classifier_acc_se", "proto_acc", "proto_acc_se",
                "logit_frechet_vs_real", "logit_frechet_se", "max_pixel_dev_vs_exact",
                "mean_pixel_dev_vs_exact")
# the modes QE_SMOKE_ENV gives: (name, encoder cache k, the int8 model?)
QE_SMOKE_MODES = (("exact", 1, False), ("enc2", 2, False), ("enc3", 3, False),
                  ("gi_0.1-0.7", 1, False), ("gi_0.15-0.55", 1, False), ("int8", 1, True),
                  ("stack_int8_enc2_gi", 2, True))


@contextlib.contextmanager
def environ(values):
    """``os.environ`` updated with ``values`` inside the block; restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_captured(fn, *args):
    """(fn(*args), the lines it printed), its output logged as it is."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"    {line}")
    return rc, lines


def encoder_decoder_calls(steps, k):
    """(encoder calls, decoder calls) of one ``Diffusion.denoise`` chain of
    ``steps`` with ``encoder_cache=k``: groups of k from the noisy end, one
    encoder call a group, the last ``steps % k`` steps uncached; the decoder
    runs every step (k = 1: every step a whole forward)."""
    k = max(1, min(k, steps))
    head = steps - steps % k if k > 1 else 0
    return head // k + (steps - head), steps


def part_counts(cfg):
    """{kind: (in the encoder, in the decoder)} of the K1, K3 and int8 conv
    calls of one forward of ``cfg``'s UNet: its AttentionBlocks, GroupNormOps
    and (built quantized) int8 layers in ``downsampling`` against the rest
    (middle, decoder, head); and of the bf16 conv's calls of a bf16 forward
    of the float model (``conv``), of the quantized one (``conv_int8``: its
    float convs) and of the quantized one recording its calibration
    (``conv_recording``). Built on the meta device."""
    from nicediffusion_tpu_torch import DiffusionModel
    from nicediffusion_tpu_torch.models.unet import AttentionBlock, GroupNormOp

    model = DiffusionModel(**cfg, device="meta")
    quantized = DiffusionModel(**cfg, quantized=True, device="meta")

    def count(kind):
        enc = sum(isinstance(m, kind) for m in model.downsampling.modules())
        return enc, sum(isinstance(m, kind) for m in model.modules()) - enc

    def convs(m, **kw):
        enc = conv_per_call(m, torch.bfloat16, part=m.downsampling, **kw)
        return enc, conv_per_call(m, torch.bfloat16, **kw) - enc

    int8 = list(quantized.int8_layers())
    n_enc = sum(name.startswith("downsampling.") for name in int8)
    return {"attention": count(AttentionBlock), "groupnorm": count(GroupNormOp),
            "int8conv": (n_enc, len(int8) - n_enc), "conv": convs(model),
            "conv_int8": convs(quantized), "conv_recording": convs(quantized, recording=True)}


def expect_quality_eval(unet_cfg, cls_cfg, env):
    """The launches of tools/quality_eval.py's ``main`` under ``env``'s knobs
    (QE_SMOKE_ENV's modes), from the two models' structure: the UNet's
    training steps (no remat: one K1, K3 per block and norm forward, one K2
    and K3 backward each), the classifier's, every mode's chain (encoder and
    decoder calls as the cache groups them; the guidance interval changes
    batches, not calls), the int8 model's calibration chain through its
    dynamic int8 path (every int8 layer through the kernel) and its 6
    calibration forwards (float: no int8 conv), and one classifier forward a
    mode and one for the real data (eval_n <= 256: one padded chunk). The
    bf16 conv: every UNet conv of the chains and the calibration (the int8
    model's float convs alone where its int8 layers run), none of the
    training steps (grad mode on) or of the f32 classifier."""
    from nicediffusion_tpu_torch import EncoderUNet

    parts = part_counts(unet_cfg)
    n_attn, gn_in, gn_out = block_counts(EncoderUNet(**cls_cfg, device="meta"))
    n_gn_cls = gn_in + gn_out
    train, cls_steps = int(env["QE_TRAIN_STEPS"]), int(env["QE_CLS_STEPS"])
    steps, eval_n = int(env["QE_SAMPLE_STEPS"]), int(env["QE_EVAL_N"])
    chunks = math.ceil(eval_n / min(eval_n, 128))
    unet_attn, unet_gn = sum(parts["attention"]), sum(parts["groupnorm"])
    out = {"attention": train * unet_attn + cls_steps * n_attn,
           "attention_bwd": train * unet_attn + cls_steps * n_attn,
           "groupnorm": train * unet_gn + cls_steps * n_gn_cls,
           "groupnorm_bwd": train * unet_gn + cls_steps * n_gn_cls,
           "mha": 0, "resblock": 0, "int8conv": 0, "conv": 0}

    def chain(k, int8, n_chunks):
        enc, dec = encoder_decoder_calls(steps, k)
        for kind in ("attention", "groupnorm") + (("int8conv",) if int8 else ()):
            out[kind] += n_chunks * (enc * parts[kind][0] + dec * parts[kind][1])
        conv = parts["conv_int8" if int8 else "conv"]
        out["conv"] += n_chunks * (enc * conv[0] + dec * conv[1])

    for _, k, int8 in QE_SMOKE_MODES:
        chain(k, int8, chunks)
    chain(1, True, 1)  # the calibration chain: 8 labels, the dynamic int8 path
    calib_points = len({round(i * (steps - 1) / 5) for i in range(6)})
    out["attention"] += calib_points * unet_attn
    out["groupnorm"] += calib_points * unet_gn
    out["conv"] += calib_points * sum(parts["conv_recording"])
    logit_calls = len(QE_SMOKE_MODES) + 1
    out["attention"] += logit_calls * n_attn
    out["groupnorm"] += logit_calls * n_gn_cls
    return out


def phase_tools(dev, workdir):
    """``[tools]``: the three evaluation tools through their entry points'
    ``main`` on the card. (a) ``eval_nll`` on a full-width ``openai_64``
    checkpoint of seeded random weights, as the preset builds the model
    (1000 classes, guidance off), at batch 8 x 2 in bf16: finite numbers, 25
    chain steps, 16 images; the same evaluation in f32 with the same
    injected noise, kernels on against ``kernels=False``, total and prior
    bits/dim within TOOLS_NLL_TOL relative. (b) ``verify_checkpoint`` on that
    file: every executed check passes, exit 0, 295,904,454 parameters; the
    file with one tensor dropped: exit 1, "missing 1"; the caller's TF32
    flags as they were. (c) ``quality_eval``
    under QE_SMOKE_ENV in bf16: every mode's line with the JAX tool's keys,
    finite; ``exact`` 0 from itself, every lever above 0 (its samples' max
    deviation, unrounded: the lines round to 1e-4). The launch counts
    of each part are held to the structure. Returns the parts' launches."""
    import numpy as np

    from nicediffusion_tpu_torch import Diffusion, DiffusionModel
    from nicediffusion_tpu_torch.tools import eval_nll, quality_eval, verify_checkpoint
    from nicediffusion_tpu_torch.utils.config import preset_for_path

    tools_dir = os.path.join(workdir, "tools")
    os.makedirs(tools_dir)
    model_path = os.path.join(tools_dir, "64x64_diffusion.pt")
    model_args, diff_args = preset_for_path(model_path)
    model = DiffusionModel(**model_args, kernels=False, device=dev).eval()
    randomize(model, SEED + 11)
    state = model.state_dict()
    torch.save(state, model_path)
    n_attn, gn_in, gn_out = block_counts(model)
    by_path, seconds = {}, {}

    # (a) eval_nll in bf16 through its entry point
    reset_launches()
    t0 = time.perf_counter()
    rc, lines = run_captured(eval_nll.main, [
        "--model_path", model_path, "--batch_size", str(TOOLS_NLL_BATCH),
        "--num_batches", str(TOOLS_NLL_BATCHES)])
    torch.cuda.synchronize()
    seconds["eval_nll"] = time.perf_counter() - t0
    launches = read_launches()
    result = json.loads(lines[-1])
    steps = diff_args["rescaled_num_steps"]
    forwards = steps * TOOLS_NLL_BATCHES
    expect = {"attention": forwards * n_attn, "attention_bwd": 0,
              "groupnorm": forwards * (gn_in + gn_out), "groupnorm_bwd": 0, "mha": 0,
              "resblock": 0, "int8conv": 0,
              "conv": forwards * conv_per_call(DiffusionModel(**model_args, device="meta"),
                                               torch.bfloat16)}
    if (rc != 0 or result["chain_steps"] != steps
            or result["num_images"] != TOOLS_NLL_BATCH * TOOLS_NLL_BATCHES
            or not all(math.isfinite(result[k])
                       for k in ("total_bpd", "prior_bpd", "eps_mse_mean"))):
        raise AssertionError(f"[tools] eval_nll: rc {rc}, {result}")
    if launches != expect:
        raise AssertionError(f"[tools] eval_nll launches {launches} != {expect}")
    by_path["tools_eval_nll_openai_64"] = launches
    log(f"[tools] (a) eval_nll, openai_64 bf16, {forwards} forwards at batch {TOOLS_NLL_BATCH}: "
        f"{result}; launches as the structure gives ({forwards} x {n_attn} K1, x "
        f"{gn_in + gn_out} K3); {seconds['eval_nll']:.2f} s")

    # (a) kernels on against off: the same images, labels and noise, in f32
    on = DiffusionModel(**model_args, device=dev).eval()
    on.load_state_dict(state, strict=True)
    unguided = dict(diff_args, guidance_method=None, guidance_strength=None)
    rng = np.random.default_rng(0)
    n = TOOLS_NLL_BATCH * TOOLS_NLL_BATCHES
    images, labels = eval_nll.synthetic_images(rng, n, model_args["resolution"],
                                               model_args["in_channels"],
                                               model_args["num_classes"])
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    noises = [torch.randn((steps, TOOLS_NLL_BATCH) + images.shape[1:], generator=g,
                          device=dev) for _ in range(TOOLS_NLL_BATCHES)]
    got = {which: eval_nll.evaluate(Diffusion(model=m, **unguided), images, labels,
                                    TOOLS_NLL_BATCH, TOOLS_NLL_BATCHES, noises=noises)
           for which, m in (("on", on), ("off", model))}
    rel = {k: abs(got["on"][k] - got["off"][k]) / abs(got["off"][k])
           for k in ("total_bpd", "prior_bpd")}
    log(f"[tools] (a) eval_nll's evaluation in f32 with injected noise, kernels on "
        f"{got['on']} against off {got['off']}: relative {rel} (gate {TOOLS_NLL_TOL})")
    if not all(v <= TOOLS_NLL_TOL for v in rel.values()):
        raise AssertionError(f"[tools] eval_nll kernels on against off: {rel}")
    del on, model, noises
    torch.cuda.empty_cache()

    # (b) verify_checkpoint on the sound file, then on one with a tensor dropped
    reset_launches()
    t0 = time.perf_counter()
    # the tool runs in f32 with TF32 off and hands its caller's setting back
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        rc, lines = run_captured(verify_checkpoint.main, ["--pt", model_path])
        kept_tf32 = torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.cuda.synchronize()
    seconds["verify_checkpoint"] = time.perf_counter() - t0
    launches = read_launches()
    if not kept_tf32:
        raise AssertionError("[tools] verify_checkpoint did not restore its caller's TF32 flags")
    fails = [line for line in lines if line.startswith("[FAIL]")]
    count_line = [line for line in lines if line.startswith("[PASS] param count")]
    if rc != 0 or fails or not count_line or f"{OPENAI_64_PARAMS:,} vs" not in count_line[0]:
        raise AssertionError(f"[tools] verify_checkpoint: rc {rc}, {lines}")
    expect = {"attention": 2 * n_attn, "attention_bwd": 0, "groupnorm": 2 * (gn_in + gn_out),
              "groupnorm_bwd": 0, "mha": 0, "resblock": 0, "int8conv": 0, "conv": 0}
    if launches != expect:
        raise AssertionError(f"[tools] verify_checkpoint launches {launches} != {expect}")
    by_path["tools_verify_openai_64"] = launches
    dropped = dict(state)
    gone = sorted(dropped)[-1]
    del dropped[gone]
    bad_path = os.path.join(tools_dir, "64x64_missing.pt")
    torch.save(dropped, bad_path)
    del dropped, state
    rc_bad, bad_lines = run_captured(verify_checkpoint.main, ["--pt", bad_path])
    structural = [line for line in bad_lines if "structural match" in line]
    if rc_bad != 1 or not structural or not structural[0].startswith("[FAIL]") \
            or "missing 1 " not in structural[0]:
        raise AssertionError(f"[tools] verify_checkpoint missed the dropped {gone}: "
                             f"rc {rc_bad}, {bad_lines}")
    log(f"[tools] (b) verify_checkpoint: exit 0, every executed check passed, launches as "
        f"the 2-step smoke sample gives ({launches}), the caller's TF32 flags restored; "
        f"{gone} dropped: exit 1, "
        f"{structural[0]!r}; {seconds['verify_checkpoint']:.2f} s")

    # (c) quality_eval at its EMNIST harness, bf16
    _, qe_cfg, cls_cfg = quality_eval.arch_config("emnist")
    expect = expect_quality_eval(qe_cfg, cls_cfg, QE_SMOKE_ENV)
    # the samples of every mode as the tool hands them to its report: the
    # deviations from the exact chain unrounded (its lines round to 1e-4)
    report, samples = quality_eval.report, {}

    def keep_samples(modes, *args):
        samples.update(modes)
        return report(modes, *args)

    reset_launches()
    t0 = time.perf_counter()
    quality_eval.report = keep_samples
    try:
        with environ(dict(QE_SMOKE_ENV, QE_DEVICE="cuda")):
            rc, lines = run_captured(quality_eval.main, [])
    finally:
        quality_eval.report = report
    torch.cuda.synchronize()
    seconds["quality_eval"] = time.perf_counter() - t0
    launches = read_launches()
    deviation = {name: float(np.abs(x - samples["exact"]).max()) for name, x in samples.items()}
    rows = {}
    for line in lines:
        if line.startswith("{"):
            row = json.loads(line)
            if "mode" in row:
                rows[row.pop("mode")] = row
    want = [name for name, _, _ in QE_SMOKE_MODES]
    problems = [f"rc {rc}"] if rc != 0 else []
    for name in want:
        row = rows.get(name)
        if row is None or tuple(row) != QE_MODE_KEYS:
            problems.append(f"{name}: {row}")
        elif not all(v is not None and math.isfinite(v) for v in row.values()):
            problems.append(f"{name} not finite: {row}")
        elif (deviation[name] == 0) != (name == "exact"):
            problems.append(f"{name}: max pixel deviation from exact {deviation[name]}")
    if "real_data" not in rows:
        problems.append("no real_data line")
    if problems:
        raise AssertionError(f"[tools] quality_eval: {problems}")
    if launches != expect:
        raise AssertionError(f"[tools] quality_eval launches {launches} != {expect}")
    by_path["tools_quality_eval_emnist"] = launches
    log(f"[tools] (c) quality_eval, EMNIST harness, bf16, {QE_SMOKE_ENV}: the {len(want)} "
        f"modes' lines present, finite; max pixel deviation from exact, unrounded: "
        f"{json.dumps(deviation)} (exact 0, each lever above 0); launches {launches}, as the "
        f"structure gives; {seconds['quality_eval']:.2f} s")
    for path, counts in by_path.items():
        for kind in ("attention", "attention_bwd", "groupnorm", "groupnorm_bwd", "int8conv"):
            runs = kind in ("attention", "groupnorm") or path == "tools_quality_eval_emnist"
            if runs and not counts[kind]:
                raise AssertionError(f"[tools] {path}: no {kind} launch")
    log(f"[tools] seconds by tool {json.dumps(seconds)}")
    return by_path


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card (torch.cuda.is_available() is False)")
    import nicediffusion_tpu_torch  # noqa: F401  (fails outside a checkout)

    record_conv_shapes()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device()
    phase_build()
    phase_done("[device], [build]")

    from nicediffusion_tpu_torch import DiffusionModel

    reference = DiffusionModel(**model_config(), kernels=False, device=dev).eval()
    randomize(reference, SEED)
    calls = main_path_calls(reference, dev)
    # the train entry point's model: EMNIST preset + null class, remat on
    emnist = DiffusionModel(**model_config("EMNIST"), use_remat=True, kernels=False,
                            device=dev).eval()
    randomize(emnist, SEED)
    emnist_calls = main_path_calls(emnist, dev)
    # the classifier-guided slice's models: openai_128 and its noisy classifier
    from nicediffusion_tpu_torch import EncoderUNet
    from nicediffusion_tpu_torch.utils.config import MODEL_PRESETS

    # remat only acts while a gradient is taken: the sampling phases do not see it
    unet128 = DiffusionModel(**MODEL_PRESETS["openai_128"], use_remat=True, kernels=False,
                             device=dev).eval()
    randomize(unet128, SEED + 1)
    cls128 = EncoderUNet(**classifier_config(), kernels=False, device=dev).eval()
    randomize(cls128, SEED + 2)
    # the super-resolution slice's model: openai_256 widths, in_channels doubled
    from nicediffusion_tpu_torch.models.unet import SuperResolutionModel

    sr256 = SuperResolutionModel(**sr_config(), kernels=False, device=dev).eval()
    randomize(sr256, SEED + 4)
    tp_calls = tp_path_calls(reference, dev)
    # tools/quality_eval.py's UNet and classifier: their shapes only
    from nicediffusion_tpu_torch.tools.quality_eval import arch_config

    meta = torch.device("meta")
    _, qe_cfg, qe_cls_cfg = arch_config("emnist")
    qe_unet = DiffusionModel(**qe_cfg, kernels=False, device=meta).eval()
    paths = {"forward": calls, "train": calls, "emnist": emnist_calls,
             "unet128": main_path_calls(unet128, dev), "cls128": main_path_calls(cls128, dev),
             "sr256": main_path_calls(sr256, dev), "serve64": calls, "dp_train": calls,
             "tp": tp_calls, "tp_train": tp_calls, "qe_unet": main_path_calls(qe_unet, meta),
             "qe_cls": main_path_calls(
                 EncoderUNet(**qe_cls_cfg, kernels=False, device=meta).eval(), meta),
             "verify64": calls}
    paths["qe_calib"] = paths["qe_gi"] = paths["qe_unet"]
    # [wide-heads]: openai_128's widths at one head, its attention calls
    wide = DiffusionModel(**wide_config(), kernels=False, device=meta).eval()
    paths["wide128"] = paths["wide128_train"] = collections.Counter(
        {k: n for k, n in main_path_calls(wide, meta).items() if k[0] == "attention"})
    halves = resblock_halves(reference, dev)
    int8_calls = int8_conv_calls(reference, model_config(), dev)
    int8_calls_emnist = int8_conv_calls(emnist, model_config("EMNIST"), dev)
    qe_int8_calls = int8_conv_calls(qe_unet, qe_cfg, meta)
    conv_paths = {"forward": conv_calls(reference, dev), "unet128": conv_calls(unet128, dev),
                  "sr256": conv_calls(sr256, dev), "tp": conv_calls(reference, dev, TP_WORLD),
                  "qe_unet": conv_calls(qe_unet, meta)}
    conv_paths["serve64"] = conv_paths["forward"]
    conv_paths["qe_calib"] = conv_paths["qe_gi"] = conv_paths["qe_unet"]
    phase_done("models made, their kernel calls found")
    errs, tallies, k3_gates = phase_kernels(dev, paths)
    phase_done("[kernels]")
    k2_errs, k2_tallies, k2_yard = phase_kernels_bwd(dev, paths)
    phase_done("[k2]")
    k3b_errs, k3b_tallies, k3b_gates = phase_k3_bwd(dev, paths)
    phase_done("[k3-bwd]")
    k4_errs, k4_tally, k4_gates = phase_resblock(dev, halves)
    k4_launches = phase_resblock_direct(dev, reference, torch.float32)
    k4_launches_bf16 = phase_resblock_direct(dev, reference, torch.bfloat16)
    phase_done("[k4]")
    int8_tally, qe_int8_tally, int8_serve_tally, int8_cases, int8_errs = phase_int8_kernel(
        dev, int8_calls, int8_calls_emnist, qe_int8_calls)
    phase_done("[int8] kernel")
    conv_tallies, conv_err, conv_rel, conv_gates, conv_held = phase_conv(dev, conv_paths)
    phase_done("[conv]")
    mha_launches = phase_mha_direct(dev, paths)
    phase_model_128(dev, unet128, cls128)
    phase_done("[k5], [model-128]")
    unet128_state, cls128_state = unet128.state_dict(), cls128.state_dict()
    train128_launches = phase_train_128(dev, unet128)
    del unet128, cls128
    torch.cuda.empty_cache()
    phase_done("[train-128]")
    wide_launches = phase_wide_heads(dev, unet128_state)
    phase_done("[wide-heads]")
    phase_model(dev, reference)
    phase_grads(dev, reference)
    phase_grads(dev, emnist, "EMNIST", EMNIST_BATCH)
    del emnist
    phase_done("[model], [grads]")
    state = reference.state_dict()
    del reference
    by_path = {"sampling": phase_slice(dev, state), "mha_attention_direct": mha_launches,
               "resblock_halves_direct": k4_launches,
               "resblock_halves_direct_bf16": k4_launches_bf16,
               "train_openai_128": train128_launches,
               "wide_heads_openai_128": wide_launches}
    phase_done("[slice]")
    win_tallies, win_err, win_rel, win_readings, by_path["winograd_openai_64"] = \
        phase_winograd(dev, state)
    phase_done("[winograd]")
    by_path["sr_chain_openai_256"] = phase_sr(dev, sr256)
    del sr256
    torch.cuda.empty_cache()
    phase_done("[sr]")
    with tempfile.TemporaryDirectory() as workdir:
        by_path["sample_cli_openai_128_guided"] = phase_sample_cli(
            dev, unet128_state, cls128_state, workdir)
        del unet128_state, cls128_state
        torch.cuda.empty_cache()
        phase_done("[guided]")
        by_path["sample_cli_openai_64_fast"] = phase_fast(dev, state, workdir)
        phase_done("[fast]")
        by_path["sample_cli_openai_64_int8"], int8_rates = phase_int8(
            dev, state, workdir, sum(int8_calls.values()))
        phase_done("[int8] entry point")
        by_path.update(phase_train(dev, state, workdir))
        phase_done("[train]")
        by_path["sample_cli_openai_64_upsample"] = phase_esrgan(dev, workdir)
        phase_done("[esrgan]")
        by_path.update(phase_distill(dev, state, workdir))
        phase_done("[distill]")
        serve_paths, serve_readings = phase_serve(dev, state, workdir, smi)
        by_path.update(serve_paths)
        log(f"[serve] readings {json.dumps(serve_readings)}")
        phase_done("[serve]")
        graph_paths, graph_readings = phase_graph(dev, state, smi)
        by_path.update(graph_paths)
        log(f"[graph] readings {json.dumps(graph_readings)}")
        phase_done("[graph]")
        dp_paths, dp_readings = phase_dp(dev, workdir, smi)
        by_path.update(dp_paths)
        log(f"[dp] readings {json.dumps(dp_readings)}")
        phase_done("[dp]")
        tp_paths, tp_readings = phase_tp(dev, workdir, smi, sum(tp_calls.values()))
        by_path.update(tp_paths)
        log(f"[tp] readings {json.dumps(tp_readings)}")
        phase_done("[tp]")
        by_path.update(phase_tools(dev, workdir))
        phase_done("[tools]")
    conv_launched, conv_late, conv_late_err, conv_late_rel = phase_conv_cover(dev, conv_held)
    conv_gates.update(cases_launched=conv_launched, cases_held=len(conv_held) + conv_late,
                      max_rel_err=max(conv_rel, conv_late_rel))
    phase_done("[conv-cover]")

    def entry(name, route, source, replaces, counter, err, err_bf16, tally, basis, others,
              routes=None, **extra):
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                **({"routes_by_dtype": routes} if routes else {}), **extra,
                "launches": sum(path.get(counter, 0) for path in by_path.values()),
                "launches_by_path": {k: path.get(counter, 0) for k, path in by_path.items()},
                "max_abs_err": err, "max_abs_err_bf16": err_bf16,
                # ms, plain_ms, library_ms host-timed; device_* from CUDA-graph
                # replays (the library's backward: torch.profiler),
                # device_profiler_* from torch.profiler
                **tally.fields(), "ms_basis": basis,
                # the same sums over the other paths' calls, in their compute types
                "other_paths": {f"{where}, batch {PATHS[where][0]}, {PATHS[where][1]}":
                                t.fields() for where, t in others.items()}}

    def by_route(kernel):
        """a kernel's launches above head dim 256 on the main paths, by route"""
        return {route: sum(path.get(f"{kernel} {route}", 0) for path in by_path.values())
                for route in ("resident", "walk")}

    forward = "sum over one openai_64 forward's calls, bf16, model batch 16"
    forward_others = ("train", "emnist", *GUIDED_PATHS, "sr256", "serve64", "dp_train",
                      "qe_unet", "qe_cls")
    # K1, K2 and K5: one kernel per input type
    attention_routes = {"bfloat16": "wgmma: tensor cores, cp.async staging; above head dim 256 "
                                    "and N <= 1152 the P-resident route (P or dS of every tile "
                                    "in shared memory, a TMA producer warpgroup, mbarriers), "
                                    "above N = 1152 the walk (the logits per output chunk)",
                        "float32": "FMA: CUDA cores"}
    kernels = [
        entry("fused_qkv_attention", "cuda", "nicediffusion_tpu_torch/csrc/attention.cu",
              "nicediffusion_tpu/ops/pallas/attention.py:177", "attention",
              errs["attention", torch.float32], errs["attention", torch.bfloat16],
              tallies["attention", "forward"], forward,
              {w: tallies["attention", w] for w in (*forward_others, "wide128")},
              attention_routes, launches_by_route_above_256=by_route("K1")),
        entry("fused_qkv_attention_bwd", "cuda", "nicediffusion_tpu_torch/csrc/attention_bwd.cu",
              "nicediffusion_tpu/ops/pallas/attention.py:334", "attention_bwd",
              k2_errs[torch.float32], k2_errs[torch.bfloat16], k2_tallies["train"],
              f"sum over one openai_64 training step's calls, bf16, batch {TRAIN_BATCH}, "
              f"K1's row log-sum-exp handed over",
              {w: k2_tallies[w] for w in ("emnist", "cls128", "unet128", "dp_train",
                                          "qe_unet", "qe_cls", "wide128_train")},
              attention_routes,
              # the same step's sums read by CUDA graph and by torch.profiler
              device_yardsticks=k2_yard, launches_by_route_above_256=by_route("K2")),
        entry("group_norm_fused", "cuda", "nicediffusion_tpu_torch/csrc/groupnorm.cu",
              "nicediffusion_tpu/ops/pallas/groupnorm.py:151", "groupnorm",
              errs["groupnorm", torch.float32], errs["groupnorm", torch.bfloat16],
              tallies["groupnorm", "forward"], forward,
              {w: tallies["groupnorm", w] for w in (*forward_others, "tp")},
              {"bfloat16": "CUDA cores; thread-block clusters, the tile in shared memory",
               "float32": "the same kernel in f32"}, **k3_gates),
        # the backward of K3's custom VJP (a jnp recompute under jax.vjp in the
        # JAX package, a kernel here); max_abs_err is f32, relative to each
        # output's largest element
        entry("group_norm_fused_bwd", "cuda", "nicediffusion_tpu_torch/csrc/groupnorm.cu",
              "nicediffusion_tpu/ops/groupnorm.py:128", "groupnorm_bwd",
              k3b_errs[torch.float32], k3b_errs[torch.bfloat16], k3b_tallies["train"],
              f"sum over one openai_64 training step's GroupNorm backwards, bf16, batch "
              f"{TRAIN_BATCH}, the forward's mean and rstd handed over",
              {w: k3b_tallies[w] for w in ("cls128", "dp_train", "tp_train", "qe_unet",
                                           "qe_cls")},
              {"bfloat16": "CUDA cores; thread-block clusters, x and dy in shared memory",
               "float32": "the same kernel in f32"}, **k3b_gates),
        # no model calls K5: its launches are phase_mha_direct's direct calls
        entry("mha_attention", "cuda", "nicediffusion_tpu_torch/csrc/attention.cu",
              "nicediffusion_tpu/ops/pallas/attention.py:486", "mha",
              errs["mha", torch.float32], errs["mha", torch.bfloat16],
              tallies["mha", "unet128"],
              f"sum over the attention calls of one openai_128 forward, bf16, batch "
              f"{GUIDED_BATCH}, q, k and v as views of the projection",
              {w: tallies["mha", w] for w in ("cls128", "wide128")}, attention_routes,
              launches_by_route_above_256=by_route("K5")),
        # no model calls K4 either: its launches are phase_resblock_direct's calls
        entry("gn_silu_conv3x3", "cuda", "nicediffusion_tpu_torch/csrc/resblock.cu",
              "nicediffusion_tpu/ops/pallas/resblock.py:131", "resblock",
              k4_errs[torch.float32], k4_errs[torch.bfloat16], k4_tally,
              "sum over the residual-block halves of one openai_64 forward that K4 could "
              "stand for, bf16, model batch 16", {},
              {"bfloat16": "wgmma: tensor cores, weights in a cp.async ring",
               "float32": "FMA: CUDA cores"}, **k4_gates),
        # no Pallas kernel in the JAX package: XLA's int8 conv (and dense
        # product) of its static int8 serving path; max_abs_err is of the
        # output against the plain version by input type (the gate: s32 sums
        # and outputs bit-equal)
        entry("int8_conv", "cuda", "nicediffusion_tpu_torch/csrc/int8conv.cu",
              "nicediffusion_tpu/ops/quant.py:87", "int8conv", int8_errs[torch.float32],
              int8_errs[torch.bfloat16], int8_tally,
              f"sum over the {sum(int8_calls.values())} int8 conv calls of one openai_64 int8 "
              f"sampling forward, bf16 in and out, model batch {PATHS['forward'][0]}; the "
              f"library call is the bf16 F.conv2d that int8 serving replaces",
              {"qe_int8": qe_int8_tally, "int8_serve": int8_serve_tally},
              {"bfloat16": "wgmma s8 x s8 -> s32, one launch a call: k = 3 stride 1 on the "
                            "halo route (halo quantized in shared memory, A by ldmatrix from "
                            "it), the rest on the row route (A quantized in shared memory, "
                            "read by descriptor); weights by cp.async, 64-channel steps",
               "float32": "the row route", "int8": "the same routes, x already quantized "
               "(the dynamic path)"},
              bit_equal_cases=int8_cases,
              samples_per_s={f"batch {b}": r for b, r in int8_rates.items()}),
        # no TPU kernel: flax nn.Conv in XLA in the JAX package; the conv of
        # every bf16 forward with grad mode off, in place of cuDNN; bf16
        # only, so max_abs_err is the bf16 one
        entry("conv_nhwc", "cuda", "nicediffusion_tpu_torch/csrc/bf16conv.cu",
              "nicediffusion_tpu/models/unet.py:243", "conv", max(conv_err, conv_late_err),
              max(conv_err, conv_late_err),
              conv_tallies[PATHS["forward"][0]],
              f"sum over the {sum(conv_paths['forward'].values())} convs of one openai_64 "
              f"sampling forward, bf16, model batch {PATHS['forward'][0]}; the library call "
              f"is the bf16 F.conv2d (cuDNN) it replaces",
              {"serve64": conv_tallies[PATHS["serve64"][0]]},
              {"bfloat16": "wgmma bf16 x bf16 -> f32, one launch a call, a fixed order of sums "
                           "(no split K): k = 3 stride 1 on the halo route (32-channel steps, "
                           "then kernel rows, then columns; A by descriptor from the halo), the "
                           "rest on the row route (taps, then 32-channel steps; A by "
                           "descriptor); one wgmma group kept in flight; warp-specialised and "
                           "persistent: a producer warpgroup loads a ring of stages by TMA "
                           "(cp.async where C % 8 or x's alignment allows none) under full "
                           "and empty mbarriers, two consumer warpgroups multiply and store "
                           "by TMA (from registers where F % 8 != 0)"},
              **conv_gates),
        # no Pallas kernel either: the JAX package's Winograd conv is an XLA
        # composition; the conv of DiffusionModel(winograd=True)'s bf16
        # forwards with grad mode off, bf16 only
        entry("winograd_conv_nhwc", "cuda", "nicediffusion_tpu_torch/csrc/winograd.cu",
              "nicediffusion_tpu/ops/winograd.py:63", "winograd", win_err, win_err,
              win_tallies[WINOGRAD_BATCHES[0]],
              f"sum over the {win_readings['convs_per_forward']} Winograd convs of one "
              f"openai_64 winograd=True sampling forward, bf16, model batch "
              f"{WINOGRAD_BATCHES[0]}, U made beforehand; the library call is cuDNN's bf16 "
              f"F.conv2d of the same conv",
              {"serve64": win_tallies[WINOGRAD_BATCHES[1]]},
              {"bfloat16": "wgmma bf16 x bf16 -> f32, one launch a call: a cluster of four "
                           "blocks owns 64 Winograd tiles x 128 (or 64) filters, block r the "
                           "4 positions of row r of V, two m64n128 accumulators a consumer "
                           "warpgroup; two producer warpgroups (alternate 32-channel steps) "
                           "make V from pixel rows loaded by TMA, U by TMA, under full, empty "
                           "and raw mbarriers; M traded through distributed shared memory, "
                           "A^T M A in the block that stores the tile; a fixed order of sums, "
                           "no split K"},
              max_rel_err=win_rel, **win_readings),
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was never launched on the main paths")
    # rule 2: the kernel slowest against its library call first, in device
    # time read by torch.profiler on both sides (every row has it); the CUDA
    # graph's factor beside it (K2's library backward, which a graph cannot
    # hold, by the profiler there too)
    def factor(k):
        return k["device_profiler_ms"] / k["device_profiler_library_ms"]

    for k in sorted(kernels, key=lambda k: -factor(k)):
        log(f"[rank] {k['name']}: {factor(k):.2f}x its library call in device time, both by "
            f"torch.profiler: {k['device_profiler_ms']:.4f} against "
            f"{k['device_profiler_library_ms']:.4f} ms "
            f"({k['device_ms'] / k['device_library_ms']:.2f}x by CUDA graph: "
            f"{k['device_ms']:.4f} against {k['device_library_ms']:.4f} ms) "
            f"({k['ms_basis']}); host-timed {k['ms']:.4f} against {k['library_ms']:.4f} ms")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
