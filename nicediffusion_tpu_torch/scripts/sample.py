"""Sampling CLI, the main user entry point (torch, one device).

Counterpart of scripts/sample.py of the JAX package: the same flags
(utils/cli.py), default-preset dispatch by model-path substring, ``--custom``
configurations, start-image partial denoising, label handling, grayscale
inversion, display or per-class-counter save naming, and classifier guidance
from a guided-diffusion noisy classifier (``--classifier_path``). It samples
on the CUDA card unless ``--cpu`` is given, and raises where there is no
card. Checkpoints are torch ``.pt`` state dicts (raw OpenAI or converted
names) or the JAX package's ``.npz``.

``--dtype auto`` computes in bfloat16 on the card and float32 under
``--cpu``; ``--dtype float32`` on the card also turns TF32 off in cuDNN and
cuBLAS, as the hand-written kernels' f32 paths use none. One
``torch.Generator`` on the device, seeded from ``--seed``, feeds each
sample's start noise, its random labels and its chain, in that order.

Fast sampling: ``--sampler dpm++`` (with fewer ``--rescaled_num_steps``),
``--prediction_type v``, ``--dynamic_thresholding [p]``, ``--encoder_cache k``
and ``--guidance_interval LO HI`` go through to ``Diffusion`` and its
``denoise``.

Static int8 serving: ``--dtype int8`` builds the model quantized (int8
convs through the int8 conv kernel, bfloat16 elsewhere) and, before the
first sample, calibrates it: one chain of ``min(batch_size, 8)`` images drawn
through the unfrozen model (the dynamic int8 path), q-sampled back to six
points of the chain, the running max |x| of every int8 layer's input
recorded over float forwards of those, then frozen. The calibration draw
takes its random numbers from a generator of its own (seeded from
``--seed`` + 1), so the samples are the same whether the calibration was
drawn or loaded. ``--int8_calibration f.npz`` saves that calibration (the
JAX package's 'calib' tree, which either package reads), or, if the file
exists, loads and freezes it without drawing.

``--upsample`` sends every batch through the Real-ESRGAN 4x stage
(models/rrdb.py) on the same device, reading ``models/RealESRGAN_x4plus.pth``
under the working directory; without that file it prints the JAX script's
"Skipping --upsample" message and keeps the samples as they are.

``--data_parallel`` raises NotImplementedError naming its ROADMAP entry
("Multi-GPU") before any model is built.

Usage:
  python -m nicediffusion_tpu_torch.scripts.sample --model_path 64x64_diffusion.pt \\
      --batch_size 8 --num_samples 2 [--labels 3/7] [--save_path out/] [-w] \\
      [--classifier_path 64x64_classifier.pt --guidance_strength 1.0] \\
      [--sampler dpm++ --rescaled_num_steps 20 --dynamic_thresholding 0.995 \\
       --encoder_cache 3 --guidance_interval 0.0 0.6] \\
      [--dtype int8 --int8_calibration calib.npz] [--upsample]
"""

from __future__ import annotations

import os
import sys


def _refuse_unported(args) -> None:
    """Raise for the flag whose feature waits in ROADMAP queue A."""
    if args.data_parallel:
        raise NotImplementedError(
            '--data_parallel is not ported yet (ROADMAP queue A, "Multi-GPU")'
        )


def main(argv: list[str] | None = None):
    """Parse ``argv`` (default: the command line), sample, save or display,
    and return the samples as a list of (shown input, output, labels) uint8
    numpy batches, one per ``--num_samples``."""
    import numpy as np
    import torch

    from ..diffusion.process import Diffusion
    from ..models.classifier import EncoderUNet
    from ..models.unet import DiffusionModel
    from ..ops.quant import calibration_inputs, collect_calibration, freeze_int8
    from ..utils.checkpoint import load_calibration, load_state_dict, save_calibration
    from ..utils.cli import get_dicts_from_args, make_argparser
    from ..utils.config import classifier_preset_for_path
    from ..utils.image import grayscale_to_rgb, load_start_image, save_image, to_uint8

    # argv re-split (reference sample.py:18-21 accepts space-joined args)
    chunks = sys.argv[1:] if argv is None else argv
    argv = []
    for chunk in chunks:
        argv.extend(chunk.split(" ")) if " " in chunk else argv.append(chunk)

    parser = make_argparser("diff_sample")
    parser.add_argument(
        "--data_parallel", action="store_true", default=False,
        help="shard each batch over all local CUDA cards (batch_size must "
             "divide by the card count)",
    )
    args = parser.parse_args(argv)
    _refuse_unported(args)
    other_args, model_args, diff_args = get_dicts_from_args(args)

    if other_args["cpu"]:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        raise RuntimeError(
            "sampling runs on the CUDA card and torch.cuda.is_available() is "
            "False; pass --cpu to run on the CPU"
        )
    seed = other_args["seed"] if other_args["seed"] is not None else 0
    generator = torch.Generator(device=device).manual_seed(seed)
    wordy = other_args["wordy"]
    num_samples, batch_size = other_args["num_samples"], other_args["batch_size"]
    labels_arg, save_path = other_args["labels"], other_args["save_path"]
    conditional = model_args["num_classes"] is not None
    resolution, in_channels = model_args["resolution"], model_args["in_channels"]

    # int8: the quantized convs, bfloat16 elsewhere (as the JAX CLI)
    dtype_flag = other_args["dtype"]
    quantized = dtype_flag == "int8"
    if dtype_flag == "auto":
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    elif quantized:
        dtype = torch.bfloat16
    else:
        dtype = getattr(torch, dtype_flag)
    if dtype == torch.float32 and device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if wordy:
        print(f"Computing in {'int8/' if quantized else ''}"
              f"{str(dtype).removeprefix('torch.')} on {device}")

    def count(module):
        return sum(p.numel() for p in module.parameters())

    model = DiffusionModel(**model_args, dtype=dtype, quantized=quantized, device=device).eval()
    model.load_state_dict(load_state_dict(other_args["model_path"], device), strict=True)

    # noisy-classifier guidance: a guided-diffusion EncoderUNet whose
    # grad log p(y | x_t) steers the sampler
    if other_args["classifier_path"]:
        cls_path = other_args["classifier_path"]
        classifier = EncoderUNet(
            **classifier_preset_for_path(cls_path), dtype=dtype, device=device
        )
        classifier.load_state_dict(load_state_dict(cls_path, device), strict=True)
        diff_args["classifier"] = classifier
        if wordy:
            print(f"Classifier made from {cls_path} with {count(classifier)} parameters! :)")

    if wordy:
        print(f"Model made from {other_args['model_path']} with {count(model)} parameters! :)")
        print(f"Starting Diffusion! There are {num_samples} samples of "
              f"{batch_size} images each")

    diffusion = Diffusion(model=model, **diff_args)

    if quantized:
        calib_path = other_args["int8_calibration"]
        if calib_path and os.path.exists(calib_path):
            if wordy:
                print(f"Loading int8 calibration from {calib_path}")
            calib = load_calibration(calib_path, device)
        else:
            calib_gen = torch.Generator(device=device).manual_seed(seed + 1)
            calib_batch = min(batch_size, 8)
            calib_y = (
                torch.randint(0, model_args["num_classes"], (calib_batch,),
                              generator=calib_gen, device=device)
                if conditional else None
            )
            if wordy:
                print("Calibrating int8 activation scales on one chain...")
            inputs = calibration_inputs(diffusion, calib_gen, y=calib_y, batch_size=calib_batch)
            calib = collect_calibration(model, inputs)
            if calib_path:
                save_calibration(calib, calib_path)
                if wordy:
                    print(f"Saved int8 calibration to {calib_path}")
        freeze_int8(model, calib)

    start_batch = None
    if other_args["start_img"] is not None and other_args["steps_to_do"] is not None:
        img = load_start_image(other_args["start_img"], resolution)
        if in_channels == 1:
            img = img.mean(axis=-1, keepdims=True)
        start_batch = torch.from_numpy(
            np.repeat(img[None], batch_size, axis=0).astype(np.float32)
        ).to(device)

    if conditional and labels_arg:
        assert len(labels_arg) == num_samples, (
            f"please provide NUM_SAMPLES={num_samples} labels"
        )

    samples = []
    for i_sample in range(num_samples):
        if start_batch is None:
            data = torch.randn(
                (batch_size, resolution, resolution, in_channels),
                generator=generator, dtype=torch.float32, device=device,
            )
            # the actual chain length: the requested count can differ
            # (eq.-19 rounding, karras dedup, --timestep_indices)
            steps = diffusion.rescaled_num_steps
            denoise_input = data
        else:
            # original-chain steps -> rescaled steps (reference sample.py:77),
            # on the actual chain length
            steps = (other_args["steps_to_do"] * diffusion.rescaled_num_steps
                     // diffusion.original_num_steps)
            denoise_input = diffusion.diffuse(
                start_batch, generator=generator, steps_to_do=steps
            )
            data = denoise_input

        if not conditional:
            labels = None
        elif not labels_arg:
            labels = torch.randint(
                0, model_args["num_classes"], (batch_size,),
                generator=generator, device=device,
            )
        else:
            labels = torch.full(
                (batch_size,), labels_arg[i_sample], dtype=torch.long, device=device
            )

        if wordy:
            print(f"Denoising sample {i_sample + 1}! :)")
        out = diffusion.denoise(
            generator, x=denoise_input, y=labels,
            start_step=steps if start_batch is not None else None,
            steps_to_do=steps,
            encoder_cache=other_args["encoder_cache"],
            guidance_interval=(
                tuple(gi) if (gi := other_args["guidance_interval"]) is not None else None
            ),
        )

        out = to_uint8(out.cpu().numpy())
        shown_input = to_uint8(
            (start_batch if start_batch is not None else data).cpu().numpy()
        )
        if in_channels == 1:
            out = grayscale_to_rgb(out)
            shown_input = grayscale_to_rgb(shown_input)
        samples.append(
            (shown_input, out, labels.cpu().numpy() if labels is not None else None)
        )

    if wordy:
        what = "Displaying" if save_path is None else f"Saving to '{save_path}'"
        print(f"{what} {num_samples * batch_size} generated images!")

    if other_args["upsample"]:
        from ..models.rrdb import esrgan_upsample_batches

        if wordy:
            r4 = resolution * 4
            print(f"Upsampling to {r4}x{r4} resolution!")
        try:
            samples = esrgan_upsample_batches(samples, device=device)
        except FileNotFoundError as e:
            print(
                f"Skipping --upsample: Real-ESRGAN weights not found ({e}).\n"
                "Download RealESRGAN_x4plus.pth into models/ to enable it."
            )

    if save_path is None:  # display
        import matplotlib.pyplot as plt

        for data, out, labels in samples:
            for b in range(batch_size):
                plt.close("all")
                fig = plt.figure(figsize=(7, 3))
                fig.add_subplot(1, 2, 1)
                plt.imshow(data[b])
                plt.title("Denoising Input")
                fig.add_subplot(1, 2, 2)
                plt.imshow(out[b])
                plt.title(
                    f"Output Image, Label={labels[b]}"
                    if labels is not None else "Output Image"
                )
                plt.pause(0.001)
                plt.waitforbuttonpress()
    else:  # save with per-class counters (reference sample.py:161-180)
        counts = np.zeros((model_args["num_classes"],), dtype=int) if conditional else 0
        for _, out, labels in samples:
            if in_channels == 1:
                out = 255 - out[..., :1]  # back to 1-channel
            for b in range(batch_size):
                if labels is not None:
                    label = int(labels[b])
                    filename = f"{label}_sample{counts[label]}.jpg"
                    counts[label] += 1
                else:
                    filename = f"sample{counts}.jpg"
                    counts += 1
                save_image(out[b], save_path + filename)

    if wordy:
        print("Done! have a nice day")
    return samples


if __name__ == "__main__":
    main()
