"""Command-line interface: argparser and argument routing.

Copy of nicediffusion_tpu/utils/cli.py (argparse only), with the training
parser's ``--device`` flag added and the sampling parser's help text naming
the card. Flag-for-flag mirror of the reference CLI (reference utils.py:12-143
`make_argparser` and utils.py:146-214 `get_dicts_from_args`): one parser
shared by the sampling and training programs, four argument groups, default
preset dispatch by model-path substring, '/'-separated list parsing, and the
out_channels / num_classes derivation rules (via utils/config.py).

`build_diffusion` is the port's own: the model, its weights and the
`Diffusion` that the sampling and serving entry points both build from the
parsed flags.
"""

from __future__ import annotations

import argparse
import os

from .config import apply_derivations, preset_for_path

__all__ = ["make_argparser", "get_dicts_from_args", "cli_device", "compute_dtype",
           "freeze_from_args", "build_diffusion"]


def make_argparser(prog: str) -> argparse.ArgumentParser:
    """Build the parser for 'diff_sample' or 'diff_train'
    (reference utils.py:12-143)."""
    if prog == "diff_sample":
        description = "Sample images generated from Diffusion Model."
        is_sample = True
    elif prog == "diff_train":
        description = "Train Diffusion Model."
        is_sample = False
    else:
        raise NotImplementedError(prog)
    o, r = "(optional)", "(required)"
    parser = argparse.ArgumentParser(prog=prog, description=description)

    if is_sample:
        g = parser.add_argument_group(
            "sampling arguments", "arguments for sampling process"
        )
        g.add_argument("--model_path", type=str, required=True, metavar=r,
                       help="relative file path of model state dict")
        g.add_argument("-c", "--custom", action="store_true", default=False,
                       help="whether to use a custom model/diffusion configuration")
        g.add_argument("--batch_size", type=int, required=True, metavar=r,
                       help="number of images per batch")
        g.add_argument("--num_samples", type=int, required=True, metavar=r,
                       help="number of batches to sample. total images is "
                            "num_samples * batch_size")
        g.add_argument("--upsample", action="store_true", default=False,
                       help="add to use Real-ESRGAN 4x superresolution")
        g.add_argument("--wordy", "-w", dest="wordy", action="store_true",
                       default=False, help="add this to print status")
        g.add_argument("--save_path", type=str, default=None, metavar=o,
                       help="relative file path to save generated images; "
                            "if not provided they are displayed instead")
        g.add_argument("--labels", type=str, default="", metavar=o,
                       help="'/'-separated labels split among samples")
        g.add_argument("--start_img", type=str, default=None, metavar=o,
                       help="image to start denoising with")
        g.add_argument("--steps_to_do", type=int, default=None, metavar=o,
                       help="number of original-chain noise steps to apply to "
                            "start_img then remove by denoising")
        g.add_argument("--seed", type=int, default=None, metavar=o,
                       help="rng seed for reproducibility")
        g.add_argument("--cpu", action="store_true", default=False,
                       help="force CPU instead of the CUDA card")
        g.add_argument("--encoder_cache", type=int, default=None, metavar=o,
                       help="reuse UNet encoder features for k-1 of every k "
                            "steps ('Faster Diffusion'; opt-in, slightly "
                            "lossy)")
        g.add_argument("--guidance_interval", type=float, nargs=2,
                       default=None, metavar=("LO", "HI"),
                       help="restrict classifier-free guidance to the chain "
                            "fraction [LO, HI) (0=clean end, 1=noise end); "
                            "steps outside run one conditional forward "
                            "instead of the doubled CFG batch (opt-in, "
                            "lossy; arXiv:2404.07724)")
        g.add_argument("--dtype", type=str, default="auto", metavar=o,
                       choices=("auto", "bfloat16", "float32", "int8"),
                       help="model compute dtype: 'auto' picks bfloat16 on "
                            "the card and float32 on "
                            "CPU/--cpu (parity with the fp32 reference); "
                            "'int8' enables the quantized conv serving path "
                            "(fastest, slightly lossy)")
        g.add_argument("--int8_calibration", type=str, default=None,
                       metavar=o,
                       help="with --dtype int8: .npz path for the "
                            "activation-scale calibration. Loaded if it "
                            "exists (skips the calibration chain); written "
                            "after calibrating otherwise")
    else:
        g = parser.add_argument_group(
            "training arguments", "arguments for training process"
        )
        g.add_argument("--batch_size", type=int, required=True, metavar=r)
        g.add_argument("--lr", type=float, required=True, metavar=r)
        g.add_argument("--weight_decay", type=float, required=True, metavar=r)
        g.add_argument("--iterations", type=int, required=True, metavar=r)
        g.add_argument("--resume_step",
                       type=lambda s: s if s == "auto" else int(s),
                       default=None, metavar=o,
                       help="checkpoint step to resume from (0 is a valid "
                            "step; omit for a fresh run; 'auto' picks the "
                            "newest checkpoint)")
        g.add_argument("--wordy", "-w", dest="wordy", action="store_true",
                       default=False)
        g.add_argument("--save_every", type=int, default=None, metavar=o)
        g.add_argument("--sample_every", type=int, default=None, metavar=o)
        g.add_argument("--ema_rate", type=float, default=0.9999, metavar=o)
        g.add_argument("--use_fp16", action="store_true", default=False,
                       help="train with bfloat16 compute and float32 "
                            "parameters (the reference parsed this flag but "
                            "never consumed it, utils.py:83-84)")
        g.add_argument("--grad_accumulation", type=int, default=1, metavar=o)
        g.add_argument("--seed", type=int, default=None, metavar=o)
        g.add_argument("--device", type=str, default=None, metavar=o,
                       help="torch device to train on; default: the CUDA "
                            "card (an error where there is none). 'cpu' "
                            "has to be asked for")

    m = parser.add_argument_group(
        "model arguments", "arguments to create DiffusionModel"
    )
    req = not is_sample
    mv = r if req else o
    m.add_argument("--resolution", type=int, required=req, metavar=mv, default=None)
    m.add_argument("--model_channels", type=int, required=req, metavar=mv, default=None)
    m.add_argument("--channel_mult", type=str, required=req, metavar=mv, default=None,
                   help="'/'-separated channel multipliers")
    m.add_argument("--num_res_blocks", type=int, required=req, metavar=mv, default=None)
    m.add_argument("--attention_resolutions", type=str, required=req, metavar=mv,
                   default=None, help="'/'-separated resolutions")
    m.add_argument("--num_classes", type=int, default=None, metavar=o)
    m.add_argument("--dropout", type=float, required=req, default=0.0, metavar=mv)
    m.add_argument("--in_channels", type=int, default=3, metavar=o)
    m.add_argument("--num_heads", type=int, default=4, metavar=o)
    m.add_argument("--num_head_channels", type=int, default=None, metavar=o)
    m.add_argument("--split_qkv_first", action="store_true", default=False)
    m.add_argument("--resblock_updown", action="store_true", default=False)
    m.add_argument("--use_adaptive_gn", action="store_true", default=False)

    d = parser.add_argument_group(
        "diffusion arguments", "arguments for the diffusion/denoising process"
    )
    d.add_argument("--rescaled_num_steps", type=int, required=req, metavar=mv,
                   default=None)
    d.add_argument("--beta_schedule", type=str, required=req, metavar=mv,
                   default=None, help="'linear', 'cosine', or 'constant'")
    d.add_argument("--sampling_var_type", type=str, required=req, metavar=mv,
                   default=None,
                   help="'small', 'large', 'learned', or 'learned_interpolation'")
    d.add_argument("--use_ddim", action="store_true", default=False)
    d.add_argument("--sampler", type=str, default=None, metavar=o,
                   choices=("ddpm", "ddim", "dpm++"),
                   help="sampler override: 'ddpm', 'ddim', or 'dpm++' "
                        "(DPM-Solver++(2M), 2nd-order multistep — same "
                        "per-step cost as ddim but needs ~2-4x fewer steps; "
                        "combine with --rescaled_num_steps to cash in the "
                        "speedup). Default: ddim if --use_ddim else ddpm")
    d.add_argument("--ddim_eta", type=float, default=0.0, metavar=o)
    d.add_argument("--respacing", type=str, default=None, metavar=o,
                   choices=("even", "karras"),
                   help="timestep-grid placement: 'even' (reference eq.-19 "
                        "stride, default) or 'karras' (rho-grid in sigma "
                        "space — better few-step sampling)")
    d.add_argument("--prediction_type", type=str, default="eps", metavar=o,
                   choices=("eps", "v"),
                   help="model output convention: 'eps' (noise, the "
                        "reference's) or 'v' (v = alpha*eps - sigma*x0 — "
                        "stable for few-step/distilled models)")
    d.add_argument("--timestep_indices", type=str, default=None, metavar=o,
                   help="'/'-separated original-chain timestep indices to "
                        "sample on (overrides --rescaled_num_steps/"
                        "--respacing; printed by scripts/distill.py for "
                        "faithful sampling of distilled students)")
    d.add_argument("--dynamic_thresholding", type=float, default=None,
                   metavar=o, nargs="?", const=0.995,
                   help="Imagen-style dynamic thresholding of pred_x0 at "
                        "this percentile (default 0.995 when given without "
                        "a value); replaces the hard [-1,1] clamp")
    d.add_argument("--original_num_steps", type=int, default=1000, metavar=o)
    d.add_argument("--loss_type", type=str, required=req, default="hybrid",
                   metavar=o if is_sample else r,
                   help="'simple', 'KL', 'KL_rescaled', or 'hybrid'")
    d.add_argument("--guidance_method", type=str, default=None, metavar=o,
                   help="'classifier', 'classifier_free', or 'none' "
                        "(explicitly disable the preset's guidance — "
                        "required when sampling guided-distilled "
                        "checkpoints, whose weights already bake CFG in)")
    d.add_argument("--guidance_strength", type=float, default=None, metavar=o)
    d.add_argument("--classifier_path", type=str, default=None, metavar=o)
    return parser


_MODEL_KEYS = [
    "resolution", "attention_resolutions", "channel_mult", "num_res_blocks",
    "model_channels", "num_heads", "num_head_channels", "in_channels",
    "out_channels", "split_qkv_first", "dropout", "resblock_updown",
    "use_adaptive_gn", "num_classes",
]
_DIFF_KEYS = [
    "rescaled_num_steps", "original_num_steps", "use_ddim", "sampler",
    "respacing", "timestep_indices", "prediction_type", "ddim_eta",
    "beta_schedule", "sampling_var_type", "classifier", "guidance_method",
    "guidance_strength", "loss_type",
]


def get_dicts_from_args(args) -> tuple[dict, dict, dict]:
    """Route parsed args into (other, model, diffusion) dicts and apply the
    preset dispatch + derivation rules (reference utils.py:146-214)."""
    args = vars(args)
    model_args, diff_args, other_args = {}, {}, {}
    for key, val in args.items():
        if key in _MODEL_KEYS:
            model_args[key] = val
        elif key in _DIFF_KEYS:
            diff_args[key] = val
        else:
            other_args[key] = val

    if diff_args.get("respacing") is None:
        diff_args["respacing"] = "even"
    if diff_args.get("timestep_indices") is not None:
        diff_args["timestep_indices"] = [
            int(i) for i in str(diff_args["timestep_indices"]).split("/")
        ]
    # user-explicit guidance_method ('none' disables) must survive preset
    # dispatch: guided-distilled checkpoints bake CFG into the weights, so
    # the preset's classifier_free would silently double-guide them
    # (scripts/distill.py prints the '--guidance_method none' hint)
    user_gm = diff_args.get("guidance_method")
    if user_gm == "none":
        diff_args["guidance_method"] = None
    # --dynamic_thresholding <p> -> clip_x='dynamic' (capability extension)
    dyn = other_args.pop("dynamic_thresholding", None)
    if dyn is not None:
        diff_args["clip_x"] = "dynamic"
        diff_args["dynamic_threshold"] = dyn

    assert (
        diff_args["guidance_method"] is None
        or model_args["num_classes"] is not None
    ), "use guidance only for conditional models"
    assert (diff_args["guidance_method"] == "classifier") == (
        other_args.get("classifier_path") is not None
    )
    # Deliberate capability extension over the reference: utils.py:168-172
    # raises NotImplementedError for --classifier_path; here the sampling
    # script loads a guided-diffusion EncoderUNet classifier
    # (models/classifier.py) and wires it into the guidance hook.

    if "custom" in other_args:  # sampling mode
        if other_args["custom"]:
            required = [
                model_args["resolution"], model_args["model_channels"],
                model_args["channel_mult"], model_args["num_res_blocks"],
                model_args["attention_resolutions"],
                diff_args["rescaled_num_steps"],
                diff_args["sampling_var_type"], diff_args["beta_schedule"],
            ]
            if not all(required):
                raise ValueError(
                    "if the model is custom, all configuration flags must be "
                    "specified"
                )
        else:
            user_strength = diff_args.get("guidance_strength")
            # user-explicit step count survives preset dispatch (the presets
            # pin 25; fast samplers like --sampler dpm++ want fewer — no
            # reference precedent: it ignores all flags in preset mode)
            user_steps = diff_args.get("rescaled_num_steps")
            # user-explicit class count survives preset dispatch: the
            # reference's own trainer adds the CFG null class (28) while
            # its EMNIST preset says 27 (README 'Deliberate divergences'
            # #5) — checkpoints trained that way need --num_classes 28
            user_ncls = model_args.get("num_classes")
            m, d = preset_for_path(other_args["model_path"])
            model_args.update(m)
            diff_args.update(d)
            if user_steps is not None:
                diff_args["rescaled_num_steps"] = user_steps
            if user_ncls is not None:
                model_args["num_classes"] = user_ncls
            if user_gm is not None:
                diff_args["guidance_method"] = (
                    None if user_gm == "none" else user_gm
                )
                if user_strength is not None:
                    diff_args["guidance_strength"] = user_strength
            # classifier guidance must survive preset dispatch (the presets
            # carry their own guidance_method, which would silently disable
            # the user's --classifier_path; no reference precedent — it
            # raises before reaching here)
            if other_args.get("classifier_path") is not None:
                diff_args["guidance_method"] = "classifier"
                if user_strength is not None:
                    diff_args["guidance_strength"] = user_strength
            if other_args.get("labels"):
                other_args["labels"] = [
                    int(i) for i in other_args["labels"].split("/")
                ]
            return other_args, model_args, diff_args

    if other_args.get("labels"):
        other_args["labels"] = [int(i) for i in other_args["labels"].split("/")]

    apply_derivations(model_args, diff_args)
    return other_args, model_args, diff_args


def cli_device(cpu: bool):
    """``--cpu`` -> the CPU; otherwise the CUDA card, raising RuntimeError
    where there is none."""
    import torch

    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "sampling runs on the CUDA card and torch.cuda.is_available() is "
            "False; pass --cpu to run on the CPU"
        )
    return torch.device("cuda")


def compute_dtype(dtype_flag: str, device):
    """``--dtype`` -> (compute dtype, quantized): ``auto`` is bfloat16 on the
    card and float32 on the CPU; ``int8`` quantizes the convs and computes in
    bfloat16 elsewhere (as the JAX CLI). float32 on the card turns TF32 off
    in cuDNN and cuBLAS, as the kernels' f32 paths use none."""
    import torch

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
    return dtype, quantized


def freeze_from_args(diffusion, calib_path: str | None, batch_size: int, seed: int,
                     wordy: bool) -> None:
    """Freeze the quantized model of ``diffusion`` for static int8: load the
    calibration at ``calib_path`` if the file exists, otherwise draw one
    chain of min(batch_size, 8) through the dynamic path from a generator of
    its own (seed + 1), record it, and save it at ``calib_path`` if given.
    In a data-parallel group every rank looks for the file before any writes
    it, draws the same calibration where it is missing, and rank 0 saves it."""
    import torch

    from ..ops.quant import calibration_inputs, collect_calibration, freeze_int8
    from ..parallel.mesh import barrier, rank
    from .checkpoint import load_calibration, save_calibration

    model, device = diffusion.model, diffusion.device
    found = bool(calib_path) and os.path.exists(calib_path)
    barrier()  # every rank has looked before rank 0 may write
    if found:
        if wordy:
            print(f"Loading int8 calibration from {calib_path}")
        calib = load_calibration(calib_path, device)
    else:
        calib_gen = torch.Generator(device=device).manual_seed(seed + 1)
        calib_batch = min(batch_size, 8)
        calib_y = (
            torch.randint(0, model.num_classes, (calib_batch,),
                          generator=calib_gen, device=device)
            if model.conditional else None
        )
        if wordy:
            print("Calibrating int8 activation scales on one chain...")
        inputs = calibration_inputs(diffusion, calib_gen, y=calib_y, batch_size=calib_batch)
        calib = collect_calibration(model, inputs)
        if calib_path and rank() == 0:
            save_calibration(calib, calib_path)
            if wordy:
                print(f"Saved int8 calibration to {calib_path}")
    freeze_int8(model, calib)


def build_diffusion(other_args: dict, model_args: dict, diff_args: dict, batch_size: int,
                    classifier: bool = True):
    """The `Diffusion` that the parsed flags describe: on the card unless
    ``--cpu``, in the ``--dtype`` compute type, the model loaded strictly
    from ``--model_path``, with the ``--classifier_path`` classifier if
    ``classifier`` and one is given, and under ``--dtype int8`` frozen from
    ``--int8_calibration`` (`freeze_from_args`, ``batch_size`` bounding the
    calibration draw)."""
    from ..diffusion.process import Diffusion
    from ..models.classifier import EncoderUNet
    from ..models.unet import DiffusionModel
    from .checkpoint import load_state_dict
    from .config import classifier_preset_for_path

    device = cli_device(other_args["cpu"])
    seed = other_args["seed"] if other_args["seed"] is not None else 0
    wordy = other_args["wordy"]
    dtype, quantized = compute_dtype(other_args["dtype"], device)
    if wordy:
        print(f"Computing in {'int8/' if quantized else ''}"
              f"{str(dtype).removeprefix('torch.')} on {device}")

    def count(module):
        return sum(p.numel() for p in module.parameters())

    model = DiffusionModel(**model_args, dtype=dtype, quantized=quantized, device=device).eval()
    model.load_state_dict(load_state_dict(other_args["model_path"], device), strict=True)

    # noisy-classifier guidance: a guided-diffusion EncoderUNet whose
    # grad log p(y | x_t) steers the sampler
    diff_args = dict(diff_args)
    if classifier and other_args.get("classifier_path"):
        cls_path = other_args["classifier_path"]
        cls = EncoderUNet(**classifier_preset_for_path(cls_path), dtype=dtype, device=device)
        cls.load_state_dict(load_state_dict(cls_path, device), strict=True)
        diff_args["classifier"] = cls
        if wordy:
            print(f"Classifier made from {cls_path} with {count(cls)} parameters! :)")
    if wordy:
        print(f"Model made from {other_args['model_path']} with {count(model)} parameters! :)")

    diffusion = Diffusion(model=model, **diff_args)
    if quantized:
        freeze_from_args(diffusion, other_args["int8_calibration"], batch_size, seed, wordy)
    return diffusion
