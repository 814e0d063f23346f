"""One-command verification of a real torch checkpoint against the port.

Counterpart of the JAX package's tools/verify_checkpoint.py, with its six
checks, its ``[PASS]`` / ``[FAIL]`` / ``[SKIP]`` lines and its exit code (0
iff every executed check passes):

  1. torch load (``weights_only``, a ``state_dict`` wrapper unwrapped) and a
     key census;
  2. preset dispatch by path substring (or ``--preset``), as the sampling
     entry point does;
  3. conversion of raw OpenAI names (utils/convert.py
     ``rename_guided_diffusion_keys``) and a structural match against the
     port module's own ``state_dict()``: missing, unexpected and mismatched
     tensors (``DiffusionModel``, or ``EncoderUNet`` under ``--classifier``);
  4. the parameter count against the preset's published count;
  5. forward parity against the original PyTorch reference at a fixed
     (x, t, y), tolerance 1e-3, when its package (``nicediffusion``) can be
     imported, from ``--reference_path`` or the import path; skipped
     otherwise, and for a classifier (the reference has none);
  6. a 2-step smoke sample through the port's ``Diffusion`` (diffusion
     checkpoints only).

It runs in float32 on the CUDA card (TF32 off), or on the CPU with
``--cpu``; without ``--cpu`` and without a card it raises. (The JAX tool
always runs on the CPU.) ``--reference_path`` has no default here.

Usage:
  python -m nicediffusion_tpu_torch.tools.verify_checkpoint --pt <file.pt> \\
      [--preset auto] [--classifier] [--reference_path DIR] [--skip-sample] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

PUBLISHED_PARAM_COUNTS = {
    # the original reference's default_args presets, verified by instantiation
    "EMNIST": 17_989_442,
    "openai_64": 295_904_454,
    "openai_128": 421_529_606,
    "openai_256": 553_838_086,
}
FORWARD_TOL = 1e-3


class Report:
    def __init__(self):
        self.failures = 0

    def check(self, name: str, ok: bool, detail: str = ""):
        status = "PASS" if ok else "FAIL"
        if not ok:
            self.failures += 1
        print(f"[{status}] {name}" + (f": {detail}" if detail else ""))

    def skip(self, name: str, why: str):
        print(f"[SKIP] {name}: {why}")


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="nicediffusion_tpu_torch.tools.verify_checkpoint",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pt", required=True, help="torch checkpoint to verify")
    ap.add_argument("--preset", default="auto",
                    help="auto | EMNIST | openai_64 | openai_128 | openai_256")
    ap.add_argument("--classifier", action="store_true",
                    help="the checkpoint is a guided-diffusion classifier")
    ap.add_argument("--reference_path", default=None,
                    help="directory holding the PyTorch reference package "
                         "(nicediffusion) for forward parity")
    ap.add_argument("--skip-sample", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    return ap


def structural_diff(expected: dict, got: dict) -> tuple[bool, str]:
    """(match?, detail) of two ``{name: shape}`` maps, in the JAX tool's
    words."""
    missing = sorted(set(expected) - set(got))
    unexpected = sorted(set(got) - set(expected))
    mismatched = sorted(k for k in set(expected) & set(got) if expected[k] != got[k])
    detail = []
    if missing:
        detail.append(f"missing {len(missing)} (e.g. {missing[:3]})")
    if unexpected:
        detail.append(f"unexpected {len(unexpected)} (e.g. {unexpected[:3]})")
    if mismatched:
        detail.append(
            f"mismatched {len(mismatched)} (e.g. "
            + ", ".join(f"{k}: ckpt{got[k]} vs model{expected[k]}" for k in mismatched[:3])
            + ")"
        )
    ok = not (missing or unexpected or mismatched)
    return ok, "; ".join(detail) or f"{len(expected)} leaves"


def parity_inputs(model_args: dict):
    """The fixed (x NCHW f32, t int64, y int64 or None) of step 5, from
    ``np.random.default_rng(0)`` as the JAX tool draws them."""
    res, in_ch = model_args["resolution"], model_args["in_channels"]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, in_ch, res, res)).astype(np.float32)
    t = np.array([7, 500], dtype=np.int64)
    y = np.array([1, 2], dtype=np.int64) if model_args.get("num_classes") is not None else None
    return x, t, y


def port_forward(model, x, t, y) -> np.ndarray:
    """The port model's output at step 5's inputs, NCHW f32 numpy."""
    import torch

    dev = next(model.parameters()).device
    with torch.inference_mode():
        out = model(torch.from_numpy(x).permute(0, 2, 3, 1).to(dev),
                    torch.from_numpy(t).to(dev),
                    torch.from_numpy(y).to(dev) if y is not None else None)
    return out.float().permute(0, 3, 1, 2).cpu().numpy()


def _reference_forward(model_args, sd, reference_path, x, t, y):
    """The original reference model's output at (x, t, y), or the
    ImportError when its package cannot be imported."""
    import torch

    if reference_path and os.path.isdir(reference_path) and reference_path not in sys.path:
        sys.path.insert(0, reference_path)
    try:
        from nicediffusion.model import DiffusionModel as TorchDiffusionModel
    except ImportError as e:
        return e
    tmodel = TorchDiffusionModel(
        resolution=model_args["resolution"],
        attention_resolutions=model_args["attention_resolutions"],
        channel_mult=model_args["channel_mult"],
        num_heads=model_args.get("num_heads", 1),
        in_channels=model_args["in_channels"],
        out_channels=model_args["out_channels"],
        model_channels=model_args["model_channels"],
        num_res_blocks=model_args["num_res_blocks"],
        num_classes=model_args.get("num_classes"),
        num_head_channels=model_args.get("num_head_channels"),
        split_qkv_first=model_args.get("split_qkv_first", True),
        dropout=model_args.get("dropout", 0.0),
        resblock_updown=model_args.get("resblock_updown", False),
        use_adaptive_gn=model_args.get("use_adaptive_gn", False),
    ).eval()
    tmodel.load_state_dict(sd, strict=True)
    with torch.no_grad():
        return tmodel(torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(y) if y is not None else None).numpy()


def main(argv: list[str] | None = None) -> int:
    args = make_parser().parse_args(argv)

    import torch

    from ..utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None, ask="pass --cpu")
    # the f32 compute of the JAX tool: TF32 off on the card while the checks
    # run, and the caller's setting back after
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _verify(args, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def _verify(args: argparse.Namespace, device) -> int:
    import torch

    from ..diffusion.process import Diffusion
    from ..models.classifier import EncoderUNet
    from ..models.unet import DiffusionModel
    from ..utils.config import (
        CLASSIFIER_PRESETS,
        DIFFUSION_PRESETS,
        MODEL_PRESETS,
        classifier_preset_for_path,
        preset_for_path,
    )
    from ..utils.convert import rename_guided_diffusion_keys

    r = Report()

    # 1. load
    raw = torch.load(args.pt, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    n_torch = sum(int(np.prod(t.shape)) for t in raw.values())
    r.check("torch load", True, f"{len(raw)} tensors, {n_torch:,} params")

    # 2. preset
    if args.classifier:
        if args.preset == "auto":
            cls_cfg = classifier_preset_for_path(args.pt)
            preset_key = "(classifier by path)"
        else:
            cls_cfg = dict(CLASSIFIER_PRESETS[args.preset])
            preset_key = args.preset
    else:
        if args.preset == "auto":
            model_args, diff_args = preset_for_path(args.pt)
            preset_key = next(
                k for k in PUBLISHED_PARAM_COUNTS
                if MODEL_PRESETS[k] == {kk: vv for kk, vv in model_args.items()
                                        if kk in MODEL_PRESETS[k]}
                or dict(MODEL_PRESETS[k]) == model_args
            )
        else:
            preset_key = args.preset
            model_args = dict(MODEL_PRESETS[preset_key])
            diff_args = dict(DIFFUSION_PRESETS[preset_key])
    r.check("preset dispatch", True, preset_key)

    # 3. conversion + structural match
    try:
        sd = {rename_guided_diffusion_keys(k): v for k, v in raw.items()}
        r.check("conversion", True)
    except Exception as e:  # noqa: BLE001 — report any conversion error
        r.check("conversion", False, repr(e))
        return 1

    def build(dev):
        if args.classifier:
            return EncoderUNet(**cls_cfg, device=dev).eval()
        return DiffusionModel(**model_args, device=dev).eval()

    expected = {k: tuple(v.shape) for k, v in build("meta").state_dict().items()}
    ok, detail = structural_diff(expected, {k: tuple(v.shape) for k, v in sd.items()})
    r.check("structural match", ok, detail)
    if not ok:
        return 1
    model = build(device)
    model.load_state_dict(sd, strict=True)

    # 4. param count
    if not args.classifier and preset_key in PUBLISHED_PARAM_COUNTS:
        want = PUBLISHED_PARAM_COUNTS[preset_key]
        r.check("param count", n_torch == want, f"{n_torch:,} vs published {want:,}")
    else:
        r.skip("param count", "no published count for this config")

    # 5. forward parity vs the torch reference
    if args.classifier:
        r.skip("reference forward parity", "reference has no classifier")
    else:
        x, t, y = parity_inputs(model_args)
        ref = _reference_forward(model_args, sd, args.reference_path, x, t, y)
        if isinstance(ref, ImportError):
            r.skip("reference forward parity", f"reference not importable: {ref}")
        else:
            diff = float(np.max(np.abs(port_forward(model, x, t, y) - ref)))
            r.check("reference forward parity", diff <= FORWARD_TOL,
                    f"max |diff| = {diff:.2e} (tol {FORWARD_TOL:g})")

    # 6. smoke sample
    if args.classifier or args.skip_sample:
        r.skip("2-step smoke sample", "classifier checkpoint" if args.classifier
               else "--skip-sample")
    else:
        smoke_args = dict(diff_args)
        smoke_args.pop("classifier", None)
        smoke_args["rescaled_num_steps"] = 2
        diffusion = Diffusion(model=model, **smoke_args)
        y = (torch.zeros((1,), dtype=torch.long, device=device)
             if model_args.get("num_classes") is not None else None)
        out = diffusion.denoise(torch.Generator(device=device).manual_seed(0), y=y,
                                batch_size=1)
        finite = bool(torch.isfinite(out).all())
        r.check("2-step smoke sample", finite, f"output {tuple(out.shape)}, finite={finite}")

    print(f"\n{'ALL CHECKS PASSED' if r.failures == 0 else f'{r.failures} FAILURE(S)'}")
    return 0 if r.failures == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
