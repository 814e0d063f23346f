"""Model/diffusion configuration presets and derivation rules.

Copy of nicediffusion_tpu/utils/config.py (framework-free; copied because the
JAX package cannot be imported without jax). Four named presets dispatched
by model-path substring, '/'-separated list parsing, and the two derivation
rules (``out_channels = 2*in_channels`` iff learned variances;
``num_classes += 1`` iff classifier-free guidance).

Presets are plain dicts (usable as ``DiffusionModel(**cfg)`` /
``Diffusion(**cfg)`` kwargs). The noisy-classifier presets stay behind with
the classifier, which this package does not have yet (ROADMAP queue A,
"Guidance classifier, SR and ESRGAN").
"""

from __future__ import annotations

from typing import Any

__all__ = [
    "MODEL_PRESETS",
    "DIFFUSION_PRESETS",
    "preset_for_path",
    "apply_derivations",
]

# --- reference default_args.py:4-10 ---
EMNIST_MODEL = dict(
    resolution=28, attention_resolutions=(7, 14), channel_mult=(1, 2, 4),
    num_heads=4, in_channels=1, out_channels=2, model_channels=64,
    num_res_blocks=2, split_qkv_first=True, dropout=0.05,
    resblock_updown=True, use_adaptive_gn=True, num_classes=27,
)
EMNIST_DIFFUSION = dict(
    rescaled_num_steps=25, original_num_steps=1000, use_ddim=False,
    ddim_eta=0.0, beta_schedule="cosine",
    sampling_var_type="learned_interpolation", classifier=None,
    guidance_method="classifier_free", guidance_strength=0.8,
    loss_type="hybrid",
)

# --- reference default_args.py:15-21 ---
OPENAI_64_MODEL = dict(
    resolution=64, attention_resolutions=(8, 16, 32), channel_mult=(1, 2, 3, 4),
    num_head_channels=64, in_channels=3, out_channels=6, model_channels=192,
    num_res_blocks=3, split_qkv_first=True, dropout=0.05,
    resblock_updown=True, use_adaptive_gn=True, num_classes=1000,
)
OPENAI_64_DIFFUSION = dict(
    rescaled_num_steps=25, original_num_steps=1000, use_ddim=True,
    ddim_eta=0.0, beta_schedule="cosine",
    sampling_var_type="learned_interpolation", classifier=None,
    guidance_method=None, guidance_strength=0.8, loss_type="hybrid",
)

# --- reference default_args.py:26-32 ---
OPENAI_128_MODEL = dict(
    resolution=128, attention_resolutions=(8, 16, 32),
    channel_mult=(1, 1, 2, 3, 4), num_heads=4, in_channels=3, out_channels=6,
    model_channels=256, num_res_blocks=2, split_qkv_first=True, dropout=0.05,
    resblock_updown=True, use_adaptive_gn=True, num_classes=1000,
)
OPENAI_128_DIFFUSION = dict(OPENAI_64_DIFFUSION, beta_schedule="linear")

# --- reference default_args.py:37-43 ---
OPENAI_256_MODEL = dict(
    resolution=256, attention_resolutions=(8, 16, 32),
    channel_mult=(1, 1, 2, 2, 4, 4), num_head_channels=64, in_channels=3,
    out_channels=6, model_channels=256, num_res_blocks=2,
    split_qkv_first=True, dropout=0.05, resblock_updown=True,
    use_adaptive_gn=True, num_classes=1000,
)
OPENAI_256_DIFFUSION = dict(OPENAI_64_DIFFUSION, beta_schedule="linear")

MODEL_PRESETS: dict[str, dict[str, Any]] = {
    "EMNIST": EMNIST_MODEL,
    "openai_64": OPENAI_64_MODEL,
    "openai_128": OPENAI_128_MODEL,
    "openai_256": OPENAI_256_MODEL,
}
DIFFUSION_PRESETS: dict[str, dict[str, Any]] = {
    "EMNIST": EMNIST_DIFFUSION,
    "openai_64": OPENAI_64_DIFFUSION,
    "openai_128": OPENAI_128_DIFFUSION,
    "openai_256": OPENAI_256_DIFFUSION,
}


def preset_for_path(model_path: str) -> tuple[dict, dict]:
    """Default-model dispatch by model-path substring
    (reference utils.py:181-196)."""
    if "64x64" in model_path:
        key = "openai_64"
    elif "128x128" in model_path:
        key = "openai_128"
    elif "256x256" in model_path:
        key = "openai_256"
    elif "EMNIST" in model_path:
        key = "EMNIST"
    else:
        raise NotImplementedError(f"{model_path}: this is not a default model")
    return dict(MODEL_PRESETS[key]), dict(DIFFUSION_PRESETS[key])


def apply_derivations(model_args: dict, diff_args: dict) -> None:
    """Apply the custom-config derivation rules in place
    (reference utils.py:198-212)."""
    if isinstance(model_args.get("attention_resolutions"), str):
        model_args["attention_resolutions"] = tuple(
            int(i) for i in model_args["attention_resolutions"].split("/")
        )
    if isinstance(model_args.get("channel_mult"), str):
        model_args["channel_mult"] = tuple(
            int(i) for i in model_args["channel_mult"].split("/")
        )
    if diff_args.get("sampling_var_type") in ("learned", "learned_interpolation"):
        model_args["out_channels"] = model_args["in_channels"] * 2
    else:
        model_args["out_channels"] = model_args["in_channels"]
    if diff_args.get("guidance_method") == "classifier_free":
        model_args["num_classes"] += 1
