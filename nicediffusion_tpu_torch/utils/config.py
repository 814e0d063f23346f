"""Model/diffusion configuration presets and derivation rules.

Copy of nicediffusion_tpu/utils/config.py (framework-free; copied because the
JAX package cannot be imported without jax). Four named presets dispatched
by model-path substring, '/'-separated list parsing, and the two derivation
rules (``out_channels = 2*in_channels`` iff learned variances;
``num_classes += 1`` iff classifier-free guidance).

Presets are plain dicts (usable as ``DiffusionModel(**cfg)`` /
``Diffusion(**cfg)`` / ``EncoderUNet(**cfg)`` kwargs).
"""

from __future__ import annotations

from typing import Any

__all__ = [
    "MODEL_PRESETS",
    "DIFFUSION_PRESETS",
    "CLASSIFIER_PRESETS",
    "preset_for_path",
    "classifier_preset_for_path",
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


# --- noisy-classifier presets (the reference raises NotImplementedError for
# --classifier_path, utils.py:168-172). These match OpenAI guided-diffusion's
# create_classifier defaults for the released
# `{64x64,128x128,256x256}_classifier.pt` checkpoints: EncoderUNetModel with
# classifier_width=128, attention at feature resolutions 32/16/8,
# num_head_channels=64, scale-shift norm (AdaGN), resblock up/down, attention
# pool; classifier_depth=4 at 64x64, the default 2 elsewhere. channel_mult
# follows the image-size rule shared with the UNets. If a checkpoint's depth
# differs, loading fails loudly on structure (strict=True). ---
_CLASSIFIER_COMMON = dict(
    in_channels=3, model_channels=128, out_channels=1000,
    attention_resolutions=(8, 16, 32), num_head_channels=64, dropout=0.0,
    resblock_updown=True, use_adaptive_gn=True, split_qkv_first=False,
    pool="attention",
)
CLASSIFIER_PRESETS: dict[str, dict[str, Any]] = {
    "openai_64": dict(
        _CLASSIFIER_COMMON, resolution=64, channel_mult=(1, 2, 3, 4),
        num_res_blocks=4,
    ),
    "openai_128": dict(
        _CLASSIFIER_COMMON, resolution=128, channel_mult=(1, 1, 2, 3, 4),
        num_res_blocks=2,
    ),
    "openai_256": dict(
        _CLASSIFIER_COMMON, resolution=256, channel_mult=(1, 1, 2, 2, 4, 4),
        num_res_blocks=2,
    ),
}


def classifier_preset_for_path(classifier_path: str) -> dict:
    """Classifier preset dispatch by path substring (same rule as
    preset_for_path)."""
    for sub, key in (
        ("64x64", "openai_64"), ("128x128", "openai_128"),
        ("256x256", "openai_256"),
    ):
        if sub in classifier_path:
            return dict(CLASSIFIER_PRESETS[key])
    raise NotImplementedError(
        f"{classifier_path}: no classifier preset for this path; expected a "
        "64x64/128x128/256x256 guided-diffusion classifier checkpoint"
    )


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
