"""Host-side image IO helpers for the CLIs.

Copy of nicediffusion_tpu/utils/image.py (numpy + PIL). Replaces the
reference's cv2/matplotlib plumbing (reference scripts/sample.py:55-64, 144-180; utils.py:295-299) with PIL/numpy. The
reference loads start images with cv2 (BGR) and immediately flips to RGB
(sample.py:58), so the net semantics preserved here are: RGB, bilinear
resize to the model resolution, scaled to [-1, 1].
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_start_image", "save_image", "to_uint8", "grayscale_to_rgb"]


def load_start_image(path: str, resolution: int) -> np.ndarray:
    """Load an image file -> float32 [H, W, 3] in [-1, 1] at `resolution`.

    Matches reference sample.py:55-58: resize (bilinear) then /127.5 - 1,
    RGB channel order.
    """
    from PIL import Image

    img = Image.open(path).convert("RGB").resize(
        (resolution, resolution), Image.BILINEAR
    )
    return np.asarray(img, dtype=np.float32) / 127.5 - 1.0


def to_uint8(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> [0, 255] uint8 (reference sample.py:94-95)."""
    return np.clip((x + 1.0) * 127.5, 0, 255).astype(np.uint8)


def grayscale_to_rgb(x: np.ndarray) -> np.ndarray:
    """Inverted 3-channel copy of a single-channel uint8 batch [N, H, W, 1]
    (reference sample.py:98-100 inverts grayscale for display)."""
    return np.repeat(255 - x, 3, axis=-1)


def save_image(img: np.ndarray, path: str) -> None:
    """Save an [H, W, C] uint8 image."""
    from PIL import Image

    if img.shape[-1] == 1:
        img = img[..., 0]
    Image.fromarray(img).save(path)
