"""Host-side input pipelines feeding device batches.

Copy of nicediffusion_tpu/training/data.py (numpy only). The reference
trains on torchvision EMNIST through a DataLoader + `cycle()` generator
(reference scripts/train.py:45-47, utils.py:317-323) and patches EMNIST's
transposed w/h orientation inside the train loop (reference trainer.py:76).
Here the pipeline is plain numpy on the host: batches come out NHWC float32
in [-1, 1] with the orientation fix already applied, and the Trainer copies
them to its device.

A synthetic dataset is provided for tests and for machines where the
EMNIST files are unavailable.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Iterator

import numpy as np

__all__ = [
    "cycle",
    "rescale_to_unit",
    "synthetic_batches",
    "emnist_batches",
    "load_emnist_idx",
]


def cycle(iterable):
    """Cycle a finite iterable of batches forever (reference utils.py:317-323)."""
    while True:
        for item in iterable:
            yield item


def rescale_to_unit(im: np.ndarray) -> np.ndarray:
    """[0, 1] -> [-1, 1] (reference utils.py:309-314, `Rescale`)."""
    return 2.0 * im - 1.0


def synthetic_batches(
    batch_size: int,
    resolution: int,
    channels: int,
    num_classes: int | None,
    seed: int = 0,
    num_distinct: int = 64,
) -> Iterator[tuple[np.ndarray, np.ndarray | None]]:
    """Deterministic synthetic image/label batches in [-1, 1], NHWC.

    Produces a small fixed pool of patterns whose content is genuinely
    class-dependent — a per-class mean shift plus a per-class 2-D
    sinusoid — shared across seeds, so (a) a few training steps measurably
    reduce the diffusion loss (trainer integration tests, SURVEY.md §4.6)
    and (b) a classifier trained on one seed's pool generalizes to another
    seed's pool.

    Note: an earlier version drew the label array independently from the
    class index used to build each image, which made labels pure noise
    w.r.t. content — conditional training could only memorize and any
    cross-seed classifier eval sat at chance.
    """
    rng = np.random.default_rng(seed)
    n_cls = num_classes or 1
    cls_idx = rng.integers(0, n_cls, size=num_distinct)
    yy, xx = np.meshgrid(
        np.linspace(0, 1, resolution), np.linspace(0, 1, resolution),
        indexing="ij",
    )
    # seed-independent class signatures: mean level + oriented sinusoid
    means = np.linspace(-0.5, 0.5, n_cls)
    freq = 1.0 + (np.arange(n_cls) % 5)
    angle = np.arange(n_cls) * (np.pi / max(n_cls, 1))
    waves = 0.35 * np.sin(
        2.0 * np.pi * freq[:, None, None]
        * (np.cos(angle)[:, None, None] * xx + np.sin(angle)[:, None, None] * yy)
    )  # (n_cls, res, res)
    pool = np.clip(
        rng.normal(size=(num_distinct, resolution, resolution, channels)) * 0.3
        + means[cls_idx].reshape(-1, 1, 1, 1)
        + waves[cls_idx][..., None],
        -1,
        1,
    ).astype(np.float32)
    labels = cls_idx
    while True:
        idx = rng.integers(0, num_distinct, size=batch_size)
        y = labels[idx] if num_classes is not None else None
        yield pool[idx], y


def load_emnist_idx(root: str, split: str = "letters", train: bool = True):
    """Load EMNIST from raw idx.gz files if present (no download).

    Looks for the standard gzip idx files under `root` (the layout produced
    by torchvision or a manual download of the NIST archive). Returns
    (images[N, 28, 28, 1] float32 in [-1, 1] with the w/h transpose fix,
    labels[N] int) or None when the files are absent.
    """
    kind = "train" if train else "test"
    img_path = os.path.join(root, f"emnist-{split}-{kind}-images-idx3-ubyte.gz")
    lbl_path = os.path.join(root, f"emnist-{split}-{kind}-labels-idx1-ubyte.gz")
    if not (os.path.exists(img_path) and os.path.exists(lbl_path)):
        return None

    with gzip.open(img_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols)
    with gzip.open(lbl_path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int64)

    # EMNIST stores transposed images; fix orientation up front (the
    # reference fixes it per-batch inside the train loop, trainer.py:76).
    images = images.transpose(0, 2, 1)
    images = rescale_to_unit(images.astype(np.float32) / 255.0)[..., None]
    return images, labels


def emnist_batches(
    batch_size: int,
    root: str = "data/EMNIST/raw",
    split: str = "letters",
    seed: int = 0,
    drop_last: bool = True,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Shuffled EMNIST batches from local idx files, cycling forever.

    Raises FileNotFoundError when the raw files are absent (use
    `synthetic_batches` in that case).
    """
    data = load_emnist_idx(root, split=split, train=True)
    if data is None:
        raise FileNotFoundError(
            f"EMNIST idx files not found under {root}; "
            "download them or use synthetic_batches()"
        )
    images, labels = data
    rng = np.random.default_rng(seed)
    n = len(images)
    while True:
        perm = rng.permutation(n)
        for i in range(0, n - (batch_size - 1 if drop_last else 0), batch_size):
            idx = perm[i : i + batch_size]
            yield images[idx], labels[idx]
