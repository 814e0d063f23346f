"""Real-ESRGAN 4x super-resolution stage (RRDBNet), torch.

Counterpart of nicediffusion_tpu/models/rrdb.py, which replaces the
original reference's optional ``basicsr`` dependency (reference
scripts/sample.py:113-142: ``RRDBNet(3, 3, num_feat=64, num_block=23,
num_grow_ch=32, scale=4)`` loading ``RealESRGAN_x4plus.pth['params_ema']``).

Architecture (basicsr's scale-4 RRDBNet):
  conv_first -> 23x RRDB -> conv_body (+ residual) -> 2x (nearest-2x up +
  conv + LeakyReLU) -> conv_hr -> LeakyReLU -> conv_last
  RRDB = 3 chained ResidualDenseBlocks, residual-scaled by 0.2
  RDB  = 5 densely connected 3x3 convs (growth 32), LeakyReLU(0.2),
         residual-scaled by 0.2

The module tree keeps basicsr's names (``conv_first``,
``body.{i}.rdb{j}.conv{k}``, ``conv_body``, ``conv_up1``, ``conv_up2``,
``conv_hr``, ``conv_last``) and its (O, I, 3, 3) conv weights, so
``RealESRGAN_x4plus.pth['params_ema']`` loads with ``strict=True`` and no
renaming. The network takes and returns NHWC in [0, 1], as the JAX one does;
inside it runs NCHW views in channels_last memory, like the UNet's convs.
No hand-written kernel: every op is a cuDNN conv or an elementwise op.
``device=None`` means the CUDA card (utils/device.py).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from ..utils.device import resolve_device

__all__ = ["RRDBNet", "RRDB", "ResidualDenseBlock", "load_esrgan_params",
           "esrgan_upsample_batches"]

ESRGAN_PATH = "models/RealESRGAN_x4plus.pth"


def _lrelu(x):
    return F.leaky_relu(x, negative_slope=0.2)


def _conv(cin, cout, device):
    return nn.Conv2d(cin, cout, 3, padding=1, device=device)


class ResidualDenseBlock(nn.Module):
    """Five densely connected 3x3 convs; the output residual-scaled by 0.2."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32, device=None):
        super().__init__()
        nf, gc = num_feat, num_grow_ch
        self.conv1 = _conv(nf, gc, device)
        self.conv2 = _conv(nf + gc, gc, device)
        self.conv3 = _conv(nf + 2 * gc, gc, device)
        self.conv4 = _conv(nf + 3 * gc, gc, device)
        self.conv5 = _conv(nf + 4 * gc, nf, device)

    def forward(self, x):
        x1 = _lrelu(self.conv1(x))
        x2 = _lrelu(self.conv2(torch.cat((x, x1), 1)))
        x3 = _lrelu(self.conv3(torch.cat((x, x1, x2), 1)))
        x4 = _lrelu(self.conv4(torch.cat((x, x1, x2, x3), 1)))
        x5 = self.conv5(torch.cat((x, x1, x2, x3, x4), 1))
        return x5 * 0.2 + x


class RRDB(nn.Module):
    """Three chained ResidualDenseBlocks, residual-scaled by 0.2."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32, device=None):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch, device)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch, device)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch, device)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """RRDB super-resolution network, scale 4: NHWC in [0, 1] ->
    NHWC at 4x the height and width."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3, num_feat: int = 64,
                 num_block: int = 23, num_grow_ch: int = 32,
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve_device(device)
        self.conv_first = _conv(num_in_ch, num_feat, device)
        self.body = nn.Sequential(*(RRDB(num_feat, num_grow_ch, device)
                                    for _ in range(num_block)))
        self.conv_body = _conv(num_feat, num_feat, device)
        self.conv_up1 = _conv(num_feat, num_feat, device)
        self.conv_up2 = _conv(num_feat, num_feat, device)
        self.conv_hr = _conv(num_feat, num_feat, device)
        self.conv_last = _conv(num_feat, num_out_ch, device)

    def forward(self, x):
        feat = self.conv_first(x.permute(0, 3, 1, 2))
        feat = feat + self.conv_body(self.body(feat))
        feat = _lrelu(self.conv_up1(F.interpolate(feat, scale_factor=2, mode="nearest")))
        feat = _lrelu(self.conv_up2(F.interpolate(feat, scale_factor=2, mode="nearest")))
        out = self.conv_last(_lrelu(self.conv_hr(feat)))
        return out.permute(0, 2, 3, 1).contiguous()


def load_esrgan_params(path: str = ESRGAN_PATH, device: torch.device | str | None = None
                       ) -> dict[str, torch.Tensor]:
    """The Real-ESRGAN checkpoint the reference uses (reference
    sample.py:129-131) as a state dict of RRDBNet's names on ``device``
    (None: the card): the ``params_ema`` entry when the file has one."""
    sd = torch.load(path, map_location=resolve_device(device), weights_only=True)
    return sd["params_ema"] if "params_ema" in sd else sd


@torch.inference_mode()
def esrgan_upsample_batches(
    samples: Sequence[tuple], model_path: str = ESRGAN_PATH, batch_chunk: int = 4,
    device: torch.device | str | None = None,
) -> list[tuple]:
    """4x-upsample the sampling CLI's (input, output, labels) uint8 NHWC
    batches (reference sample.py:128-142): the outputs go through the
    full-size RRDBNet in f32 in [0, 1], ``batch_chunk`` images a call; the
    inputs are resized bilinearly 4x for the side-by-side display. Raises
    FileNotFoundError when ``model_path`` is missing."""
    device = resolve_device(device)
    net = RRDBNet(device=device).eval()
    net.load_state_dict(load_esrgan_params(model_path, device), strict=True)

    upscaled = []
    for data, out, labels in samples:
        x = torch.from_numpy(np.asarray(out)).to(device, torch.float32) / 255.0
        sr = torch.cat([net(x[i:i + batch_chunk]) for i in range(0, x.shape[0], batch_chunk)])
        sr = (sr * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
        data = torch.from_numpy(np.asarray(data)).to(device, torch.float32)
        data4 = resize_bilinear(data, data.shape[1] * 4, data.shape[2] * 4)
        upscaled.append((data4.to(torch.uint8).cpu().numpy(), sr, labels))
    return upscaled
