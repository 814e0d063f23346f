"""The int8 conv's plan (ops/kernels/int8conv.py::int8_conv_plan) on the CPU.

The kernel takes its route and tiles from the plan, which depends on the
call's shape and input type alone, so these checks pin what the card runs:
which route each call of the served models takes, and that no call of
``openai_64`` issues a product of zeros (a channel step or filter tile past
C or F, a pixel tile past the map).
"""

import pytest
import torch

from chip_smoke import PATHS, int8_conv_calls, model_config
from nicediffusion_tpu_torch import DiffusionModel
from nicediffusion_tpu_torch.ops.kernels.int8conv import CHANNEL_STEP, int8_conv_plan

META = torch.device("meta")


def _calls(cfg):
    model = DiffusionModel(**cfg, kernels=False, device=META).eval()
    return int8_conv_calls(model, cfg, META)


def _issued(b, h, w, c, f, k, stride, plan):
    """(issued, useful) multiply-adds of one call under ``plan``: K walked in
    whole channel steps, N in whole filter tiles, M in whole blocks (two 8 x 8
    tiles on the halo route, 128 pixels on the row route)."""
    route, tile, step = plan
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    useful = b * ho * wo * f * k * k * c
    if route == "halo":
        tiles = b * -(-h // 8) * -(-w // 8)
        rows = -(-tiles // 2) * 2 * 64
    else:
        rows = -(-b * ho * wo // 128) * 128
    return rows * -(-f // tile) * tile * k * k * -(-c // step) * step, useful


OPENAI_64 = sorted(_calls(model_config()).items())


def test_openai_64_has_the_int8_convs_the_model_tree_gives():
    assert sum(n for _, n in OPENAI_64) == 91
    assert {key[4] for key, _ in OPENAI_64} == {1, 3}


@pytest.mark.parametrize("batch", [PATHS["forward"][0], PATHS["int8_serve"][0]],
                         ids=["model_batch_16", "model_batch_128"])
def test_openai_64_issues_no_zero_product(batch):
    """Every int8 conv of an openai_64 forward, k = 3 on the halo route and
    the 1 x 1 skips on the row route, 64-channel steps: issued products equal
    useful ones."""
    for (h, w, c, f, k, stride), _ in OPENAI_64:
        plan = int8_conv_plan(batch, h, w, c, f, k, stride, torch.bfloat16)
        assert plan[0] == ("halo" if k == 3 and stride == 1 else "row"), (h, w, c, f, k)
        assert plan[2] == CHANNEL_STEP == 64
        issued, useful = _issued(batch, h, w, c, f, k, stride, plan)
        assert issued == useful, ((h, w, c, f, k, stride), plan)


def test_openai_64_takes_192_filter_tiles_at_the_serve_batch():
    """At model batch 128 every call has waves enough for the widest tile."""
    for (h, w, c, f, k, stride), _ in OPENAI_64:
        assert int8_conv_plan(128, h, w, c, f, k, stride, torch.bfloat16)[1] == 192


def test_small_maps_take_narrow_tiles_for_waves():
    """At model batch 16 the 8 x 8 convs (8 blocks of two tiles) take 64
    filters a block: 96 blocks on 132 multiprocessors rather than 32."""
    assert int8_conv_plan(16, 8, 8, 768, 768, 3, 1, torch.bfloat16) == ("halo", 64, 64)
    assert int8_conv_plan(16, 8, 8, 768, 768, 3, 1, torch.bfloat16, sms=16)[1] == 192


def test_quality_unet_64_channel_convs_take_64_channel_steps():
    """quality_eval's UNet (EMNIST widths): its 64-channel convs issue no
    product past C (one 64-channel step)."""
    from nicediffusion_tpu_torch.tools.quality_eval import arch_config

    _, cfg, _ = arch_config("emnist")
    calls = sorted(_calls(cfg).items())
    assert any(key[2] == 64 for key, _ in calls)
    for (h, w, c, f, k, stride), _ in calls:
        route, tile, step = int8_conv_plan(PATHS["qe_int8"][0], h, w, c, f, k, stride,
                                           torch.bfloat16)
        assert step == 64 and route == ("halo" if k == 3 and stride == 1 else "row")
        if c == 64:
            assert -(-c // step) * step == c


@pytest.mark.parametrize("shape,f,k,stride,xdtype,route", [
    ((16, 64, 64, 384), 192, 1, 1, torch.bfloat16, "row"),      # a 1 x 1 skip
    ((16, 32, 32, 192), 192, 3, 2, torch.bfloat16, "row"),      # a Downsample conv
    ((2, 9, 7, 40), 24, 1, 2, torch.int8, "row"),
    ((1, 1, 2 * 256, 384), 3 * 384, 1, 1, torch.bfloat16, "row"),  # Int8Dense's view
    ((16, 64, 64, 192), 192, 3, 1, torch.float32, "row"),       # f32 x: any shape
    ((16, 64, 64, 192), 192, 3, 1, torch.bfloat16, "halo"),
    ((16, 64, 64, 192), 192, 3, 1, torch.int8, "halo"),         # s8 x straight into the halo
], ids=["skip", "downsample", "s8_k1_s2", "dense_view", "f32", "bf16", "s8"])
def test_routes(shape, f, k, stride, xdtype, route):
    assert int8_conv_plan(*shape, f, k, stride, xdtype)[0] == route


@pytest.mark.parametrize("f,tile", [(192, 192), (576, 192), (384, 192), (768, 192),
                                    (128, 128), (64, 64), (130, 192)])
def test_filter_tiles_divide_f_when_one_does(f, tile):
    """At many waves the widest tile that divides F (none divides 130: the
    widest, masked)."""
    assert int8_conv_plan(128, 64, 64, 192, f, 3, 1, torch.bfloat16)[1] == tile
