"""The bf16 conv's plain version (ops/kernels/conv.py) against the JAX
package's flax convs (and a dense layer, as the 1 x 1 dense view), its batch
independence, its plan, the model's routing of bf16 convs to it, and
K1/K2's head-dim rounding, on the CPU.

The conv kernel itself runs only on the card (tests/test_torch_kernels.py,
``-k bf16_conv``); here the wrappers take the plain versions, which the card
holds the kernel to.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nicediffusion_tpu.models.unet import _conv as jax_conv  # noqa: E402
from nicediffusion_tpu_torch import DiffusionModel  # noqa: E402
from nicediffusion_tpu_torch.models import unet as unet_module  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import attention as k1  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import conv as kc  # noqa: E402

torch.set_num_threads(2)

# bf16: both sides sum the exact products in f32 (in other orders) and round
# to bf16 before and after the bias, so an element may differ by a bf16 ulp
# of the sum and one of the output: two ulps of the largest output, 2^-6 of
# it (the card's gate, tests/test_torch_kernels.py BF16_CONV_TOL). f32: the
# order of the f32 sums alone.
TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-5}
JAX_DTYPES = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _operands(shape, f, k, dtype, seed=0):
    """x rounded to ``dtype`` (f32 values), an (F, C, k, k) weight and a bias."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((f, c, k, k)) / np.sqrt(c * k * k))
                         .astype(np.float32))
    b = torch.from_numpy((0.2 * rng.standard_normal(f)).astype(np.float32))
    return x, w, b


def _close(out, ref, dtype):
    out, ref = out.float().numpy(), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(out - ref).max() <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,f,k,stride", [
    ((2, 8, 8, 32), 64, 3, 1), ((2, 9, 7, 12), 6, 3, 1), ((3, 8, 8, 48), 32, 1, 1),
    ((2, 8, 8, 32), 32, 3, 2), ((1, 7, 5, 3), 16, 3, 1),
])
def test_conv_plain_matches_jax_conv(dtype, shape, f, k, stride):
    """conv_nhwc_plain against the JAX package's conv (flax nn.Conv with
    ``dtype``: the product rounded to it, then the bias added in it)."""
    x, w, b = _operands(shape, f, k, dtype, seed=f + k)
    module = jax_conv(f, k, stride, dtype=JAX_DTYPES[dtype])
    params = {"kernel": jnp.asarray(w.permute(2, 3, 1, 0).numpy()), "bias": jnp.asarray(b.numpy())}
    ref = module.apply({"params": params}, jnp.asarray(x.float().numpy()))
    assert ref.dtype == JAX_DTYPES[dtype]
    out = kc.conv_nhwc(x, w, b, stride)
    assert out.dtype == dtype
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("lead,c,f", [((4,), 32, 128), ((2, 16), 48, 144), ((3, 5), 20, 7)])
def test_conv_plain_dense_view_matches_jax_dense(dtype, lead, c, f):
    """conv_nhwc_plain on the dense view, a 1 x 1 conv over (1, 1, M, C),
    against flax nn.Dense with ``dtype``, the JAX package's dense layer."""
    rng = np.random.default_rng(c + f)
    x = torch.from_numpy(rng.standard_normal((*lead, c)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((f, c)) / np.sqrt(c)).astype(np.float32))
    b = torch.from_numpy((0.2 * rng.standard_normal(f)).astype(np.float32))
    module = fnn.Dense(f, dtype=JAX_DTYPES[dtype])
    ref = module.apply({"params": {"kernel": jnp.asarray(w.T.numpy()),
                                   "bias": jnp.asarray(b.numpy())}},
                       jnp.asarray(x.float().numpy()))
    out = kc.conv_nhwc(x.reshape(1, 1, -1, c), w[:, :, None, None], b)
    _close(out.reshape(*lead, f), ref, dtype)


@pytest.mark.parametrize("shape,f,k,stride", [((8, 8, 32), 64, 3, 1), ((8, 8, 32), 48, 1, 1),
                                              ((9, 9, 16), 16, 3, 2)])
def test_conv_plain_row_is_batch_invariant(shape, f, k, stride):
    """One example's bf16 output bit-identical alone, at every row of
    batches of 4 and 8, among random batch mates and among zeros."""
    x0, w, b = _operands((1, *shape), f, k, torch.bfloat16)
    ref = kc.conv_nhwc(x0, w, b, stride)[0]
    rng = np.random.default_rng(1)
    for batch in (4, 8):
        for row in range(batch):
            for mates in ("random", "zeros"):
                x = (torch.from_numpy(rng.standard_normal((batch, *shape)).astype(np.float32))
                     if mates == "random" else torch.zeros((batch, *shape))).bfloat16()
                x[row] = x0[0]
                assert torch.equal(kc.conv_nhwc(x, w, b, stride)[row], ref), (batch, row, mates)


@pytest.mark.parametrize("h,w,k,stride,f,route,tile", [
    # openai_64: 64 x 64 and 32 x 32 levels fill the card at the widest tile
    (64, 64, 3, 1, 192, "halo", 192), (32, 32, 3, 1, 384, "halo", 192),
    (64, 64, 1, 1, 192, "row", 192), (16, 16, 3, 1, 576, "halo", 192),
    # small maps split finer: 8 x 8 at 64 filters, 16 x 16 at 384 filters at 128
    (8, 8, 3, 1, 768, "halo", 64), (8, 8, 1, 1, 768, "row", 64), (16, 16, 3, 1, 384, "halo", 128),
    (3, 1, 3, 1, 256, "halo", 64),
    # no tile divides F: 64 (the head's F = 6, ragged F)
    (64, 64, 3, 1, 6, "halo", 64), (1, 1, 1, 1, 130, "row", 64), (16, 16, 3, 2, 64, "row", 64),
])
def test_conv_plan_takes_no_batch(h, w, k, stride, f, route, tile):
    """The route from k and stride; the tile from the map, k, stride and F:
    one of 192, 128 and 64 that divides F (else 64), the fewest waves of
    units on the card at PLAN_BATCH, the widest on a tie. The batch is not
    an argument."""
    assert kc.conv_nhwc_plan(h, w, k, stride, f) == (route, tile)


@functools.lru_cache(maxsize=None)
def _preset_conv_shapes():
    """Every (H, W, C, F, k, stride) of one forward of openai_64, openai_128
    and the super-resolution UNet at openai_256's widths (the meta device)."""
    from chip_smoke import conv_calls, model_config, sr_config
    from nicediffusion_tpu_torch.models.unet import SuperResolutionModel

    meta = torch.device("meta")
    shapes = set()
    for cfg, cls in ((model_config("openai_64"), DiffusionModel),
                     (model_config("openai_128"), DiffusionModel),
                     (sr_config(), SuperResolutionModel)):
        shapes |= set(conv_calls(cls(**cfg, kernels=False, device=meta).eval(), meta))
    return tuple(sorted(shapes))


def test_conv_plan_reads_no_batch_at_every_preset_shape():
    """The plan's arguments are the map, k, stride and F; what the wrapper
    launches with (plan_for of x's shape) is the same at batches 1, 16 and
    128 at every conv shape of openai_64, openai_128 and sr256."""
    import inspect

    assert list(inspect.signature(kc.conv_nhwc_plan).parameters) == ["h", "w", "k", "stride", "f"]
    shapes = _preset_conv_shapes()
    assert len(shapes) > 60
    for h, w, c, f, k, stride in shapes:
        plans = {kc.plan_for((b, h, w, c), f, k, stride) for b in (1, 16, 128)}
        assert plans == {kc.conv_nhwc_plan(h, w, k, stride, f)}, (h, w, c, f, k, stride)


@pytest.mark.parametrize("f", [6, 64, 96, 130, 192, 256, 320, 384, 448, 576, 640, 768, 1000, 1024,
                               1152, 1536])
def test_conv_plan_leaves_no_zero_products_where_f_allows(f):
    """At every map, k and stride of the presets, the tile divides F whenever
    one of 192, 128 and 64 does; the units at batch 16 grow as the tile
    narrows."""
    for h, w, _, _, k, stride in _preset_conv_shapes():
        route, tile = kc.conv_nhwc_plan(h, w, k, stride, f)
        assert route == ("halo" if (k, stride) == (3, 1) else "row")
        if any(f % t == 0 for t in kc.FILTER_TILES):
            assert f % tile == 0, (h, w, k, stride, f, tile)
        else:
            assert tile == 64
        units = [kc.conv_nhwc_units(16, h, w, k, stride, f, t) for t in kc.FILTER_TILES]
        assert units == sorted(units)


def test_bf16_model_sends_every_conv_to_the_conv_wrapper(monkeypatch):
    """A bf16 kernels=True model with grad mode off calls conv_nhwc for every
    Conv2d; under autograd, in f32 and with kernels=False never."""
    calls = []
    fn = unet_module.conv_nhwc
    monkeypatch.setattr(unet_module, "conv_nhwc", lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    cfg = dict(resolution=8, in_channels=3, model_channels=32, out_channels=6,
               num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2),
               num_heads=2, num_classes=5, resblock_updown=True, use_adaptive_gn=True)
    x, t, y = torch.randn(2, 8, 8, 3), torch.tensor([3, 30]), torch.tensor([1, 2])
    for dtype, kernels, grad, expect in ((torch.bfloat16, True, False, True),
                                         (torch.bfloat16, True, True, False),
                                         (torch.float32, True, False, False),
                                         (torch.bfloat16, False, False, False)):
        model = DiffusionModel(**cfg, dtype=dtype, kernels=kernels, device="cpu").eval()
        convs = sum(isinstance(m, unet_module.Conv2d) for m in model.modules())
        calls.clear()
        with torch.set_grad_enabled(grad):
            assert torch.isfinite(model(x, t, y)).all()
        assert len(calls) == (convs if expect else 0), (dtype, kernels, grad)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("which,cfg", [
    ("unet", dict(resolution=8, in_channels=3, model_channels=32, out_channels=6,
                  num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2),
                  num_heads=2, num_classes=5, resblock_updown=False)),
    ("classifier", dict(resolution=8, in_channels=1, model_channels=32, out_channels=10,
                        num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2),
                        num_head_channels=16, resblock_updown=False, pool="adaptive")),
])
def test_models_hand_their_kernels_flag_to_every_conv(which, cfg, kernels):
    """Every Conv2d of a DiffusionModel or an EncoderUNet, the stem, the
    head and the resampling convs included, is built with the model's
    ``kernels``."""
    from nicediffusion_tpu_torch import EncoderUNet

    cls = DiffusionModel if which == "unet" else EncoderUNet
    model = cls(**cfg, kernels=kernels, device="meta")
    convs = [m for m in model.modules() if isinstance(m, unet_module.Conv2d)]
    assert any(m.stride == 2 for m in convs) and all(m.kernels is kernels for m in convs)


@pytest.mark.parametrize("d,build", [(24, 32), (32, 32), (48, 64), (96, 128), (100, 128),
                                     (160, 192), (200, 256), (256, 256), (257, k1.CHUNKED),
                                     (512, k1.CHUNKED), (1024, k1.CHUNKED)])
def test_head_dim_rounds_up_to_a_build(d, build):
    assert k1.head_dim_build(d) == build


def test_head_dim_over_256_raises_naming_the_roadmap():
    """A head dim over 256 raises no more: it runs on the chunked build, at
    any width. Only a head dim under 1 raises."""
    for d in (257, 300, 768, 4096):
        assert k1.head_dim_build(d) == k1.CHUNKED
    with pytest.raises(ValueError, match="head dim 0"):
        k1.head_dim_build(0)
