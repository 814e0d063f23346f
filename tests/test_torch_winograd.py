"""The port's Winograd F(2x2, 3x3) conv against the JAX package's, on the CPU.

``nicediffusion_tpu_torch/ops/winograd.py`` is held to
``nicediffusion_tpu/ops/winograd.py`` at tests/test_winograd.py's sizes: the
weight transform U and the input transform V bit for bit in f32 and bf16 (V
from the JAX function's own tile gather and einsum), the whole conv with a
bias to 1e-5 of the largest element in f32 and 2^-6 in bf16, and to
``F.conv2d`` at 1e-4 in f32. Then ``DiffusionModel(winograd=True)`` on
weights carried over by ``flax_params_to_torch_state_dict``: the forward at
test_winograd.py's config and at its odd-resolution (7x7) level to 1e-4, a
hybrid AdaGN training loss and its gradients to ``jax.value_and_grad``;
``SuperResolutionModel(winograd=True)`` against its direct forward, the
int8 + Winograd routing, the
state-dict keys, the kernel's plan and a tensor-parallel shard. On CPU
tensors the kernel's wrapper takes its plain version and counts no launch.
"""

import inspect

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nicediffusion_tpu.diffusion.process import Diffusion as JaxDiffusion  # noqa: E402
from nicediffusion_tpu.models.unet import DiffusionModel as JaxModel  # noqa: E402
from nicediffusion_tpu.ops import winograd as jw  # noqa: E402
from nicediffusion_tpu_torch import Diffusion, DiffusionModel  # noqa: E402
from nicediffusion_tpu_torch.models.unet import (  # noqa: E402
    Conv2d,
    Int8Conv,
    SuperResolutionModel,
    WinogradConv,
    shard_module_,
)
from nicediffusion_tpu_torch.ops import winograd as tw  # noqa: E402
from nicediffusion_tpu_torch.ops.kernels import winograd as kw  # noqa: E402
from nicediffusion_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from nicediffusion_tpu_torch.utils.convert import flax_params_to_torch_state_dict  # noqa: E402
from test_torch_unet import inputs, port_model, random_jax_params  # noqa: E402

torch.set_num_threads(2)

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
SIZES = [(8, 8), (7, 7), (7, 10), (28, 28)]
# tests/test_winograd.py's model config: two levels with AdaGN and resblock
# up/down
CFG = dict(
    resolution=16, in_channels=1, model_channels=32, out_channels=2,
    num_res_blocks=1, attention_resolutions=(8,), channel_mult=(1, 2),
    num_heads=4, num_classes=5, dropout=0.0, resblock_updown=True,
    use_adaptive_gn=True, split_qkv_first=True,
)
# its odd-resolution EMNIST-style one (there 28 -> 14 -> 7), cut to its 7x7
# level: odd maps (a ragged last tile row and column) with attention there,
# unconditional
CFG_ODD = dict(CFG, resolution=7, channel_mult=(1,), attention_resolutions=(7,), num_heads=2,
               num_classes=None)
# conv resampling (the Upsample conv is Winograd, the Downsample's stride-2
# conv is not), additive embedding
CFG_RESAMPLE = dict(
    resolution=8, in_channels=3, model_channels=32, out_channels=3,
    num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2),
    num_heads=2, split_qkv_first=False, resblock_updown=False,
    use_adaptive_gn=False, num_classes=None,
)


def conv_case(hw, seed=0, c=5, f=7):
    """tests/test_winograd.py's op inputs: x (2, H, W, 5), an HWIO kernel
    scaled by 0.2 (the port takes it as OIHW), a bias."""
    rng = np.random.default_rng(seed)
    h, w = hw
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    k = (rng.normal(size=(3, 3, c, f)) * 0.2).astype(np.float32)
    b = rng.normal(size=(f,)).astype(np.float32)
    return x, k, b


def jax_v(x):
    """V as the JAX function makes it (ops/winograd.py:70-89), in x's type."""
    n, h, w, _ = x.shape
    pad_h, pad_w = h % 2, w % 2
    xp = jnp.pad(x, ((0, 0), (1, 1 + pad_h), (1, 1 + pad_w), (0, 0)))
    th, tw_ = (h + pad_h) // 2, (w + pad_w) // 2
    idx_h = (2 * jnp.arange(th))[:, None] + jnp.arange(4)[None, :]
    idx_w = (2 * jnp.arange(tw_))[:, None] + jnp.arange(4)[None, :]
    tiles = xp[:, idx_h][:, :, :, idx_w].transpose(0, 1, 3, 2, 4, 5)
    bt = jw._B_T.astype(x.dtype)
    return jnp.einsum("ij,npqjkc,lk->npqilc", bt, tiles, bt)


def as_np(a):
    return np.asarray(a.astype(jnp.float32)) if hasattr(a, "astype") and not isinstance(
        a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_weight_transform_matches_jax_bit_for_bit(dtype):
    tdt, jdt = DTYPES[dtype]
    _, k, _ = conv_case((8, 8))
    ref = np.asarray(jw.transform_weights_3x3(jnp.asarray(k).astype(jdt)).astype(jnp.float32))
    u = tw.transform_weights_3x3(torch.from_numpy(k).permute(3, 2, 0, 1).to(tdt))
    assert u.dtype == tdt and u.shape == (16, 7, 5)
    # JAX's (4, 4, C, F) -> the port's (16, F, C)
    np.testing.assert_array_equal(u.float().numpy(), ref.reshape(16, 5, 7).transpose(0, 2, 1))


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_input_transform_matches_jax_bit_for_bit(dtype, hw):
    tdt, jdt = DTYPES[dtype]
    x, _, _ = conv_case(hw)
    ref = as_np(jax_v(jnp.asarray(x).astype(jdt)))
    v = tw.input_transform(tw.input_tiles(torch.from_numpy(x).to(tdt)))
    assert v.dtype == tdt and v.shape == ref.shape
    np.testing.assert_array_equal(v.float().numpy(), ref)


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_winograd_conv_matches_jax(dtype, hw):
    """With the bias, f32 to 1e-5 of the largest element, bf16 to 2^-6 of it
    (the sums over C may be taken in another order)."""
    tdt, jdt = DTYPES[dtype]
    x, k, b = conv_case(hw)
    xj, kj = jnp.asarray(x).astype(jdt), jnp.asarray(k).astype(jdt)
    ref = as_np(jw.winograd_conv_3x3(xj, kj, bias=jnp.asarray(b)))
    w = torch.from_numpy(k).permute(3, 2, 0, 1).to(tdt)
    out = tw.winograd_conv_3x3(torch.from_numpy(x).to(tdt), w, torch.from_numpy(b))
    assert out.dtype == tdt and out.shape == ref.shape
    tol = 1e-5 if dtype == "f32" else 2.0 ** -6
    assert np.abs(out.float().numpy() - ref).max() <= tol * np.abs(ref).max()
    # the kernel's wrapper on a CPU tensor: the plain version, no launch
    before = kw.winograd_conv_nhwc.launches
    plain = kw.winograd_conv_nhwc(torch.from_numpy(x).to(tdt), tw.transform_weights_3x3(w),
                                  torch.from_numpy(b))
    assert torch.equal(plain, out) and kw.winograd_conv_nhwc.launches == before


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_winograd_conv_matches_direct_conv_f32(hw):
    x, k, b = conv_case(hw, seed=1)
    w = torch.from_numpy(k).permute(3, 2, 0, 1)
    out = tw.winograd_conv_3x3(torch.from_numpy(x), w, torch.from_numpy(b))
    ref = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), w, torch.from_numpy(b), padding=1)
    np.testing.assert_allclose(out.numpy(), ref.permute(0, 2, 3, 1).numpy(), atol=1e-4,
                               rtol=1e-4)


def jax_forward(cfg, jmodel, params, model):
    x, t, y = inputs(cfg)
    ref = np.asarray(jax.jit(jmodel.apply)({"params": params}, x, t, y))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                    None if y is None else torch.from_numpy(y).long())
    return out.numpy(), ref


@pytest.mark.parametrize("cfg", [CFG, CFG_ODD], ids=["ada", "odd_7x7"])
def test_model_matches_jax(cfg):
    """DiffusionModel(winograd=True) against the JAX model with
    ``winograd=True`` on the same weights, f32, to 1e-4."""
    jmodel, params = random_jax_params({**cfg, "winograd": True})
    model = port_model(cfg, params, winograd=True)
    assert sum(isinstance(m, WinogradConv) for m in model.modules()) > 0
    out, ref = jax_forward(cfg, jmodel, params, model)
    assert out.shape == ref.shape and np.abs(ref).max() > 1e-2
    assert np.abs(out - ref).max() <= 1e-4


def test_training_loss_and_gradients_match_jax():
    """A hybrid loss with learned-interpolation variances (the EMNIST
    recipe's) of the AdaGN Winograd model and every parameter's gradient
    against ``jax.value_and_grad`` of the JAX package's ``Diffusion.loss``:
    the loss to 1e-4 of itself, gradients to 1e-3 of the largest."""
    cfg = dict(CFG, resolution=8, channel_mult=(1,), attention_resolutions=(), num_classes=5)
    jmodel, params = random_jax_params({**cfg, "winograd": True}, seed=2)
    last = params["out"]["layers_2"]
    last["kernel"], last["bias"] = 0.1 * last["kernel"], 0.1 * last["bias"]
    model = port_model(cfg, params, winograd=True)
    kw_ = dict(original_num_steps=1000, rescaled_num_steps=8, beta_schedule="cosine",
               guidance_method="classifier_free", guidance_strength=0.8,
               sampling_var_type="learned_interpolation", loss_type="hybrid")
    jd, td = JaxDiffusion(model=jmodel, **kw_), Diffusion(model=model, **kw_)
    rng = np.random.default_rng(4)
    x0 = rng.uniform(-1, 1, size=(3, 8, 8, 1)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    t, y = np.array([0, 3, 7], np.int32), np.array([1, 0, 4], np.int32)
    ref_loss, ref = jax.jit(jax.value_and_grad(
        lambda p: jd.loss(p, x0, t, None, y=y, noise=noise).mean()))(params)
    ref = flax_params_to_torch_state_dict(jax.tree.map(np.asarray, ref))
    loss = td.loss(torch.from_numpy(x0), torch.from_numpy(t).long(),
                   y=torch.from_numpy(y).long(), noise=torch.from_numpy(noise)).mean()
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert abs(loss.item() - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    top = max(np.abs(g).max() for g in ref.values())
    assert top > 0
    for name, g in zip(names, grads):
        got = np.zeros_like(ref[name]) if g is None else g.numpy()
        assert np.abs(got - ref[name]).max() <= 1e-3 * top, name


def test_super_resolution_model():
    """SuperResolutionModel takes the flag from DiffusionModel: its Winograd
    forward (conv resampling: the Upsample conv too) against its direct one
    on the same weights, f32, to 1e-4."""
    cfg = dict(CFG_RESAMPLE, in_channels=6)
    direct = SuperResolutionModel(**cfg, device="cpu").eval()
    fast = SuperResolutionModel(**cfg, winograd=True, device="cpu").eval()
    torch.manual_seed(0)
    with torch.no_grad():
        for p in direct.parameters():
            p.normal_(0.0, 0.2)
    fast.load_state_dict(direct.state_dict(), strict=True)
    assert sum(isinstance(m, WinogradConv) for m in fast.modules()) > 0
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 8, 8, 3)).astype(np.float32))
    low = torch.from_numpy(rng.normal(size=(2, 4, 4, 3)).astype(np.float32))
    t = torch.tensor([5, 900])
    with torch.no_grad():
        out, ref = fast(x, t, low_res=low), direct(x, t, low_res=low)
    assert (out - ref).abs().max() <= 1e-4 * max(1.0, ref.abs().max().item())


def conv_kinds(model):
    """{module name: class name} of every conv of ``model``."""
    return {n: type(m).__name__ for n, m in model.named_modules() if isinstance(m, Conv2d)}


@pytest.mark.parametrize("cfg", [CFG, CFG_RESAMPLE], ids=["updown", "resample"])
def test_winograd_at_jaxs_sites(cfg):
    """Stride-1 3x3 convs become WinogradConv (the stem, in_conv, out_conv,
    the Upsample conv); the 1x1 skips, the stride-2 Downsample conv and the
    head stay Conv2d. In an int8 model the residual and resampling convs are
    Int8Conv first, and only the stem is Winograd."""
    kinds = conv_kinds(DiffusionModel(**cfg, winograd=True, device="meta"))
    plain_model = DiffusionModel(**cfg, device="meta")
    plain = dict(plain_model.named_modules())
    assert set(conv_kinds(plain_model).values()) == {"Conv2d"}
    for name, kind in kinds.items():
        k = plain[name].weight.shape[-1]
        stride2 = name.endswith(".conv") and name.startswith("downsampling")
        want = "Conv2d" if name == "out.2" or k == 1 or stride2 else "WinogradConv"
        assert kind == want, name
    assert kinds["downsampling.0.0"] == "WinogradConv"
    if not cfg["resblock_updown"]:
        assert "WinogradConv" in {kinds[n] for n in kinds if n.startswith("upsampling")
                                  and n.endswith(".conv")}
    quantized = DiffusionModel(**cfg, winograd=True, quantized=True, device="meta")
    q = conv_kinds(quantized)
    assert q["downsampling.0.0"] == "WinogradConv" and q["out.2"] == "Conv2d"
    assert {v for n, v in q.items() if n not in ("downsampling.0.0", "out.2")} == {"Int8Conv"}
    assert all(isinstance(m, Int8Conv) for m in quantized.int8_layers().values())


@pytest.mark.parametrize("cfg", [CFG, CFG_ODD, CFG_RESAMPLE], ids=["ada", "odd_7x7", "resample"])
def test_state_dict_keys_and_shapes_as_without_winograd(cfg):
    """The same checkpoint loads either way, strict."""
    a = DiffusionModel(**cfg, device="cpu").state_dict()
    b = DiffusionModel(**cfg, winograd=True, device="cpu")
    assert [(k, v.shape) for k, v in a.items()] == [(k, v.shape) for k, v in
                                                    b.state_dict().items()]
    b.load_state_dict(a, strict=True)


def test_plan_reads_the_map_never_the_batch():
    assert list(inspect.signature(kw.winograd_conv_plan).parameters) == ["h", "w", "c", "f"]
    plan = kw.winograd_conv_plan(7, 10, 3, 192)
    assert plan == {"tiles": 64, "filters": 128, "cluster": 4, "channel_step": 32, "steps": 1,
                    "tile_rows": 4, "tile_cols": 5, "filter_tiles": 2}
    # the grid grows with the batch (a cluster of four blocks a unit); the
    # work of a tile does not
    assert kw.winograd_conv_units(1, 64, 64, 192, 192) == 16 * 2 * 4
    assert kw.winograd_conv_units(128, 8, 8, 768, 768) == 32 * 6 * 4
    assert kw.winograd_conv_units(16, 28, 28, 1, 64) == 49 * 1 * 4


def _model_shapes(preset):
    from chip_smoke import model_config, winograd_calls

    meta = torch.device("meta")
    cfg = model_config() if preset == "openai_64" else model_config(preset)
    return sorted(winograd_calls(DiffusionModel(**cfg, winograd=True, kernels=False,
                                                device=meta).eval(), meta))


@pytest.mark.parametrize("preset,tiles", [
    # openai_64: F of 192, 384, 576, 768 take 128 filters a unit (576 pads to
    # 640: fewer shared-memory bytes than nine units of 64)
    ("openai_64", {192: 128, 384: 128, 576: 128, 768: 128}),
    # EMNIST: 64 filters take 64, 128 and 256 take 128
    ("EMNIST", {64: 64, 128: 128, 256: 128}),
])
def test_plan_of_every_model_shape(preset, tiles):
    """The cluster and filter tile of every Winograd conv of the two models:
    a cluster of four (block r the positions of row r of V), the tile from F
    alone, the same at every batch."""
    shapes = _model_shapes(preset)
    assert {f for _, _, _, f in shapes} == set(tiles)
    for h, w, c, f in shapes:
        plan = kw.winograd_conv_plan(h, w, c, f)
        assert plan["cluster"] == 4 and plan["tiles"] == 64
        assert plan["filters"] == tiles[f] and plan["filter_tiles"] == -(-f // tiles[f])
        for b in (1, 16, 128):
            groups = -(-b * plan["tile_rows"] * plan["tile_cols"] // 64)
            assert kw.winograd_conv_units(b, h, w, c, f) == groups * plan["filter_tiles"] * 4


def test_filter_tile_is_the_cuda_sources():
    """The wrapper's filter tile is csrc/winograd.cu's winograd_filter_tile,
    read from the source and evaluated with C's integer division."""
    import re

    src = (kw._build.CSRC / "winograd.cu").read_text()
    body = re.search(r"int winograd_filter_tile\(int f\) \{\s*return (.+?) \? 64 : 128;", src)
    assert body, "winograd_filter_tile's rule is not in csrc/winograd.cu"
    rule = body.group(1).replace("/", "//")
    for f in range(1, 2049):
        assert kw.winograd_filter_tile(f) == (64 if eval(rule, {"f": f}) else 128), f


def test_bf16_forward_on_the_cpu_takes_the_plain_version():
    """In bf16 with grad mode off the model calls the kernel's wrapper,
    which on CPU tensors runs the plain version and launches nothing; the
    result tracks the f32 model."""
    torch.manual_seed(8)
    f32 = DiffusionModel(**CFG, winograd=True, device="cpu").eval()
    with torch.no_grad():  # the zero-initialised output convs take part
        for p in f32.parameters():
            p.add_(0.02 * torch.randn_like(p))
    bf16 = DiffusionModel(**CFG, winograd=True, dtype=torch.bfloat16, device="cpu").eval()
    bf16.load_state_dict(f32.state_dict(), strict=True)
    x, t, y = (torch.from_numpy(a) for a in inputs(CFG))
    before = kw.winograd_conv_nhwc.launches
    with torch.no_grad():
        ref, out = f32(x, t.long(), y.long()), bf16(x, t.long(), y.long())
    assert kw.winograd_conv_nhwc.launches == before
    assert out.dtype == torch.float32
    assert (out - ref).abs().max() <= 0.05 * ref.abs().max()


@pytest.mark.parametrize("rank", [0, 1])
def test_tensor_parallel_shard_builds(rank):
    """shard_module_ cuts a Winograd model's paired convs by name as it
    cuts a Conv2d's (in_conv by filters, out_conv by channels), each rank
    its own slice of the whole weight."""
    whole = DiffusionModel(**CFG, winograd=True, device="cpu").eval()
    model = DiffusionModel(**CFG, winograd=True, device="cpu").eval()
    model.load_state_dict(whole.state_dict(), strict=True)
    shard_module_(model, Mesh(1, 2, model_rank=rank))
    paired = 0
    for name, block in model.named_modules():
        if block.__class__.__name__ != "ResidualBlock" or block.tp is None:
            continue
        paired += 1
        ref = whole.get_submodule(name)
        assert isinstance(block.in_conv, WinogradConv) and isinstance(block.out_conv, WinogradConv)
        half = ref.in_conv.weight.shape[0] // 2
        assert torch.equal(block.in_conv.weight, ref.in_conv.weight[rank * half:(rank + 1) * half])
        assert torch.equal(block.out_conv.weight,
                           ref.out_conv.weight[:, rank * half:(rank + 1) * half])
    assert paired > 0


def test_transformed_weight_is_kept_until_the_weight_changes():
    """With grad mode off WinogradConv keeps U between calls (JAX hoists the
    transform out of the sampling scan) and makes it anew when the weight
    changes in place or is replaced; with grad mode on it makes U in the
    graph, so the weight gets its gradient."""
    torch.manual_seed(0)
    conv = WinogradConv(4, 6, device="cpu")
    with torch.no_grad():
        conv.bias.normal_()
    x = torch.randn(2, 5, 6, 4)
    with torch.no_grad():
        u = conv.transformed_weight(torch.float32)
        assert conv.transformed_weight(torch.float32) is u
        out = conv(x)
        assert torch.equal(out, tw.winograd_conv_3x3(x, conv.weight, conv.bias))
        conv.weight.mul_(2.0)  # exact: U doubles bit for bit
        doubled = conv.transformed_weight(torch.float32)
        assert torch.equal(doubled, 2.0 * u)
        assert conv.transformed_weight(torch.bfloat16).dtype == torch.bfloat16
        conv.weight.data = conv.weight.data.clone()  # new storage, same values
        again = conv.transformed_weight(torch.float32)
        assert again is not doubled and torch.equal(again, doubled)
    conv(x).sum().backward()
    assert conv.weight.grad is not None and conv.weight.grad.abs().max() > 0
    with torch.inference_mode():  # a weight made here has no version counter
        made = WinogradConv(4, 6, device="cpu")
        assert made.weight.is_inference()
        assert torch.equal(made(x), tw.winograd_conv_3x3(x, made.weight, made.bias))
