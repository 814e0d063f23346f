"""The port's super-resolution stage against the JAX package's, on the CPU.

``resize_bilinear`` against ``jax.image.resize(..., "linear")`` at 2x, 4x, a
non-integer upsampling ratio and a downsampling (1e-6), and at 2x and 4x
against torch's bilinear ``interpolate`` too; ``SuperResolutionModel`` on
tests/test_sr_model.py's configuration against the JAX model (1e-4); a
deterministic DDIM chain (eta 0) driven through ``with_model_kwargs(low_res=)``
against JAX's (1e-3), unguided and under CFG with the low-res batch doubled;
the encoder cache refusing model kwargs. ESRGAN: ``RRDBNet`` (2 blocks, 16
features) against JAX's on weights carried across by
``flax_rrdb_to_torch_state_dict`` (1e-4); a basicsr-named ``params_ema``
checkpoint loading with ``strict=True`` at the published width (16,697,987
parameters); ``esrgan_upsample_batches`` against JAX's on the same uint8
samples (within 1 count).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import traverse_util  # noqa: E402

from nicediffusion_tpu.diffusion.process import Diffusion as JaxDiffusion  # noqa: E402
from nicediffusion_tpu.models import rrdb as jrrdb  # noqa: E402
from nicediffusion_tpu.models.unet import SuperResolutionModel as JaxSR  # noqa: E402
from nicediffusion_tpu.ops.resize import resize_bilinear as jax_resize  # noqa: E402
from nicediffusion_tpu_torch import Diffusion  # noqa: E402
from nicediffusion_tpu_torch.models import rrdb  # noqa: E402
from nicediffusion_tpu_torch.models.unet import SuperResolutionModel  # noqa: E402
from nicediffusion_tpu_torch.ops.resize import resize_bilinear  # noqa: E402
from nicediffusion_tpu_torch.utils.convert import (  # noqa: E402
    flax_params_to_torch_state_dict,
    flax_rrdb_to_torch_state_dict,
)

# tests/test_sr_model.py's configuration, at 16x16 from an 8x8 low-res image
CFG = dict(
    model_channels=32, out_channels=3, num_res_blocks=1, attention_resolutions=(8,),
    channel_mult=(1, 2), num_heads=2, num_classes=None, dropout=0.0, resblock_updown=False,
    use_adaptive_gn=False, split_qkv_first=True,
)
SR = dict(CFG, resolution=16, in_channels=6)


def filled(shapes, seed):
    """Seeded fan-in-scaled values for every leaf of a parameter tree."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in traverse_util.flatten_dict(shapes).items():
        if path[-1] == "kernel":
            v = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif path[-1] == "scale":
            v = 1.0 + 0.2 * rng.normal(size=leaf.shape)
        elif path[-1] == "embedding":
            v = rng.normal(size=leaf.shape)
        else:
            v = 0.2 * rng.normal(size=leaf.shape)
        flat[path] = v.astype(np.float32)
    return traverse_util.unflatten_dict(flat)


def sr_pair(cfg=SR, seed=0):
    jmodel = JaxSR(**cfg)
    y = jnp.zeros((1,), jnp.int32) if cfg["num_classes"] else None
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32),
        low_res=jnp.zeros((1, 8, 8, 3)), y=y))["params"]
    params = filled(shapes, seed)
    model = SuperResolutionModel(**cfg, device="cpu").eval()
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                           flax_params_to_torch_state_dict(params).items()}, strict=True)
    return jmodel, params, model


@pytest.mark.parametrize("src,dst", [((8, 8), (16, 16)), ((8, 8), (32, 32)),
                                     ((6, 10), (9, 25)), ((64, 64), (256, 256)),
                                     ((16, 16), (6, 5))],
                         ids=["2x", "4x", "non_integer", "64_to_256", "down"])
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.default_rng(0).normal(size=(2, *src, 3)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), *dst))
    got = resize_bilinear(torch.from_numpy(x), *dst)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    if dst[0] % src[0] == 0 and dst[1] % src[1] == 0:
        # the package's ratios (2x, 4x): the same as torch's bilinear
        # interpolate with align_corners=False, which clamps at the edge
        lib = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), size=dst, mode="bilinear",
            align_corners=False).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), lib.numpy(), atol=1e-6, rtol=0)


def test_sr_model_matches_jax():
    jmodel, params, model = sr_pair()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    low = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    t = np.array([13, 513])
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, x, t, low_res=low))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t), low_res=torch.from_numpy(low))
    assert got.shape == (2, 16, 16, 3) and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    with pytest.raises(AssertionError, match="low_res"):
        model(torch.from_numpy(x), torch.from_numpy(t))


DIFF = dict(original_num_steps=40, rescaled_num_steps=8, sampling_var_type="small",
            loss_type="simple", beta_schedule="cosine", use_ddim=True, ddim_eta=0.0)


@pytest.mark.parametrize("guided", [False, True], ids=["unguided", "cfg_doubled_low_res"])
def test_ddim_chain_with_low_res_matches_jax(guided):
    cfg = dict(SR, num_classes=4) if guided else SR
    jmodel, params, model = sr_pair(cfg, seed=2)
    rng = np.random.default_rng(3)
    low = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    dkw, y = {}, None
    if guided:  # the model batch is doubled under CFG: so must low_res be
        dkw, y = dict(guidance_method="classifier_free", guidance_strength=1.5), np.array([1, 3])
        low_res = np.concatenate([low, low])
    else:
        low_res = low
    jd = JaxDiffusion(model=jmodel, **DIFF, **dkw).with_model_kwargs(low_res=jnp.asarray(low_res))
    want = np.asarray(jd.denoise(params, jax.random.PRNGKey(0), x=jnp.asarray(x),
                                 y=None if y is None else jnp.asarray(y)))
    pd = Diffusion(model=model, **DIFF, **dkw)
    assert pd.with_model_kwargs(low_res=torch.from_numpy(low_res)) is pd
    got = pd.denoise(x=torch.from_numpy(x), y=None if y is None else torch.from_numpy(y))
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_encoder_cache_refuses_model_kwargs():
    _, _, model = sr_pair()
    d = Diffusion(model=model, **DIFF).with_model_kwargs(low_res=torch.zeros(1, 8, 8, 3))
    with pytest.raises(NotImplementedError, match="encoder_cache"):
        d.denoise(x=torch.zeros(1, 16, 16, 3), encoder_cache=2)


# ---------------------------------------------------------------------------
# ESRGAN
# ---------------------------------------------------------------------------

SMALL = dict(num_feat=16, num_block=2)


def rrdb_pair(seed=0):
    jnet = jrrdb.RRDBNet(**SMALL)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 8, 8, 3))))["params"]
    params = filled(shapes, seed)
    net = rrdb.RRDBNet(**SMALL, device="cpu").eval()
    net.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                         flax_rrdb_to_torch_state_dict(params).items()}, strict=True)
    return jnet, params, net


def test_rrdbnet_matches_jax():
    jnet, params, net = rrdb_pair()
    x = np.random.default_rng(4).uniform(size=(2, 8, 8, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, x))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_basicsr_checkpoint_loads_strict(tmp_path):
    """The port's names are basicsr's: a ``{"params_ema": ...}`` file loads
    with ``strict=True``, and the JAX package's basicsr converter maps the
    same names onto its RRDBNet's tree, leaf for leaf."""
    net = rrdb.RRDBNet(device="meta")
    assert sum(p.numel() for p in net.parameters()) == 16_697_987  # RealESRGAN_x4plus
    names = [n for n, _ in net.named_parameters()]
    assert {"conv_first.weight", "body.22.rdb3.conv5.bias", "conv_hr.weight",
            "conv_last.bias"} <= set(names)
    _, _, small = rrdb_pair()
    path = str(tmp_path / "RealESRGAN_x4plus.pth")
    torch.save({"params_ema": small.state_dict()}, path)
    sd = rrdb.load_esrgan_params(path, device="cpu")
    rrdb.RRDBNet(**SMALL, device="cpu").load_state_dict(sd, strict=True)
    tree = jrrdb.convert_esrgan_state_dict(sd)
    shapes = jax.eval_shape(lambda: jrrdb.RRDBNet(**SMALL).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3))))["params"]
    assert jax.tree.map(np.shape, tree) == jax.tree.map(lambda s: s.shape, shapes)


def test_esrgan_upsample_batches_matches_jax(tmp_path, monkeypatch):
    """Both packages' stage at 2 blocks of 16 features (their RRDBNet
    narrowed by monkeypatching, on one basicsr-named file): the 4x images
    agree within one count (float noise at a rounding boundary), the
    bilinear 4x inputs too, the labels pass through."""
    _, _, small = rrdb_pair(seed=5)
    path = str(tmp_path / "RealESRGAN_x4plus.pth")
    torch.save({"params_ema": small.state_dict()}, path)
    monkeypatch.setattr(jrrdb, "RRDBNet", functools.partial(jrrdb.RRDBNet, **SMALL))
    monkeypatch.setattr(rrdb, "RRDBNet", functools.partial(rrdb.RRDBNet, **SMALL))
    rng = np.random.default_rng(6)
    samples = [(rng.integers(0, 256, size=(3, 8, 8, 3), dtype=np.uint8),
                rng.integers(0, 256, size=(3, 8, 8, 3), dtype=np.uint8),
                np.array([1, 2, 3]) if i == 0 else None) for i in range(2)]
    want = jrrdb.esrgan_upsample_batches(samples, model_path=path, batch_chunk=2)
    got = rrdb.esrgan_upsample_batches(samples, model_path=path, batch_chunk=2, device="cpu")
    for (wd, ws, wl), (gd, gs, gl) in zip(want, got):
        assert gs.shape == (3, 32, 32, 3) and gs.dtype == np.uint8 and gd.shape == gs.shape
        assert np.abs(gs.astype(int) - ws.astype(int)).max() <= 1
        assert np.abs(gd.astype(int) - wd.astype(int)).max() <= 1
        assert (gl is None and wl is None) or (gl == wl).all()
    assert any(s[1].std() > 0 for s in got)
    with pytest.raises(FileNotFoundError):
        rrdb.esrgan_upsample_batches(samples, model_path=str(tmp_path / "absent.pth"),
                                     device="cpu")
