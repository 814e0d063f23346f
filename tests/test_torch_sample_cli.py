"""The port's sampling entry point on the CPU:
``nicediffusion_tpu_torch.scripts.sample.main([...])`` with ``--cpu``.

A narrow ``--custom`` UNet and a narrow classifier come from ``.npz`` files
written by the JAX package's ``save_params_npz`` (flax ``init`` weights); the
classifier preset is monkeypatched in the port's config, as
tests/test_classifier.py does for the JAX package's.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from nicediffusion_tpu.models.classifier import EncoderUNet as JaxEncoderUNet  # noqa: E402
from nicediffusion_tpu.models.unet import DiffusionModel as JaxModel  # noqa: E402
from nicediffusion_tpu.utils.checkpoint import save_params_npz  # noqa: E402
from nicediffusion_tpu_torch.scripts.sample import main  # noqa: E402
from nicediffusion_tpu_torch.utils import config as config_mod  # noqa: E402
from nicediffusion_tpu_torch.utils.checkpoint import load_state_dict  # noqa: E402

TINY_CLS = dict(
    resolution=16, in_channels=1, model_channels=32, out_channels=10,
    num_res_blocks=1, attention_resolutions=(8,), channel_mult=(1, 2),
    num_head_channels=16, use_adaptive_gn=True, resblock_updown=True,
    pool="attention",
)
TINY_UNET = dict(
    resolution=16, in_channels=1, model_channels=32, out_channels=2,
    num_res_blocks=1, attention_resolutions=(8,), channel_mult=(1, 2),
    num_heads=2, num_classes=10, use_adaptive_gn=True,
    resblock_updown=True, split_qkv_first=True,
)
CUSTOM = [
    "--custom", "--resolution", "16", "--model_channels", "32",
    "--channel_mult", "1/2", "--num_res_blocks", "1",
    "--attention_resolutions", "8", "--in_channels", "1",
    "--num_heads", "2", "--num_classes", "10", "--split_qkv_first",
    "--resblock_updown", "--use_adaptive_gn",
    "--rescaled_num_steps", "5", "--original_num_steps", "40",
    "--beta_schedule", "cosine", "--sampling_var_type", "learned_interpolation",
]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(UNet .npz, classifier .npz) written by the JAX package."""
    root = tmp_path_factory.mktemp("ckpt")
    x, t0 = jnp.zeros((1, 16, 16, 1)), jnp.zeros((1,), jnp.int32)
    model_path = str(root / "tiny_model.npz")
    save_params_npz(JaxModel(**TINY_UNET).init(jax.random.PRNGKey(0), x, t0, t0)["params"],
                    model_path)
    cls_path = str(root / "64x64_tiny_classifier.npz")
    save_params_npz(JaxEncoderUNet(**TINY_CLS).init(jax.random.PRNGKey(1), x, t0)["params"],
                    cls_path)
    return model_path, cls_path


def _argv(model_path, out_dir, *extra, batch="2", samples="1"):
    os.makedirs(out_dir, exist_ok=True)
    return ["--model_path", model_path, *CUSTOM, "--batch_size", batch,
            "--num_samples", samples, "--save_path", out_dir, "--seed", "0", "--cpu", *extra]


GUIDED = ["--guidance_method", "classifier", "--guidance_strength", "1.0"]


def test_classifier_guided_sampling_writes_per_class_names(checkpoints, tmp_path, monkeypatch):
    """Classifier-guided sampling end to end: images land under the
    per-class-counter names, and the run repeats itself from its seed."""
    model_path, cls_path = checkpoints
    monkeypatch.setitem(config_mod.CLASSIFIER_PRESETS, "openai_64", TINY_CLS)
    out_dir = str(tmp_path / "out") + "/"
    argv = _argv(model_path, out_dir, *GUIDED, "--classifier_path", cls_path,
                 "--labels", "3/7/3", samples="3")
    samples = main(argv)
    assert sorted(os.listdir(out_dir)) == [
        "3_sample0.jpg", "3_sample1.jpg", "3_sample2.jpg", "3_sample3.jpg",
        "7_sample0.jpg", "7_sample1.jpg",
    ]
    assert Image.open(out_dir + "7_sample1.jpg").size == (16, 16)
    assert len(samples) == 3
    for (shown, out, labels), label in zip(samples, (3, 7, 3)):
        assert out.shape == shown.shape == (2, 16, 16, 3) and out.dtype == np.uint8
        assert labels.tolist() == [label, label]
    again = main(argv)
    for (_, a, _), (_, b, _) in zip(samples, again):
        np.testing.assert_array_equal(a, b)
    # unguided sampling of the same model gives other images
    plain = main(_argv(model_path, str(tmp_path / "plain") + "/", "--labels", "3/7/3",
                       samples="3"))
    assert any((a != b).any() for (_, a, _), (_, b, _) in zip(samples, plain))


def test_pt_state_dicts_and_space_joined_arguments(checkpoints, tmp_path, monkeypatch):
    """A ``.pt`` state dict of each model works as the ``.npz`` does, random
    labels come from the seed, and space-joined arguments are re-split."""
    model_path, cls_path = checkpoints
    monkeypatch.setitem(config_mod.CLASSIFIER_PRESETS, "openai_64", TINY_CLS)
    pt_model = str(tmp_path / "tiny_model.pt")
    pt_cls = str(tmp_path / "64x64_tiny_classifier.pt")
    torch.save(load_state_dict(model_path, device="cpu"), pt_model)
    torch.save(load_state_dict(cls_path, device="cpu"), pt_cls)
    ref = main(_argv(model_path, str(tmp_path / "a") + "/", *GUIDED,
                     "--classifier_path", cls_path))
    argv = _argv(pt_model, str(tmp_path / "b") + "/", "--classifier_path " + pt_cls,
                 " ".join(GUIDED))
    out = main(argv)
    np.testing.assert_array_equal(out[0][1], ref[0][1])
    np.testing.assert_array_equal(out[0][2], ref[0][2])
    names = sorted(os.listdir(str(tmp_path / "b")))
    assert len(names) == 2 and all(n.endswith(".jpg") for n in names)
    assert sorted(int(n.split("_")[0]) for n in names) == sorted(out[0][2].tolist())


def test_start_image_partial_denoising(checkpoints, tmp_path):
    """``--start_img`` with ``--steps_to_do`` diffuses the image and denoises
    it back over the matching share of the chain."""
    model_path, _ = checkpoints
    rng = np.random.default_rng(0)
    img_path = str(tmp_path / "start.png")
    Image.fromarray(rng.integers(0, 255, size=(20, 20, 3), dtype=np.uint8)).save(img_path)
    out_dir = str(tmp_path / "out") + "/"
    samples = main(_argv(model_path, out_dir, "--labels", "4", "--start_img", img_path,
                         "--steps_to_do", "16"))
    assert sorted(os.listdir(out_dir)) == ["4_sample0.jpg", "4_sample1.jpg"]
    shown, out, _ = samples[0]
    assert shown.shape == out.shape == (2, 16, 16, 3)
    np.testing.assert_array_equal(shown[0], shown[1])  # the start image, repeated
    assert shown.std() > 0


def test_unconditional_model_saves_running_names(tmp_path):
    cfg = dict(TINY_UNET, num_classes=None, in_channels=3, out_channels=6)
    x, t0 = jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32)
    model_path = str(tmp_path / "uncond.npz")
    save_params_npz(JaxModel(**cfg).init(jax.random.PRNGKey(0), x, t0, None)["params"],
                    model_path)
    out_dir = str(tmp_path / "out") + "/"
    argv = [a for a in _argv(model_path, out_dir) if a not in ("--num_classes", "10")]
    argv[argv.index("--in_channels") + 1] = "3"
    samples = main(argv)
    assert sorted(os.listdir(out_dir)) == ["sample0.jpg", "sample1.jpg"]
    assert samples[0][2] is None and samples[0][1].shape == (2, 16, 16, 3)


CFG_FLAGS = ["--guidance_method", "classifier_free", "--guidance_strength", "0.8"]


@pytest.mark.parametrize("flags", [
    ("--sampler", "dpm++"), ("--prediction_type", "v"), ("--dynamic_thresholding",),
    ("--dynamic_thresholding", "0.9"), ("--encoder_cache", "2"),
    ("--guidance_interval", "0.0", "0.6"),
    ("--sampler", "dpm++", "--dynamic_thresholding", "0.995", "--encoder_cache", "3",
     "--guidance_interval", "0.0", "0.6", "--prediction_type", "v"),
], ids=lambda f: "+".join(a.lstrip("-") for a in f if a.startswith("--")))
def test_fast_sampling_flags_reach_the_chain(checkpoints, tmp_path, monkeypatch, flags):
    """Each fast-sampling flag is passed through under ``--cpu``: the
    Diffusion is built with it and ``denoise`` is called with it."""
    from nicediffusion_tpu_torch.diffusion.process import Diffusion

    model_path, _ = checkpoints
    seen = {}
    inner = Diffusion.denoise

    def spy(self, *args, **kw):
        seen.update(sampler=self.sampler, clip_x=self.clip_x, q=self.dynamic_threshold,
                    prediction_type=self.prediction_type,
                    encoder_cache=kw["encoder_cache"], interval=kw["guidance_interval"])
        return inner(self, *args, **kw)

    monkeypatch.setattr(Diffusion, "denoise", spy)
    out_dir = str(tmp_path / "out") + "/"
    argv = _argv(model_path, out_dir, *CFG_FLAGS, "--labels", "3", *flags)
    argv[argv.index("--num_classes") + 1] = "9"  # CFG adds the null class: 10 rows
    samples = main(argv)
    assert sorted(os.listdir(out_dir)) == ["3_sample0.jpg", "3_sample1.jpg"]
    assert samples[0][1].shape == (2, 16, 16, 3) and samples[0][1].dtype == np.uint8

    def given(flag, default, parse=str):
        if flag not in flags:
            return default
        nxt = flags[flags.index(flag) + 1:flags.index(flag) + 2]
        return parse(nxt[0]) if nxt and not nxt[0].startswith("--") else "bare"

    assert seen["sampler"] == given("--sampler", "ddpm")
    assert seen["prediction_type"] == given("--prediction_type", "eps")
    assert seen["encoder_cache"] == given("--encoder_cache", None, int)
    assert seen["interval"] == ((0.0, 0.6) if "--guidance_interval" in flags else None)
    q = given("--dynamic_thresholding", None, float)
    assert seen["clip_x"] == (True if q is None else "dynamic")
    if q is not None:
        assert seen["q"] == (0.995 if q == "bare" else q)


def test_guidance_interval_wants_classifier_free_guidance(checkpoints, tmp_path):
    model_path, _ = checkpoints
    with pytest.raises(ValueError, match="requires classifier-free guidance"):
        main(_argv(model_path, str(tmp_path / "out") + "/", "--guidance_interval", "0.0", "0.6"))


@pytest.mark.parametrize("flags", [
    ("--dtype", "int8"), ("--int8_calibration", "calib.npz"), ("--data_parallel",),
    ("--upsample",),
], ids=lambda f: f[0].lstrip("-"))
def test_unported_flags_name_their_roadmap_entry(flags, checkpoints, tmp_path, capsys,
                                                monkeypatch):
    """Raised before any model is built: the checkpoint does not exist.
    Static int8 is ported: ``--dtype int8`` samples through the quantized
    model, calibrated on the spot, and ``--int8_calibration`` (with it) writes
    the calibration file on the first run and serves from it on the next.
    ``--upsample`` is ported: without ``models/RealESRGAN_x4plus.pth`` under
    the working directory it prints the skip message and keeps the images;
    with random full-width ESRGAN weights there (basicsr names, inside
    ``params_ema``) every saved image is 4x."""
    if flags[0] == "--upsample":
        from nicediffusion_tpu_torch.models.rrdb import RRDBNet

        model_path, _ = checkpoints
        monkeypatch.chdir(tmp_path)
        skipped = main(_argv(model_path, str(tmp_path / "skip") + "/", *flags))
        assert "Skipping --upsample" in capsys.readouterr().out
        assert skipped[0][1].shape == (2, 16, 16, 3)
        os.makedirs(tmp_path / "models")
        torch.manual_seed(0)  # the module initialisers draw from the global RNG
        torch.save({"params_ema": RRDBNet(device="cpu").state_dict()},
                   tmp_path / "models" / "RealESRGAN_x4plus.pth")
        out_dir = str(tmp_path / "up") + "/"
        upsampled = main(_argv(model_path, out_dir, *flags))
        assert "Skipping" not in capsys.readouterr().out
        shown, out, _ = upsampled[0]
        assert out.shape == shown.shape == (2, 64, 64, 3) and out.dtype == np.uint8
        assert out.std() > 0
        names = sorted(os.listdir(out_dir))
        assert len(names) == 2 and Image.open(out_dir + names[0]).size == (64, 64)
        return
    if flags[0] in ("--dtype", "--int8_calibration"):
        model_path, _ = checkpoints
        extra = ("--dtype", "int8", "--int8_calibration", str(tmp_path / flags[1])) \
            if flags[0] == "--int8_calibration" else flags
        runs = [main(_argv(model_path, str(tmp_path / f"out{i}") + "/", *extra))
                for i in range(2)]
        assert runs[0][0][1].shape == (2, 16, 16, 3) and runs[0][0][1].std() > 0
        np.testing.assert_array_equal(runs[0][0][1], runs[1][0][1])
        assert os.path.exists(tmp_path / flags[1]) == (flags[0] == "--int8_calibration")
        return
    argv = _argv(str(tmp_path / "absent.npz"), str(tmp_path / "out") + "/", *flags)
    with pytest.raises(NotImplementedError, match=r"ROADMAP queue A") as err:
        main(argv)
    assert flags[0] in str(err.value)


def test_wrong_label_count_asserts(checkpoints, tmp_path):
    model_path, _ = checkpoints
    with pytest.raises(AssertionError, match="NUM_SAMPLES=2"):
        main(_argv(model_path, str(tmp_path / "out") + "/", "--labels", "3", samples="2"))


def test_without_cpu_flag_the_entry_point_wants_the_card(checkpoints, tmp_path):
    """No quiet CPU run: without ``--cpu`` and without a card it raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    model_path, _ = checkpoints
    argv = [a for a in _argv(model_path, str(tmp_path / "out") + "/") if a != "--cpu"]
    with pytest.raises(RuntimeError, match="--cpu"):
        main(argv)
