"""The port's evaluation tools (nicediffusion_tpu_torch/tools/) against the
JAX package's (tools/), on the CPU.

  * eval_nll: the synthetic images and labels bit-equal to the JAX tool's
    recipe; the loop with injected noise against the JAX ``Diffusion``'s
    per-t terms (1e-4); the entry point prints the JAX tool's keys;
  * verify_checkpoint: a sound EMNIST ``.pt``, one with a tensor dropped and
    one with a tensor reshaped, through the port's tool and the JAX tool (run
    as a subprocess): the same checks, verdicts, exit codes and parameter
    count; a classifier; the fixed-input forward against the JAX
    ``DiffusionModel`` on the same file (1e-3), also through the tool's
    reference-parity step with a stand-in reference package;
  * quality_eval: ``frechet`` against the JAX tool's (1e-10 relative), two
    classifier AdamW steps against optax's ``adamw`` (1e-5 of each
    parameter's largest element, where the gradient is live), the synthetic
    stream and the configurations equal to the JAX tool's, ``main()`` on the
    CPU at tiny sizes with every mode's line, and a variance weight of 0
    read as off.

Every tool raises without a card unless asked for the CPU.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nicediffusion_tpu.diffusion.process import Diffusion as JaxDiffusion  # noqa: E402
from nicediffusion_tpu.diffusion.process import _bcast as jax_bcast  # noqa: E402
from nicediffusion_tpu.models.classifier import EncoderUNet as JaxEncoderUNet  # noqa: E402
from nicediffusion_tpu.ops.math import kl_div as jax_kl_div  # noqa: E402
from nicediffusion_tpu.ops.math import mean_flat as jax_mean_flat  # noqa: E402
from nicediffusion_tpu_torch import Diffusion, DiffusionModel, EncoderUNet  # noqa: E402
from nicediffusion_tpu_torch.tools import eval_nll, quality_eval, verify_checkpoint  # noqa: E402
from nicediffusion_tpu_torch.utils import config as port_config  # noqa: E402
from nicediffusion_tpu_torch.utils.convert import (  # noqa: E402
    convert_torch_state_dict,
    flax_params_to_torch_state_dict,
)
from test_torch_unet import port_model, random_jax_params  # noqa: E402

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
# the keys of a mode's line in the JAX tool (tools/quality_eval.py:829-838)
MODE_KEYS = ["classifier_acc", "classifier_acc_se", "proto_acc", "proto_acc_se",
             "logit_frechet_vs_real", "logit_frechet_se", "max_pixel_dev_vs_exact",
             "mean_pixel_dev_vs_exact"]
# the keys of the JAX eval_nll's line (tools/eval_nll.py:107-114)
NLL_KEYS = ["model_path", "num_images", "chain_steps", "total_bpd", "prior_bpd",
            "eps_mse_mean"]


def _jax_tool(name, arch="emnist"):
    """The JAX package's tools/<name>.py as a module, loaded by path (its
    ``_env`` bootstrap from tools/ on the import path); ``QE_ARCH`` is read
    at its import."""
    key = f"_jax_tool_{name}_{arch}"
    if key not in sys.modules:
        prev = os.environ.get("QE_ARCH")
        os.environ["QE_ARCH"] = arch
        sys.path.insert(0, str(REPO / "tools"))
        try:
            spec = importlib.util.spec_from_file_location(key, REPO / "tools" / f"{name}.py")
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            sys.modules[key] = module
        finally:
            sys.path.remove(str(REPO / "tools"))
            if prev is None:
                os.environ.pop("QE_ARCH")
            else:
                os.environ["QE_ARCH"] = prev
    return sys.modules[key]


# ---------------------------------------------------------------------------
# every tool: the card unless the CPU is asked for
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool", ["eval_nll", "verify_checkpoint", "quality_eval"])
def test_tools_raise_without_a_card_unless_asked_for_the_cpu(tool, tmp_path, monkeypatch):
    monkeypatch.delenv("QE_DEVICE", raising=False)
    # no card: what the tools see (monkeypatched, so the check holds on any machine)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "EMNIST_model.pt")
    argv = {"eval_nll": ["--model_path", path], "verify_checkpoint": ["--pt", path],
            "quality_eval": []}[tool]
    torch.save({}, path)
    main = {"eval_nll": eval_nll, "verify_checkpoint": verify_checkpoint,
            "quality_eval": quality_eval}[tool].main
    ask = "set QE_DEVICE=cpu" if tool == "quality_eval" else "pass --cpu"
    with pytest.raises(RuntimeError, match=f"CUDA card.*; {ask} to run on the CPU"):
        main(argv)


# ---------------------------------------------------------------------------
# eval_nll
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("res,ch,n_cls,seed", [(28, 1, 27, 0), (64, 3, 1000, 3), (16, 3, None, 7)])
def test_eval_nll_synthetic_images_bit_equal_to_the_jax_recipe(res, ch, n_cls, seed):
    """The JAX tool's recipe (tools/eval_nll.py:83-93), re-run here from the
    same numpy seed."""
    n = 6
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:res, 0:res] / res
    phase = rng.uniform(0, 2 * np.pi, size=(n, 1, 1, ch))
    freq = rng.uniform(1, 3, size=(n, 1, 1, ch))
    want = np.sin(2 * np.pi * freq * (yy + xx)[None, :, :, None] + phase).astype(np.float32) * 0.8
    want_labels = rng.integers(0, n_cls, size=(n,)) if n_cls is not None else None

    images, labels = eval_nll.synthetic_images(np.random.default_rng(seed), n, res, ch, n_cls)
    assert images.dtype == np.float32 and images.shape == (n, res, res, ch)
    np.testing.assert_array_equal(images, want)
    if n_cls is None:
        assert labels is None
    else:
        np.testing.assert_array_equal(labels, want_labels)


# a small conditional UNet with learned-interpolation variances; the output
# conv scaled down so the raw log-variance stays in its interpolation range,
# as a trained model's does (tests/test_torch_losses.py)
SMALL = dict(resolution=8, in_channels=2, model_channels=32, out_channels=4,
             num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2),
             num_heads=2, split_qkv_first=True, resblock_updown=True,
             use_adaptive_gn=True, num_classes=5, dropout=0.0)
SMALL_DIFF = dict(original_num_steps=1000, rescaled_num_steps=8, beta_schedule="cosine",
                  sampling_var_type="learned_interpolation", loss_type="hybrid")


def test_eval_nll_loop_matches_jax_per_t_terms():
    """``evaluate`` over two batches with injected noise against the JAX
    ``Diffusion``'s per-t terms on the same noise (the JAX ``bpd`` draws
    inside its scan), aggregated as the JAX tool aggregates them."""
    jmodel, params = random_jax_params(SMALL, seed=5)
    last = params["out"]["layers_2"]
    last["kernel"], last["bias"] = 0.1 * last["kernel"], 0.1 * last["bias"]
    model = port_model(SMALL, params)
    jd = JaxDiffusion(model=jmodel, **SMALL_DIFF)
    td = Diffusion(model=model, **SMALL_DIFF)
    batch, batches, steps = 3, 2, SMALL_DIFF["rescaled_num_steps"]
    images, labels = eval_nll.synthetic_images(np.random.default_rng(1), batch * batches, 8, 2, 5)
    noises = np.random.default_rng(2).normal(
        size=(batches, steps, batch, 8, 8, 2)).astype(np.float32)

    eps_and_log_var = jax.jit(jd.get_eps_and_log_var)
    totals, priors, mses = [], [], []
    for i in range(batches):
        x0 = images[i * batch:(i + 1) * batch]
        y = jnp.asarray(labels[i * batch:(i + 1) * batch])
        vlb, mse = [], []
        for ts in range(steps):
            t = jnp.full((batch,), ts, jnp.int32)
            noise = noises[i, ts]
            x_t = jd.q_sample(x0, t, noise)
            eps, log_var = eps_and_log_var(params, x_t, t, y)
            vlb.append(np.asarray(jd.variational_lower_bound(x0, x_t, t, eps, log_var)))
            mse.append(np.asarray(jax_mean_flat((eps - noise) ** 2)))
        t_last = jnp.full((batch,), steps - 1, jnp.int32)
        mean_t = jax_bcast(jd._sqrt_acp, t_last, 4) * x0
        log_var_t = jnp.broadcast_to(jnp.log1p(-jax_bcast(jd._acp, t_last, 4)), x0.shape)
        prior = np.asarray(jax_mean_flat(jax_kl_div(mean_t, log_var_t, 0.0 * mean_t,
                                                    0.0 * mean_t))) / np.log(2.0)
        totals.append(np.stack(vlb).sum(0) + prior)
        priors.append(prior)
        mses.append(np.stack(mse).mean(axis=1))
    want = {"total_bpd": float(np.concatenate(totals).mean()),
            "prior_bpd": float(np.concatenate(priors).mean()),
            "eps_mse_mean": float(np.stack(mses).mean())}

    got = eval_nll.evaluate(td, images, labels, batch, batches, noises=noises)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)
    # drawn noise: reproducible from the generator's seed
    a = eval_nll.evaluate(td, images, labels, batch, batches, torch.Generator().manual_seed(0))
    b = eval_nll.evaluate(td, images, labels, batch, batches, torch.Generator().manual_seed(0))
    assert a == b


@pytest.fixture(scope="module")
def emnist_weights():
    """Seeded JAX parameters of the EMNIST preset as ``preset_for_path``
    builds it (27 classes), and the same weights under the port's names."""
    cfg, _ = port_config.preset_for_path("EMNIST_model.pt")
    jmodel, params = random_jax_params(cfg, seed=3)
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in flax_params_to_torch_state_dict(params).items()}
    return cfg, jmodel, params, sd


@pytest.fixture(scope="module")
def emnist_files(tmp_path_factory, emnist_weights):
    """Three EMNIST ``.pt`` files written by the port: sound, one tensor
    dropped, one tensor reshaped."""
    _, _, _, sd = emnist_weights
    root = tmp_path_factory.mktemp("ckpt")
    files = {"sound": dict(sd), "dropped": dict(sd), "reshaped": dict(sd)}
    del files["dropped"]["upsampling.0.0.in_conv.weight"]
    w = sd["downsampling.4.0.in_conv.weight"]  # (128, 64, 3, 3)
    files["reshaped"]["downsampling.4.0.in_conv.weight"] = w.reshape(64, 128, 3, 3)
    paths = {}
    for name, state in files.items():
        paths[name] = str(root / f"EMNIST_{name}.pt")
        torch.save(state, paths[name])
    return paths


def test_eval_nll_entry_point_prints_the_jax_keys(emnist_files, tmp_path, capsys):
    path = emnist_files["sound"]
    assert eval_nll.main(["--model_path", path, "--cpu", "--batch_size", "2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == NLL_KEYS
    assert line["chain_steps"] == 25 and line["num_images"] == 2 and line["model_path"] == path
    assert all(np.isfinite(line[k]) for k in NLL_KEYS[3:])
    # --data without the labels a class-conditional model needs: exit 1
    data = str(tmp_path / "images.npz")
    np.savez(data, images=np.zeros((4, 28, 28, 1), np.uint8))
    assert eval_nll.main(["--model_path", path, "--cpu", "--data", data]) == 1
    assert "needs the true labels" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# verify_checkpoint
# ---------------------------------------------------------------------------

def _verdicts(stdout):
    """[(status, check name)] of a verify_checkpoint report."""
    out = []
    for line in stdout.splitlines():
        if line.startswith("["):
            status, rest = line[1:].split("] ", 1)
            out.append((status, rest.split(":", 1)[0]))
    return out


def _line(stdout, name):
    return next(line for line in stdout.splitlines() if f"] {name}" in line)


@pytest.mark.parametrize("which,rc,detail", [
    ("sound", 0, "309 leaves"), ("dropped", 1, "missing 1 "), ("reshaped", 1, "mismatched 1 ")])
def test_verify_checkpoint_matches_the_jax_tool(emnist_files, capsys, which, rc, detail):
    path = emnist_files[which]
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "verify_checkpoint.py"), "--pt", path,
         "--skip-sample"], cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    got_rc = verify_checkpoint.main(["--pt", path, "--cpu", "--skip-sample"])
    port = capsys.readouterr().out
    assert (got_rc, proc.returncode) == (rc, rc), proc.stderr[-2000:]
    assert _verdicts(port) == _verdicts(proc.stdout)
    assert detail in _line(port, "structural match")
    assert detail in _line(proc.stdout, "structural match")
    assert _line(port, "torch load") == _line(proc.stdout, "torch load")
    if which == "sound":
        assert _line(port, "param count") == _line(proc.stdout, "param count") == (
            "[PASS] param count: 17,989,442 vs published 17,989,442")
        assert port.rstrip().endswith("ALL CHECKS PASSED")
    else:  # both stop at the failed structural match
        assert port.rstrip().splitlines()[-1] == _line(port, "structural match")


def test_verify_checkpoint_smoke_sample(emnist_files, capsys):
    assert verify_checkpoint.main(["--pt", emnist_files["sound"], "--cpu"]) == 0
    assert "[PASS] 2-step smoke sample: output (1, 28, 28, 1), finite=True" in (
        capsys.readouterr().out)


TINY_CLS = dict(resolution=16, in_channels=3, model_channels=32, out_channels=10,
                num_res_blocks=1, attention_resolutions=(8,), channel_mult=(1, 2),
                num_head_channels=32, use_adaptive_gn=True, resblock_updown=True,
                split_qkv_first=False, pool="attention", dropout=0.0)


def test_verify_checkpoint_classifier(tmp_path, capsys, monkeypatch):
    """A classifier ``.pt`` with ``--classifier``: dispatched by path (a
    small stand-in for the 64x64 preset), matched, exit 0; the count, the
    reference parity and the sample are skipped as in the JAX tool."""
    monkeypatch.setitem(port_config.CLASSIFIER_PRESETS, "openai_64", TINY_CLS)
    path = str(tmp_path / "64x64_classifier.pt")
    torch.manual_seed(0)
    torch.save(EncoderUNet(**TINY_CLS, device="cpu").state_dict(), path)
    assert verify_checkpoint.main(["--pt", path, "--classifier", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert _verdicts(out) == [
        ("PASS", "torch load"), ("PASS", "preset dispatch"), ("PASS", "conversion"),
        ("PASS", "structural match"), ("SKIP", "param count"),
        ("SKIP", "reference forward parity"), ("SKIP", "2-step smoke sample")]
    assert "reference has no classifier" in out


_STAND_IN = '''
"""A stand-in for the original reference's model module: the JAX package's
DiffusionModel on the converted state dict, behind the reference's
constructor and load_state_dict."""
import jax.numpy as jnp
import numpy as np
import torch

from nicediffusion_tpu.models.unet import DiffusionModel as _Jax
from nicediffusion_tpu.utils.convert import convert_torch_state_dict


class DiffusionModel(torch.nn.Module):
    def __init__(self, **cfg):
        super().__init__()
        self.model = _Jax(**cfg)

    def load_state_dict(self, sd, strict=True):
        self.params = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})

    def forward(self, x, t, y=None):
        out = self.model.apply({"params": self.params},
                               jnp.asarray(x.numpy().transpose(0, 2, 3, 1)),
                               jnp.asarray(t.numpy()),
                               None if y is None else jnp.asarray(y.numpy()))
        return torch.from_numpy(np.asarray(out).transpose(0, 3, 1, 2).copy())
'''


def test_verify_checkpoint_forward_matches_jax(emnist_weights, emnist_files, tmp_path, capsys,
                                               monkeypatch):
    """The tool's fixed (x, t, y) through the port's model loaded from the
    file against the JAX DiffusionModel on ``convert_torch_state_dict`` of
    the same file, to 1e-3; and the tool's reference-parity step passing
    with a stand-in reference package that runs that JAX model."""
    cfg, jmodel, _, _ = emnist_weights
    path = emnist_files["sound"]
    sd = torch.load(path, weights_only=True)
    x, t, y = verify_checkpoint.parity_inputs(cfg)
    ref = np.asarray(jmodel.apply(
        {"params": convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})},
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t), jnp.asarray(y)))
    ref = ref.transpose(0, 3, 1, 2)
    model = DiffusionModel(**cfg, device="cpu").eval()
    model.load_state_dict(sd, strict=True)
    out = verify_checkpoint.port_forward(model, x, t, y)
    assert out.shape == (2, 2, 28, 28) and np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)

    package = tmp_path / "reference" / "nicediffusion"
    package.mkdir(parents=True)
    (package / "__init__.py").write_text("")
    (package / "model.py").write_text(_STAND_IN)
    for name in ("nicediffusion", "nicediffusion.model"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setattr(sys, "path", list(sys.path))
    try:
        rc = verify_checkpoint.main(["--pt", path, "--cpu", "--skip-sample",
                                     "--reference_path", str(tmp_path / "reference")])
    finally:
        for name in ("nicediffusion", "nicediffusion.model"):
            sys.modules.pop(name, None)
    stdout = capsys.readouterr().out
    assert rc == 0, stdout
    assert _line(stdout, "reference forward parity").startswith("[PASS]")


# ---------------------------------------------------------------------------
# quality_eval
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,shift", [(256, 28, 0.0), (128, 28, 0.5), (300, 6, 2.0)])
def test_frechet_matches_the_jax_tool(n, d, shift):
    rng = np.random.default_rng(n + d)
    a = rng.normal(size=(n, d)) @ rng.normal(size=(d, d))
    b = rng.normal(size=(n, d)) * 1.5 + shift
    want = _jax_tool("quality_eval").frechet(a, b)
    got = quality_eval.frechet(a, b)
    assert want > 0
    assert abs(got - want) <= 1e-10 * abs(want)


@pytest.mark.parametrize("seed", [0, 1, 9])
def test_shifted_synthetic_bit_equal_to_the_jax_tool(seed):
    want = _jax_tool("quality_eval").shifted_synthetic(16, seed=seed)
    got = quality_eval.shifted_synthetic(16, seed=seed)
    for _ in range(3):
        (wx, wy), (gx, gy) = next(want), next(got)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert gy.min() >= 1 and gy.max() <= 27


@pytest.mark.parametrize("arch", ["emnist", "im64"])
def test_arch_configs_equal_the_jax_tool(arch):
    """The UNet's and the classifier's configurations, which the JAX tool
    reads from ``QE_ARCH`` at its import and the port in ``main``."""
    tool = _jax_tool("quality_eval", arch)
    assert quality_eval.arch_config(arch) == (tool.RESOLUTION, tool.MODEL_CFG, tool.CLS_CFG)


def test_classifier_adamw_steps_match_optax():
    """Two steps of the port's ``train_classifier`` from the JAX tool's
    initial weights against the JAX tool's ``train_classifier`` (optax's
    ``adamw(1e-3, weight_decay=1e-4)``) on the same batches: every parameter
    to 1e-5 of its largest element (3e-5 for a tensor that starts at zero:
    its elements are then of the updates' size, where optax's f32 bias
    correction carries 1e-5 of relative error), on the elements whose
    gradient is, at each step, exactly zero or at least 1e-3 of its
    parameter's largest in a parameter whose largest is at least 1e-6 of the
    model's. The zero-initialised head and output convs give much of the
    trunk zero gradients (weight decay alone moves it); AdamW turns float
    noise on a zero gradient, such as that of the biases before a GroupNorm
    whose groups hold one channel, into a move of up to the rate."""
    tool = _jax_tool("quality_eval")
    _, _, cls_cfg = quality_eval.arch_config("emnist")
    batch = 8
    gen = tool.shifted_synthetic(batch, seed=1)
    x0, _ = next(gen)
    steps = [next(gen) for _ in range(2)]
    jmodel = JaxEncoderUNet(**tool.CLS_CFG)
    zeros = jnp.zeros((batch,), jnp.int32)
    init = jmodel.init(jax.random.PRNGKey(5), jnp.asarray(x0), zeros)["params"]

    @jax.jit
    def grad_fn(p, x, y):
        def loss_fn(p):
            logits = jmodel.apply({"params": p}, x, zeros)
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        return jax.grad(loss_fn)(p)

    # the gradients at both steps (the first update as the tool makes it)
    tx = optax.adamw(1e-3, weight_decay=1e-4)
    g1 = grad_fn(init, jnp.asarray(steps[0][0]), jnp.asarray(steps[0][1]))
    updates, _ = tx.update(g1, tx.init(init), init)
    g2 = grad_fn(optax.apply_updates(init, updates), jnp.asarray(steps[1][0]),
                 jnp.asarray(steps[1][1]))
    grads = [flax_params_to_torch_state_dict(jax.tree.map(np.asarray, g)) for g in (g1, g2)]
    _, want = tool.train_classifier(2, batch, jax.random.PRNGKey(5))
    want = flax_params_to_torch_state_dict(jax.tree.map(np.asarray, want))
    start = {k: torch.from_numpy(np.array(v))
             for k, v in flax_params_to_torch_state_dict(jax.tree.map(np.asarray, init)).items()}

    model = quality_eval.train_classifier(2, batch, torch.device("cpu"), cls_cfg, 28,
                                          init_state=start)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    tops = [max(np.abs(g).max() for g in step.values()) for step in grads]
    compared = 0
    for name, w in want.items():
        live = [(np.abs(g[name]) >= 1e-3 * np.abs(g[name]).max())
                & (np.abs(g[name]).max() >= 1e-6 * top) for g, top in zip(grads, tops)]
        mask = ((grads[0][name] == 0) | live[0]) & ((grads[1][name] == 0) | live[1])
        compared += int(mask.sum())
        err = np.abs(got[name].numpy() - w)[mask]
        # a tensor that starts at zero ends at the updates' size, where
        # optax's f32 bias correction shows (2e-5 relative on 1 - 0.999**2,
        # 1e-5 after the square root; torch forms it in float64)
        rel = 3e-5 if not start[name].any() else 1e-5
        assert err.size == 0 or err.max() <= rel * np.abs(w).max(), name
        # the two steps moved what had a gradient
        moved = np.abs(w - start[name].numpy())[mask & (live[0] | live[1])]
        assert moved.size == 0 or moved.max() > 1e-4, name
    assert compared > 0.9 * sum(v.size for v in want.values())


# the quality UNet cut to 8x8 and one block a level for the CPU; dropout 0,
# since the two frameworks draw their dropout masks apart
TINY_QE = dict(resolution=8, in_channels=1, model_channels=32, out_channels=2,
               num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2), num_heads=2,
               num_classes=quality_eval.NUM_CLASSES, dropout=0.0, use_adaptive_gn=True,
               resblock_updown=True, split_qkv_first=True)


def _agreeing(port_grads, jax_grads, name):
    """Where each step's gradient is exactly zero in both frameworks, or is
    at least 1e-6 of the step's largest (above the float noise of the sums)
    and the two agree to 1e-5 of the element: the elements on which AdamW,
    which divides by the gradient's own size, does not turn float noise into
    a move of up to the rate."""
    mask = True
    for pg, jg in zip(port_grads, jax_grads):
        p, j = pg[name], jg[name]
        top = max(np.abs(g).max() for g in jg.values())
        mask = mask & (((p == 0) & (j == 0))
                       | ((np.abs(j) >= 1e-6 * top) & (np.abs(p - j) <= 1e-5 * np.abs(j))))
    return mask


def test_train_unet_steps_match_the_jax_tool(monkeypatch, tmp_path):
    """Two steps of the port's ``train_unet`` against the JAX tool's
    ``train_unet`` (the JAX Trainer: its lr, weight decay, EMA rate, label
    drop and diffusion arguments) at TINY_QE: the JAX run's initial weights
    carried across, the same batches (both tools' synthetic streams), and the
    t, noise and label drop the JAX step draws from its key injected into the
    port's steps. The losses to 1e-5 relative; each step's gradients to 1e-4
    of the step's largest (the repo's bar); the weights and the EMA weights to
    1e-5 of each parameter's largest element (3e-5 for a tensor that starts
    at zero: it holds the two updates themselves, where optax's bias
    correction, 1 - 0.999**t formed in f32, shows), on the elements
    ``_agreeing`` keeps (over 90% of them)."""
    tool = _jax_tool("quality_eval")
    monkeypatch.setattr(tool, "MODEL_CFG", TINY_QE)
    monkeypatch.setattr(tool, "RESOLUTION", TINY_QE["resolution"])
    batch, steps = 4, 2
    jax_run = {"states": [], "draws": [], "losses": []}

    class RecordingJaxTrainer(tool.Trainer):
        def __init__(self, **kwargs):
            super().__init__(**dict(kwargs, checkpoint_dir=str(tmp_path / "jax")))
            jax_run["trainer"] = self
            inner = self._train_step

            def step(state, b, y, rng):
                jax_run["states"].append(jax.tree.map(np.asarray, state.params))
                jax_run["draws"].append((np.asarray(b), np.asarray(y), rng))
                state, metrics = inner(state, b, y, rng)
                jax_run["losses"].append(float(metrics["loss"]))
                return state, metrics
            self._train_step = step

    monkeypatch.setattr(tool, "Trainer", RecordingJaxTrainer)
    _, want_ema = tool.train_unet(steps, batch, jnp.float32)
    jtrainer = jax_run["trainer"]
    diffusion = jtrainer.train_diffusion
    n_steps = diffusion.rescaled_num_steps

    # the draws inside the JAX step (nicediffusion_tpu/training/trainer.py
    # train_step, and Diffusion.loss's noise), and its gradients on them
    grad_fn = jax.jit(jax.grad(lambda p, b, t, y, noise: diffusion.loss(
        p, b, t, None, y=y, noise=noise).mean()))
    injected, grads = [], []
    for params, (b, y, rng) in zip(jax_run["states"], jax_run["draws"]):
        rng_t, rng_noise, rng_drop, _ = jax.random.split(rng, 4)
        t = jax.random.randint(rng_t, (batch,), 0, n_steps, dtype=jnp.int32)
        drop = jax.random.bernoulli(rng_drop, jtrainer.label_drop_prob, (batch,))
        noise = jax.random.normal(jax.random.split(rng_noise)[1], b.shape, dtype=b.dtype)
        g = grad_fn(params, b, t, jnp.where(drop, 0, y), noise)
        grads.append(flax_params_to_torch_state_dict(jax.tree.map(np.asarray, g)))
        injected.append(dict(t=np.array(t), noise=np.array(noise), drop=np.array(drop)))
    start = {k: torch.from_numpy(np.array(v))
             for k, v in flax_params_to_torch_state_dict(jax_run["states"][0]).items()}

    port_run = {"losses": [], "batches": [], "grads": []}

    class InjectedTrainer(quality_eval.Trainer):
        def __init__(self, model, **kwargs):
            model.load_state_dict(start, strict=True)
            super().__init__(model=model, **kwargs)
            port_run["trainer"] = self

        def train_step(self, batch, labels):
            port_run["batches"].append((np.asarray(batch), np.asarray(labels)))
            draws = injected[len(port_run["losses"])]
            # the gradients the step will take, as train_step forms them
            y = torch.as_tensor(np.where(draws["drop"], 0, labels)).long()
            self.model.train()
            loss = self.train_diffusion.loss(torch.as_tensor(batch),
                                             torch.as_tensor(draws["t"]).long(), y=y,
                                             noise=torch.as_tensor(draws["noise"])).mean()
            names, leaves = zip(*self.model.named_parameters())
            port_run["grads"].append({n: g.numpy() for n, g in
                                      zip(names, torch.autograd.grad(loss, leaves))})
            metrics = super().train_step(batch, labels, **draws)
            port_run["losses"].append(metrics["loss"].item())
            return metrics

    monkeypatch.setattr(quality_eval, "Trainer", InjectedTrainer)
    ema_model = quality_eval.train_unet(steps, batch, torch.float32, torch.device("cpu"),
                                        TINY_QE, TINY_QE["resolution"])
    trainer = port_run["trainer"]
    assert trainer.ema_rate == jtrainer.ema_rate == 0.9999
    assert trainer.label_drop_prob == jtrainer.label_drop_prob
    for (b, y), (jb, jy, _) in zip(port_run["batches"], jax_run["draws"]):
        np.testing.assert_array_equal(b, jb)
        np.testing.assert_array_equal(y, jy)
    np.testing.assert_allclose(port_run["losses"], jax_run["losses"], rtol=1e-5)

    want = {"params": flax_params_to_torch_state_dict(
                jax.tree.map(np.asarray, jtrainer.state.params)),
            "ema": flax_params_to_torch_state_dict(jax.tree.map(np.asarray, want_ema))}
    got = {"params": dict(trainer.model.named_parameters()),
           "ema": dict(ema_model.named_parameters())}
    for pg, jg in zip(port_run["grads"], grads):
        assert sorted(pg) == sorted(jg)
        top = max(np.abs(g).max() for g in jg.values())
        for name, g in jg.items():
            np.testing.assert_allclose(pg[name], g, rtol=0, atol=1e-4 * top, err_msg=name)
    compared = 0
    for which in ("params", "ema"):
        assert sorted(got[which]) == sorted(want[which])
        for name, w in want[which].items():
            mask = _agreeing(port_run["grads"], grads, name)
            compared += int(mask.sum())
            err = np.abs(got[which][name].detach().numpy() - w)[mask]
            rel = 3e-5 if not start[name].any() else 1e-5
            assert err.size == 0 or err.max() <= rel * np.abs(w).max(), (which, name)
    # the steps moved the live weights by about the rate
    moved = max(np.abs(got["params"][n].detach().numpy() - start[n].numpy()).max()
                for n in start)
    assert moved > 1e-4
    assert compared > 0.9 * 2 * sum(v.size for v in want["params"].values())


@pytest.mark.parametrize("enc_cache,gi", [(None, None), (2, None), (None, (0.1, 0.7))])
def test_sample_mode_matches_the_jax_tool(monkeypatch, enc_cache, gi):
    """One chunk of the port's ``sample_mode`` against the JAX tool's
    (``Diffusion.denoise`` on ``fold_in(PRNGKey(123), 0)``, its labels
    cycling 1..27) on the same weights, the tool's sampling chain (its
    training arguments, 6 DDPM steps, CFG 0.8): the start noise and every
    step's noise that the JAX chain draws from its key fed to the port's
    chain. To 1e-3, the repo's bar for a chain."""
    tool = _jax_tool("quality_eval")
    jmodel, params = random_jax_params(TINY_QE, seed=3)
    last = params["out"]["layers_2"]
    last["kernel"], last["bias"] = 0.1 * last["kernel"], 0.1 * last["bias"]
    model = port_model(TINY_QE, params).eval()
    samp_args = dict(quality_eval.DIFF_TRAIN_ARGS, rescaled_num_steps=6)
    assert samp_args == dict(tool.DIFF_TRAIN_ARGS, rescaled_num_steps=6)
    eval_n = 5
    y_np = (np.arange(eval_n) % 27) + 1

    key = jax.random.fold_in(jax.random.PRNGKey(123), 0)
    want = np.asarray(JaxDiffusion(model=jmodel, **samp_args).denoise(
        params, key, y=jnp.asarray(y_np, jnp.int32), batch_size=eval_n,
        encoder_cache=enc_cache, guidance_interval=gi))
    # the JAX chain's draws: the start noise, then one key a step
    shape = (eval_n, 8, 8, 1)
    key, init_key = jax.random.split(key)
    x_start = np.array(jax.random.normal(init_key, shape, dtype=jnp.float32))
    noises = []
    for _ in range(samp_args["rescaled_num_steps"]):
        key, step_key = jax.random.split(key)
        noises.append(np.array(jax.random.normal(step_key, shape, dtype=jnp.float32)))
    draws = iter(noises)
    denoise = Diffusion.denoise
    monkeypatch.setattr(Diffusion, "denoise", lambda self, generator=None, x=None, **kw:
                        denoise(self, generator, x=torch.from_numpy(x_start), **kw))
    monkeypatch.setattr(Diffusion, "_noise", lambda self, like, generator, row_shard=None:
                        torch.from_numpy(next(draws)))

    got = quality_eval.sample_mode(Diffusion(model=model, **samp_args),
                                   torch.as_tensor(y_np, dtype=torch.long), enc_cache, gi)
    assert next(draws, None) is None  # every step drew once
    assert got.shape == want.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("value,want", [(None, None), ("", None), ("0", None), ("0.0", None),
                                        ("1.0", 1.0)])
def test_variance_weight_zero_is_off(monkeypatch, value, want):
    """``QE_GDISTILL_VARW=0`` (and ``QE_PGDISTILL_VARW=0``) read as off, as
    the port's distillers read ``var_weight=0``: no DDPM row, no
    "vlb-trained" label."""
    for name in ("QE_GDISTILL_VARW", "QE_PGDISTILL_VARW"):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
        assert quality_eval._var_weight(name) == want


def test_quality_eval_main_on_the_cpu(monkeypatch, capsys):
    """The whole harness at tiny sizes under ``QE_DEVICE=cpu``: every mode's
    line with the JAX tool's keys, finite, exact 0 from itself, the chunk
    layout and the real data's line."""
    knobs = dict(QE_DEVICE="cpu", QE_TRAIN_STEPS="2", QE_CLS_STEPS="2", QE_EVAL_N="8",
                 QE_BATCH="8", QE_SAMPLE_STEPS="4", QE_MODES="enc,gi,int8", QE_CHUNK="4")
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("QE_CKPT", raising=False)
    assert quality_eval.main([]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    modes = {row.pop("mode"): row for row in rows if "mode" in row}
    assert list(modes) == ["exact", "enc2", "enc3", "gi_0.1-0.7", "gi_0.15-0.55", "int8",
                           "stack_int8_enc2_gi", "real_data"]
    for name, row in modes.items():
        if name == "real_data":
            assert list(row) == ["classifier_acc", "proto_acc", "logit_frechet_vs_real"]
            continue
        assert list(row) == MODE_KEYS, name
        assert all(v is not None and np.isfinite(v) for v in row.values()), name
    assert modes["exact"]["max_pixel_dev_vs_exact"] == 0.0
    assert {"stats": {"eval_n": 8, "chunks": 2, "chunk_size": 4, "n_in_chunk_stats": 8}} in rows


@pytest.mark.parametrize("preset,count", [("qe_unet", 21), ("qe_cls", 4)])
def test_quality_eval_groupnorm_keys_are_pinned(preset, count):
    """The GroupNorm shapes of quality_eval's UNet and classifier that the
    card tests index (tests/test_torch_kernels.py, ``_gn_keys``): their
    count, and the classifier's groups of 1 and 2 channels."""
    from test_torch_kernels import _gn_keys

    keys = _gn_keys(preset)
    assert len(keys) == count
    channels = {c for (_, _, c), _ in keys}
    if preset == "qe_cls":
        assert channels == {32, 64}  # 32 groups: 1 and 2 channels a group
    else:
        assert channels == {64, 128, 256, 384, 512, 192}
