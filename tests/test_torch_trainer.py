"""The port's Trainer against optax and the JAX trainer's behaviour, on the CPU.

Step parity: ``Trainer.train_step`` with injected t, noise and label drop
against ``optax.adamw`` plus the JAX trainer's EMA line on the same
gradients, one step from fresh state and a second step after the JAX state
has been carried across by ``utils/convert.py::train_state_to_torch``
(parameters, EMA, ``exp_avg``/``exp_avg_sq`` to 1e-6), and accumulation k = 2
against ``optax.MultiSteps``. Behaviour, mirroring tests/test_trainer.py:
loss falls and EMA moves on synthetic data, checkpoint round trip,
``resume_step="auto"``, accumulation applies every k, in-training sampling,
label drop only under CFG. Remat: same loss, gradients and dropout masks
with and without. The train entry point runs. Everything on ``device="cpu"``.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nicediffusion_tpu_torch import DiffusionModel, Trainer  # noqa: E402
from nicediffusion_tpu_torch.scripts.train import main as train_main  # noqa: E402
from nicediffusion_tpu_torch.training.data import synthetic_batches  # noqa: E402
from nicediffusion_tpu_torch.utils.convert import (  # noqa: E402
    convert_torch_state_dict,
    flax_params_to_torch_state_dict,
    train_state_to_torch,
)
from test_torch_unet import port_model, random_jax_params  # noqa: E402

TINY_MODEL = dict(
    resolution=8, in_channels=1, model_channels=32, out_channels=2,
    num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2),
    num_heads=2, num_classes=4, dropout=0.0, resblock_updown=True,
    use_adaptive_gn=True, split_qkv_first=True,
)
DIFF_ARGS = dict(
    original_num_steps=100, rescaled_num_steps=100,
    sampling_var_type="learned_interpolation", loss_type="hybrid",
    beta_schedule="cosine", guidance_method="classifier_free", guidance_strength=0.8,
)
LR, WD, EMA = 2e-3, 1e-2, 0.9


def make_trainer(tmp_path, model=None, iterations=12, **overrides):
    if model is None:
        torch.manual_seed(0)  # the module initialisers draw from the global RNG
        model = DiffusionModel(**TINY_MODEL, device="cpu")
    kwargs = dict(
        model=model, diffusion_args=dict(DIFF_ARGS),
        dataloader=synthetic_batches(batch_size=8, resolution=8, channels=1,
                                     num_classes=4, seed=1),
        iterations=iterations, batch_size=8, lr=2e-3, weight_decay=1e-4,
        checkpoint_dir=str(tmp_path / "ckpt"), seed=0, device="cpu",
    )
    kwargs.update(overrides)
    return Trainer(**kwargs)


def state_tensors(trainer):
    out = {f"model.{k}": v for k, v in trainer.model.state_dict().items()}
    out.update({f"ema.{k}": v for k, v in trainer.ema_model.state_dict().items()})
    for i, st in trainer.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items()})
    return out


# ---------------------------------------------------------------------------
# (iv) optimizer steps against optax
# ---------------------------------------------------------------------------

def draws(seed, b=4):
    rng = np.random.default_rng(seed)
    return dict(
        batch=rng.uniform(-1, 1, size=(b, 8, 8, 1)).astype(np.float32),
        labels=rng.integers(1, 4, size=(b,)),
        t=rng.integers(0, 100, size=(b,)),
        noise=rng.normal(size=(b, 8, 8, 1)).astype(np.float32),
        drop=np.array([False, True, False, False][:b]),
    )


def port_gradients(trainer, d):
    """The gradients ``train_step`` will take on these draws, as a flax tree."""
    y = np.where(d["drop"], 0, d["labels"])
    trainer.model.train()
    loss = trainer.train_diffusion.loss(
        torch.from_numpy(d["batch"]), torch.from_numpy(d["t"]).long(),
        y=torch.from_numpy(y).long(), noise=torch.from_numpy(d["noise"])).mean()
    names, leaves = zip(*trainer.model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), convert_torch_state_dict(dict(zip(names, grads)))


def assert_state_matches(trainer, params, ema, mu, nu, count):
    want_p, want_e, want_opt = train_state_to_torch(
        params, ema, mu, nu, count, [n for n, _ in trainer.model.named_parameters()])
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name], atol=1e-6, err_msg=name)
        np.testing.assert_allclose(trainer.ema_model.get_parameter(name).numpy(),
                                   want_e[name], atol=1e-6, err_msg=name)
    got_opt = trainer.optimizer.state_dict()["state"]
    assert got_opt.keys() == want_opt.keys()
    for i, want in want_opt.items():
        assert float(got_opt[i]["step"]) == count
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(got_opt[i][key].numpy(), want[key], atol=1e-6,
                                       err_msg=f"{i}.{key}")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def ema_line(ema, params):
    return jax.tree.map(lambda e, p: EMA * e + (1.0 - EMA) * p, ema, params)


def test_two_adamw_ema_steps_match_optax(tmp_path):
    _, params = random_jax_params(TINY_MODEL, seed=11)
    trainer = make_trainer(tmp_path, port_model(TINY_MODEL, params), iterations=0,
                           lr=LR, weight_decay=WD, ema_rate=EMA)
    opt = optax.adamw(LR, b1=0.9, b2=0.999, weight_decay=WD)
    opt_state, ema = opt.init(params), params

    # step 1, both from fresh state
    d = draws(1)
    loss, grads = port_gradients(trainer, d)
    metrics = trainer.train_step(**d)
    assert trainer.step == 1 and abs(metrics["loss"].item() - loss) < 1e-6
    updates, opt_state = opt.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    ema = ema_line(ema, params)
    assert_state_matches(trainer, *map(np_tree, (params, ema, opt_state[0].mu, opt_state[0].nu)),
                         int(opt_state[0].count))

    # step 2 in a fresh Trainer (other weights), the JAX state carried across
    torch.manual_seed(3)
    fresh = make_trainer(tmp_path, DiffusionModel(**TINY_MODEL, device="cpu"), iterations=0,
                         lr=LR, weight_decay=WD, ema_rate=EMA)
    names = [n for n, _ in fresh.model.named_parameters()]
    fresh.load_train_state(*train_state_to_torch(
        *map(np_tree, (params, ema, opt_state[0].mu, opt_state[0].nu)),
        int(opt_state[0].count), names), step=1)
    assert_state_matches(fresh, *map(np_tree, (params, ema, opt_state[0].mu, opt_state[0].nu)), 1)
    d = draws(2)
    _, grads = port_gradients(fresh, d)
    fresh.train_step(**d)
    updates, opt_state = opt.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    ema = ema_line(ema, params)
    assert fresh.step == 2
    assert_state_matches(fresh, *map(np_tree, (params, ema, opt_state[0].mu, opt_state[0].nu)), 2)


def test_accumulation_matches_optax_multisteps(tmp_path):
    """k = 2: the first call accumulates only (EMA still runs), the second
    applies the mean of both micro-batch gradients."""
    _, params = random_jax_params(TINY_MODEL, seed=12)
    trainer = make_trainer(tmp_path, port_model(TINY_MODEL, params), iterations=0,
                           lr=LR, weight_decay=WD, ema_rate=EMA, grad_accumulation=2)
    opt = optax.MultiSteps(optax.adamw(LR, b1=0.9, b2=0.999, weight_decay=WD),
                           every_k_schedule=2)
    opt_state, ema = opt.init(params), params
    for i, seed in enumerate((5, 6)):
        d = draws(seed)
        _, grads = port_gradients(trainer, d)
        before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        trainer.train_step(**d)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = ema_line(ema, params)
        changed = any(not torch.equal(p, before[n]) for n, p in trainer.model.named_parameters())
        assert changed == (i == 1)
        inner = opt_state.inner_opt_state[0]
        want_p, want_e, _ = train_state_to_torch(
            *map(np_tree, (params, ema, inner.mu, inner.nu)), int(inner.count), list(before))
        for name, p in trainer.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want_p[name], atol=1e-6)
            np.testing.assert_allclose(trainer.ema_model.get_parameter(name).numpy(),
                                       want_e[name], atol=1e-6)


def test_train_state_converter_layouts():
    """Moments go through the parameters' transposes; no AdamW state before
    the first update."""
    _, params = random_jax_params(TINY_MODEL, seed=13)
    names = list(flax_params_to_torch_state_dict(params))
    sd, ema_sd, opt = train_state_to_torch(params, params, params, params, 0, names)
    assert opt == {} and sd.keys() == ema_sd.keys() == set(names)
    sd, _, opt = train_state_to_torch(params, params, params, params, 7, names)
    assert all(float(s["step"]) == 7 for s in opt.values())
    for i, name in enumerate(names):
        np.testing.assert_array_equal(opt[i]["exp_avg"], sd[name])
        assert opt[i]["exp_avg_sq"].flags["C_CONTIGUOUS"]


# ---------------------------------------------------------------------------
# (v) trainer behaviour, mirroring tests/test_trainer.py
# ---------------------------------------------------------------------------

def test_loss_decreases_and_ema_moves(tmp_path):
    trainer = make_trainer(tmp_path, iterations=0)
    ema_before = {k: v.clone() for k, v in trainer.ema_model.state_dict().items()}
    losses = []
    for _ in range(30):
        batch, labels = next(trainer.loader)
        losses.append(trainer.train_step(batch, labels)["loss"].item())
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert trainer.step == 30
    # EMA moved away from init, and is a copy: it differs from the live weights
    ema = trainer.ema_model.state_dict()
    assert max((ema[k] - ema_before[k]).abs().max().item() for k in ema) > 0
    live = trainer.model.state_dict()
    assert max((ema[k] - live[k]).abs().max().item() for k in ema) > 0
    assert not any(p.requires_grad for p in trainer.ema_model.parameters())


def test_checkpoint_round_trip(tmp_path):
    metrics = tmp_path / "metrics.jsonl"
    trainer = make_trainer(tmp_path, iterations=3, save_every=None, metrics_path=str(metrics))
    trainer.train()  # trains 3 steps then saves step_3
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert rows and set(rows[0]) == {"step", "loss", "grad_norm", "steps_per_sec"}
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows)

    restored = make_trainer(tmp_path, iterations=0, resume_step=3)
    a, b = state_tensors(trainer), state_tensors(restored)
    assert a.keys() == b.keys() and any(k.startswith("opt.") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert restored.step == trainer.step == 3


def test_resume_step_auto_picks_the_newest(tmp_path):
    assert make_trainer(tmp_path, iterations=0, resume_step="auto").step == 0  # none yet
    trainer = make_trainer(tmp_path, iterations=2, save_every=1)
    trainer.train()  # saves step_1 (periodic) and step_2 (final)
    assert trainer.latest_checkpoint_step() == 2
    resumed = make_trainer(tmp_path, iterations=0, resume_step="auto")
    assert resumed.step == 2
    for (k, a), b in zip(trainer.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_grad_accumulation_applies_every_k(tmp_path):
    trainer = make_trainer(tmp_path, iterations=0, grad_accumulation=2)
    p0 = [p.detach().clone() for p in trainer.model.parameters()]
    batch, labels = next(trainer.loader)
    trainer.train_step(batch, labels)
    # first micro-batch: accumulate only, no update
    assert all(torch.equal(a, b) for a, b in zip(p0, trainer.model.parameters()))
    trainer.train_step(batch, labels)
    assert any(not torch.equal(a, b) for a, b in zip(p0, trainer.model.parameters()))


def test_in_training_sampling(tmp_path):
    seen = []
    trainer = make_trainer(tmp_path, iterations=0,
                           sample_callback=lambda imgs, labels: seen.append((imgs, labels)))
    assert trainer.sampling_diffusion.rescaled_num_steps == 100  # min(250, T)
    assert trainer.sampling_diffusion.model is trainer.ema_model
    out = trainer.sample(2)
    assert out.shape == (2, 8, 8, 1) and out.dtype == np.uint8
    assert seen[0][0] is out and seen[0][1].shape == (2,)


@pytest.mark.parametrize("guidance", ["classifier_free", None])
def test_label_drop_only_under_cfg(tmp_path, guidance):
    """An all-True injected drop sends the labels to class 0 under CFG and
    leaves them alone without it."""
    d = draws(9)
    # the zero-initialised output conv hides the labels from a fresh model's
    # output, so the comparison runs on seeded non-zero weights
    _, params = random_jax_params(TINY_MODEL, seed=14)

    def loss(labels, drop):
        trainer = make_trainer(tmp_path, port_model(TINY_MODEL, params), iterations=0,
                               diffusion_args=dict(DIFF_ARGS, guidance_method=guidance))
        return trainer.train_step(d["batch"], labels, t=d["t"], noise=d["noise"],
                                  drop=drop)["loss"].item()

    everyone = np.ones(4, bool)
    dropped = loss(d["labels"], everyone)
    kept = loss(d["labels"], ~everyone)
    zeros = loss(np.zeros(4, np.int64), ~everyone)
    assert kept != zeros
    assert dropped == (zeros if guidance else kept)


# ---------------------------------------------------------------------------
# (vi) remat
# ---------------------------------------------------------------------------

def _remat_pair(dropout):
    cfg = dict(TINY_MODEL, num_classes=5, dropout=dropout)
    _, params = random_jax_params(cfg, seed=21)  # no leaf at zero
    return (port_model(cfg, params, use_remat=False).train(),
            port_model(cfg, params, use_remat=True).train())


def _loss_and_grads(model, seed=42):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 8, 8, 1)).astype(np.float32))
    t, y = torch.tensor([3, 7]), torch.tensor([1, 4])
    g = torch.Generator().manual_seed(seed)
    out = model(x, t, y, generator=g)
    grads = torch.autograd.grad(out.square().mean(), list(model.parameters()))
    return out.detach(), grads, g.get_state()


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_remat_matches_plain(dropout):
    """Same output, same gradients, and the generator left in the same state:
    the recompute replays the dropout masks and puts the generator back."""
    plain, remat = _remat_pair(dropout)
    out_p, grads_p, state_p = _loss_and_grads(plain)
    out_r, grads_r, state_r = _loss_and_grads(remat)
    torch.testing.assert_close(out_r, out_p, rtol=0, atol=1e-6)
    for a, b in zip(grads_r, grads_p):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert torch.equal(state_r, state_p)
    if dropout:  # the masks matter: another seed, another output
        assert not torch.allclose(_loss_and_grads(plain, seed=7)[0], out_p)


def test_dropout_needs_train_mode_and_a_generator():
    plain, _ = _remat_pair(0.5)
    x, t, y = torch.zeros(1, 8, 8, 1), torch.tensor([3]), torch.tensor([1])
    with pytest.raises(ValueError, match="Generator"):
        plain(x, t, y)
    plain.eval()
    with torch.no_grad():
        assert torch.equal(plain(x, t, y), plain(x, t, y))  # inactive in eval()


# ---------------------------------------------------------------------------
# (vii) the train entry point
# ---------------------------------------------------------------------------

def test_train_entry_point_runs(tmp_path, capsys):
    trainer = train_main([
        "--synthetic", "--device", "cpu", "--iterations", "2", "--batch_size", "4",
        "--resolution", "8", "--model_channels", "32", "--channel_mult", "1/2",
        "--num_res_blocks", "1", "--attention_resolutions", "4", "--use_fp16", "-w",
        "--print_every", "1", "--checkpoint_dir", str(tmp_path / "ckpt"),
        "--metrics_path", str(tmp_path / "metrics.jsonl"),
        "--samples_dir", str(tmp_path / "samples"),
    ])
    assert trainer.step == 2 and trainer.latest_checkpoint_step() == 2
    assert trainer.model.use_remat and trainer.model.dtype == torch.bfloat16
    assert trainer.model.num_classes == 28  # EMNIST's 27 + the CFG null class
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert "Loss=" in capsys.readouterr().out
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1] and all(np.isfinite(r["loss"]) for r in rows)


def test_train_entry_point_trains_a_v_prediction_model(tmp_path):
    """``--prediction_type v`` reaches the training and the in-training
    sampling Diffusion, and the model trains on the v target."""
    trainer = train_main([
        "--synthetic", "--device", "cpu", "--iterations", "2", "--batch_size", "4",
        "--resolution", "8", "--model_channels", "32", "--channel_mult", "1",
        "--num_res_blocks", "1", "--attention_resolutions", "", "--prediction_type", "v",
        "--print_every", "1", "--checkpoint_dir", str(tmp_path / "ckpt"),
        "--metrics_path", str(tmp_path / "metrics.jsonl"),
        "--samples_dir", str(tmp_path / "samples"),
    ])
    assert trainer.step == 2
    assert trainer.train_diffusion.prediction_type == "v"
    assert trainer.sampling_diffusion.prediction_type == "v"
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 2 and all(np.isfinite(r["loss"]) for r in rows)
    images = trainer.sample(2)
    assert images.shape == (2, 8, 8, 1) and images.dtype == np.uint8


def test_train_entry_point_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="--device"):
        train_main(["--synthetic", "--iterations", "1"])


def test_train_entry_point_f32_means_no_tf32(tmp_path, monkeypatch):
    # f32 compute is f32 arithmetic in the libraries too, as in K1 and K2
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        trainer = train_main([
            "--synthetic", "--device", "cpu", "--iterations", "1", "--batch_size", "2",
            "--resolution", "8", "--model_channels", "32", "--channel_mult", "1",
            "--num_res_blocks", "1", "--attention_resolutions", "",
            "--checkpoint_dir", str(tmp_path / "ckpt"),
            "--metrics_path", str(tmp_path / "metrics.jsonl"),
            "--samples_dir", str(tmp_path / "samples"),
        ])
        assert trainer.model.dtype is None and trainer.step == 1
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
