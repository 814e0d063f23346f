"""The port's tensor parallelism on the CPU, mirroring tests/test_tensor_parallel.py.

Gloo ranks started by ``parallel/dryrun.py::spawn_ranks`` (fresh processes,
a ``file://`` rendezvous, every group under a timeout and killed at its end)
run the rank functions of ``torch_tp_workers.py`` on the JAX test's small
UNet (``MODEL``: resolution 8, 32 channels, ``channel_mult (1, 2)``,
attention at 4) with seeded random weights from the JAX initialiser:

  * the table: for every parameter and tp in {2, 3, 4}, the port's shard
    dimension equals the JAX package's ``_spec_for`` of the same leaf,
    through the converter's names and layouts (tp = 3 does not divide 32:
    the pairs stay replicated, the attention projections do not);
  * the collectives: scatter then gather gives x back and the gradient
    unscaled; a column- then row-parallel product and its gradients equal
    the unsharded ones; a paired ResidualBlock's forward issues one
    all-reduce and no gather, an AttentionBlock's one gather and one
    all-reduce (the counterpart of the HLO check);
  * the forward at tp = 2 and at dp = 2 x tp = 2 equals the port's
    unsharded forward (atol 1e-5, the JAX test's bar) and JAX's
    ``model.apply`` (1e-3); the gradients of mean(out^2), gathered, equal
    the port's unsharded ones (rtol 1e-4, atol 1e-6) and ``jax.grad`` (1e-4
    of the largest);
  * one dp = 2 x tp = 2 Trainer step equals the four-rank data-parallel
    step: loss rtol 1e-5, grad norm rtol 1e-5, gradients and AdamW's moments
    rtol 1e-4, atol 1e-6, parameters and EMA the same where the gradient is
    live (see tests/test_torch_distributed.py); parameters, EMA and moments
    of shard shape; replicated ones bit-equal across model peers;
  * the checkpoint: TP -> a whole file (loads strict into one process) ->
    TP, and a one-process file -> TP shards;
  * ``Trainer.sample`` on a model axis of two equals one process's;
  * ``dryrun_multigpu(4)`` prints its five lines.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nicediffusion_tpu.parallel.sharding import _spec_for  # noqa: E402
from nicediffusion_tpu_torch import DiffusionModel  # noqa: E402
from nicediffusion_tpu_torch.models.unet import shard_module_  # noqa: E402
from nicediffusion_tpu_torch.parallel.dryrun import dryrun_multigpu, spawn_ranks  # noqa: E402
from nicediffusion_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402
from nicediffusion_tpu_torch.parallel.sharding import unet_param_shard_dims  # noqa: E402
from nicediffusion_tpu_torch.utils.convert import (  # noqa: E402
    _convert_leaf,
    _flax_path,
    flax_params_to_torch_state_dict,
)
from test_torch_unet import port_model, random_jax_params  # noqa: E402
import torch_tp_workers as workers  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 120.0

MODEL = dict(
    resolution=8, in_channels=1, model_channels=32, out_channels=2, num_res_blocks=1,
    attention_resolutions=(4,), channel_mult=(1, 2), num_heads=2, num_classes=4,
    dropout=0.0, resblock_updown=True, use_adaptive_gn=True, split_qkv_first=True,
)


def run(target, world, **kwargs):
    return spawn_ranks(f"torch_tp_workers:{target}", world, kwargs, timeout_s=TIMEOUT_S,
                       pythonpath=(TESTS,))


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Both groups' results: (directory, JAX model, parameter tree,
    {group: per-rank returns})."""
    root = tmp_path_factory.mktemp("tp")
    assert workers.TINY_MODEL == MODEL
    jmodel, params = random_jax_params(MODEL, seed=11)
    torch.save(port_model(MODEL, params).state_dict(), root / "weights.pt")
    kw = dict(work=str(root), weights=str(root / "weights.pt"))
    got = {"tp2": run("tp2", 2, **kw), "dp2tp2": run("dp2tp2", 4, **kw),
           "sample": run("sample_tp", 2, **kw)}
    return root, jmodel, params, got


def load(root, name):
    return torch.load(root / name, weights_only=False)


def unsharded(params):
    return port_model(MODEL, params)


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------

def _jax_dim(spec, ndim):
    """The torch dimension of a JAX PartitionSpec on a leaf of ``ndim``
    (HWIO kernels, Dense (I, O), 1-D), through the converter's layouts."""
    axes = [i for i, a in enumerate(spec) if a == "model"]
    if not axes:
        return None
    (axis,) = axes
    if ndim == 4:  # HWIO -> OIHW
        return {3: 0, 2: 1}[axis]
    if ndim == 2:  # Dense (I, O) -> Linear (O, I) or Conv1d (O, I, 1)
        return {1: 0, 0: 1}[axis]
    return axis


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_shard_dims_match_jax_spec_for(tp):
    _, params = random_jax_params(MODEL, seed=0)
    model = unsharded(params)
    dims = unet_param_shard_dims(model, tp)
    sharded = 0
    for name, p in model.state_dict().items():
        path, leaf = _flax_path(name)
        leaf, value = _convert_leaf(path, leaf, p.numpy())
        want = _jax_dim(_spec_for(tuple(path) + (leaf,), value, tp), value.ndim)
        assert dims[name] == want, (name, tp)
        sharded += want is not None
    # tp = 3: no pair (32 % 3), but the qkv projections (3C) shard
    pairs = sum(dims[n] is not None for n in dims if ".in_conv." in n)
    assert (pairs > 0) == (32 % tp == 0) and sharded > 0


def test_mesh_of_one_and_the_quantized_refusal():
    mesh = make_mesh()
    assert (mesh.num_data, mesh.num_model, mesh.data_rank, mesh.model_rank) == (1, 1, 0, 0)
    assert mesh.data_group is None and mesh.model_group is None
    with pytest.raises(ValueError, match="must divide the process count 1"):
        make_mesh(1, 2)
    torch.manual_seed(0)
    model = DiffusionModel(**MODEL, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert shard_module_(model, mesh) is model  # a model axis of one changes nothing
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    q = DiffusionModel(**MODEL, device="cpu", quantized=True)
    with pytest.raises(ValueError, match="quantized=True with tensor parallelism"):
        shard_module_(q, Mesh(1, 2))


def test_mesh_layout_is_model_fastest(work):
    """rank = d * num_model + m, as JAX's devices.reshape(num_data, num_model)."""
    got = work[3]["dp2tp2"]
    assert [(g["data_rank"], g["model_rank"]) for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_tp_path_calls_pin_the_shard_shapes():
    """The channel-sharded out_norm calls of an ``openai_64`` forward at
    tp = 2 that chip_smoke.py's [tp] counts apart and the card tests index
    (tests/test_torch_kernels.py ``_tp_gn_keys``): 36 calls, 10 shapes, C/2
    channels from 96 to 384 in 16 groups (shapes only, on the meta device)."""
    from chip_smoke import model_config, tp_path_calls

    meta = torch.device("meta")
    model = DiffusionModel(**model_config(), kernels=False, device=meta).eval()
    calls = tp_path_calls(model, meta, tp=2)
    assert sum(calls.values()) == 36 and len(calls) == 10
    assert {k[3] for k in calls} == {16} and {k[2] for k in calls} == {"ada"}
    assert sorted({k[1][2] for k in calls}) == [96, 192, 288, 384]


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def test_collectives_values_and_gradients(work):
    c = load(work[0], "tp2.0.pt")["collectives"]
    g = torch.Generator().manual_seed(4)
    x = torch.randn(3, 4, generator=g).requires_grad_(True)
    w = torch.randn(3, 4, generator=g)
    y, gx = c["scatter_gather"]
    assert torch.equal(y, x.detach()) and torch.equal(gx, w)
    a, b = torch.randn(4, 6, generator=g), torch.randn(6, 5, generator=g)
    a.requires_grad_(True), b.requires_grad_(True)
    z = x @ a @ b
    ref = torch.autograd.grad((z * z).sum(), (x, a, b))
    for got, want in zip(c["pair"], (z.detach(), *ref)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("block,forward,backward", [
    ("residual", {"all_reduce.forward": 1},
     # in_conv's input (copy) and the modulation rows' scatter
     {"all_reduce.backward": 1, "all_gather.backward": 1}),
    ("attention", {"all_gather.forward": 1, "all_reduce.forward": 1},
     {"all_reduce.backward": 1, "all_gather.backward": 1}),
])
def test_block_collective_structure(work, block, forward, backward):
    """One all-reduce per paired residual block and no gather of the
    intermediate; the attention block's gather of qkv and its all-reduce.
    The block's output and gathered gradients equal the unsharded block's."""
    from nicediffusion_tpu_torch.models.unet import AttentionBlock, ResidualBlock

    c = load(work[0], "tp2.0.pt")["collectives"]
    assert c[f"{block}.forward"] == forward
    assert c[f"{block}.backward"] == backward
    g = torch.Generator().manual_seed(4)
    for shape in ((3, 4), (3, 4), (4, 6), (6, 5)):
        torch.randn(*shape, generator=g)  # the draws before the blocks'
    whole = (ResidualBlock(64, 64, 32, use_adaptive_gn=True, device="cpu") if block == "residual"
             else AttentionBlock(64, num_heads=2, device="cpu"))
    whole.load_state_dict(c[f"{block}.whole"], strict=True)
    xb = torch.randn(2, 4, 4, 64, generator=g)
    emb = torch.randn(2, 32, generator=g)
    h = whole(xb, emb) if block == "residual" else whole(xb)
    grads = torch.autograd.grad(h.square().sum(), list(whole.parameters()))
    torch.testing.assert_close(c[f"{block}.out"], h.detach(), rtol=0, atol=1e-5)
    for (name, _), gr in zip(whole.named_parameters(), grads):  # 1e-5 of the largest
        err = (c[f"{block}.grads"][name] - gr).abs().max().item()
        assert err <= 1e-5 * gr.abs().max().item(), (name, err)


# ---------------------------------------------------------------------------
# forward and gradients against the unsharded port and JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", ["tp2", "dp2tp2"])
def test_tp_forward_matches_unsharded_and_jax(work, mesh_name):
    root, jmodel, params, _ = work
    out = load(root, f"{mesh_name}.0.pt")["forward"]
    x, t, y = workers.inputs()
    with torch.no_grad():
        ref = unsharded(params)(x, t, y)
    assert out.shape == ref.shape == (4, 8, 8, 2)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    jref = np.asarray(jax.jit(jmodel.apply)({"params": params}, x.numpy(), t.numpy(), y.numpy()))
    np.testing.assert_allclose(out.numpy(), jref, atol=1e-3)


def test_tp_gradients_match_unsharded_and_jax(work):
    root, jmodel, params, got = work
    res = load(root, "tp2.0.pt")
    model = unsharded(params)
    x, t, y = workers.inputs()
    names = [n for n, _ in model.named_parameters()]
    ref = torch.autograd.grad(model(x, t, y).square().mean(), list(model.parameters()))
    for name, want in zip(names, ref):
        torch.testing.assert_close(res["grads"][name], want, rtol=1e-4, atol=1e-6)

    def loss(p):
        return jnp.mean(jmodel.apply({"params": p}, x.numpy(), t.numpy(), y.numpy()) ** 2)

    jgrads = flax_params_to_torch_state_dict(
        jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params)))
    top = max(np.abs(g).max() for g in jgrads.values())  # 1e-4 of the largest gradient
    for name in names:
        assert np.abs(res["grads"][name].numpy() - jgrads[name]).max() <= 1e-4 * top, name
    # the replicated gradients are the same on both model ranks, bit for bit
    assert got["tp2"][0] == got["tp2"][1]


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def test_replicated_gradients_averaged_over_the_model_group(work):
    """The trainer's reduce on a mesh of 1 x 2, fed gradients of 1 on rank
    0 and 2 on rank 1: the replicated ones become 1.5 on both (peers whose
    replicated gradients drift apart, as cuDNN's weight gradients do on the
    card, are brought back); the shards keep their own."""
    for r in (0, 1):
        reduced = load(work[0], f"tp2.{r}.pt")["reduce"]
        assert any(d is None for d, _ in reduced.values())
        assert any(d is not None for d, _ in reduced.values())
        for name, (dim, values) in reduced.items():
            assert values == ([1.5] if dim is None else [r + 1.0]), name


def test_tp_train_step_matches_dp(work):
    root, _, _, got = work
    res = [load(root, f"dp2tp2.{r}.pt") for r in range(4)]
    r0 = res[0]
    np.testing.assert_allclose(r0["tp.metrics"]["loss"], r0["dp.metrics"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(r0["tp.metrics"]["grad_norm"], r0["dp.metrics"]["grad_norm"],
                               rtol=1e-5)
    for name, g in r0["dp.grads"].items():
        torch.testing.assert_close(r0["tp.grads"][name], g, rtol=1e-4, atol=1e-6)
    tp, dp = r0["tp.state"], r0["dp.state"]
    assert set(tp) == set(dp)
    for key, want in dp.items():
        if key.startswith("opt."):
            torch.testing.assert_close(tp[key], want, rtol=1e-4, atol=1e-6)
            continue
        name = key.split(".", 1)[1]
        live = r0["dp.grads"][name].abs() >= 1e-5
        torch.testing.assert_close(tp[key][live], want[live], rtol=1e-4, atol=1e-6,
                                   msg=lambda m: f"{key}: {m}")
    # every rank holds the same loss; model peers the same replicated state
    assert len({g["loss"] for g in got["dp2tp2"]}) == 1
    by_data = {}
    for g in got["dp2tp2"]:
        by_data.setdefault(g["data_rank"], set()).add(g["replicated"])
    assert all(len(v) == 1 for v in by_data.values())


def test_tp_state_is_sharded(work):
    """Parameters, EMA and AdamW's moments hold the rank's shards: the whole
    shape with the table's dimension halved (the JAX test asserts the same
    of in_conv's kernel, its EMA and its moments)."""
    root = work[0]
    r0 = load(root, "dp2tp2.0.pt")
    dims, shapes, whole = r0["dims"], r0["tp.shapes"], r0["dp.state"]
    assert dims["downsampling.1.0.in_conv.weight"] == 0
    n_sharded = 0
    for key, shape in shapes.items():
        name = key.split(".", 1)[1].rsplit(".", 1)[0] if key.startswith("opt.") else \
            key.split(".", 1)[1]
        want = list(whole[key].shape)
        if dims[name] is not None:
            want[dims[name]] //= 2
            n_sharded += 1
        assert list(shape) == want, key
    assert n_sharded > 0


def test_tp_checkpoint_round_trip(work):
    root = work[0]
    r0 = load(root, "dp2tp2.0.pt")
    same, step = r0["ckpt.round_trip"]
    assert same and step == 1
    a, b = r0["ckpt.next_losses"]
    assert a == b  # the restored trainer trains on as the saved one
    # the TP trainer's file is a whole one-process checkpoint
    state = torch.load(root / "ckpt" / "step_1" / "state.pt", weights_only=True)
    model = DiffusionModel(**MODEL, device="cpu")
    model.load_state_dict(state["model"], strict=True)
    model.load_state_dict(state["ema"], strict=True)
    for k, v in state["model"].items():
        torch.testing.assert_close(v, r0["tp.state"][f"model.{k}"], rtol=0, atol=0)
    # a one-process checkpoint restored into TP shards and gathered back: equal
    assert all(r0["ckpt.from_one"].values()) and r0["ckpt.from_one"]


def test_tp_sample_matches_one_process(work):
    root, _, _, got = work
    s = load(root, "sample.pt")
    assert got["sample"] == [False, True]  # rank 0 returns the images
    assert s["tp"].shape == s["one"].shape == (2, 8, 8, 1)
    assert np.abs(s["tp"].astype(int) - s["one"].astype(int)).max() <= 1


def test_dryrun_prints_five_lines(capsys):
    lines = dryrun_multigpu(4)
    assert len(lines) == 5
    out = capsys.readouterr().out
    assert "dp=2 x tp=2 forward OK" in out and "dp=2 x tp=2 TRAIN step OK" in out
    assert "one DP train step OK" in out and "sharded serving daemon OK" in out
