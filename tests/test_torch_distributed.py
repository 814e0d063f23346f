"""The port's data parallelism on the CPU, mirroring tests/test_distributed.py.

Two ranks in a gloo group (``parallel/dryrun.py::spawn_ranks``: fresh
processes, a ``file://`` rendezvous under ``tmp_path``, every group under a
timeout of its own and killed at its end) run the rank functions of
``torch_dp_workers.py``:

  * ``shard_rows`` and ``gather_rows`` place rows as ``P('data')`` does;
  * a data-parallel step's loss and reduced gradients equal
    ``jax.value_and_grad`` of the JAX package's ``Diffusion.loss`` on the
    same global batch and injected draws (tests/test_torch_losses.py's bars:
    loss 1e-5, gradients 1e-4 of the largest);
  * a data-parallel step on a global batch of 8 split by rank equals the
    single-process step on the whole batch (loss rtol 1e-5; gradients and
    parameters rtol 1e-4, atol 1e-6: tests/test_distributed.py's bar, the
    parameters where their gradient is live), both ranks holding the same
    state bit for bit; two DP updates equal optax's AdamW of the reduced
    gradients (the means of test_torch_trainer.py's optax test, 1e-6);
    accumulation k = 2 under DP the same;
  * sharded sampling equals unsharded for DDIM, DDPM, DPM++ and the encoder
    cache at 2 and 3, from given and from drawn start noise, at atol 1e-5;
    the deterministic chains (DDIM, DPM++, DPM++ with the encoder cache at
    3) from a given x_T, gathered, equal the JAX package's ``denoise`` on the
    same x_T and labels (1e-3, the port's bar against JAX; no farther from
    it than the one-process chain, to 1e-5);
  * ``scripts/sample.py --data_parallel`` on two ranks writes the files one
    process writes, byte for byte; in a world of one the flag changes
    nothing.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import optax  # noqa: E402

from nicediffusion_tpu.diffusion.process import Diffusion as JaxDiffusion  # noqa: E402
from nicediffusion_tpu_torch.parallel import gather_rows, shard_rows  # noqa: E402
from nicediffusion_tpu_torch.parallel.dryrun import spawn_ranks  # noqa: E402
from nicediffusion_tpu_torch.scripts.sample import main as sample_main  # noqa: E402
from nicediffusion_tpu_torch.utils.convert import (  # noqa: E402
    convert_torch_state_dict,
    flax_params_to_torch_state_dict,
)
from test_torch_trainer import (  # noqa: E402
    TINY_MODEL,
    assert_state_matches,
    ema_line,
    np_tree,
)
from test_torch_unet import port_model, random_jax_params  # noqa: E402
import torch_dp_workers as workers  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 120.0  # each group of two ranks; they take about 10 s


def run(target, **kwargs):
    return spawn_ranks(f"torch_dp_workers:{target}", 2, kwargs, timeout_s=TIMEOUT_S,
                       pythonpath=(TESTS,))


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The JAX-initialised weights as a port state dict, and both groups'
    results: (directory, parameter tree, JAX model)."""
    root = tmp_path_factory.mktemp("dp")
    assert workers.TINY_MODEL == TINY_MODEL
    jmodel, params = random_jax_params(TINY_MODEL, seed=11)
    torch.save(port_model(TINY_MODEL, params).state_dict(), root / "weights.pt")
    kwargs = dict(work=str(root), weights=str(root / "weights.pt"))
    assert run("training", **kwargs) == [0, 1]
    assert run("sampling", **kwargs) == [0, 1]
    return root, params, jmodel


def test_shard_rows_places_rows_as_p_data():
    x = torch.arange(16).reshape(16, 1)
    for w in (1, 2, 8):
        parts = [shard_rows(x, r, w) for r in range(w)]
        assert all(p.shape == (16 // w, 1) for p in parts)
        assert torch.equal(torch.cat(parts), x)  # rank r holds rows [r*B/W, (r+1)*B/W)
    with pytest.raises(ValueError, match="global batch 16 must divide process count 3"):
        shard_rows(x, 0, 3)
    # without a group gather_rows is the rank's own rows, on the CPU
    assert torch.equal(gather_rows(x), x)


def test_gather_rows_collects_rank_order_on_rank_0(work):
    root = work[0]
    got = [torch.load(root / f"training{r}.pt", weights_only=False)["gathered"] for r in (0, 1)]
    assert torch.equal(got[0], torch.arange(8.0).reshape(8, 1)) and got[1] is None


def _results(root):
    return [torch.load(root / f"training{r}.pt", weights_only=False) for r in (0, 1)]


@pytest.mark.parametrize("k", [1, 2])
def test_dp_step_matches_the_single_process_step(work, k):
    """Two micro-steps on two ranks against one process on the global batch:
    k = 1, two updates; k = 2, one update of the mean of both.

    Loss and gradient norm to 1e-5 at each micro-step; up to the first
    update every parameter's gradient as the update sees it (after the
    reduce), and after it AdamW's moments, to rtol 1e-4, atol 1e-6; both
    ranks' bit for bit throughout. The parameters and their EMA after the
    first update to the same bar, on the elements whose gradient is at least
    1e-5, a thousand times AdamW's eps: where the gradient is about 0 (the
    biases before a GroupNorm) the two sums keep different float noise of
    about 1e-9, which AdamW, dividing by |g| + 1e-8, turns into moves of up
    to the rate (and the second step's gradients then differ by more)."""
    res0, res1 = _results(work[0])
    for i in (0, 1):
        dp, dp1, one = res0[f"k{k}.dp.{i}"], res1[f"k{k}.dp.{i}"], res0[f"k{k}.one.{i}"]
        assert dp == dp1  # loss and grad norm of the global batch on every rank
        np.testing.assert_allclose(dp["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(dp["grad_norm"], one["grad_norm"], rtol=1e-5)
        dp_g, dp1_g, one_g = (res0[f"k{k}.dp.grads"][i], res1[f"k{k}.dp.grads"][i],
                              res0[f"k{k}.one.grads"][i])
        for name in one_g:
            assert torch.equal(dp_g[name], dp1_g[name]), name
            if i < k:  # both at the same parameters
                np.testing.assert_allclose(dp_g[name].numpy(), one_g[name].numpy(),
                                           rtol=1e-4, atol=1e-6, err_msg=name)
    for when in ("first_update", "state"):
        assert res0[f"k{k}.dp.{when}"].keys() == res1[f"k{k}.dp.{when}"].keys()
        for key, v in res0[f"k{k}.dp.{when}"].items():
            assert torch.equal(v, res1[f"k{k}.dp.{when}"][key]), key  # one update everywhere
    state, single = res0[f"k{k}.dp.first_update"], res0[f"k{k}.one.first_update"]
    assert state.keys() == single.keys() and any(key.startswith("opt.") for key in state)
    grads = res0[f"k{k}.one.grads"]
    mean = {n: sum(g[n] for g in grads[:k]) / k for n in grads[0]}  # the update's gradient
    checked = 0
    for key in state:
        a, b = state[key].numpy(), single[key].numpy()
        name = key.split(".", 1)[1]
        if name in mean:  # a parameter or its EMA copy: the live elements
            live = (mean[name].abs() >= 1e-5).numpy()
            a, b = a[live], b[live]
            checked += live.sum()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=key)
    assert checked > 0.8 * 2 * sum(g.numel() for g in mean.values())


def test_dp_steps_match_optax_on_the_reduced_gradients(work):
    """Two DP updates equal optax's AdamW and the JAX trainer's EMA line
    applied to the gradients the DP step reduced (the means of
    test_torch_trainer.py's optax test, 1e-6)."""
    root, params, _ = work
    res = _results(root)[0]
    trainer = workers.make_trainer(str(root / "weights.pt"), False)
    opt = optax.adamw(workers.LR, b1=0.9, b2=0.999, weight_decay=workers.WD)
    opt_state, ema = opt.init(params), params
    for grads in res["k1.dp.grads"]:
        grads = convert_torch_state_dict({n: g for n, g in grads.items()})
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = ema_line(ema, params)
    state = res["k1.dp.state"]
    adamw = {}
    for key, v in state.items():
        if key.startswith("opt."):
            _, i, name = key.split(".", 2)
            adamw.setdefault(int(i), {})[name] = v
    trainer.load_train_state({k[6:]: v for k, v in state.items() if k.startswith("model.")},
                             {k[4:]: v for k, v in state.items() if k.startswith("ema.")},
                             adamw, step=2)
    assert_state_matches(trainer, *map(np_tree, (params, ema, opt_state[0].mu, opt_state[0].nu)),
                         int(opt_state[0].count))


@pytest.fixture(scope="module")
def jax_steps(work):
    """seed -> (loss, gradients by port name): ``jax.value_and_grad`` of the
    JAX package's loss on ``draws(seed)`` (the global batch of 8, the label
    drop applied as the trainer applies it) at the initial weights."""
    _, params, jmodel = work
    jd = JaxDiffusion(model=jmodel, **workers.DIFF_ARGS)

    def loss(p, x0, t, y, noise):
        return jd.loss(p, x0, t, None, y=y, noise=noise).mean()

    step = jax.jit(jax.value_and_grad(loss))
    out = {}
    for seed in (1, 2):
        d = workers.draws(seed)
        value, grads = step(params, d["batch"], d["t"].astype(np.int32),
                            np.where(d["drop"], 0, d["labels"]).astype(np.int32), d["noise"])
        out[seed] = float(value), flax_params_to_torch_state_dict(
            jax.tree.map(np.asarray, grads))
    return out


@pytest.mark.parametrize("k,i", [(1, 0), (2, 0), (2, 1)])
def test_dp_step_matches_jax_value_and_grad(work, jax_steps, k, i):
    """The micro-steps taken at the initial weights (k = 1's first; both of
    k = 2's, whose update waits for the second): the loss every rank reports
    and the gradients it reduced over the two ranks, against the JAX loss's
    ``jax.value_and_grad`` on the same global batch and draws, at
    tests/test_torch_losses.py's bars (loss rtol 1e-5; every gradient to
    1e-4 of the largest gradient)."""
    res0, res1 = _results(work[0])
    ref_loss, ref_grads = jax_steps[(1, 2)[i]]
    for res in (res0, res1):
        np.testing.assert_allclose(res[f"k{k}.dp.{i}"]["loss"], ref_loss, rtol=1e-5, atol=1e-5)
        grads = res[f"k{k}.dp.grads"][i]
        assert grads.keys() == ref_grads.keys()
        top = max(np.abs(g).max() for g in ref_grads.values())
        assert top > 0
        for name, g in grads.items():
            assert np.abs(g.numpy() - ref_grads[name]).max() <= 1e-4 * top, name


def test_dp_trainer_sample_matches_one_process(work):
    """``Trainer.sample(4)`` on two ranks (2 rows each of the forced 250-step
    DDPM chain, gathered to rank 0) against one process: the uint8 images
    within 1 count (the CPU's f32 products round by batch), rank 0's
    generator advanced as one process advances it, nothing on rank 1."""
    res0, res1 = _results(work[0])
    (dp, dp_state), (one, one_state) = res0["sample.dp"], res0["sample.one"]
    assert res1["sample.dp"][0] is None
    assert dp.shape == one.shape == (4, 8, 8, 1) and dp.dtype == np.uint8
    assert np.abs(dp.astype(int) - one.astype(int)).max() <= 1
    assert torch.equal(dp_state, one_state)


@pytest.mark.parametrize("case", [f"{s}.{e}" for s, e in workers.SAMPLING_CASES])
def test_sharded_sampling_matches_unsharded(work, case):
    sharded, single, drawn, drawn_single = torch.load(work[0] / "sampling.pt",
                                                      weights_only=False)[case]
    assert sharded.shape == single.shape == (8, 8, 8, 1)
    np.testing.assert_allclose(sharded.numpy(), single.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(drawn.numpy(), drawn_single.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("sampler,enc", [("ddim", None), ("dpm++", None), ("dpm++", 3)])
def test_sharded_chain_matches_jax_denoise(work, sampler, enc):
    """The deterministic chains (DDIM eta 0, DPM++) sharded over two ranks
    from a given x_T and gathered, against the JAX package's ``denoise`` on
    the same x_T, labels and weights: within the repo's bar for the port's
    chain against JAX's (1e-3, test_torch_diffusion.py), and no farther from
    JAX than the one-process chain is, to 1e-5. The one-process chain itself
    is up to 1.2e-4 from JAX's here (DDIM-8 on these weights: the two
    frameworks' f32 convolutions round differently), so 1e-5 to JAX is not a
    bar the port meets unsharded either."""
    _, params, jmodel = work
    x, y = workers.sampling_inputs()
    jd = JaxDiffusion(model=jmodel, **dict(workers.DIFF_ARGS, rescaled_num_steps=8),
                      sampler=sampler)
    ref = np.asarray(jd.denoise(params, jax.random.PRNGKey(0), x=x.numpy(),
                                y=y.numpy().astype(np.int32), encoder_cache=enc))
    sharded, single = torch.load(work[0] / "sampling.pt",
                                 weights_only=False)[f"{sampler}.{enc}"][:2]
    np.testing.assert_allclose(sharded.numpy(), ref, rtol=0, atol=1e-3)
    assert np.abs(sharded.numpy() - ref).max() <= np.abs(single.numpy() - ref).max() + 1e-5


CUSTOM = ["--custom", "--resolution", "8", "--model_channels", "32", "--channel_mult", "1/2",
          "--num_res_blocks", "1", "--attention_resolutions", "4", "--in_channels", "1",
          "--num_heads", "2", "--num_classes", "3", "--split_qkv_first", "--resblock_updown",
          "--use_adaptive_gn", "--rescaled_num_steps", "4", "--original_num_steps", "40",
          "--beta_schedule", "cosine", "--sampling_var_type", "learned_interpolation",
          "--guidance_method", "classifier_free", "--guidance_strength", "0.8"]


def _files(d):
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


def test_data_parallel_entry_point_writes_what_one_process_writes(work, tmp_path):
    """DDPM (step noise drawn at the global shape) through the entry point:
    2 samples of 4 random labels on two ranks, rank 0 saving, against one
    process with and without the flag."""
    root = work[0]
    argv = lambda out, *extra: ["--model_path", str(root / "weights.pt"), *CUSTOM,  # noqa: E731
                                "--batch_size", "4", "--num_samples", "2", "--save_path",
                                str(out) + "/", "--seed", "5", "--cpu", *extra]
    for name in ("dp", "one", "flag"):
        os.makedirs(tmp_path / name)
    assert run("sample_cli", argv=argv(tmp_path / "dp", "--data_parallel")) == [2, 0]
    one = sample_main(argv(tmp_path / "one"))
    flag = sample_main(argv(tmp_path / "flag", "--data_parallel"))  # a world of one
    for a, b in zip(one, flag):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    files = _files(tmp_path / "dp")
    assert len(files) == 8 and files == _files(tmp_path / "one") == _files(tmp_path / "flag")
