"""The graphed training steps (training/graphs.py) on the CPU.

On a CUDA device ``Trainer.train_step`` and both distillers' ``train_step``
replay one captured CUDA graph a step. What a graph captures is the step's
body on static buffers (``TrainGraphs._body``); ``TrainGraphs(capture=False)``
keeps that body, run eagerly, in place of each replay, so the graphed path
(its static inputs and outputs, keys, draws made ahead, the dropout draws'
refill, the accumulators, the clones it returns, the signature) runs here:

- (a) the Trainer's graphed step equals its eager step bit for bit (k = 1,
  2 and 3, dropout 0.05 with remat, HYBRID under CFG with the label drop):
  every step's loss and gradient norm, the parameters, EMA, AdamW's state,
  the accumulators and the generator;
- (b) the tensors it returns are the caller's: a list of them reads every
  step's own value;
- (c) a restore in the middle of an accumulation round drops the graphs and
  carries the pending gradients into the static buffers;
- (d) both distillers, constant rate and ``warmup_cosine``, bit for bit;
- (e) the graphed path against optax and the JAX distillers at the existing
  tests' tolerances (tests/test_torch_trainer.py, tests/test_torch_distill.py);
- (f) ``cuda_graph=True`` raises on the CPU, on the data- and
  tensor-parallel trainers and while int8 calibration records; the draws'
  stand-in and the signature.

The card holds real graphs against the eager step bit for bit in
tests/test_torch_kernels.py (``-k graph``) and chip_smoke.py's
``[train-graph]``.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import test_torch_distill as tdist  # noqa: E402
import test_torch_trainer as ttrain  # noqa: E402
from nicediffusion_tpu_torch import DiffusionModel, Trainer  # noqa: E402
from nicediffusion_tpu_torch.models.unet import DropoutDraws  # noqa: E402
from nicediffusion_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from nicediffusion_tpu_torch.training import distill as td  # noqa: E402
from nicediffusion_tpu_torch.training.data import synthetic_batches  # noqa: E402
from nicediffusion_tpu_torch.training.graphs import TrainGraphs, make_adamw  # noqa: E402

MODEL = dict(ttrain.TINY_MODEL)
DIFF = dict(ttrain.DIFF_ARGS)


def graphed(obj):
    """``obj`` (a Trainer or a distiller) on the graphed path with the body
    run eagerly in place of each replay: what a CUDA device runs, minus the
    capture."""
    obj._graphs = TrainGraphs(capture=False)
    obj._use_graphs = lambda: True
    return obj


def trainer(tmp_path, graph, k=1, dropout=0.0, remat=False, **kw):
    torch.manual_seed(0)
    model = DiffusionModel(**dict(MODEL, dropout=dropout, use_remat=remat), device="cpu")
    tr = Trainer(model, dict(DIFF), synthetic_batches(8, 8, 1, 4, seed=1), iterations=8,
                 batch_size=8, lr=2e-3, weight_decay=1e-4, ema_rate=0.9, grad_accumulation=k,
                 checkpoint_dir=str(tmp_path / ("graph" if graph else "eager")), seed=3,
                 device="cpu", **kw)
    return graphed(tr) if graph else tr


def trainer_state(tr):
    out = [p.detach() for p in tr.model.parameters()] + list(tr.ema_model.parameters())
    out += [v for s in tr.optimizer.state.values() for v in s.values()]
    out += list(tr._grad_accum or ())
    return [t.clone() for t in out] + [tr.generator.get_state()]


def run_steps(tr, n):
    return [tr.train_step(*next(tr.loader)) for _ in range(n)]


def assert_same_steps(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for name in a:
            assert torch.equal(a[name], b[name]), name


def assert_same_state(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"state tensor {i}"


# ----------------------------------------------------------------------
# (a), (b) the Trainer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("model", ["plain", "dropout_remat"])
def test_graphed_trainer_step_equals_the_eager_step(tmp_path, k, model):
    """Seven steps (the keys' first steps, then replays), HYBRID under CFG
    with a label drop of 0.3, with dropout 0.05 and remat or without: bit
    for bit, and one key a micro-step position."""
    kw = dict(dropout=0.05, remat=True) if model == "dropout_remat" else {}
    g, e = trainer(tmp_path, True, k, label_drop_prob=0.3, **kw), trainer(
        tmp_path, False, k, label_drop_prob=0.3, **kw)
    assert_same_steps(run_steps(g, 7), run_steps(e, 7))
    assert_same_state(trainer_state(g), trainer_state(e))
    assert g.step == e.step == 7 and len(g._graphs.graphs) == k
    draws = next(iter(g._graphs.buffers.values())).draws
    n_res = sum(type(m).__name__ == "ResidualBlock" for m in g.model.modules())
    assert len(draws.buffers) == (n_res if model == "dropout_remat" else 0)


def test_graphed_steps_return_tensors_the_caller_owns(tmp_path):
    """A caller that keeps each step's metrics reads each step's values, not
    the last replay's: the graphed step returns clones of its static
    outputs."""
    g, e = trainer(tmp_path, True), trainer(tmp_path, False)
    kept, want = run_steps(g, 4), run_steps(e, 4)
    assert len({m["loss"].item() for m in kept}) == 4
    assert [m["loss"].item() for m in kept] == [m["loss"].item() for m in want]
    static = next(iter(g._graphs.buffers.values())).outputs
    assert all(m[n].data_ptr() != static[n].data_ptr() for m in kept for n in m)


def test_train_loop_logs_the_eager_losses(tmp_path):
    """``train()``'s running sum over graphed steps: the metrics file reads
    as the eager run's."""
    rows = {}
    for graph in (True, False):
        path = tmp_path / f"metrics_{graph}.jsonl"
        tr = trainer(tmp_path, graph, k=2, metrics_path=str(path), print_every=2)
        tr.iterations = 5
        tr.train()
        rows[graph] = [{k: v for k, v in r.items() if k != "steps_per_sec"}
                       for r in map(json.loads, path.read_text().splitlines())]
    assert rows[True] == rows[False] and len(rows[True]) == 3


def test_a_restore_mid_run_drops_the_graphs_and_matches_eager(tmp_path):
    """k = 2: three steps (a round pending), save, two more, then a restore
    of the save and two steps again. The restore replaces AdamW's tensors,
    so it drops every graph; its pending gradients go into the static
    accumulators. Graphed and eager agree bit for bit at every step."""
    runs = {}
    for graph in (True, False):
        tr = trainer(tmp_path, graph, k=2, dropout=0.05, remat=True)
        metrics = run_steps(tr, 3)
        tr.save(3)
        metrics += run_steps(tr, 2)
        if graph:
            assert tr._graphs.graphs
        assert tr.restore(3) == 3 and tr._grad_accum is not None
        if graph:
            assert not tr._graphs.graphs
        metrics += run_steps(tr, 2)
        runs[graph] = (metrics, trainer_state(tr))
    assert_same_steps(runs[True][0], runs[False][0])
    assert_same_state(runs[True][1], runs[False][1])


def test_replaced_state_moves_the_signature(tmp_path):
    """The signature holds the pointers of what a graph writes and reads
    outside the pool: held across steps, moved by a replaced parameter."""
    g = trainer(tmp_path, True)
    run_steps(g, 2)
    sig = g._graph_signature()
    assert g._graphs.signature == sig
    run_steps(g, 1)
    assert g._graph_signature() == sig and len(g._graphs.graphs) == 1
    name, p = next(iter(g.model.named_parameters()))
    owner, attr = name.rsplit(".", 1)
    setattr(g.model.get_submodule(owner), attr, torch.nn.Parameter(p.detach().clone()))
    g._params = list(g.model.parameters())
    assert g._graph_signature() != sig


def test_a_step_bumps_the_versions_of_what_it_wrote():
    """A replay writes without moving version counters (here: a write
    through ``.data``, which moves none either); every step bumps the
    versions of ``written``, so a cache keyed on them (``WinogradConv``'s U,
    the chain graphs' signature) sees the update."""
    w = torch.zeros(3)
    graphs = TrainGraphs(capture=False)

    def body(inputs, draws):
        w.data.add_(inputs["x"])
        return {"sum": w.sum()}

    for i in range(3):
        before = w._version
        out = graphs.run(lambda: (w.data_ptr(),), [w], {"x": torch.ones(3)}, None, None, body)
        assert w._version > before and out["sum"].item() == 3.0 * (i + 1)


# ----------------------------------------------------------------------
# (d) both distillers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine"])
@pytest.mark.parametrize("kind", ["guided", "progressive"])
def test_graphed_distiller_step_equals_the_eager_step(kind, schedule):
    """Four steps of each distiller, graphed against eager, the variance
    term on: every step's metrics, the student, EMA, AdamW's state and the
    generator bit for bit; one key."""
    model, params, batch, labels = tdist.jax_setup(tdist.TINY_LV, seed=2)
    runs = {}
    for graph in (True, False):
        kw = dict(var_weight=1.0, lr_schedule=schedule, ema_rate=0.5, seed=5, lr=1e-3)
        if kind == "guided":
            kw["guidance_strength"] = 0.8
        d = tdist.port_pair(kind, tdist.TINY_LV, params, tdist.DARGS_LV, **kw)
        if graph:
            graphed(d)
        metrics = [d.train_step(batch, labels) for _ in range(4)]
        state = [p.detach() for p in d.model.parameters()] + list(d.ema_model.parameters())
        state += [v for s in d.optimizer.adamw.state.values() for v in s.values()]
        runs[graph] = (metrics, [t.clone() for t in state] + [d.generator.get_state()], d)
    assert_same_steps(runs[True][0], runs[False][0])
    assert_same_state(runs[True][1], runs[False][1])
    g = runs[True][2]
    assert len(g._graphs.graphs) == 1 and g.optimizer.count == g.step == 4
    assert len({m["loss"].item() for m in runs[True][0]}) == 4


# ----------------------------------------------------------------------
# (e) against optax and the JAX distillers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["test_two_adamw_ema_steps_match_optax",
                                  "test_accumulation_matches_optax_multisteps"])
def test_graphed_trainer_matches_optax(tmp_path, monkeypatch, case):
    """tests/test_torch_trainer.py's optax comparisons, as they stand (1e-6),
    with every Trainer they make on the graphed path."""
    init = Trainer.__init__

    def graphed_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        graphed(self)

    monkeypatch.setattr(Trainer, "__init__", graphed_init)
    getattr(ttrain, case)(tmp_path)


@pytest.mark.parametrize("case", ["guided_eps_teacher_v_student", "progressive_x0snr_var"])
def test_graphed_distillers_match_jax(case):
    """tests/test_torch_distill.py's two steps against the JAX distillers
    (metrics 1e-5 relative; the student and EMA to 1e-5 of the student's
    largest element where the gradients are not float noise) on the graphed
    path: warmup-cosine rates, a guided v student and the progressive
    variance term."""
    kind, cfg, dargs, kw = tdist.STEP_CASES[case]
    kw = dict(kw, ema_rate=0.5, seed=5)
    model, params, batch, labels = tdist.jax_setup(cfg, seed=1)
    jcls = tdist.jd.GuidedDistiller if kind == "guided" else tdist.jd.ProgressiveDistiller
    jdist = jcls(model=model, teacher_params=params, diffusion_args=dargs,
                 dataloader=iter(()), iterations=2, **kw)
    pdist = graphed(tdist.port_pair(kind, cfg, params, dargs, **kw))
    grads = []
    apply = pdist.optimizer.apply

    def recording(gs):  # the graphed body's update
        gs = list(gs)
        grads.append([g.abs().numpy().copy() for g in gs])
        return apply(gs)

    pdist.optimizer.apply = recording
    key = jdist.rng
    for step in range(2):
        key, step_rng = jax.random.split(key)
        jdist.state, want = jdist._step_fn(jdist.state, jdist.teacher_params,
                                           jnp.asarray(batch), jnp.asarray(labels), step_rng)
        j_rng, n_rng = jax.random.split(step_rng)
        j = jax.random.randint(j_rng, (tdist.BATCH,), 0, jdist.student.rescaled_num_steps)
        noise = jax.random.normal(n_rng, batch.shape, dtype=jnp.float32)
        got = pdist.train_step(batch, labels, j=np.asarray(j), noise=np.asarray(noise))
        for name in ("loss", "loss_eps", "loss_var", "grad_norm"):
            np.testing.assert_allclose(got[name].item(), float(want[name]), rtol=1e-5,
                                       atol=1e-12, err_msg=f"{name} at step {step + 1}")
    assert len(grads) == 2 and pdist.step == 2 and len(pdist._graphs.graphs) == 1
    names = [n for n, _ in pdist.model.named_parameters()]
    top = [max(g.max() for g in step_grads) for step_grads in grads]
    mask = {n: np.logical_and(*[(g[i] >= 1e-3 * g[i].max()) & (g[i].max() >= 1e-6 * t)
                                for g, t in zip(grads, top)])
            for i, n in enumerate(names)}
    left_out = sum((~m).sum() for m in mask.values()) / sum(m.size for m in mask.values())
    assert left_out < 0.1
    tdist.assert_tree_close(pdist.model, jdist.state.params, "student", mask)
    tdist.assert_tree_close(pdist.ema_model, jdist.state.ema_params, "EMA", mask)


# ----------------------------------------------------------------------
# (f) refusals, the draws' stand-in
# ----------------------------------------------------------------------

@pytest.fixture()
def group_of_one(tmp_path):
    """A gloo process group of this one process, torn down after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", ["data_parallel", "tensor_parallel"])
def test_cuda_graph_true_raises_on_the_parallel_trainers(tmp_path, group_of_one, case):
    """Their collectives stay eager (NCCL capture needs a host with several
    GPUs): ``cuda_graph=True`` names the reason, None runs eagerly."""
    kw = dict(distributed=True) if case == "data_parallel" else dict(mesh=Mesh(1, 2))
    reason = "data-parallel" if case == "data_parallel" else "tensor-parallel"
    with pytest.raises(NotImplementedError, match=f"{reason}.*ROADMAP.md queue A item 2"):
        trainer(tmp_path, False, cuda_graph=True, **kw)
    tr = trainer(tmp_path, False, **kw)
    assert tr._use_graphs() is False


def test_cuda_graph_true_raises_on_the_cpu_and_while_calibrating(tmp_path):
    with pytest.raises(ValueError, match="needs a CUDA device"):
        trainer(tmp_path, False, cuda_graph=True)
    model, params, _, _ = tdist.jax_setup(tdist.TINY_COND, seed=2)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tdist.port_pair("progressive", tdist.TINY_COND, params, tdist.DARGS, cuda_graph=True)
    torch.manual_seed(0)
    q = DiffusionModel(**MODEL, quantized=True, device="cpu")
    tr = Trainer(q, dict(DIFF), synthetic_batches(8, 8, 1, 4, seed=1), iterations=1,
                 batch_size=8, lr=1e-3, weight_decay=0.0, checkpoint_dir=str(tmp_path),
                 device="cpu")
    assert tr._graph_refusal() is None and tr._use_graphs() is False
    with q.calibrating():
        assert "int8 calibration" in tr._graph_refusal()
        tr.cuda_graph = True
        with pytest.raises(NotImplementedError, match="int8 calibration"):
            tr._use_graphs()


def test_dropout_draws_replay_the_generator_stream():
    """``DropoutDraws`` records the first step's draws from the generator,
    refills them in order before a later step (the stream the eager steps
    draw), and its cursor is what the remat recompute resets."""
    g, ref = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    draws = DropoutDraws(g)
    shapes = [(2, 3), (4,), (2, 3)]
    first = [draws.uniform(s, "cpu").clone() for s in shapes]
    assert all(torch.equal(a, torch.rand(s, generator=ref)) for a, s in zip(first, shapes))
    draws.set_state(1)  # a recompute of the second block
    assert torch.equal(draws.uniform((4,), "cpu"), first[1])
    draws.refill()
    second = [draws.uniform(s, "cpu") for s in shapes]
    assert all(torch.equal(a, torch.rand(s, generator=ref)) for a, s in zip(second, shapes))
    assert torch.equal(g.get_state(), ref.get_state())
    draws.set_state(0)  # a forward of other shapes on the same draws
    with pytest.raises(ValueError, match="forward asks for"):
        draws.uniform((5,), "cpu")


def test_make_adamw_is_plain_on_the_cpu():
    p = [torch.nn.Parameter(torch.ones(3))]
    opt = make_adamw(p, 1e-3, 0.1, tensor_lr=True)
    group = opt.param_groups[0]
    assert group["lr"] == 1e-3 and not group["capturable"]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert isinstance(td._make_optimizer(p, 1e-3, 0.0, 10, 1.0, "constant"), td._Optimizer)
