"""The port's multi-process plumbing on the CPU, mirroring tests/test_multihost.py.

  * Two processes in a gloo group (``spawn_ranks``: a ``file://`` rendezvous,
    a timeout, every process ended) take two data-parallel steps, save, and
    a fresh ``Trainer(resume_step="auto")`` on each restores: the state is
    bit for bit what was saved on both ranks, only rank 0 wrote, and the
    restored state trains on.
  * ``maybe_initialize_distributed`` reads torchrun's environment: nothing
    without ``WORLD_SIZE``, the rank, world, card and default backend with
    it, and only once.
  * ``process_local_batch_size`` keeps the JAX package's contract and message.
"""

import datetime
import os

import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")

from nicediffusion_tpu_torch.parallel import multihost  # noqa: E402
from nicediffusion_tpu_torch.parallel.dryrun import spawn_ranks  # noqa: E402
from test_torch_unet import port_model, random_jax_params  # noqa: E402
import torch_dp_workers as workers  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 120.0  # the group of two ranks; it takes about 6 s


def test_two_process_checkpoint_roundtrip(tmp_path):
    _, params = random_jax_params(workers.TINY_MODEL, seed=5)
    torch.save(port_model(workers.TINY_MODEL, params).state_dict(), tmp_path / "weights.pt")
    got = spawn_ranks("torch_dp_workers:checkpoint_round_trip", 2,
                      dict(work=str(tmp_path), weights=str(tmp_path / "weights.pt")),
                      timeout_s=TIMEOUT_S, pythonpath=(TESTS,))
    for r, res in enumerate(got):
        assert res["before"] == res["after"], f"rank {r} restored another state"
        assert res["step"] == 2
    assert got[0]["before"] == got[1]["before"]  # one state on both ranks
    assert [res["saves"] for res in got] == [1, 0]  # only rank 0 wrote
    assert got[0]["loss"] == got[1]["loss"] and got[0]["loss"] > 0
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_2"]
    assert os.listdir(tmp_path / "ckpt" / "step_2") == ["state.pt"]


def test_train_entry_point_on_two_ranks(tmp_path):
    """scripts/train.py in a group of two (its own ``maybe_initialize_distributed``
    finds the group): a global batch of 8 as 4 rows a rank, both ranks end
    with one state, and only rank 0 wrote the checkpoint, metrics and
    samples (``--sample_every 1``: the in-training sampler runs sharded)."""
    argv = ["--synthetic", "--device", "cpu", "--iterations", "2", "--batch_size", "8",
            "--resolution", "8", "--model_channels", "32", "--channel_mult", "1/2",
            "--num_res_blocks", "1", "--attention_resolutions", "4", "--num_head_channels", "16",
            "--sample_every", "1", "--save_every", "0",
            "--checkpoint_dir", str(tmp_path / "ckpt"), "--metrics_path",
            str(tmp_path / "metrics.jsonl"), "--samples_dir", str(tmp_path / "samples")]
    got = spawn_ranks("torch_dp_workers:train_cli", 2, dict(argv=argv), timeout_s=TIMEOUT_S,
                      pythonpath=(TESTS,))
    assert got[0] == got[1]
    assert got[0]["step"] == 2 and got[0]["rows"] == 4 and got[0]["distributed"]
    assert os.listdir(tmp_path / "ckpt") == ["step_2"]
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 2
    assert len(os.listdir(tmp_path / "samples")) == 4


def test_maybe_initialize_distributed_env_plumbing(monkeypatch):
    """No-op without WORLD_SIZE; with torchrun's variables, one
    init_process_group with the rank, world, rendezvous and timeout, the
    card set from LOCAL_RANK and the backends chosen by whether there is a
    card; idempotent once a group exists."""
    calls, devices = [], []
    initialized = [False]
    monkeypatch.setattr(dist, "is_initialized", lambda: initialized[0])
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(torch.cuda, "set_device", devices.append)
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)

    # no-op without the launcher's environment
    assert multihost.maybe_initialize_distributed() is False
    assert calls == [] and devices == []

    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert multihost.maybe_initialize_distributed() is True
    timeout = datetime.timedelta(seconds=multihost.COLLECTIVE_TIMEOUT_S)
    assert calls[-1] == (("gloo",), dict(init_method="env://", rank=3, world_size=4,
                                         timeout=timeout))
    assert devices == []  # no card: none set

    # with a card: cuda:LOCAL_RANK, NCCL for CUDA tensors and gloo for CPU ones
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert multihost.maybe_initialize_distributed() is True
    assert calls[-1][0] == ("cpu:gloo,cuda:nccl",) and devices == [1]
    # an explicit backend (several ranks on one card) and rendezvous are kept
    multihost.maybe_initialize_distributed("gloo", init_method="file:///tmp/x")
    assert calls[-1][0] == ("gloo",) and calls[-1][1]["init_method"] == "file:///tmp/x"

    # idempotent: once a group exists, nothing more happens
    initialized[0] = True
    assert multihost.maybe_initialize_distributed() is False
    assert len(calls) == 3


def test_process_local_batch_size(monkeypatch):
    assert multihost.process_local_batch_size(468) == 468  # no group: one process
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    assert multihost.process_local_batch_size(16) == 4
    with pytest.raises(AssertionError, match="global batch 10 must divide process count 4"):
        multihost.process_local_batch_size(10)


def test_backend_for(monkeypatch):
    assert multihost.backend_for("cuda") is None  # no group
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend_config", lambda: "cpu:gloo,cuda:nccl")
    assert (multihost.backend_for("cuda"), multihost.backend_for("cpu")) == ("nccl", "gloo")
    monkeypatch.setattr(dist, "get_backend_config", lambda: "gloo")
    assert multihost.backend_for("cuda") == "gloo"
