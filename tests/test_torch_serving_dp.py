"""The port's data-parallel serving daemon on the CPU, mirroring
tests/test_serving.py::test_mesh_sharded_service_matches_single_device.

Two ranks in a gloo group (``spawn_ranks``: a ``file://`` rendezvous, a
timeout, every process ended): rank 0 serves, rank 1 follows.

  * The two-rank service equals the one-rank service at atol 1e-5 (the JAX
    test's bar, on its weights) and, on random weights too, the rows each
    rank's chain computes (1e-6), with no padded rows, after an idle wait in
    which rank 0 sends idle headers (``KEEPALIVE_S`` shortened to 0.2 s);
    ``close()`` on rank 0 ends ``follow()`` on rank 1.
  * A chain that raises on one rank (rank 0 or the follower) fails that
    request alone, every rank skipping the gather; the next request is
    served as before and ``close()`` still ends ``follow()``.
  * ``--serve_data_parallel --dtype int8`` through ``build_service`` on two
    ranks, from one calibration file, equals the one-process daemon.
  * ``serve_batch`` not a multiple of the world size raises ValueError.
  * ``dryrun_multigpu(2)`` prints its three lines.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from nicediffusion_tpu.models.unet import DiffusionModel as JaxModel  # noqa: E402
from nicediffusion_tpu_torch import Diffusion, DiffusionModel  # noqa: E402
from nicediffusion_tpu_torch.parallel.dryrun import dryrun_multigpu, spawn_ranks  # noqa: E402
from nicediffusion_tpu_torch.scripts import serve  # noqa: E402
from nicediffusion_tpu_torch.serving import SamplerService, ServingConfig  # noqa: E402
from test_torch_serving import SERVE_CUSTOM, serve_npz  # noqa: E402, F401
from test_torch_unet import port_model, random_jax_params  # noqa: E402
import torch_dp_workers as workers  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 120.0  # each group of two ranks; they take about 5 to 10 s


def run(tmp_path, target="serving", **kwargs):
    return spawn_ranks(f"torch_dp_workers:{target}", 2, dict(work=str(tmp_path), **kwargs),
                       timeout_s=TIMEOUT_S, pythonpath=(TESTS,))


@pytest.mark.parametrize("weights", ["jax_init", "random"])
def test_two_rank_service_matches_one_rank(tmp_path, weights):
    """``jax_init``: the JAX test's weights (flax init, PRNGKey(0)), held to
    the one-rank service at its 1e-5. ``random``: seeded fan-in-scaled
    weights. Both held to 1e-6 against the rows each rank computes, made in
    this process by ``Diffusion.denoise`` with the row shard. With the random
    weights the one-rank chain at batch 8 and the same chain as two batches
    of 4 in one process already differ by about 7e-5, ranks or none: the
    CPU's f32 matrix products round by batch (2e-6 on a forward's output of
    2), and DDIM-4's first x0 projection multiplies that by 1/sqrt(acp)."""
    if weights == "jax_init":
        params = JaxModel(**workers.SERVE_MODEL).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 1)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1,), jnp.int32))["params"]
        params = jax.tree.map(np.array, params)  # writable numpy leaves
    else:
        _, params = random_jax_params(workers.SERVE_MODEL, seed=0)
    model = port_model(workers.SERVE_MODEL, params).eval()
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    got = run(tmp_path, weights=str(tmp_path / "weights.pt"), keepalive_s=0.2)
    assert got[0] == {"padded_rows": 0, "batches": 1}
    assert got[1] == {"followed": True, "closed": True}  # close() ended follow()
    served = torch.load(tmp_path / "served.pt").numpy()
    assert served.shape == (8, 8, 8, 1) and np.isfinite(served).all()

    diffusion = Diffusion(model=model, **workers.SERVE_DIFF)
    cfg = ServingConfig(serve_batch=8, linger_ms=100.0)
    with SamplerService(diffusion, cfg, device="cpu") as svc:
        single = svc.sample(labels=workers.SERVE_LABELS, seed=11, timeout=120)
        x, y = svc._draw_x(11, 8), torch.tensor(workers.SERVE_LABELS)
        rows = torch.cat([diffusion.denoise(svc._step_generator(0), x=x[4 * r:4 * r + 4],
                                            y=y[4 * r:4 * r + 4], row_shard=(r, 2))
                          for r in (0, 1)]).numpy()
    np.testing.assert_allclose(served, rows, rtol=0, atol=1e-6)
    if weights == "jax_init":
        np.testing.assert_allclose(served, single, rtol=0, atol=1e-5)
    print(f"{weights}: two ranks against one rank, max abs {abs(served - single).max():.3g}")


@pytest.mark.parametrize("fail_rank", [0, 1])
def test_a_chain_that_raises_fails_its_batch_alone(tmp_path, fail_rank):
    """The chain raises once on ``fail_rank`` in the first served batch: that
    request fails on rank 0 (no rank is left waiting in the gather), the
    second request (k = 1) comes back as the rows each rank computes (1e-6),
    and close() ends follow()."""
    _, params = random_jax_params(workers.SERVE_MODEL, seed=0)
    model = port_model(workers.SERVE_MODEL, params).eval()
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    got = run(tmp_path, "serving_with_a_failure", weights=str(tmp_path / "weights.pt"),
              fail_rank=fail_rank)
    assert got[0]["batches"] == 1
    assert got[0]["error"].startswith("the chain raised on 1 of 2 ranks")
    assert ("injected on rank 0" in got[0]["error"]) == (fail_rank == 0)
    assert got[1] == {"followed": True, "closed": True, "warm": True}
    served = torch.load(tmp_path / "served.pt").numpy()
    diffusion = Diffusion(model=model, **workers.SERVE_DIFF)
    with SamplerService(diffusion, ServingConfig(serve_batch=8), device="cpu") as svc:
        x, y = svc._draw_x(11, 8), torch.tensor(workers.SERVE_LABELS)
        rows = torch.cat([diffusion.denoise(svc._step_generator(1), x=x[4 * r:4 * r + 4],
                                            y=y[4 * r:4 * r + 4], row_shard=(r, 2))
                          for r in (0, 1)]).numpy()
    np.testing.assert_allclose(served, rows, rtol=0, atol=1e-6)


def test_int8_daemon_on_two_ranks_matches_one(tmp_path, serve_npz):  # noqa: F811
    """The calibration is drawn and written by the one-process daemon, then
    read by both ranks."""
    argv = ["--model_path", serve_npz, *SERVE_CUSTOM, "--use_ddim", "--cpu", "--batch_size", "4",
            "--dtype", "int8", "--int8_calibration", str(tmp_path / "calib.npz")]
    svc, _ = serve.build_service(argv)
    with svc:
        single = svc.sample(n=4, seed=11, timeout=120)
    got = run(tmp_path, weights="", int8_argv=argv + ["--serve_data_parallel"])
    assert got[0] == {"padded_rows": 0, "batches": 1} and got[1]["followed"]
    np.testing.assert_allclose(torch.load(tmp_path / "served.pt").numpy(), single,
                               rtol=0, atol=1e-5)


def test_serve_batch_must_be_a_multiple_of_the_world(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    model = DiffusionModel(**workers.SERVE_MODEL, device="cpu").eval()
    with pytest.raises(ValueError, match="serve_batch=3 must be a multiple of the 'data' axis "
                                         "size 2"):
        SamplerService(Diffusion(model=model, **workers.SERVE_DIFF), ServingConfig(serve_batch=3),
                       device="cpu", distributed=True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)  # a follower: no worker, no submit
    svc = SamplerService(Diffusion(model=model, **workers.SERVE_DIFF),
                         ServingConfig(serve_batch=4), device="cpu", distributed=True)
    assert svc.warmup() is svc and svc._worker is None
    with pytest.raises(RuntimeError, match="submit on rank 0"):
        svc.submit(labels=[1])
    svc.close()


def test_dryrun_multigpu_prints_its_three_lines(capsys):
    lines = dryrun_multigpu(2, timeout_s=TIMEOUT_S)
    out = capsys.readouterr().out.splitlines()
    assert out == lines and len(lines) == 3
    assert lines[0].startswith("dryrun_multigpu(2): one DP train step OK, loss=")
    assert lines[1].startswith("dryrun_multigpu(2): DP sampling chain OK (batch 4 sharded")
    assert lines[2].startswith("dryrun_multigpu(2): sharded serving daemon OK (serve batch 2")
