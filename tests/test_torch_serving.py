"""The port's serving daemon (nicediffusion_tpu_torch/serving/,
scripts/serve.py) on the CPU, against the JAX package's.

Every case of tests/test_serving.py but the mesh one (that one is in
tests/test_torch_serving_dp.py), on the port's service with ``device="cpu"``
and the same tiny configuration (8x8 one-channel UNet, 4 DDIM eta=0 steps).
Then parity: the
JAX and the port service on the same weights (seeded numpy values carried
across by ``flax_params_to_torch_state_dict``), the same start noise
injected into both through ``_draw_x``, several requests packed with
padding, to 1e-3 in f32; one CFG case with the encoder cache and the
guidance interval; DDPM bit-equal between two port services with the same
``rng_seed`` (and after a warmup); both packages' ``build_service`` on one
``.npz``; the refusals of the serving entry point.
"""

import functools
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nicediffusion_tpu.diffusion.process import Diffusion as JaxDiffusion  # noqa: E402
from nicediffusion_tpu.serving import SamplerService as JaxService  # noqa: E402
from nicediffusion_tpu.serving import ServingConfig as JaxConfig  # noqa: E402
from nicediffusion_tpu.utils.checkpoint import save_params_npz  # noqa: E402
from nicediffusion_tpu_torch import Diffusion  # noqa: E402
from nicediffusion_tpu_torch.scripts import serve  # noqa: E402
from nicediffusion_tpu_torch.serving import (  # noqa: E402
    SamplerService,
    ServingConfig,
    decode_images,
    make_server,
)
from nicediffusion_tpu_torch.serving.http import _encode  # noqa: E402
from test_torch_unet import port_model, random_jax_params  # noqa: E402


def tiny_cfg(conditional=True):
    return dict(
        resolution=8, in_channels=1, model_channels=32, out_channels=2,
        num_res_blocks=1, attention_resolutions=(), channel_mult=(1, 2),
        num_heads=2, num_classes=5 if conditional else None, dropout=0.0,
        resblock_updown=False, use_adaptive_gn=False, split_qkv_first=True,
    )


def diff_args(steps=4, **kw):
    return dict(original_num_steps=40, rescaled_num_steps=steps,
                sampling_var_type="learned_interpolation", loss_type="hybrid",
                beta_schedule="linear", sampler="ddim", ddim_eta=0.0, use_ddim=True, **kw)


@functools.lru_cache(maxsize=None)
def weights(conditional=True, seed=0):
    """(JAX model, seeded numpy parameter tree) of tiny_cfg; read only."""
    return random_jax_params(tiny_cfg(conditional), seed)


def _tiny_service(serve_batch=4, linger_ms=200.0, conditional=True, steps=4,
                  dargs=None, dtype=None, **cfg_kw):
    _, params = weights(conditional)
    model = port_model(tiny_cfg(conditional), params, dtype=dtype)
    diffusion = Diffusion(model=model, **(dargs or diff_args(steps)))
    return SamplerService(
        diffusion, ServingConfig(serve_batch=serve_batch, linger_ms=linger_ms, **cfg_kw),
        device="cpu",
    )


def noise(seed, n, shape=(8, 8, 1)):
    """The injected start noise: seeded numpy draws, the same in both packages."""
    return np.random.default_rng(seed).standard_normal((n, *shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# tests/test_serving.py's cases, on the port
# ---------------------------------------------------------------------------

def test_submit_and_shapes():
    with _tiny_service() as svc:
        out = svc.sample(labels=[1, 2], seed=0, timeout=120)
        assert out.shape == (2, 8, 8, 1)
        assert out.dtype == np.float32
        assert np.isfinite(out).all()
        assert np.abs(out).max() <= 1.0


def test_microbatching_coalesces_concurrent_requests():
    with _tiny_service(serve_batch=4, linger_ms=500.0) as svc:
        svc.warmup()
        assert svc.stats()["warm"] is True
        futs = [svc.submit(labels=[i], seed=i) for i in range(4)]
        outs = [f.result(timeout=120) for f in futs]
        s = svc.stats()
        # 4 single-row requests filled exactly one 4-row batch; warmup is
        # not counted in the serving stats
        assert s["batches"] == 1
        assert s["samples"] == 4
        assert s["padded_rows"] == 0
        assert s["requests"] == 4
        assert all(o.shape == (1, 8, 8, 1) for o in outs)


def test_partial_batch_is_padded_and_flushed_by_linger():
    with _tiny_service(serve_batch=4, linger_ms=30.0) as svc:
        svc.warmup()
        out = svc.sample(labels=[3], seed=7, timeout=120)
        assert out.shape == (1, 8, 8, 1)
        s = svc.stats()
        assert s["padded_rows"] == 3  # 1 real row + 3 padding
        assert 0.0 < s["occupancy"] < 1.0
        assert s["samples_per_sec"] > 0
        json.dumps(s)  # /stats dumps it: plain Python numbers only


def test_deterministic_sampler_is_batch_position_independent():
    # DDIM eta=0 is deterministic given x_T, and x_T comes from the request
    # seed, so the same (labels, seed) must reproduce bit for bit whatever
    # it was co-batched with
    with _tiny_service(serve_batch=4, linger_ms=300.0) as svc:
        svc.warmup()
        alone = svc.sample(labels=[2], seed=42, timeout=120)  # a padded batch
        futs = [svc.submit(labels=[i], seed=i) for i in range(3)]
        futs.append(svc.submit(labels=[2], seed=42))  # last row of a full batch
        outs = [f.result(timeout=120) for f in futs]
        assert svc.stats()["batches"] == 2
        np.testing.assert_allclose(alone, outs[-1], rtol=0, atol=1e-6)


def test_deterministic_sampler_is_batch_position_independent_in_bf16():
    # the same in bf16 compute, bit for bit: the convs and dense products
    # take the bf16 conv's plain version here (its kernel on the card), which
    # sums each example alone
    with _tiny_service(serve_batch=4, linger_ms=300.0, dtype=torch.bfloat16) as svc:
        assert svc.diffusion.model.dtype == torch.bfloat16
        svc.warmup()
        alone = svc.sample(labels=[2], seed=42, timeout=120)  # a padded batch
        futs = [svc.submit(labels=[i], seed=i) for i in range(3)]
        futs.append(svc.submit(labels=[2], seed=42))  # last row of a full batch
        outs = [f.result(timeout=120) for f in futs]
        assert svc.stats()["batches"] == 2
        np.testing.assert_allclose(alone, outs[-1], rtol=0, atol=0)


def test_fifo_packing_request_spans_to_next_batch():
    with _tiny_service(serve_batch=4, linger_ms=150.0) as svc:
        svc.warmup()
        f1 = svc.submit(labels=[0, 1, 2], seed=1)  # 3 rows
        f2 = svc.submit(labels=[3, 4], seed=2)     # 2 rows -> next batch
        o1, o2 = f1.result(timeout=120), f2.result(timeout=120)
        assert o1.shape == (3, 8, 8, 1) and o2.shape == (2, 8, 8, 1)
        s = svc.stats()
        assert s["batches"] == 2  # two serving batches (warmup not counted)
        assert s["padded_rows"] == 1 + 2


def test_request_validation():
    with _tiny_service() as svc:
        with pytest.raises(ValueError):
            svc.submit(labels=[1, 2, 3, 4, 0])  # > serve_batch
        with pytest.raises(ValueError):
            svc.submit()  # conditional model needs labels
        with pytest.raises(ValueError):
            svc.submit(labels=[99])  # label out of range
        with pytest.raises(ValueError):
            svc.submit(labels=[1, 2], n=1)  # n mismatch
    with _tiny_service(conditional=False) as svc:
        with pytest.raises(ValueError):
            svc.submit(labels=[1])  # unconditional takes no labels
        with pytest.raises(ValueError):
            svc.submit(n=5)  # > serve_batch
        out = svc.sample(n=2, seed=0, timeout=120)
        assert out.shape == (2, 8, 8, 1)


def test_closed_service_rejects_and_fails_pending():
    svc = _tiny_service(linger_ms=60_000.0)
    pending = svc.submit(labels=[0], seed=0)  # waits out the linger window
    svc.close()
    assert not svc._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        pending.result(timeout=10)
    assert svc.stats()["batches"] == 0  # no chain of pure padding after the close
    with pytest.raises(RuntimeError):
        svc.submit(labels=[0])
    with pytest.raises(RuntimeError):
        svc.warmup()


def test_worker_error_fails_that_batch_and_the_service_goes_on():
    with _tiny_service(serve_batch=2, linger_ms=10.0) as svc:
        denoise = svc.diffusion.denoise
        calls = []

        def failing(*args, **kw):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("CUDA error: an illegal memory access was encountered")
            return denoise(*args, **kw)

        svc.diffusion.denoise = failing
        with pytest.raises(RuntimeError, match="illegal memory access"):
            svc.sample(labels=[1], seed=0, timeout=120)
        assert svc.sample(labels=[1], seed=0, timeout=120).shape == (1, 8, 8, 1)
        assert len(calls) == 2  # nothing retried the failed batch


def test_encoding_roundtrip():
    imgs = np.linspace(-1, 1, 2 * 8 * 8 * 1, dtype=np.float32).reshape(2, 8, 8, 1)
    for enc in ("b64npz", "list"):
        payload = {"images": _encode(imgs, enc)}
        np.testing.assert_allclose(decode_images(payload), imgs, rtol=1e-6)
    with pytest.raises(ValueError):
        _encode(imgs, "png")


def test_http_server_end_to_end():
    with _tiny_service(serve_batch=2, linger_ms=20.0) as svc:
        server = make_server(svc, port=0)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        host, port = server.server_address
        base = f"http://{host}:{port}"
        try:
            with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
                assert json.load(r)["ok"] is True

            for enc in ("b64npz", "list"):
                body = json.dumps({"labels": [1], "seed": 5, "encoding": enc}).encode()
                req = urllib.request.Request(f"{base}/sample", data=body, method="POST")
                with urllib.request.urlopen(req, timeout=300) as r:
                    payload = json.load(r)
                assert payload["shape"] == [1, 8, 8, 1]
                imgs = decode_images(payload)
                assert imgs.shape == (1, 8, 8, 1)
                assert np.isfinite(imgs).all()

            with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
                stats = json.load(r)
            assert stats["requests"] >= 2 and stats["batches"] >= 1

            # bad request -> 400, not a hung connection
            bad = urllib.request.Request(
                f"{base}/sample", data=json.dumps({"labels": [999]}).encode(), method="POST",
            )
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(bad, timeout=60)
            assert ei.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"{base}/nowhere", timeout=60)
            assert ei.value.code == 404
        finally:
            server.shutdown()
            server.server_close()


def test_http_request_timeout_surfaces_as_500():
    """A stuck worker surfaces as a 500 after request_timeout instead of
    hanging the client connection (scripts/serve.py --request_timeout)."""

    class StuckService:
        def submit(self, **kw):
            return Future()  # never completed

        def stats(self):
            return {"warm": True}

    server = make_server(StuckService(), port=0, request_timeout=0.2)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    host, port = server.server_address
    try:
        req = urllib.request.Request(
            f"http://{host}:{port}/sample",
            data=json.dumps({"labels": [1]}).encode(), method="POST",
        )
        t0 = time.time()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 500
        assert "TimeoutError" in json.load(ei.value)["error"]
        assert time.time() - t0 < 30  # bounded by request_timeout, not 60 s
    finally:
        server.shutdown()
        server.server_close()


def test_http_listen_backlog_takes_a_burst_of_clients():
    """The front end listens with socket.SOMAXCONN, not socketserver's 5: a
    burst of 64 closed-loop clients (a serve batch of 64) would overflow an
    accept queue of 5, and the kernel would drop their SYNs."""
    import socket

    server = make_server(None, port=0)  # no request reaches the service
    try:
        assert server.request_queue_size == socket.SOMAXCONN >= 64
    finally:
        server.server_close()


SERVE_CUSTOM = [
    "--custom", "--batch_size", "2",
    "--resolution", "8", "--model_channels", "32",
    "--channel_mult", "1/2", "--num_res_blocks", "1",
    "--attention_resolutions", "4", "--num_heads", "2",
    "--in_channels", "3", "--rescaled_num_steps", "3",
    "--original_num_steps", "12", "--sampling_var_type",
    "learned_interpolation", "--beta_schedule", "linear", "--linger_ms", "10",
]
SERVE_CFG = dict(resolution=8, in_channels=3, model_channels=32, out_channels=6,
                 num_res_blocks=1, attention_resolutions=(4,), channel_mult=(1, 2),
                 num_heads=2, num_classes=None, dropout=0.0)


@pytest.fixture(scope="module")
def serve_npz(tmp_path_factory):
    _, params = random_jax_params(SERVE_CFG, seed=3)
    path = str(tmp_path_factory.mktemp("serve") / "tiny.npz")
    save_params_npz(params, path)
    return path


def test_serve_cli_builds_service(serve_npz):
    svc, args = serve.build_service(
        ["--model_path", serve_npz, *SERVE_CUSTOM, "--cpu", "--no_warmup"])
    with svc:
        assert args.port == 8000
        assert svc.device.type == "cpu" and not svc.stats()["warm"]
        assert next(svc.diffusion.model.parameters()).dtype == torch.float32  # auto on the CPU
        out = svc.sample(n=1, seed=0, timeout=300)
        assert out.shape == (1, 8, 8, 3)
    # warm by default: the chain ran once on the worker
    svc, _ = serve.build_service(["--model_path", serve_npz, *SERVE_CUSTOM, "--cpu"])
    with svc:
        s = svc.stats()
        assert s["warm"] is True and s["batches"] == 0


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

def _inject(svc_port, svc_jax):
    svc_port._draw_x = lambda seed, n: torch.from_numpy(noise(seed, n))
    svc_jax._draw_x = lambda seed, n: jnp.asarray(noise(seed, n))


def _serve_both(conditional, dargs, requests, serve_batch=4, **cfg_kw):
    jmodel, params = weights(conditional, seed=1)
    cfg = tiny_cfg(conditional)
    pdiff = Diffusion(model=port_model(cfg, params), **dargs)
    jdiff = JaxDiffusion(model=jmodel, **dargs)
    with SamplerService(pdiff, ServingConfig(serve_batch=serve_batch, linger_ms=300.0,
                                             **cfg_kw), device="cpu") as psvc, \
            JaxService(jdiff, params, JaxConfig(serve_batch=serve_batch, linger_ms=300.0,
                                                **cfg_kw)) as jsvc:
        _inject(psvc, jsvc)
        outs = []
        for svc in (psvc, jsvc):
            futs = [svc.submit(**req) for req in requests]
            outs.append([f.result(timeout=300) for f in futs])
        assert psvc.stats()["padded_rows"] == jsvc.stats()["padded_rows"] > 0
        assert psvc.stats()["batches"] == jsvc.stats()["batches"]
    return outs


@pytest.mark.parametrize("conditional", [True, False], ids=["conditional", "unconditional"])
def test_service_matches_jax(conditional):
    """Three requests of 3, 2 and 1 rows at serve_batch 4: the second does
    not fit beside the first, which is served with one padded row; the
    second and third share the next batch, with one padded row."""
    if conditional:
        requests = [dict(labels=[1, 2, 3], seed=11), dict(labels=[4, 0], seed=12),
                    dict(labels=[2], seed=13)]
    else:
        requests = [dict(n=3, seed=11), dict(n=2, seed=12), dict(n=1, seed=13)]
    (port, ref) = _serve_both(conditional, diff_args(), requests)
    for p, r, req in zip(port, ref, requests):
        assert p.shape == np.asarray(r).shape
        np.testing.assert_allclose(p, np.asarray(r), rtol=0, atol=1e-3)
        assert np.abs(p).max() > 0.05  # the chain moved


def test_cfg_service_with_encoder_cache_and_guidance_interval_matches_jax():
    requests = [dict(labels=[1, 2], seed=21), dict(labels=[3], seed=22),
                dict(labels=[4, 1, 2], seed=23)]
    dargs = diff_args(steps=6, guidance_method="classifier_free", guidance_strength=0.8)
    port, ref = _serve_both(True, dargs, requests, encoder_cache=2,
                            guidance_interval=(0.1, 0.7))
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p, np.asarray(r), rtol=0, atol=1e-3)


def test_ddpm_service_is_deterministic_in_rng_seed():
    """DDPM draws step noise from the k-th batch's generator, seeded from
    (rng_seed, k) alone: two services with the same rng_seed and requests
    give bit-equal outputs, warmup or not; another rng_seed does not."""
    dargs = dict(diff_args(), sampler="ddpm", use_ddim=False)

    def run(warm, rng_seed=7):
        with _tiny_service(serve_batch=2, linger_ms=10.0, dargs=dargs,
                           rng_seed=rng_seed) as svc:
            if warm:
                svc.warmup()
            return [svc.sample(labels=[3], seed=5, timeout=120) for _ in range(2)]

    a, b, c = run(False), run(False), run(True)
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    assert not np.array_equal(a[0], a[1])  # batch 0 and batch 1: other step noise
    assert not np.array_equal(a[0], run(False, rng_seed=8)[0])


def test_build_service_matches_jax_build_service(serve_npz, monkeypatch):
    import importlib

    monkeypatch.syspath_prepend("scripts")
    jserve = importlib.import_module("serve")
    argv = ["--model_path", serve_npz, *SERVE_CUSTOM, "--use_ddim", "--cpu", "--no_warmup"]
    jsvc, _ = jserve.build_service(argv)
    psvc, _ = serve.build_service(argv)
    with psvc, jsvc:
        psvc._draw_x = lambda seed, n: torch.from_numpy(noise(seed, n, (8, 8, 3)))
        jsvc._draw_x = lambda seed, n: jnp.asarray(noise(seed, n, (8, 8, 3)))
        for seed in (0, 1):
            p = psvc.sample(n=2, seed=seed, timeout=300)
            r = np.asarray(jsvc.sample(n=2, seed=seed, timeout=300))
            np.testing.assert_allclose(p, r, rtol=0, atol=1e-3)


def test_int8_build_service_calibrates_then_loads(serve_npz, tmp_path):
    """--dtype int8 goes through the sampling entry point's calibrate-or-load:
    the first build writes --int8_calibration, the second reads it; both
    serve the same images."""
    calib = str(tmp_path / "calib.npz")
    argv = ["--model_path", serve_npz, *SERVE_CUSTOM, "--use_ddim", "--cpu", "--no_warmup",
            "--dtype", "int8", "--int8_calibration", calib]
    outs = []
    for _ in range(2):
        svc, _ = serve.build_service(argv)
        with svc:
            layers = svc.diffusion.model.int8_layers().values()
            assert layers and all(layer.kernel_q is not None for layer in layers)
            outs.append(svc.sample(n=2, seed=4, timeout=300))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert np.isfinite(outs[0]).all()


def test_serve_data_parallel_is_refused_before_a_model_is_built(monkeypatch):
    """``--serve_data_parallel`` is ported (tests/test_torch_serving_dp.py).
    What stays refused before any model is built (the checkpoint does not
    exist): a serve batch that the world size does not divide, and several
    processes without the flag."""
    from nicediffusion_tpu_torch import parallel

    monkeypatch.setattr(parallel, "maybe_initialize_distributed", lambda: True)
    monkeypatch.setattr(parallel, "world", lambda: 2)
    argv = ["--model_path", "no_such_file.npz", *SERVE_CUSTOM, "--batch_size", "3"]
    with pytest.raises(ValueError, match="serve_batch=3 must be a multiple of the 'data' axis"):
        serve.build_service(argv + ["--serve_data_parallel"])
    with pytest.raises(ValueError, match="pass --serve_data_parallel"):
        serve.build_service(argv)


def test_build_service_without_a_card_raises(serve_npz, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        serve.build_service(["--model_path", serve_npz, *SERVE_CUSTOM, "--no_warmup"])
    _, params = weights()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        SamplerService(Diffusion(model=port_model(tiny_cfg(), params), **diff_args()))


def test_service_device_must_be_the_diffusions():
    _, params = weights()
    diffusion = Diffusion(model=port_model(tiny_cfg(), params), **diff_args())
    with pytest.raises(ValueError, match="lives on cpu"):
        SamplerService(diffusion, device="meta")
