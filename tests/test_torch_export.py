"""The port's checkpoint export (nicediffusion_tpu_torch/scripts/export.py)
and profiling hooks (utils/profiling.py) on the CPU.

Export against the JAX package's scripts/export.py: ``.pt`` -> ``.npz`` gives
the same leaves bit for bit as the JAX script run as a subprocess on the
same file; ``.npz`` -> ``.pt`` loads with ``strict=True`` into the port's
DiffusionModel and equals the JAX package's ``export_torch_checkpoint``; the
port Trainer's ``step_{N}`` directory gives the model's or the EMA's
weights; a directory without ``state.pt`` (an orbax checkpoint) is refused
with the JAX script named.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from nicediffusion_tpu.utils.checkpoint import load_params  # noqa: E402
from nicediffusion_tpu.utils.checkpoint import save_params_npz as jax_save_npz  # noqa: E402
from nicediffusion_tpu.utils.convert import export_torch_checkpoint  # noqa: E402
from nicediffusion_tpu_torch import DiffusionModel  # noqa: E402
from nicediffusion_tpu_torch.scripts.export import main as export_main  # noqa: E402
from nicediffusion_tpu_torch.utils import profiling  # noqa: E402
from nicediffusion_tpu_torch.utils.checkpoint import load_npz_tree  # noqa: E402
from test_torch_trainer import TINY_MODEL, make_trainer  # noqa: E402
from test_torch_unet import port_model, random_jax_params  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(port model with seeded weights, its .pt, the same tree as the JAX
    package's .npz)."""
    root = tmp_path_factory.mktemp("export")
    _, params = random_jax_params(TINY_MODEL, seed=2)
    model = port_model(TINY_MODEL, params)
    pt, npz = str(root / "model.pt"), str(root / "model.npz")
    torch.save(model.state_dict(), pt)
    jax_save_npz(params, npz)
    return model, pt, npz


def test_pt_to_npz_matches_the_jax_script(weights, tmp_path, capsys):
    model, pt, _ = weights
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    export_main(["--input", pt, "--output", ours])
    n = sum(p.numel() for p in model.parameters())
    assert capsys.readouterr().out.strip() == f"Exported {n} parameters from {pt} to {ours}"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "export.py"),
                           "--input", pt, "--output", theirs],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith(f"Exported {n} parameters from {pt} to {theirs}")
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_npz_to_pt_loads_strictly_and_matches_jax_export(weights, tmp_path):
    model, _, npz = weights
    ours, theirs = str(tmp_path / "ours.pt"), str(tmp_path / "theirs.pt")
    export_main(["--input", npz, "--output", ours])
    export_torch_checkpoint(load_params(npz), theirs)
    a = torch.load(ours, weights_only=True)
    b = torch.load(theirs, weights_only=True)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    fresh = DiffusionModel(**TINY_MODEL, device="cpu")
    fresh.load_state_dict(a, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_npz_round_trip_through_pt_is_exact(weights, tmp_path):
    _, _, npz = weights
    pt, back = str(tmp_path / "m.pt"), str(tmp_path / "back.npz")
    export_main(["--input", npz, "--output", pt])
    export_main(["--input", pt, "--output", back])
    want, got = flat(load_npz_tree(npz)), flat(load_npz_tree(back))
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg="::".join(k))


@pytest.mark.parametrize("part,key", [("params", "model"), ("ema_params", "ema")])
def test_trainer_checkpoint_directory(tmp_path, part, key):
    trainer = make_trainer(tmp_path, iterations=2, ema_rate=0.5)
    for _ in range(2):
        batch, labels = next(trainer.loader)
        trainer.train_step(batch, labels)
    trainer.save(2)
    step_dir = str(tmp_path / "ckpt" / "step_2")
    out = str(tmp_path / f"{part}.pt")
    export_main(["--input", step_dir, "--output", out, "--part", part])
    got = torch.load(out, weights_only=True)
    want = (trainer.model if key == "model" else trainer.ema_model).state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v.cpu()), k
    # the model and the EMA differ after two steps at rate 0.5
    other = (trainer.ema_model if key == "model" else trainer.model).state_dict()
    assert any(not torch.equal(got[k], v) for k, v in other.items())


def test_directory_without_state_pt_is_refused(tmp_path):
    orbax_like = tmp_path / "step_10"
    orbax_like.mkdir()
    (orbax_like / "_METADATA").write_text("{}")
    with pytest.raises(FileNotFoundError, match="scripts/export.py"):
        export_main(["--input", str(orbax_like), "--output", str(tmp_path / "m.pt")])


def test_output_suffix_is_checked(weights, tmp_path):
    _, pt, _ = weights
    with pytest.raises(ValueError, match=".npz or .pt"):
        export_main(["--input", pt, "--output", str(tmp_path / "m.safetensors")])


# ---------------------------------------------------------------------------
# utils/profiling.py
# ---------------------------------------------------------------------------

def test_step_timer_on_known_intervals(monkeypatch):
    clock = iter([10.0, 10.5, 11.0, 12.0, 12.25])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer(window=3)
    assert timer.steps_per_sec == 0.0
    assert timer.tick() is None
    assert [timer.tick() for _ in range(4)] == [0.5, 0.5, 1.0, 0.25]
    # the window keeps the last 3 intervals: 0.5 + 1.0 + 0.25
    assert timer.steps_per_sec == pytest.approx(3 / 1.75)


def test_trace_writes_a_chrome_trace_and_nothing_when_disabled(tmp_path):
    on, off = tmp_path / "on", tmp_path / "off"
    with profiling.trace(str(on)) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    files = os.listdir(on)
    assert len(files) == 1 and files[0].endswith(".json")
    assert (on / files[0]).stat().st_size > 0
    assert any("matmul" in e.key for e in prof.key_averages())
    with profiling.trace(str(on)):
        pass
    assert len(os.listdir(on)) == 2  # a second trace does not overwrite the first
    with profiling.trace(str(off), enabled=False) as prof:
        torch.ones(4).sum()
    assert prof is None and not off.exists()
