"""The port's distillation entry point on the CPU:
``nicediffusion_tpu_torch.scripts.distill.main([..., "--cpu"])``.

On one random EMNIST-preset checkpoint written by the JAX package, the JAX
script (scripts/distill.py, run as a subprocess) and the port's entry point
with the same flags and ``--iterations 0`` write the same ``.distill.json``
sidecar, an ``.npz`` with the same keys, shapes and values (no update: the
teacher's weights come back) and print the same sampling hint. Then the
port distills for one iteration per stage, and the port's sampling entry
point samples the student with the printed hint: one forward a step, on the
sidecar's grid, without guidance.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax import traverse_util  # noqa: E402

from nicediffusion_tpu.models.unet import DiffusionModel as JaxModel  # noqa: E402
from nicediffusion_tpu.utils.checkpoint import save_params_npz  # noqa: E402
from nicediffusion_tpu.utils.config import preset_for_path  # noqa: E402
from nicediffusion_tpu_torch.diffusion.process import Diffusion  # noqa: E402
from nicediffusion_tpu_torch.models.unet import DiffusionModel  # noqa: E402
from nicediffusion_tpu_torch.scripts.distill import main as distill_main  # noqa: E402
from nicediffusion_tpu_torch.scripts.sample import main as sample_main  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--distill_guidance", "2.0", "--rounds", "1", "--steps", "4", "--batch_size", "4",
         "--var_weight", "1.0", "--cpu"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """Seeded fan-in-scaled EMNIST-preset weights (no leaf at zero) as the
    JAX package's ``.npz``."""
    model_args, _ = preset_for_path("EMNIST_rand.npz")
    shapes = jax.eval_shape(lambda: JaxModel(**model_args).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,), jnp.int32)))["params"]
    rng = np.random.default_rng(0)
    flat = {}
    for path, leaf in traverse_util.flatten_dict(shapes).items():
        if path[-1] == "kernel":
            v = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif path[-1] == "scale":
            v = 1.0 + 0.1 * rng.normal(size=leaf.shape)
        else:
            v = 0.1 * rng.normal(size=leaf.shape)
        flat[path] = v.astype(np.float32)
    path = str(tmp_path_factory.mktemp("ckpt") / "EMNIST_rand.npz")
    save_params_npz(traverse_util.unflatten_dict(flat), path)
    return path


def hint_of(stdout):
    """The printed lines after 'Sample with:'."""
    return stdout[stdout.index("Sample with:\n") + len("Sample with:\n"):].strip("\n")


def test_sidecar_npz_and_hint_match_the_jax_cli(checkpoint, tmp_path, capsys):
    jax_out, port_out = str(tmp_path / "EMNIST_jax.npz"), str(tmp_path / "EMNIST_port.npz")
    argv = ["--model_path", checkpoint, *FLAGS, "--iterations", "0"]
    proc = subprocess.run(
        [sys.executable, f"{REPO}/scripts/distill.py", *argv, "--save_path", jax_out],
        cwd=tmp_path, env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    sidecar = distill_main(argv + ["--save_path", port_out])
    port_stdout = capsys.readouterr().out

    with open(jax_out + ".distill.json") as f:
        want = json.load(f)
    with open(port_out + ".distill.json") as f:
        assert json.load(f) == want == sidecar
    assert want["guided"] and want["steps"] == 2 and len(want["timestep_indices"]) == 2
    assert hint_of(port_stdout) == hint_of(proc.stdout)
    assert "--guidance_method none" in hint_of(port_stdout)
    assert "variance head trained" in hint_of(port_stdout)
    with np.load(jax_out) as a, np.load(port_out) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_student_samples_with_the_printed_hint(checkpoint, tmp_path, capsys, monkeypatch):
    out = str(tmp_path / "EMNIST_student.npz")
    # a constant rate: warmup_cosine's first update has rate 0
    sidecar = distill_main(["--model_path", checkpoint, *FLAGS, "--iterations", "1",
                            "--lr_schedule", "constant", "--save_path", out, "-w"])
    stdout = capsys.readouterr().out
    assert "guided-distill step 1/1" in stdout and "distill step 1/1" in stdout
    # the student was trained: its weights are not the teacher's
    with np.load(checkpoint) as a, np.load(out) as b:
        assert any(not np.array_equal(a[k], b[k]) for k in a.files)
    hint = hint_of(stdout).splitlines()[0].split("#")[0].split()

    seen, calls = {}, []
    inner = Diffusion.denoise

    def spy(self, *args, **kw):
        seen.update(steps=self.rescaled_num_steps, guidance=self.guidance,
                    grid=self.timestep_map.tolist(), sampler=self.sampler)
        return inner(self, *args, **kw)

    forward = DiffusionModel.forward

    def counting(self, x, *args, **kw):
        calls.append(x.shape[0])
        return forward(self, x, *args, **kw)

    monkeypatch.setattr(Diffusion, "denoise", spy)
    monkeypatch.setattr(DiffusionModel, "forward", counting)
    save_dir = str(tmp_path / "samples") + "/"
    os.makedirs(save_dir)
    samples = sample_main(["--model_path", out, *hint, "--batch_size", "2", "--num_samples", "1",
                           "--labels", "3", "--save_path", save_dir, "--seed", "0", "--cpu"])
    assert seen == {"steps": 2, "guidance": None, "grid": sidecar["timestep_indices"],
                    "sampler": "ddim"}
    assert calls == [2, 2]  # one forward a step at the request's batch: no CFG doubling
    assert sorted(os.listdir(save_dir)) == ["3_sample0.jpg", "3_sample1.jpg"]
    assert samples[0][1].shape == (2, 28, 28, 3) and samples[0][1].dtype == np.uint8


def test_var_weight_zero_is_off(checkpoint, tmp_path, capsys):
    """A divergence from the JAX script, which counts 0 as on: no
    variance-head hint for a head that was not trained."""
    distill_main(["--model_path", checkpoint, "--rounds", "1", "--steps", "4", "--iterations",
                  "0", "--var_weight", "0", "--cpu", "--save_path", str(tmp_path / "s.npz")])
    hint = hint_of(capsys.readouterr().out)
    assert "--timestep_indices" in hint and "variance head" not in hint


def test_orbax_directory_is_refused(tmp_path):
    ckpt = tmp_path / "EMNIST_step_100"
    ckpt.mkdir()
    with pytest.raises(ValueError, match="scripts/export.py"):
        distill_main(["--model_path", str(ckpt), "--cpu"])


def test_without_cpu_flag_the_entry_point_wants_the_card(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="--cpu"):
        distill_main(["--model_path", checkpoint])
