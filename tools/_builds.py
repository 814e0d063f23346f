"""What the tools that build a kernel source outside the package share.

- :func:`nvcc`: one ``.cu`` file compiled with the package's nvcc flags into
  a library, loaded by ctypes (each tool sets its own signatures);
- :func:`ptxas_lines`: ptxas's register and spill lines of a build;
- :func:`card`: the card's name and power limit, as nvidia-smi gives them;
- :func:`in_turns`: times of two builds taken in turns (other, this, this,
  other), the smaller of each build's two turns kept.

Imports torch and the port, and no JAX.
"""

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from nicediffusion_tpu_torch.ops.kernels import _build  # noqa: E402

TURNS = ("other", "this", "this", "other")


def nvcc(src, lib, *extra):
    """Compile ``src`` into the library ``lib`` with the package's flags and
    ``extra`` arguments; exit naming the source if nvcc refuses it. Returns
    the loaded library and nvcc's standard error (ptxas's lines)."""
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib)), proc.stderr


def ptxas_lines(log):
    """ptxas's register and spill lines of a build's log."""
    return [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]


def card():
    """The card's name and power limit, as nvidia-smi gives them (the
    device's name where nvidia-smi cannot be run)."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(0)


def in_turns(fns, timers):
    """``{(build, timer name): ms}``: each timer of ``timers`` (name ->
    function of a callable, returning ms) on each build's callable of
    ``fns`` in the order of :data:`TURNS`, the smaller of its two turns."""
    best = {}
    for turn in TURNS:
        for how, timer in timers.items():
            best[turn, how] = min(best.get((turn, how), float("inf")), timer(fns[turn]))
    return best
