"""The kernel builder's cache on the CPU, with a stand-in for nvcc.

``_build.build`` keys a library by a hash of its source, the shared headers
and the flags, and keeps nvcc's stderr (ptxas's register and spill report)
beside it, so a cached build hands back the same log as a fresh one.
"""

import stat

import pytest

from nicediffusion_tpu_torch.ops.kernels import _build

FAKE_NVCC = """#!/bin/sh
# writes an empty library to the path after -o and a ptxas-like report
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
: > "$out"
echo "ptxas info    : Used 42 registers" >&2
echo "call" >> "$(dirname "$0")/calls"
"""


@pytest.fixture()
def fake_tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    (csrc / "common.cuh").write_text("// a header\n")
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    return tmp_path


def _calls(tree):
    path = tree / "bin" / "calls"
    return len(path.read_text().splitlines()) if path.exists() else 0


def test_cached_build_returns_its_log(fake_tree):
    lib, log, _ = _build.build("k")
    assert lib.exists() and "Used 42 registers" in log
    assert lib.with_suffix(".log").read_text() == log
    again, cached_log, seconds = _build.build("k")
    assert again == lib and cached_log == log and seconds == 0.0
    assert _calls(fake_tree) == 1


@pytest.mark.parametrize("edit", ["source", "header", "log_missing"])
def test_rebuilds_when_the_key_or_log_changes(fake_tree, edit):
    """An edited source or header is a new key; a library without its log
    (an older cache) is built again, so its report is never lost."""
    lib, _, _ = _build.build("k")
    if edit == "source":
        (fake_tree / "csrc" / "k.cu").write_text("// edited\n")
    elif edit == "header":
        (fake_tree / "csrc" / "common.cuh").write_text("// edited\n")
    else:
        lib.with_suffix(".log").unlink()
    again, log, _ = _build.build("k")
    assert "Used 42 registers" in log and _calls(fake_tree) == 2
    assert (again == lib) == (edit == "log_missing")
