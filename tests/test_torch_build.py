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


# ptxas -v lines as nvcc writes them for one template instance of a kernel
def _ptxas(kernel, spill_bytes):
    mangled = f"_ZN12_GLOBAL__N_1{len(kernel) + 7}{kernel}_kernelILi3EEEvN12_GLOBAL__N_18ConvArgsE"
    return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            f"    {spill_bytes} bytes stack frame, {spill_bytes} bytes spill stores, "
            f"{spill_bytes} bytes spill loads\n"
            "ptxas info    : Used 168 registers, used 1 barriers, 512 bytes cmem[0]\n")


def test_build_report_passes_a_clean_tensor_core_k4():
    from chip_smoke import build_report

    lines = build_report("resblock", _ptxas("group_stats", 0) + _ptxas("gn_silu_conv3x3_wgmma", 0))
    assert any(line.startswith("gn_silu_conv3x3_wgmma bf16 filters=192: Used 168 registers")
               for line in lines)


@pytest.mark.parametrize("log,match", [
    (_ptxas("gn_silu_conv3x3_wgmma", 16), "spills"),  # sums in local memory
    (_ptxas("gn_silu_conv3x3", 0) + _ptxas("group_stats", 0), "names no wgmma"),
], ids=["spilling", "no_wgmma_entry"])
def test_build_report_refuses_a_k4_build(log, match):
    from chip_smoke import build_report

    with pytest.raises(AssertionError, match=match):
        build_report("resblock", log)


def _ptxas_k3(kernel, spill_bytes):
    mangled = (f"_ZN12_GLOBAL__N_1{len(kernel) + 7}{kernel}_kernelI13__nv_bfloat16Li8EEEv"
               "NS_6GnArgsE")
    return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            f"    {spill_bytes} bytes stack frame, {spill_bytes} bytes spill stores, "
            f"{spill_bytes} bytes spill loads\n"
            "ptxas info    : Used 72 registers, used 1 barriers, 512 bytes cmem[0]\n")


def test_build_report_passes_a_clean_k3():
    from chip_smoke import build_report

    lines = build_report("groupnorm", _ptxas_k3("group_norm_fwd", 0)
                         + _ptxas_k3("group_norm_bwd", 0))
    assert lines[0].startswith("group_norm_fwd bf16 vector=8: Used 72 registers")
    assert lines[1].startswith("group_norm_bwd bf16 vector=8: Used 72 registers")


@pytest.mark.parametrize("log,match", [
    (_ptxas_k3("group_norm_fwd", 0) + _ptxas_k3("group_norm_bwd", 8), "spills"),
    ("ptxas info    : 0 bytes gmem\n", "names no K3"),
], ids=["spilling", "no_k3_entry"])
def test_build_report_refuses_a_k3_build(log, match):
    """K3 has no wgmma, so no HGMMA gate applies; a spill in any of its
    instantiations fails, and so does a log that names none."""
    from chip_smoke import build_report

    with pytest.raises(AssertionError, match=match):
        build_report("groupnorm", log)
