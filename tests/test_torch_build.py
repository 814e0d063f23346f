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


def test_build_report_names_k2s_exact_and_masked_instances():
    """K2's two instances of a build: the exact one (the head dim is hc) and
    the one for head dims below it."""
    from chip_smoke import build_report

    def k2(kernel, args):
        mangled = f"_ZN12_GLOBAL__N_1{len(kernel) + 7}{kernel}_kernelI{args}EEvNS_7BwdArgsE"
        return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
                "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
                "ptxas info    : Used 132 registers, used 1 barriers\n")

    lines = build_report("attention_bwd", k2("attention_bwd_dq_wgmma", "Li64ELb1E")
                         + k2("attention_bwd_dq_wgmma", "Li64ELb0E")
                         + k2("attention_bwd_dkv_wgmma", "Li256ELb1E"))
    assert lines[0].startswith("attention_bwd_dq_wgmma bf16 hc=64 exact: Used 132")
    assert lines[1].startswith("attention_bwd_dq_wgmma bf16 hc=64 (head dim below hc): Used")
    assert lines[2].startswith("attention_bwd_dkv_wgmma bf16 hc=256 exact (dV and dK in separate "
                               "blocks): Used")


def test_build_report_names_and_gates_the_chunked_attention_kernels():
    """The kernels for head dims above 256 (a block per chunk of the
    output's columns) are named with their chunk, their tensor-core
    instances gated for spills like any wgmma instance."""
    from chip_smoke import build_report

    def chunked(kernel, spill_bytes):
        mangled = f"_ZN12_GLOBAL__N_1{len(kernel) + 7}{kernel}_kernelILi256EEEvNS_7BwdArgsE"
        return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
                f"    0 bytes stack frame, {spill_bytes} bytes spill stores, 0 bytes spill loads\n"
                "ptxas info    : Used 200 registers, used 1 barriers\n")

    lines = build_report("attention_bwd", chunked("attention_bwd_dq_chunked_wgmma", 0)
                         + chunked("attention_bwd_dkv_chunked_wgmma", 0)
                         + chunked("attention_bwd_dq_chunked", 0))
    assert [line.split(":")[0] for line in lines] == [
        "attention_bwd_dq_chunked_wgmma bf16 chunk=256",
        "attention_bwd_dkv_chunked_wgmma bf16 chunk=256 (dV and dK in separate blocks)",
        "attention_bwd_dq_chunked f32 chunk=256"]
    lines = build_report("attention", chunked("attention_fwd_chunked_wgmma", 0))
    assert lines[0].startswith("attention_fwd_chunked_wgmma bf16 chunk=256: Used 200")
    with pytest.raises(AssertionError, match="attention_fwd_chunked_wgmma bf16 chunk=256 spills"):
        build_report("attention", chunked("attention_fwd_chunked_wgmma", 8))


def test_build_report_names_and_gates_the_resident_attention_kernels():
    """The P-resident route's kernels (head dims above 256, N up to the
    limit; no template arguments) and K2's delta kernel are named, and the
    tensor-core ones gated for spills like any wgmma instance."""
    from chip_smoke import build_report

    def entry(kernel, args, spill_bytes, registers=168):
        mangled = (f"_ZN49_GLOBAL__N__a3f9efbf_16_attention_bwd_cu_1fe32b06{len(kernel) + 7}"
                   f"{kernel}_kernel{args}")
        return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
                f"ptxas info    : Function properties for {mangled}\n"
                f"    0 bytes stack frame, {spill_bytes} bytes spill stores, 0 bytes spill loads\n"
                f"ptxas info    : Used {registers} registers, used 2 barriers\n")

    resident = "EN2nd8resident4ArgsE"
    lines = build_report("attention_bwd",
                         entry("attention_bwd_resident_wgmma", resident, 0)
                         + entry("attention_bwd_delta", "EPK13__nv_bfloat16S2_Pfiii", 0, 30)
                         + entry("attention_bwd_dq_chunked_wgmma", "ILi256EEEvNS_7BwdArgsE", 0))
    assert [line.split(":")[0] for line in lines] == [
        "attention_bwd_resident_wgmma bf16 P in shared memory, TMA producer",
        "attention_bwd_delta bf16 in, f32 sums",
        "attention_bwd_dq_chunked_wgmma bf16 chunk=256"]
    assert lines[0].split(": ", 1)[1].startswith("Used 168 registers")
    lines = build_report("attention", entry("attention_fwd_resident_wgmma", resident, 0))
    assert lines[0].startswith("attention_fwd_resident_wgmma bf16 P in shared memory, TMA "
                               "producer: Used 168")
    with pytest.raises(AssertionError, match="attention_fwd_resident_wgmma bf16 .* spills"):
        build_report("attention", entry("attention_fwd_resident_wgmma", resident, 16))


def test_the_resident_attention_sass_gate_counts_tma_loads_and_setmaxnreg():
    """The P-resident kernels' machine code is read apart from the other
    attention kernels': their warpgroup multiplies, TMA loads and register
    handovers (a kernel of another name counts nothing)."""
    from chip_smoke import resident_sass_by_instance

    def function(kernel, body):
        return (f"\t\tFunction : _ZN12_GLOBAL__N_1{len(kernel) + 7}{kernel}_kernel"
                f"EN2nd8resident4ArgsE\n" + body)

    sass = (function("attention_fwd_resident_wgmma",
                     "  USETMAXREG.DEALLOC.CTAPOOL 0x38 ;\n  UTMALDG.4D [UR8], [UR4] ;\n"
                     "  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24 ;\n"
                     "  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR12], R24 ;\n")
            + function("attention_fwd_chunked_wgmma",
                       "  HGMMA.64x64x16.F32.BF16 R24, R152, gdesc[UR8], R24 ;\n")
            + function("attention_bwd_resident_wgmma",
                       "  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24 ;\n"))
    counts = resident_sass_by_instance(sass)
    assert counts == {
        "attention_fwd_resident_wgmma": {"HGMMA": 2, "UTMALDG": 1, "USETMAXREG": 1},
        "attention_bwd_resident_wgmma": {"HGMMA": 1, "UTMALDG": 0, "USETMAXREG": 0}}


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


def _ptxas_int8(route, x_type, nb, spill_bytes):
    name = f"int8_conv_{route}_wgmma_kernel"
    mangled = (f"_ZN44_GLOBAL__N__56394114_11_int8conv_cu_4548ab42{len(name)}{name}ILi"
               f"{x_type}ELi{nb}EEEvNS_4ArgsE")
    return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            f"    {spill_bytes} bytes stack frame, {spill_bytes} bytes spill stores, "
            f"{spill_bytes} bytes spill loads\n"
            "ptxas info    : Used 122 registers, used 1 barriers\n")


def test_build_report_passes_a_clean_int8_conv():
    """The int8 conv's instances (halo and row route, by input type and
    filter tile), named as nvcc 12.8 mangles them: each a line, every
    instance's spills gated."""
    from chip_smoke import build_report

    lines = build_report("int8conv", _ptxas_int8("halo", 1, 3, 0) + _ptxas_int8("halo", 2, 1, 0)
                         + _ptxas_int8("row", 0, 2, 0))
    assert [line.split(":")[0] for line in lines] == [
        "int8_conv_halo_wgmma s8 x=bf16 filters=192", "int8_conv_halo_wgmma s8 x=s8 filters=64",
        "int8_conv_row_wgmma s8 x=f32 filters=128"]
    assert lines[0].endswith("0 bytes spill loads") and "Used 122 registers" in lines[0]


@pytest.mark.parametrize("log,match", [
    (_ptxas_int8("halo", 1, 3, 0) + _ptxas_int8("row", 1, 3, 24), "spills"),
    ("ptxas info    : 0 bytes gmem\n", "names no wgmma"),
], ids=["spilling", "no_wgmma_entry"])
def test_build_report_refuses_an_int8_conv_build(log, match):
    from chip_smoke import build_report

    with pytest.raises(AssertionError, match=match):
        build_report("int8conv", log)


def test_the_int8_sass_gate_counts_integer_warpgroup_multiplies():
    """The int8 library's gate counts integer warpgroup multiplies under any
    mnemonic and no bf16 or fp8 one; the bf16 libraries' counts HGMMA."""
    import re

    from chip_smoke import GMMA_SASS

    sass = ("  /*0a10*/  IGMMA.64x128x32.S8.S8 R24, gdesc[UR4], R24 ;\n"
            "  /*0a20*/  HGMMA.64x64x16.F32.BF16 R0, gdesc[UR8], R0 ;\n"
            "  /*0a30*/  QGMMA.64x64x32.F32.E4M3.E4M3 R0, gdesc[UR8], R0 ;\n")
    assert re.findall(rf"\b({GMMA_SASS['int8conv']})\.", sass) == ["IGMMA"]
    assert re.findall(rf"\b({GMMA_SASS['resblock']})\.", sass) == ["HGMMA"]


def test_the_bf16_conv_sass_gate_counts_tma_loads_and_setmaxnreg_per_instance():
    """The bf16 conv's gate reads each instance's machine code apart: its
    warpgroup multiplies, TMA loads and register handovers, by route and
    filter tile (the instance whose producer lost its TMA loads shows 0)."""
    from chip_smoke import BF16_CONV_SASS, bf16_sass_by_instance

    def function(route, nb, body):
        name = (f"_ZN12_GLOBAL__N_1{len(route) + 22}bf16_conv_{route}_wgmma_kernel"
                f"ILi{nb}EEEvNS_4ArgsE")
        return f"\t\tFunction : {name}\n" + body

    sass = (function("halo", 3, "  USETMAXREG.DEALLOC.CTAPOOL 0x38 ;\n  UTMALDG.4D [UR8], [UR4] ;\n"
                                "  UTMALDG.3D [UR16], [UR4] ;\n"
                                "  HGMMA.64x192x16.F32.BF16 R24, R152, gdesc[UR8], R24 ;\n")
            + function("row", 1, "  USETMAXREG.TRY_ALLOC.CTAPOOL 0xe0 ;\n"
                                 "  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24 ;\n"))
    counts = bf16_sass_by_instance(sass)
    assert BF16_CONV_SASS == ("HGMMA", "UTMALDG", "USETMAXREG")
    assert counts["bf16_conv_halo_wgmma bf16 filters=192"] == {"HGMMA": 1, "UTMALDG": 2,
                                                               "USETMAXREG": 1}
    assert counts["bf16_conv_row_wgmma bf16 filters=64"] == {"HGMMA": 1, "UTMALDG": 0,
                                                             "USETMAXREG": 1}


def test_build_all_builds_every_source():
    """``build_all``'s default names are every csrc/*.cu of the package, the
    Winograd conv's included, each a library of its own."""
    import inspect

    names = inspect.signature(_build.build_all).parameters["names"].default
    assert "winograd" in names and len(set(names)) == len(names)
    assert set(names) == {p.stem for p in _build.CSRC.glob("*.cu")}


def _winograd_mangled(ft):
    return ("_ZN44_GLOBAL__N__1d2fba03_11_winograd_cu_2b73cc7b34"
            f"winograd_conv_cluster_wgmma_kernelILi{ft}EEEvNS_4ArgsE")


def _ptxas_winograd(spill_bytes):
    """nvcc 12.8's ptxas lines for the Winograd conv's two instances (filter
    tiles 128 and 64), the second spilling ``spill_bytes``."""
    log = ""
    for ft, spill in ((128, 0), (64, spill_bytes)):
        mangled = _winograd_mangled(ft)
        log += (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
                f"ptxas info    : Function properties for {mangled}\n"
                f"    {spill} bytes stack frame, {spill} bytes spill stores, "
                f"{spill} bytes spill loads\n"
                "ptxas info    : Used 128 registers, used 1 barriers\n")
    return log


def test_build_report_gates_the_winograd_conv():
    """The Winograd conv's instances (filter tiles 128 and 64), named as nvcc
    12.8 mangles them: a clean build passes with a line each, one spilling
    instance fails, a log naming no wgmma instance fails (its spills would go
    unchecked)."""
    from chip_smoke import GMMA_SASS, WGMMA_LIBS, build_report

    assert "winograd" in WGMMA_LIBS and GMMA_SASS["winograd"] == "HGMMA"
    lines = build_report("winograd", _ptxas_winograd(0))
    assert [line.split(":")[0] for line in lines] == [
        "winograd_conv_cluster_wgmma bf16 filters=128",
        "winograd_conv_cluster_wgmma bf16 filters=64"]
    assert "cluster of 4, 2 x m64n128 a consumer" in lines[0]
    assert all("Used 128 registers" in line for line in lines)
    with pytest.raises(AssertionError, match="filters=64.* spills"):
        build_report("winograd", _ptxas_winograd(56))
    with pytest.raises(AssertionError, match="names no wgmma"):
        build_report("winograd", "ptxas info    : 0 bytes gmem\n")


@pytest.mark.parametrize("lost", [None, "UTMALDG", "USETMAXREG", "HGMMA"])
def test_the_winograd_sass_gate_counts_each_instance(lost):
    """The Winograd conv's gate reads each instance's machine code apart:
    warpgroup multiplies, TMA loads and register handovers by filter tile; an
    instance that lost one of them shows 0 for it."""
    from chip_smoke import BF16_CONV_SASS, WINOGRAD_INSTANCES, winograd_sass_by_instance

    body = {"USETMAXREG": "  USETMAXREG.DEALLOC.CTAPOOL 0x48 ;\n",
            "UTMALDG": "  UTMALDG.4D [UR8], [UR4] ;\n  UTMALDG.3D [UR16], [UR4] ;\n",
            "HGMMA": "  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24 ;\n"}
    sass = "".join(f"\t\tFunction : {_winograd_mangled(ft)}\n"
                   + "".join(text for op, text in body.items() if not (ft == 64 and op == lost))
                   for ft in (128, 64))
    counts = winograd_sass_by_instance(sass)
    assert WINOGRAD_INSTANCES == len(counts) == 2
    assert counts["winograd_conv_cluster_wgmma bf16 filters=128"] == {
        "HGMMA": 1, "UTMALDG": 2, "USETMAXREG": 1}
    small = counts["winograd_conv_cluster_wgmma bf16 filters=64"]
    assert {op for op in BF16_CONV_SASS if not small[op]} == ({lost} if lost else set())
