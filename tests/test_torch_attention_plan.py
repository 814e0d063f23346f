"""The plan of the attention kernels' head dims above 256, on the CPU.

``chunked_attention_plan(n, d, pairs, kernel)`` picks the bf16 route of K1,
K2 and K5 from N and D (the P-resident route up to ``RESIDENT_N_LIMIT``
tokens, the walk above) and, on the resident route, the split of a row
tile's output columns over blocks, which alone reads the number of (batch,
head) pairs. The kernels refuse what the plan does not allow; these tests
hold the plan itself.
"""

import re
from pathlib import Path

import pytest
import torch

from nicediffusion_tpu_torch.ops.kernels import attention as k1

LIMIT = k1.RESIDENT_N_LIMIT
NS = (17, 64, 1024, LIMIT, LIMIT + 1, 4096)
DS = (257, 512, 768, 1024, 2048)
PAIRS = (1, 2, 8, 16, 64, 1024)
KERNELS = ("K1", "K2", "K5")


def most_split(d):
    return max(1, -(-d // 64) // 2)


def test_the_limit_is_the_kernels():
    """The plan's N limit is the one the CUDA source's shared-memory budget
    gives (csrc/attention_chunked.cuh: resident::kNLimit)."""
    src = (Path(k1.__file__).resolve().parents[2] / "csrc" / "attention_chunked.cuh").read_text()
    assert re.search(rf"static_assert\(kNLimit == {LIMIT},", src)
    assert LIMIT == 1152 and LIMIT % 64 == 0


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("n", NS)
def test_route_and_limit_read_n_and_d_alone(n, d):
    """The route is the resident one up to the limit and the walk above it,
    whatever the kernel and the number of (batch, head) pairs; the N limit
    never changes."""
    plans = [k1.chunked_attention_plan(n, d, pairs, kernel)
             for pairs in PAIRS for kernel in KERNELS]
    assert {p["route"] for p in plans} == {"resident" if n <= LIMIT else "walk"}
    assert {p["n_limit"] for p in plans} == {LIMIT}


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("n", NS)
def test_split(n, d):
    """The walk has no split. On the resident route the split lies between 1
    and the most the head dim allows (two 64-column blocks a part), is 1 on
    grids of more than 16 blocks, and on smaller ones spreads the columns so
    that the blocks stay within the card's 132 multiprocessors."""
    for kernel in KERNELS:
        roles = 3 if kernel == "K2" else 1
        for pairs in PAIRS:
            split = k1.chunked_attention_plan(n, d, pairs, kernel)["split"]
            if n > LIMIT:
                assert split == 1
                continue
            blocks = -(-n // 64) * pairs * roles
            assert 1 <= split <= most_split(d)
            if blocks > 16:
                assert split == 1
            else:
                assert blocks * split <= 132
                assert split == min(most_split(d), 132 // blocks)


@pytest.mark.parametrize("d", DS)
def test_forced_split(d):
    """A forced split is taken where the head dim allows it and refused
    elsewhere, and on the walk."""
    for split in range(1, most_split(d) + 1):
        assert k1.chunked_attention_plan(64, d, 8, "K1", split)["split"] == split
    for split in (0, most_split(d) + 1):
        with pytest.raises(ValueError, match="split"):
            k1.chunked_attention_plan(64, d, 8, "K1", split)
    with pytest.raises(ValueError, match="walk"):
        k1.chunked_attention_plan(LIMIT + 1, d, 8, "K2", 2)
    assert k1.chunked_attention_plan(LIMIT + 1, d, 8, "K2", 1)["split"] == 1


@pytest.mark.parametrize("args,match", [
    ((1024, 256, 8), "above 256"),
    ((0, 512, 8), "positive"),
    ((64, 512, 0), "positive"),
    ((64, 512, 8, "K3"), "K1, K2 or K5"),
])
def test_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        k1.chunked_attention_plan(*args)


def test_the_wide128_shapes():
    """openai_128 at one head (head dims 512, 768, 1024 at N 1024, 256, 64):
    a sampling forward at model batch 8 and a training step at batch 2 take
    the resident route; only the 8 x 8 level's few blocks are split."""
    forward = [k1.chunked_attention_plan(n, d, 8, "K1") for n, d in
               ((1024, 512), (256, 768), (64, 1024))]
    assert [p["route"] for p in forward] == ["resident"] * 3
    assert [p["split"] for p in forward] == [1, 1, 8]
    step = [k1.chunked_attention_plan(n, d, 2, "K2") for n, d in
            ((1024, 512), (256, 768), (64, 1024))]
    assert [p["split"] for p in step] == [1, 1, 8]


def test_cpu_tensors_take_the_plain_versions_and_count_no_route():
    """On CPU tensors the wrappers run the plain versions: no launch and no
    route counted, at a head dim above 256 too; a split there is ignored."""
    k1.route_launches.clear()
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(1, 17, 3 * 320, generator=g).bfloat16()
    out = k1.fused_qkv_attention(qkv, 1, True, split=2)
    torch.testing.assert_close(out, k1.fused_qkv_attention_plain(qkv, 1, True))
    q, k, v = k1.split_qkv(qkv, 1, True)
    k1.mha_attention(q, k, v, split=2)
    k1.fused_qkv_attention_bwd(qkv, torch.ones_like(out), out, 1, True, split=2)
    assert not k1.route_launches
