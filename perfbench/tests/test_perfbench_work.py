"""The benchmark's frozen formulas equal the program's at today's shapes:
``kernels/work.py``'s ``live_pairs``, ``flash_attn_work`` and
``kernel_work``, and ``head_costs``' sketch FLOPs."""

import pytest
import torch

from perfbench.tests import smoke  # noqa: F401  (puts src/ on the path)
from perfbench import work
from repro_torch.core.sketch_lm_head import head_costs
from repro_torch.kernels import work as prog
from repro_torch.models.config import SketchHeadConfig

HEAD = {"n_rows": 128, "n_buckets": 16, "k": 1, "proj_dim": 32,
        "bandwidth": 2.0}


@pytest.mark.parametrize("s,window", [(1, None), (384, None), (4160, 4096),
                                      (12288, None), (2048, 512)])
def test_live_pairs(s, window):
    assert work.live_pairs(s, window) == prog.live_pairs(s, window)


@pytest.mark.parametrize("b,s", [(1, 384), (1, 2048), (2, 8945), (1, 12288)])
def test_flash_attn_work_at_command_r_shapes(b, s):
    assert work.flash_attn_work(b, s, 64, 8, 128, None, 2) == \
        prog.flash_attn_work(b, s, 64, 8, 128, None, 2)


@pytest.mark.parametrize("batch,d,vocab", [(128, 2048, 65536),
                                           (32, 8192, 256000), (4, 8192, 256000)])
def test_fused_decode_work_at_the_cells_shapes(batch, d, vocab):
    g = torch.Generator().manual_seed(batch)
    idx = torch.randint(0, 16, (batch, 128), generator=g, dtype=torch.int32)
    rows = (torch.arange(128)[None] * 16 + idx.long()).unique().numel()
    head = {"w": torch.empty(128, 1, 32, device="meta"),
            "array": torch.empty(128, 16, vocab, device="meta")}
    hidden = torch.empty(batch, d, device="meta")
    assert work.fused_decode_work(batch, d, HEAD, vocab, rows) == \
        prog.kernel_work("fused_decode", hidden, head, idx, None)


def test_expected_rows_is_the_mean_of_uniform_hashes():
    g = torch.Generator().manual_seed(0)
    counts = [(torch.arange(128)[None] * 16 + torch.randint(
        0, 16, (32, 128), generator=g)).unique().numel() for _ in range(200)]
    assert sum(counts) / len(counts) == pytest.approx(
        work.expected_rows(128, 16, 32), rel=0.01)


@pytest.mark.parametrize("d,vocab", [(2048, 65536), (8192, 256000), (64, 256)])
def test_sketch_flops(d, vocab):
    cfg = SketchHeadConfig(n_rows=128, n_buckets=16, k=1, proj_dim=32,
                           bandwidth=2.0)
    assert work.sketch_flops(HEAD, d, vocab) == head_costs(
        cfg, d, vocab)["sketch_flops"]
