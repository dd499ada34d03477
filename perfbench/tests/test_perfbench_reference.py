"""The plain reference against the port on the CPU at smoke sizes, in f32:
the backbones' final hiddens, the dense and sketched heads, the hash; and
the reference's sources import nothing of the program or of JAX."""

import ast
from pathlib import Path

import pytest
import torch

from perfbench.tests import smoke
from perfbench import hashing, harness, reference, weights
from repro_torch.kernels.fused_decode.ops import fused_decode_ref
from repro_torch.kernels.lsh_hash.ops import lsh_hash_ref
from repro_torch.models import model as port

HERE = Path(__file__).resolve().parents[1]


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.to(torch.float32)


@pytest.mark.parametrize("kind", ["rwkv", "attn"])
def test_final_hidden_matches_the_port_in_f32(kind):
    c = smoke.cell(kind)
    m = c["cfg"]["model"]
    params = _f32(weights.draw_backbone(m, 2 ** 32 + 5, "cpu"))
    tokens = torch.randint(0, m["vocab_size"], (70,),
                           generator=torch.Generator().manual_seed(1))
    mc = harness.model_config(c["cfg"])
    with torch.no_grad():
        x, _ = port.backbone(params, tokens[None], mc)
        want = port.final_hidden(params, x, mc)[0]
        got = reference.final_hidden(params, m, tokens)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(
            reference.dense_logits(params, m, got[-3:]),
            port.dense_logits(params, want[None, -3:], mc)[0],
            rtol=2e-4, atol=2e-4)


def test_the_fp8_control_departs_from_f32():
    c = smoke.cell("rwkv")
    m = c["cfg"]["model"]
    params = weights.draw_backbone(m, 9, "cpu")
    tokens = torch.arange(40) % m["vocab_size"]
    with torch.no_grad():
        a = reference.final_hidden(params, m, tokens)
        b = reference.final_hidden(params, m, tokens,
                                   reference.Precision("fp8"))
    rel = ((a - b).norm(dim=-1) / a.norm(dim=-1)).mean()
    assert 0.01 < rel < 1.0


def test_sketched_head_and_hash_match_the_port():
    head = weights.draw_head(smoke.HEAD, 64, 256, 77, 0, "cpu")
    h = torch.randn(20, 64, generator=torch.Generator().manual_seed(2))
    q = h @ head["proj"]
    assert torch.equal(
        hashing.bucket_indices(q, head["w"], head["b"], 2.0, 16),
        lsh_hash_ref(q, head["w"], head["b"], 2.0, 16).long())
    torch.testing.assert_close(
        reference.sketch_logits(head, smoke.HEAD, h),
        fused_decode_ref(h, head["proj"], head["w"], head["b"], head["array"],
                         2.0, 16), rtol=1e-5, atol=1e-6)


def test_head_counts_are_the_anchors_weights_by_bucket():
    """array[l, r, v] = Σ_m [idx[m, l] = r]·α[m, v]: every row of counts
    sums over its buckets to the anchors' total weight."""
    head = weights.draw_head(smoke.HEAD, 64, 256, 78, 0, "cpu")
    per_row = head["array"].sum(1)                       # (L, V)
    torch.testing.assert_close(per_row, per_row[:1].expand_as(per_row),
                               rtol=1e-4, atol=1e-5)


def test_gaps_are_zero_for_the_reference_own_tokens():
    c = smoke.cell("attn")
    m = c["cfg"]["model"]
    params = weights.draw_backbone(m, 10, "cpu")
    head = weights.draw_head(smoke.HEAD, 64, 256, 10, 0, "cpu")
    prompt = torch.arange(7)
    with torch.no_grad():
        seq = prompt.clone()
        served = []
        for i in range(6):      # greedy through the reference itself
            h = reference.final_hidden(params, m, seq)[-1:]
            lg = (reference.dense_logits(params, m, h) if i == 0
                  else reference.sketch_logits(head, smoke.HEAD, h))
            served.append(int(lg.argmax()))
            seq = torch.cat([seq, torch.tensor(served[-1:])])
        out = reference.check_requests(
            params, m, lambda t: head, smoke.HEAD,
            [{"prompt": prompt, "served": torch.tensor(served), "tenant": None}])
    assert out["first"] == 0.0 and out["decode"] == 0.0


_BANNED = ("repro_torch", "repro", "jax", "jaxlib", "flax")


@pytest.mark.parametrize("name", ["reference.py", "hashing.py", "weights.py",
                                  "work.py", "traffic.py", "trace.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    tree = ast.parse((HERE / name).read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert not mods & set(_BANNED), mods
