"""The other families on a 2×2 gloo mesh: granite-8b (plain attention),
mixtral-8x7b (MoE), jamba-v0.1-52b (Mamba and MoE), deepseek-v3-671b
(MLA with its dense prologue, MoE) and llama-3.2-vision-11b
(cross-attention over encoder states), at smoke size; the three other
plain-attention archs, and the mesh against the JAX package, are
``test_torch_sharded_archs_dense.py``'s.

For each, ``LM.with_mesh`` serves the dense stream of the single-device
model, at decode_chunk 1 and 4, and (but for llama-vision, whose engine is
refused) through the engine.  One module fixture spawns four gloo ranks
(``tests/torch_mesh.py``, one CPU thread each) and runs every arch; the
rwkv6-1.6b and gemma2-27b twins of the reference's sharded-serving tests
are ``test_torch_sharded_serving*.py``.  ~75 s on an idle machine.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pathlib import Path

ARCHS = ["granite-8b", "mixtral-8x7b", "jamba-v0.1-52b", "deepseek-v3-671b",
         "llama-3.2-vision-11b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arch_ranks(rank, world, *archs):
    """Each of ``archs``: the single-device and the mesh streams."""
    from repro_torch.api import LM

    out = {}
    for arch in archs:
        lm = LM.from_config(arch, smoke=True, device="cpu")
        cfg = lm.cfg
        prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 6))
        enc = None
        if cfg.n_encoder_tokens:
            enc = torch.randn((4, cfg.n_encoder_tokens, cfg.d_model),
                              generator=torch.Generator().manual_seed(0)
                              ).to(torch.bfloat16)
        mesh_lm = lm.with_mesh("2x2")
        out[f"{arch}/base"] = lm.generate(prompts, 5,
                                          encoder_states=enc).numpy()
        for chunk in (1, 4):
            out[f"{arch}/mesh/{chunk}"] = mesh_lm.generate(
                prompts, 5, encoder_states=enc, decode_chunk=chunk).numpy()
        if not cfg.n_encoder_tokens:
            out[f"{arch}/engine"] = mesh_lm.serve(
                [(prompts[i], 5) for i in range(4)], n_slots=4)
    return out


@pytest.fixture(scope="module")
def r():
    from torch_mesh import run_ranks

    return run_ranks(str(Path(__file__)), "arch_ranks", world=4, timeout=240,
                     args=ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_stream_on_mesh_equals_one_device(r, arch):
    check_streams(r, arch)


def check_streams(r, arch):
    """The mesh streams at decode_chunk 1 and 4, and the engine's, equal
    the single-device stream."""
    base = r[f"{arch}/base"]
    for chunk in (1, 4):
        np.testing.assert_array_equal(r[f"{arch}/mesh/{chunk}"], base,
                                      err_msg=f"decode_chunk {chunk}")
    if f"{arch}/engine" in r:
        for i in range(4):
            np.testing.assert_array_equal(np.asarray(r[f"{arch}/engine"][i]),
                                          base[i, 6:])
