"""Sharded serving on a 2×2 gloo mesh: gemma2-27b smoke (attention with
GQA, the SWA ring, softcaps; the prefill's ``flash_attention`` on each
rank's heads).

The same twins of ``tests/test_sharded_serving.py`` as
``test_torch_sharded_serving.py`` runs for rwkv6-1.6b, on their own
spawned ranks (a file per arch and scenario group keeps each file's time
down under the test run's six workers; the paged, speculative and
quantized streams are ``test_torch_sharded_serving_gemma2_spec.py``'s).
~35 s on an idle machine.
"""

import pytest

torch = pytest.importorskip("torch")

from pathlib import Path

from torch_mesh import run_ranks
from test_torch_sharded_serving import (  # noqa: F401  (collected here too)
    test_apply_head_quantized_sharded_logits_close,
    test_apply_head_sharded_logits_close,
    test_chunked_engine_on_mesh_matches_k1_and_keeps_shardings,
    test_count_arrays_sharded_over_model,
    test_engine_matches_generate_on_mesh,
    test_engine_pool_shardings_preserved,
    test_engine_staggered_matches_solo_on_mesh,
    test_generate_dense_token_parity_vs_single_device,
    test_model_params_sharded, test_parse_mesh_specs,
    test_per_tenant_heads_on_mesh, test_quantized_head_scales_sharded_over_model,
    test_serve_cli_on_mesh, test_sharded_generate_deterministic)

ARCH = "gemma2-27b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def r():
    return run_ranks(str(Path(__file__).with_name("torch_mesh_serving.py")),
                     "serving_ranks", world=4, timeout=240, args=(ARCH,))
