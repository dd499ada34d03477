"""Sharded serving on a 2×2 gloo mesh, gemma2-27b smoke: the paged engine,
speculative decode and quantized heads' streams.

The cases of ``test_torch_sharded_serving_spec.py`` (there for
rwkv6-1.6b) on gemma2's attention stack: GQA, the SWA ring (the
speculative rollback restores ring slots), softcaps.  ~45 s on an idle
machine.
"""

import pytest

torch = pytest.importorskip("torch")

from pathlib import Path

from torch_mesh import run_ranks
from test_torch_sharded_serving_spec import (  # noqa: F401  (collected here too)
    test_paged_engine_matches_contiguous_on_mesh,
    test_quantized_generate_on_mesh, test_spec_decode_matches_dense_on_mesh)

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
                     "spec_ranks", world=4, timeout=240, args=(ARCH,))
