"""Sharded serving on a 2×2 gloo mesh, rwkv6-1.6b smoke: the paged engine,
speculative decode and quantized heads' streams.

Twins of those cases of ``tests/test_sharded_serving.py`` (the JAX
package's 4×2 forced-CPU mesh; 4 ranks is what fits beside the test run's
other workers on an 8-core machine), on their own spawn of four gloo ranks
(``tests/torch_mesh_serving.py``'s ``spec_ranks``) so that neither this nor
``test_torch_sharded_serving.py`` outgrows its time.  On the mesh:

* the paged engine's seeded streams, with prefix hits, equal the
  contiguous engine's bit for bit;
* speculative decode (the sharded sketch head drafting, the dense head
  verifying) gives the dense streams bit for bit, static and engine,
  greedy and seeded, K = 1 and 4;
* a quantized head serves deterministically, the engine equal to the
  static ``generate``.

~45 s on an idle machine.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pathlib import Path

from torch_mesh import run_ranks

ARCH = "rwkv6-1.6b"


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


@pytest.mark.parametrize("kind", ["dense", "sketch-fused"])
def test_paged_engine_matches_contiguous_on_mesh(r, kind):
    assert r[f"paged/{kind}/True"] == r[f"paged/{kind}/False"]
    assert r[f"paged/{kind}/hits"] > 0


@pytest.mark.parametrize("kind", ["sketch-ref", "sketch-fused"])
def test_spec_decode_matches_dense_on_mesh(r, kind):
    for si in (0, 1):
        for k in (1, 4):
            np.testing.assert_array_equal(
                r[f"spec/{kind}/{si}/{k}"], r["spec/dense"][si],
                err_msg=f"on-mesh spec_decode={k} diverged ({kind})")
    assert r[f"spec/{kind}/engine/spec"] == r["spec/engine/dense"]


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_generate_on_mesh(r, quant):
    static = r[f"quantgen/{quant}/static"]
    np.testing.assert_array_equal(r[f"quantgen/{quant}/again"], static)
    for i in range(4):
        np.testing.assert_array_equal(
            np.asarray(r[f"quantgen/{quant}/served"][i]), static[i, 6:])
