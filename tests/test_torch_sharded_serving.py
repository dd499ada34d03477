"""Sharded serving on a 2×2 gloo mesh: rwkv6-1.6b smoke.

Twins of ``tests/test_sharded_serving.py`` (the JAX package's 4×2
forced-CPU mesh): the port serves SPMD over four spawned gloo ranks, one
CPU thread each (4 ranks is what fits beside the test run's other workers
on an 8-core machine).  One module fixture spawns the ranks once and runs
every scenario (``tests/torch_mesh_serving.py``); the tests assert on what
rank 0 hands back.  gemma2-27b's twins are in
``test_torch_sharded_serving_gemma2.py``.  ~50 s on an idle machine.

The paged, speculative and quantized streams are
``test_torch_sharded_serving_spec.py``'s (a spawn of their own).  The
invariants are the reference's:

* dense streams on the mesh equal the single-device streams;
* sampled streams on the mesh reproduce with one seed;
* on the mesh the engine (contiguous, staggered, chunked, per-tenant)
  gives the static ``generate`` streams bit for bit;
* the sharded head's logits are within 1e-5 of the single-device head's
  on one hidden (f32 reassociation of the L/m-row partial means);
* the count arrays, scales and params are split over ``model`` (each
  rank's local shapes), the hash params replicated;
* the slot pool keeps its ``cache_shardings`` placements through insert,
  decode and reset.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pathlib import Path

from torch_mesh import run_ranks
from torch_mesh_serving import HEAD_CFG

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
                     "serving_ranks", world=4, timeout=240, args=(ARCH,))


def test_generate_dense_token_parity_vs_single_device(r):
    np.testing.assert_array_equal(r["dense/mesh"], r["dense/base"])
    np.testing.assert_array_equal(r["dense/unmeshed"], r["dense/base"])


@pytest.mark.parametrize("kind", ["dense", "sketch-ref", "sketch-fused"])
def test_sharded_generate_deterministic(r, kind):
    a, b = r[f"determinism/{kind}"]
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["dense", "sketch-ref", "sketch-fused"])
def test_engine_matches_generate_on_mesh(r, kind):
    static = r[f"engine/{kind}/static"]
    served = r[f"engine/{kind}/served"]
    for i in range(4):
        np.testing.assert_array_equal(np.asarray(served[i]), static[i, 6:])


def test_engine_staggered_matches_solo_on_mesh(r):
    for rid, solo in enumerate(r["staggered/solo"]):
        np.testing.assert_array_equal(np.asarray(r["staggered/served"][rid]),
                                      solo)


@pytest.mark.parametrize("backend", ["ref", "two_kernel", "fused"])
def test_apply_head_sharded_logits_close(r, backend):
    np.testing.assert_allclose(r[f"head/{backend}/mesh"],
                               r[f"head/{backend}/base"],
                               rtol=1e-5, atol=1e-5)


def test_count_arrays_sharded_over_model(r):
    assert r["head/placements"]["array"] == ("model", None, None)
    for name in ("proj", "w", "b"):
        assert all(e is None for e in r["head/placements"][name]), name
    l, v = HEAD_CFG.n_rows, r["head/fused/base"].shape[1]
    for shapes in r["head/local_shapes"]:
        assert shapes["array"] == (l // 2, HEAD_CFG.n_buckets, v)
        assert shapes["w"][0] == l


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("backend", ["two_kernel", "fused"])
def test_apply_head_quantized_sharded_logits_close(r, backend, quant):
    sharded = r[f"quant/{quant}/{backend}/mesh"]
    np.testing.assert_allclose(sharded, r[f"quant/{quant}/{backend}/base"],
                               rtol=1e-5, atol=1e-5)
    f32 = r[f"quant/{quant}/{backend}/f32"]
    assert np.abs(sharded - f32).max() < r[f"quant/{quant}/max_scale"]


def test_quantized_head_scales_sharded_over_model(r):
    assert r["quant/int8/dtype"] == "torch.int8"
    assert r["quant/int8/placements"]["array"] == ("model", None, None)
    assert r["quant/int8/placements"]["scale"] == ("model", None)
    assert set(r["quant/int8/scale_local"]) == {
        (HEAD_CFG.n_rows // 2, HEAD_CFG.n_buckets)}


def test_model_params_sharded(r):
    assert r["params/embed"][:1] == ("model",)
    for local in r["params/local"]:
        assert local["embed"][0] * 2 == r["head/fused/base"].shape[1]


def test_engine_pool_shardings_preserved(r):
    assert r["pool/fresh"]
    assert r["pool/after"]


def test_chunked_engine_on_mesh_matches_k1_and_keeps_shardings(r):
    assert r["chunked/got"] == r["chunked/base"]
    assert r["chunked/placed"]


def test_per_tenant_heads_on_mesh(r):
    """A ``HeadCache`` on the mesh: the bank laid out by
    ``head_bank_shardings`` (the tenant axis unsharded, each row's counts
    over ``model``), and every request of a per-tenant engine equal to its
    tenant's head alone through ``generate`` on the mesh."""
    assert r["tenants/bank"]["array"] == (None, "model", None, None)
    assert r["tenants/bank"]["w"] == (None, None, None, None)
    for i, solo in enumerate(r["tenants/solo"]):
        np.testing.assert_array_equal(np.asarray(r["tenants/served"][i]), solo)


def test_serve_cli_on_mesh(r):
    """``serve --mesh 2x2`` (what each torchrun rank runs) serves and
    prints its banner once."""
    assert r["cli"].count("served 4 seqs x 4 new tokens") == 1, r["cli"]


def test_parse_mesh_specs(r):
    assert r["mesh/none"] and r["mesh/same"]
    assert r["mesh/dims"] == {"data": 2, "model": 2}
    assert "not of the form" in r["mesh/banana"]
    for bad in ("64x64", "4x2"):
        assert bad in r[f"mesh/{bad}"] and "ranks" in r[f"mesh/{bad}"]


def test_parse_mesh_needs_a_process_group():
    """Without an initialised process group a mesh spec raises, naming
    the spec (no fallback to one device)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import parse_mesh

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="'2x2'.*process group"):
        parse_mesh("2x2", "cpu")
    assert parse_mesh(None) is None


def test_fused_decode_ref_row_start_parts_equal_whole():
    """A row shard hashes with its global rows' salts: each part's indices
    are the whole head's columns, and the parts' scaled partial means sum
    to the whole mean (f32 reassociation of L/m-term means)."""
    from repro_torch.kernels.fused_decode.ops import fused_decode_ref

    rng = np.random.default_rng(0)
    f32 = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
    b, d, dp, l, k, rr, v = 5, 24, 8, 32, 2, 8, 40
    h, proj, w, bias = f32(b, d), f32(d, dp), f32(l, k, dp), f32(l, k)
    sketch = f32(l, rr, v)
    whole_idx = torch.empty((b, l), dtype=torch.int32)
    whole = fused_decode_ref(h, proj, w, bias, sketch, 2.0, rr,
                             idx_out=whole_idx)
    for m in (2, 4):
        ls = l // m
        total = torch.zeros_like(whole)
        for part in range(m):
            rows = slice(part * ls, (part + 1) * ls)
            idx = torch.empty((b, ls), dtype=torch.int32)
            out = fused_decode_ref(h, proj, w[rows], bias[rows],
                                   sketch[rows], 2.0, rr, idx_out=idx,
                                   row_start=part * ls)
            torch.testing.assert_close(idx, whole_idx[:, rows], rtol=0,
                                       atol=0)
            total += out * (ls / l)
        torch.testing.assert_close(total, whole, rtol=1e-6, atol=1e-6)
        # without the global-row salts the parts hash elsewhere
        idx0 = torch.empty((b, ls), dtype=torch.int32)
        fused_decode_ref(h, proj, w[ls:2 * ls], bias[ls:2 * ls],
                         sketch[ls:2 * ls], 2.0, rr, idx_out=idx0)
        assert not torch.equal(idx0, whole_idx[:, ls:2 * ls])
