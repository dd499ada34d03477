"""The port's sketch-head kernels and helpers against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs each op with ``backend="pallas"`` (interpret mode on the
CPU, as tests/test_kernels.py runs it) and with ``backend="ref"``; the
port's wrappers run their plain versions on CPU tensors.  Tolerances
(``repro_torch.parity``): integers bit for bit; hash indices may
differ only at a floor() boundary within the f32 summation error bound;
logits within the bound of two f32 means of the same L terms.

The ``cuda`` cases hold each CUDA kernel against its plain version on the
card and skip without one; they import no JAX, so they run on a GPU
machine with ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.lsh import L2LSH, LSHConfig, _fold_subhashes, row_salts
from repro_torch.core.sketch_lm_head import quantize_counts
from repro_torch.kernels.common import pack_int4_rows, pad_axis, unpack_int4_rows
from repro_torch.kernels.fused_decode.ops import fused_decode_logits, fused_decode_ref
from repro_torch.kernels.lsh_hash.ops import lsh_hash, lsh_hash_ref
from repro_torch.kernels.race_update.ops import (race_update,
                                                 race_update_counts,
                                                 race_update_counts_ref,
                                                 race_update_ref)
from repro_torch.parity import (check_hash_indices, gather_atol,
                                race_update_tol)
from repro_torch.kernels.sketch_head.ops import (dequantize_sketch_ref,
                                                 sketch_head_logits,
                                                 sketch_head_ref)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's functions (imported here, so that the cuda cases
    of this file also run where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import lsh as jlsh
    from repro.core.sketch_lm_head import quantize_counts as jquant
    from repro.kernels import common as jcommon
    from repro.kernels.fused_decode.ops import fused_decode_logits as jfused
    from repro.kernels.lsh_hash.ops import lsh_hash as jhash
    from repro.kernels.lsh_hash.ref import lsh_hash_ref as jhash_ref
    from repro.kernels.race_update.ops import race_update as jrace
    from repro.kernels.sketch_head.ops import sketch_head_logits as jgather
    from repro.kernels.sketch_head.ref import sketch_head_ref as jgather_ref
    return dict(jax=jax, jnp=jnp, lsh=jlsh, quant=jquant, common=jcommon,
                fused=jfused, hash=jhash, hash_ref=jhash_ref, gather=jgather,
                gather_ref=jgather_ref, race=jrace)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no "
                    "CPU mode; their plain versions are tested above")
    return torch.device("cuda")


def _head(seed, *, d=24, dp=8, n_rows=5, k=2, r=7, v=203, bandwidth=1.5):
    """Numpy head arrays at odd L, R and V (V not a tile multiple)."""
    rng = np.random.default_rng(seed)
    return dict(
        proj=(rng.standard_normal((d, dp)) / np.sqrt(d)).astype(np.float32),
        w=rng.standard_normal((n_rows, k, dp)).astype(np.float32),
        b=(rng.random((n_rows, k)) * bandwidth).astype(np.float32),
        array=rng.standard_normal((n_rows, r, v)).astype(np.float32),
        bandwidth=bandwidth, r=r)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ helpers

@pytest.mark.parametrize("shape", [(7, 3, 5), (6, 1, 11), (1, 2, 3)])
def test_int4_pack_unpack_bitwise(jx, shape):
    q = np.random.default_rng(0).integers(-8, 8, shape).astype(np.int8)
    packed = pack_int4_rows(_t(q))
    want = np.asarray(jx["common"].pack_int4_rows(jx["jnp"].asarray(q)))
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(unpack_int4_rows(packed, shape[0]).numpy(),
                                  q)


@pytest.mark.parametrize("axis,multiple", [(0, 8), (1, 4), (-1, 3)])
def test_pad_axis_matches_jax(jx, axis, multiple):
    x = np.random.default_rng(1).standard_normal((5, 7)).astype(np.float32)
    got = pad_axis(_t(x), axis, multiple, value=-1.0).numpy()
    want = np.asarray(jx["common"].pad_axis(jx["jnp"].asarray(x), axis,
                                            multiple, value=-1.0))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_rows", [1, 13])
def test_row_salts_bitwise(jx, n_rows):
    got = row_salts(n_rows).numpy()
    want = np.asarray(jx["lsh"].row_salts(n_rows)).astype(np.int64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("n_buckets", [7, 16])
def test_fold_subhashes_bitwise(jx, k, n_buckets):
    codes = np.random.default_rng(k).integers(
        -50, 50, (4, 9, k)).astype(np.int32)        # negatives included
    got = _fold_subhashes(_t(codes), n_buckets).numpy()
    want = np.asarray(jx["lsh"]._fold_subhashes(jx["jnp"].asarray(codes),
                                                n_buckets))
    np.testing.assert_array_equal(got, want)


def test_l2lsh_hash_matches_jax(jx):
    h = _head(2, n_rows=9, k=3)
    x = np.random.default_rng(3).standard_normal((11, 8)).astype(np.float32)
    cfg = dict(n_rows=9, n_buckets=7, k=3, dim=8, bandwidth=h["bandwidth"])
    got = L2LSH(LSHConfig(**cfg)).hash({"w": _t(h["w"]), "b": _t(h["b"])},
                                       _t(x))
    jl = jx["lsh"].L2LSH(jx["lsh"].LSHConfig(**cfg))
    want = jl.hash({"w": h["w"], "b": h["b"]}, jx["jnp"].asarray(x))
    check_hash_indices(got, _t(np.asarray(want)), _t(x), _t(h["w"]),
                       _t(h["b"]), h["bandwidth"])


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantize_counts_bitwise(jx, quant):
    a = _head(4)["array"]
    a[1, 2] = 0.0                                    # an all-zero row
    store, scale = quantize_counts(_t(a), quant)
    jstore, jscale = jx["quant"](jx["jnp"].asarray(a), quant)
    np.testing.assert_array_equal(store.numpy(), np.asarray(jstore))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


# ------------------------------------------- plain versions against JAX

@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("k", [1, 2])
def test_lsh_hash_matches_jax(jx, b, k):
    h = _head(10 + k, k=k)
    x = np.random.default_rng(b).standard_normal((b, 8)).astype(np.float32)
    got = lsh_hash(_t(x), _t(h["w"]), _t(h["b"]), bandwidth=h["bandwidth"],
                   n_buckets=h["r"])
    assert got.dtype == torch.int32 and got.shape == (b, 5)
    for backend in ("pallas", "ref"):
        want = jx["hash"](jx["jnp"].asarray(x), h["w"], h["b"],
                          bandwidth=h["bandwidth"], n_buckets=h["r"],
                          backend=backend)
        check_hash_indices(got, _t(np.asarray(want)), _t(x), _t(h["w"]),
                           _t(h["b"]), h["bandwidth"])


def _storage(jx, array, quant):
    """(torch store, torch scale, jax store, jax scale, max |count|)."""
    if quant is None:
        return _t(array), None, array, None, float(np.abs(array).max())
    jstore, jscale = jx["quant"](jx["jnp"].asarray(array), quant)
    store, scale = _t(np.asarray(jstore)), _t(np.asarray(jscale))
    amax = float(dequantize_sketch_ref(store, scale, quant).abs().max())
    return store, scale, jstore, jscale, amax


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_sketch_head_matches_jax(jx, b, quant):
    h = _head(20)
    idx = np.random.default_rng(b).integers(0, h["r"], (b, 5)).astype(np.int32)
    store, scale, jstore, jscale, amax = _storage(jx, h["array"], quant)
    got = sketch_head_logits(store, _t(idx), scale=scale, quant=quant)
    assert got.dtype == torch.float32 and got.shape == (b, 203)
    atol = gather_atol(5, amax)
    for backend in ("pallas", "ref"):
        want = jx["gather"](jstore, jx["jnp"].asarray(idx), scale=jscale,
                            quant=quant, backend=backend)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_fused_decode_matches_jax(jx, b, k, quant):
    """bf16 hiddens at b=3, f32 elsewhere; both cast to f32 first."""
    jnp = jx["jnp"]
    h = _head(30 + k, k=k)
    dtype = jnp.bfloat16 if b == 3 else jnp.float32
    jhid = jnp.asarray(np.random.default_rng(b).standard_normal((b, 24)),
                       dtype)
    hid32 = np.asarray(jhid.astype(jnp.float32))
    hid = _t(hid32).to(torch.bfloat16 if b == 3 else torch.float32)
    store, scale, jstore, jscale, amax = _storage(jx, h["array"], quant)
    idx = torch.empty((b, 5), dtype=torch.int32)
    got = fused_decode_logits(hid, _t(h["proj"]), _t(h["w"]), _t(h["b"]),
                              store, bandwidth=h["bandwidth"],
                              n_buckets=h["r"], scale=scale, quant=quant,
                              idx_out=idx)
    # The JAX indices of the same composition, held to the boundary rule;
    # then every row's logits against JAX's gather at the port's indices
    # (rows whose indices agree: against JAX's fused op itself).
    jidx = jx["hash_ref"](jnp.asarray(hid32) @ h["proj"], h["w"], h["b"],
                          h["bandwidth"], h["r"])
    check_hash_indices(idx, _t(np.asarray(jidx)), _t(hid32), _t(h["w"]),
                       _t(h["b"]), h["bandwidth"], proj=_t(h["proj"]))
    atol = gather_atol(5, amax)
    at_ours = jx["gather_ref"](jstore, jnp.asarray(idx.numpy()), jscale, quant)
    np.testing.assert_allclose(got.numpy(), np.asarray(at_ours), rtol=0,
                               atol=atol)
    same = (idx.numpy() == np.asarray(jidx)).all(axis=1)
    for backend in ("pallas", "ref"):
        want = jx["fused"](jhid, h["proj"], h["w"], h["b"], jstore,
                           bandwidth=h["bandwidth"], n_buckets=h["r"],
                           scale=jscale, quant=quant, backend=backend)
        np.testing.assert_allclose(got.numpy()[same],
                                   np.asarray(want)[same], rtol=0, atol=atol)


def _race_case(seed, m, n_rows, r, c):
    """A (C, L, R) sketch, (M, L) indices with some outside [0, R) (they add
    nothing), and (M, C) weights."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((c, n_rows, r)).astype(np.float32),
            rng.integers(-1, r + 1, (m, n_rows)).astype(np.int32),
            (rng.standard_normal((m, c)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("m,n_rows,r,c", [(1, 3, 4, 5), (37, 5, 7, 203),
                                          (300, 9, 16, 64)])
def test_race_update_matches_jax(jx, m, n_rows, r, c):
    """Both entries, (C, L, R) and the head's (L, R, V), against JAX's
    race_update (pallas in interpret mode, 256-point blocks, and ref) on
    the same indices and weights, within race_update_tol."""
    sketch, idx, alphas = _race_case(m, m, n_rows, r, c)
    got = race_update(_t(sketch), _t(idx), _t(alphas))
    lrv = race_update_counts(_t(sketch).permute(1, 2, 0).contiguous(),
                             _t(idx), _t(alphas))
    assert got.shape == (c, n_rows, r) and lrv.shape == (n_rows, r, c)
    tol = race_update_tol(_t(sketch), _t(alphas), 0).numpy()
    for backend in ("pallas", "ref"):
        want = np.asarray(jx["race"](jx["jnp"].asarray(sketch), idx, alphas,
                                     backend=backend), np.float64)
        assert (np.abs(got.numpy() - want) <= tol).all()
        assert (np.abs(lrv.numpy().transpose(2, 0, 1) - want) <= tol).all()


def test_race_update_out_in_place():
    sketch, idx, alphas = _race_case(3, 20, 4, 6, 33)
    want = race_update_ref(_t(sketch), _t(idx), _t(alphas))
    buf = _t(sketch)
    assert race_update(buf, _t(idx), _t(alphas), out=buf) is buf
    assert torch.equal(buf, want)
    counts = _t(sketch).permute(1, 2, 0).contiguous()
    got = race_update_counts(counts, _t(idx), _t(alphas), out=counts)
    assert got is counts and torch.equal(
        counts, race_update_counts_ref(_t(sketch).permute(1, 2, 0),
                                       _t(idx), _t(alphas)))


def test_quant_scale_must_pair():
    h = _head(40)
    with pytest.raises(ValueError, match="together"):
        sketch_head_logits(_t(h["array"]), torch.zeros((1, 5), dtype=torch.int32),
                           quant="int8")


# ----------------------------------------------------- on the card

_CUDA_SHAPES = [  # (b, d, dp, n_rows, k, r, v, bandwidth)
    (1, 2048, 32, 128, 1, 16, 65536, 2.0),      # the serve.py rwkv6 head
    (4, 2048, 64, 64, 2, 16, 65519, 4.0),       # SketchHeadConfig(), ragged V
    (9, 40, 8, 5, 3, 7, 203, 1.5),              # odd everything, b > tile
    (3, 600, 70, 19, 2, 9, 700, 3.0),           # 2-row tiles, d' > 64, d in 3 chunks
]


def _cuda_case(dev, shape, quant, seed=0):
    b, d, dp, n_rows, k, r, v, bw = shape
    g = torch.Generator(dev).manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    hid = randn(b, d)
    proj = randn(d, dp) / d ** 0.5
    w, bias = randn(n_rows, k, dp), torch.rand((n_rows, k), generator=g,
                                               device=dev) * bw
    array = randn(n_rows, r, v)
    store, scale = (array, None) if quant is None else quantize_counts(array, quant)
    deq = array if quant is None else dequantize_sketch_ref(store, scale, quant)
    return hid, proj, w, bias, store, scale, bw, r, gather_atol(n_rows, float(deq.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _CUDA_SHAPES)
def test_cuda_lsh_hash_kernel(cuda, shape):
    hid, proj, w, bias, _, _, bw, r, _ = _cuda_case(cuda, shape, None)
    q = hid @ proj
    got = lsh_hash(q, w, bias, bandwidth=bw, n_buckets=r)
    torch.cuda.synchronize()
    check_hash_indices(got, lsh_hash_ref(q, w, bias, bw, r), q, w, bias, bw)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("shape", _CUDA_SHAPES)
def test_cuda_sketch_head_kernel(cuda, shape, quant):
    hid, _, _, _, store, scale, _, r, atol = _cuda_case(cuda, shape, quant)
    idx = torch.randint(0, r, (hid.shape[0], shape[3]), device=cuda,
                        dtype=torch.int32)
    got = sketch_head_logits(store, idx, scale=scale, quant=quant)
    torch.cuda.synchronize()
    want = sketch_head_ref(store, idx, scale, quant)
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("shape", _CUDA_SHAPES)
def test_cuda_fused_decode_kernel(cuda, shape, quant):
    hid, proj, w, bias, store, scale, bw, r, atol = _cuda_case(cuda, shape, quant)
    idx = torch.empty((hid.shape[0], shape[3]), dtype=torch.int32, device=cuda)
    got = fused_decode_logits(hid, proj, w, bias, store, bandwidth=bw,
                              n_buckets=r, scale=scale, quant=quant,
                              idx_out=idx)
    torch.cuda.synchronize()
    ref_idx = torch.empty_like(idx)
    fused_decode_ref(hid, proj, w, bias, store, bw, r, scale, quant, ref_idx)
    check_hash_indices(idx, ref_idx, hid, w, bias, bw, proj=proj)
    torch.testing.assert_close(got, sketch_head_ref(store, idx, scale, quant),
                               rtol=0, atol=atol)


_RACE_SHAPES = [  # (m, n_rows, r, v)
    (256, 128, 16, 65536),      # the refresh of the serve.py rwkv6 head
    (1024, 64, 16, 65519),      # SketchHeadConfig(), ragged V
    (37, 5, 7, 203),            # odd everything
    (100, 19, 40, 333),         # R > 16: several bucket passes
    (0, 3, 4, 5),               # no points: out = counts
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _RACE_SHAPES)
def test_cuda_race_update_kernel(cuda, shape):
    """Both entries against their plain versions within race_update_tol,
    two launches bit for bit equal, the in-place fold equal to the fresh
    one, and one launch counted per call."""
    m, n_rows, r, v = shape
    g = torch.Generator(cuda).manual_seed(m)
    counts = torch.randn((n_rows, r, v), generator=g, device=cuda)
    idx = torch.randint(-1, r + 1, (m, n_rows), generator=g, device=cuda,
                        dtype=torch.int32)
    alphas = torch.randn((m, v), generator=g, device=cuda)
    race_update.launches = 0
    got, again = (race_update_counts(counts, idx, alphas) for _ in range(2))
    inplace = counts.clone()
    race_update_counts(inplace, idx, alphas, out=inplace)
    sketch = counts.permute(2, 0, 1).contiguous()
    clr = race_update(sketch, idx, alphas)
    torch.cuda.synchronize()
    assert race_update.launches == 4
    want = race_update_counts_ref(counts, idx, alphas)
    assert bool(((got - want).abs().double()
                 <= race_update_tol(counts, alphas, -1)).all())
    assert torch.equal(got, again) and torch.equal(inplace, got)
    assert torch.equal(clr.permute(1, 2, 0), got)
    assert bool(((clr - race_update_ref(sketch, idx, alphas)).abs().double()
                 <= race_update_tol(sketch, alphas, 0)).all())


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_operands(cuda):
    hid, proj, w, bias, store, _, bw, r, _ = _cuda_case(cuda, _CUDA_SHAPES[2], None)
    with pytest.raises(TypeError, match="dtype"):
        sketch_head_logits(store, torch.zeros((9, 5), dtype=torch.int64,
                                              device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        lsh_hash((hid @ proj).t().contiguous().t(), w, bias, bandwidth=bw,
                 n_buckets=r)
    with pytest.raises(ValueError, match="cuda"):
        fused_decode_logits(hid, proj.cpu(), w, bias, store, bandwidth=bw,
                            n_buckets=r)
    with pytest.raises(TypeError, match="dtype"):
        race_update_counts(store, torch.zeros((2, 5), dtype=torch.int64,
                                              device=cuda),
                           torch.zeros((2, 203), device=cuda))
