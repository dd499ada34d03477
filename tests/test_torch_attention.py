"""The port's attention family (gemma2-27b's smoke config) against the JAX
package.

Inputs are made with numpy from a seed and handed to both packages; params
come from the JAX package's init through ``convert.params_from_numpy``.
Tolerances:

* The flash kernel's plain version against JAX's ``flash_attention_ref``
  and the Pallas kernel in interpret mode: f32 ``rtol = atol = 2e-5``
  (tests/test_kernels.py's own); bf16 at most one bf16 ulp of the JAX
  value (the f32 sums run in another order before the one rounding).
  GQA inputs go to JAX with the KV heads expanded (``jnp.repeat``, axis 2).
* The plain ``_attend_*`` functions against JAX's: the same f32 bound.
* RoPE (f32) within ``4u·(|x1| + |x2|)`` (u = 2⁻²⁴: XLA's f32 cos/sin
  and the port's, rounded from f64, may be one f32 ulp apart), bf16 RoPE
  and SwiGLU at most one bf16 ulp.
* One layer of each kind against ``repro.models.blocks.apply_layer`` run
  eagerly: at most one bf16 ulp.
* The whole forward and every decode step against JAX's compiled ones:
  ``repro_torch.parity``'s bf16 backbone rule (2⁻⁵ in norm, 2⁻⁴ at the
  worst element); the first layer's cache bit for bit, later layers' under
  the same rule (XLA keeps excess precision inside its fusions).
* Greedy tokens: exact, dense and sketched (a head frozen by JAX, carried
  as an archive).

The ``cuda`` case holds the CUDA kernel against its plain version within
``repro_torch.parity.flash_attn_tol`` (bf16 inputs run on the tensor cores
and take its ``tensor_cores`` form) and skips without a card; JAX is
imported inside fixtures, so it also runs where JAX is not installed
(``python -m pytest --noconftest -m cuda``).  On the CPU, the tensor-core
path's premise is checked directly: the bf16 split of p is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import LM, SketchHead
from repro_torch.configs import get_config
from repro_torch.convert import decode_cache_from_numpy, params_from_numpy
from repro_torch.kernels.flash_attn.ops import (flash_attention,
                                                flash_attention_ref)
from repro_torch.launch import serve
from repro_torch.launch.steps import prefill_step, serve_step
from repro_torch.models import attention as attn
from repro_torch.models import blocks, model
from repro_torch.models.config import AttentionConfig
from repro_torch.models.layers import apply_rope, rope_frequencies, swiglu
from repro_torch.parity import (assert_bf16_backbone_close,
                                assert_flash_attn_close, flash_attn_tol)

ARCH = "gemma2-27b"
F32_TOL = 2e-5
# (S, window, softcap, block_q, block_k): tests/test_kernels.py's cases.
FLASH_CASES = [(96, None, None, 32, 32), (200, 64, None, 64, 64),
               (128, None, 50.0, 32, 64), (256, 32, 30.0, 128, 128)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its cases are many tiny
    eager ops, and PyTorch's default (a thread per core in every pytest
    worker) oversubscribes the machine under ``-n 6``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces these tests hold the port against."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.api.heads import load_head
    from repro.configs import get_config as config
    from repro.core import sketch_lm_head as head
    from repro.kernels.flash_attn.ops import flash_attention as flash
    from repro.kernels.flash_attn.ref import flash_attention_ref as flash_ref
    from repro.launch.serve import generate
    from repro.models import attention, blocks as jblocks, layers, model as jmodel
    from repro.models.config import AttentionConfig as JaxAttentionConfig
    from repro.models.config import SketchHeadConfig
    return dict(jax=jax, jnp=jnp, load_head=load_head, config=config,
                head=head, flash=flash, flash_ref=flash_ref, generate=generate,
                attention=attention, blocks=jblocks, layers=layers,
                model=jmodel, AttentionConfig=JaxAttentionConfig,
                SketchHeadConfig=SketchHeadConfig)


@pytest.fixture(scope="module")
def smoke(jx):
    """JAX config and params, and the port's, on the CPU."""
    jcfg, cfg = jx["config"](ARCH, smoke=True), get_config(ARCH, smoke=True)
    jparams = jx["model"].init_model(jx["jax"].random.PRNGKey(0), jcfg)
    params = params_from_numpy(jx["jax"].tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _f32(jx, a):
    return np.asarray(jx["jnp"].asarray(a).astype(jx["jnp"].float32))


def assert_within_bf16_ulp(got, want):
    """Every element within one bf16 ulp (8 significant bits) of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    over = np.abs(got - want) > ulp
    assert not over.any(), (f"{int(over.sum())} elements beyond one bf16 ulp, "
                            f"worst {np.abs(got - want).max()}")


def _qkv(seed, b, s, h, hkv, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, dh)).astype(np.float32),
            rng.standard_normal((b, s, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, s, hkv, dh)).astype(np.float32))


# ------------------------------------------------------------ flash_attn

@pytest.mark.parametrize("hkv", [2, 1], ids=["mha", "gqa"])
@pytest.mark.parametrize("s,window,cap,bq,bk", FLASH_CASES)
def test_flash_ref_matches_jax_ref_and_pallas(jx, s, window, cap, bq, bk, hkv):
    jnp = jx["jnp"]
    q, k, v = _qkv(s, 2, s, 2, hkv, 16)
    g = 2 // hkv
    jq, jk, jv = (jnp.asarray(q), jnp.repeat(jnp.asarray(k), g, axis=2),
                  jnp.repeat(jnp.asarray(v), g, axis=2))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), window=window, softcap=cap)
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = jx["flash_ref"](jq, jk, jv, window=window, softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    pallas = jx["flash"](jq, jk, jv, window=window, softcap=cap, block_q=bq,
                         block_k=bk, backend="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=F32_TOL,
                               atol=F32_TOL)
    # The bound the card's kernel is held to also covers JAX's evaluations.
    tol = flash_attn_tol(*(torch.from_numpy(a) for a in (q, k, v)), window, cap)
    for other in (want, pallas):
        assert_flash_attn_close(got, torch.from_numpy(np.asarray(other)), tol)


@pytest.mark.parametrize("window,cap", [(None, 50.0), (24, None)])
def test_flash_ref_bf16_within_one_ulp_of_jax(jx, window, cap):
    jnp = jx["jnp"]
    q, k, v = _qkv(7, 2, 64, 4, 2, 32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention_ref(tq, tk, tv, window=window, softcap=cap)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jx["flash_ref"](jq, jnp.repeat(jk, 2, axis=2),
                           jnp.repeat(jv, 2, axis=2), window=window,
                           softcap=cap)
    assert_within_bf16_ulp(got.float().numpy(), _f32(jx, want))


def test_flash_wrapper_on_cpu_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 40, 4, 2, 16))
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=9, softcap=30.0)
    assert torch.equal(got, flash_attention_ref(q, k, v, window=9,
                                                softcap=30.0))
    assert flash_attention.launches == before
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(q, k[:, :, :1].expand(-1, -1, 3, -1), v[:, :, :1]
                        .expand(-1, -1, 3, -1))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)


def test_flash_window_band_starts_mid_tile():
    """A window whose band starts inside the kernel's 32-key tiles (the
    rows at the band's edge see only masked keys in its first tile): every
    row equals softmax attention over its own window computed row by row
    in f64.  Here that holds the plain version; the cuda case below holds
    the kernel to it at the same window."""
    q, k, v = _qkv(3, 1, 150, 2, 1, 16)
    window = 45                                # 150 - 45 is no multiple of 32
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          window=window).numpy()
    q64, k64, v64 = (a.astype(np.float64) for a in (q, k, v))
    for i in range(150):
        lo = max(0, i - window + 1)
        for h in range(2):
            s = q64[0, i, h] @ k64[0, lo:i + 1, 0].T / 4.0
            p = np.exp(s - s.max())
            np.testing.assert_allclose(got[0, i, h],
                                       p @ v64[0, lo:i + 1, 0] / p.sum(),
                                       rtol=F32_TOL, atol=F32_TOL)


def _f32_at_every_exponent(rng, exp_fields, n=64):
    """f32 values with each biased exponent field in ``exp_fields`` (0:
    subnormal), random sign and significand plus its ends (all zeros, all
    ones)."""
    e = np.repeat(np.asarray(exp_fields, np.uint32), n)
    frac = rng.integers(0, 1 << 23, e.size, dtype=np.uint32)
    frac[::n], frac[1::n] = 0, (1 << 23) - 1
    sign = rng.integers(0, 2, e.size, dtype=np.uint32) << 31
    return torch.from_numpy((sign | (e << 23) | frac).view(np.float32))


def split_bf16(x: torch.Tensor):
    """``(hi, mid, lo)``, the bf16 terms the kernel's tensor-core path
    (``split3`` in ``csrc/flash_attn.cu``) splits f32 ``x`` into:
    ``hi = bf16(x)``, ``mid = bf16(x - hi)``, ``lo = bf16(x - hi - mid)``,
    each residual exact in f32."""
    hi = x.to(torch.bfloat16)
    r = x - hi.to(x.dtype)
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.to(x.dtype)).to(torch.bfloat16)


def _split_sum(x):
    return sum(t.to(torch.float64) for t in split_bf16(x))


@pytest.mark.parametrize("case", ["p_scaled", "above_2^-110"])
def test_flash_bf16_split_is_exact(case):
    """The tensor-core path's p·v premise, in plain torch: hi + mid + lo of
    ``split_bf16`` equals x exactly.  ``p_scaled``: x = p·2¹⁶ for f32 p in
    [0, 1] of every exponent down to f32's least subnormal (what the kernel
    splits; unscaled, p = 2⁻¹⁴⁹ would split to 0).  ``above_2^-110``: every
    binade from 2⁻¹¹⁰ up to bf16's largest finite value (above it hi
    overflows), where mid and lo may be bf16 subnormals."""
    rng = np.random.default_rng(16)
    if case == "p_scaled":
        p = _f32_at_every_exponent(rng, range(0, 127)).abs()
        p = torch.cat([p, torch.tensor([0.0, 1.0, 2.0 ** -149])])
        x = p * 2.0 ** 16
        assert torch.equal(x.to(torch.float64), p.to(torch.float64) * 2.0 ** 16)
        tiny = torch.tensor([2.0 ** -149])
        assert float(_split_sum(tiny)) != float(tiny)     # why it scales
    else:
        x = _f32_at_every_exponent(rng, range(127 - 110, 255))
        x = x[x.abs() <= torch.finfo(torch.bfloat16).max]
    hi, mid, lo = split_bf16(x)
    assert bool(((mid.float() != 0) & (mid.float().abs() < 2.0 ** -126)).any())
    assert torch.equal(_split_sum(x), x.to(torch.float64))


def test_flash_tensor_core_bound_covers_the_f32_one():
    """``flash_attn_tol(tensor_cores=True)`` (the wgmma accumulation model)
    is finite and at least the f32 bound everywhere, at the dh the tests
    and the card use."""
    for dh, window, cap in ((16, None, 50.0), (64, 20, None), (160, None, None)):
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _qkv(dh, 1, 70, 4, 2, dh))
        f32 = flash_attn_tol(q, k, v, window, cap)
        tc = flash_attn_tol(q, k, v, window, cap, tensor_cores=True)
        assert bool(tc.isfinite().all()) and bool((tc >= f32).all())
        assert float((tc / f32).max()) < 16.0


# ------------------------------------------------- the _attend functions

def _cfgs(jx, **kw):
    return AttentionConfig(**kw), jx["AttentionConfig"](**kw)


@pytest.mark.parametrize("window,cap", [(None, None), (16, 50.0)])
def test_attend_full_and_chunked_match_jax(jx, window, cap):
    jnp = jx["jnp"]
    cfg, jcfg = _cfgs(jx, n_heads=4, n_kv_heads=2, head_dim=16, window=window,
                      logit_softcap=cap)
    q, _, _ = _qkv(11, 2, 24, 4, 2, 16)
    _, k, v = _qkv(12, 2, 40, 4, 2, 16)
    q_pos = np.arange(16, 40)
    k_pos = np.where(np.arange(40) < 37, np.arange(40), 2 ** 31 - 1)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tqp, tkp = torch.from_numpy(q_pos), torch.from_numpy(k_pos)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(q_pos, jnp.int32), jnp.asarray(k_pos, jnp.int32))
    full = attn._attend_full(tq, tk, tv, tqp, tkp, cfg)
    np.testing.assert_allclose(
        full.numpy(), np.asarray(jx["attention"]._attend_full(*jargs, jcfg)),
        rtol=F32_TOL, atol=F32_TOL)
    chunked = attn._attend_chunked(tq, tk, tv, tqp, tkp, cfg, chunk=16)
    np.testing.assert_allclose(
        chunked.numpy(),
        np.asarray(jx["attention"]._attend_chunked(*jargs, jcfg, chunk=16)),
        rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("s", [48, 45])
def test_attend_banded_matches_jax_and_the_flash_function(jx, s):
    """JAX's cacheless path for S > window + chunk (``_attend_banded``)
    against the flash kernel's function, which the port's cacheless
    forward runs."""
    jnp = jx["jnp"]
    _, jcfg = _cfgs(jx, n_heads=4, n_kv_heads=2, head_dim=16, window=8,
                    logit_softcap=50.0)
    q, k, v = _qkv(s, 2, s, 4, 2, 16)
    pos = np.arange(s)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = jx["attention"]._attend_banded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(pos, jnp.int32), jnp.asarray(pos, jnp.int32), jcfg,
        chunk=16)
    flash = flash_attention(tq, tk, tv, window=8, softcap=50.0)
    np.testing.assert_allclose(flash.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


# --------------------------------------------------------- RoPE, SwiGLU

@pytest.mark.parametrize("head_dim", [16, 128, 160])
def test_rope_frequencies_bitwise(jx, head_dim):
    np.testing.assert_array_equal(
        rope_frequencies(head_dim, 10000.0).numpy(),
        np.asarray(jx["layers"].rope_frequencies(head_dim, 10000.0)))


@pytest.mark.parametrize("batched", [False, True])
def test_apply_rope_matches_jax(jx, batched):
    jnp = jx["jnp"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 300, 2, 16)).astype(np.float32)
    pos = (np.stack([np.arange(300), np.arange(300) + 4000]) if batched
           else np.arange(300))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    want = np.asarray(jx["layers"].apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                              10000.0))
    # Each output is x1·cos ∓ x2·sin: a cos or sin one f32 ulp (2u) apart
    # and the roundings of the products and the sum stay within
    # 4u·(|x1| + |x2|), u = 2⁻²⁴.
    x1, x2 = np.split(np.abs(x), 2, axis=-1)
    bound = 4 * 2.0 ** -24 * np.concatenate([x1 + x2] * 2, axis=-1)
    assert (np.abs(got.numpy() - want) <= bound).all()
    got16 = apply_rope(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos),
                       10000.0)
    want16 = jx["layers"].apply_rope(jnp.asarray(x, jnp.bfloat16),
                                     jnp.asarray(pos), 10000.0)
    assert got16.dtype == torch.bfloat16
    assert_within_bf16_ulp(got16.float().numpy(), _f32(jx, want16))


def test_swiglu_matches_jax(jx):
    jnp = jx["jnp"]
    rng = np.random.default_rng(5)
    x, wg, wu, wd = (rng.standard_normal(s).astype(np.float32) * 0.3
                     for s in ((3, 7, 64), (64, 128), (64, 128), (128, 64)))
    got = swiglu(*(torch.from_numpy(a).bfloat16() for a in (x, wg, wu, wd)))
    want = jx["layers"].swiglu(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in (x, wg, wu, wd)))
    assert_within_bf16_ulp(got.float().numpy(), _f32(jx, want))


# ------------------------------------------------------------ the model

def test_init_model_tree_matches_jax(smoke, jx):
    jcfg, cfg, jparams, _ = smoke
    ours = model.init_model(cfg, torch.Generator("cpu").manual_seed(0))
    tree = jx["jax"].tree_util
    jflat = {tree.keystr(p): l for p, l in tree.tree_leaves_with_path(jparams)}
    oflat = {tree.keystr(p): l for p, l in tree.tree_leaves_with_path(ours)}
    assert set(oflat) == set(jflat)
    for k, leaf in jflat.items():
        assert tuple(oflat[k].shape) == leaf.shape, k
        assert str(oflat[k].dtype).split(".")[-1] == str(leaf.dtype), k


@pytest.mark.parametrize("kind", ["attn_local", "attn_global"])
@pytest.mark.parametrize("mode", ["cacheless", "prefill", "append", "decode",
                                  "per_slot"])
def test_layer_matches_jax_eager(jx, smoke, kind, mode):
    """One smoke layer of each kind against JAX's, op by op: the cacheless
    forward and the fresh-cache prefill of 12 tokens (past the local
    window of 8: the ring wraps) on the flash path; 6 tokens appended to a
    filled cache at position 5 (the plain path: over the old ring and the
    new tokens on the local layer, a bulk write on the global one); one
    decode token on a filled cache at a scalar and at per-slot positions."""
    jax, jnp = jx["jax"], jx["jnp"]
    jcfg, cfg, jparams, params = smoke
    j = cfg.pattern.index(kind)
    rng = np.random.default_rng(len(mode))
    seq = {"cacheless": 12, "prefill": 12, "append": 6}.get(mode, 1)
    x = rng.standard_normal((3, seq, cfg.d_model)).astype(np.float32)
    jcache = cache = cpos = jcpos = None
    pos = np.arange(seq)
    if mode != "cacheless":
        one = jx["blocks"].init_layer_cache(jcfg, kind, 3, 20)
        if mode == "prefill":
            jcache = one
            cpos = 0
        else:
            jcache = type(one)(*(jnp.asarray(
                rng.standard_normal(a.shape) * 0.5, jnp.bfloat16) for a in one))
            cpos = {"append": 5, "decode": 13}.get(mode, np.array([13, 5, 0]))
            pos = (cpos[:, None] if mode == "per_slot"
                   else cpos + np.arange(seq))
        jcpos = jnp.asarray(cpos, jnp.int32)
        cache = decode_cache_from_numpy(
            {"periods": {"pos": jax.tree.map(np.asarray, jcache)}},
            "cpu")["periods"]["pos"]
        cpos = torch.from_numpy(cpos) if mode == "per_slot" else cpos
    jlayer = jax.tree.map(lambda t: t[0], jparams["periods"][f"pos{j}"])
    xj = jnp.asarray(x, jnp.bfloat16)
    with jax.disable_jit():
        jy, jc, _ = jx["blocks"].apply_layer(
            jlayer, xj, jnp.asarray(pos), jcfg, kind, "dense", cache=jcache,
            cache_pos=jcpos)
    y, c = blocks.apply_layer(model._index(params["periods"][f"pos{j}"], 0),
                              params_from_numpy(np.asarray(xj), "cpu"), cfg,
                              kind, positions=torch.from_numpy(pos),
                              cache=cache, cache_pos=cpos)
    assert_within_bf16_ulp(y.float().numpy(), _f32(jx, jy))
    if mode != "cacheless":
        for got, want in zip(c, jc):
            assert_within_bf16_ulp(got.float().numpy(), _f32(jx, want))


@pytest.mark.parametrize("return_hidden", [False, True])
def test_forward_teacher_forced_matches_jax(jx, smoke, return_hidden):
    jcfg, cfg, jparams, params = smoke
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 40))
    want, _, _ = jx["model"].forward(jparams, jx["jnp"].asarray(toks, "int32"),
                                     jcfg, remat=False,
                                     return_hidden=return_hidden)
    got, _ = model.forward(params, torch.from_numpy(toks), cfg,
                           return_hidden=return_hidden)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert_bf16_backbone_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["granite-8b", "stablelm-12b",
                                  "command-r-35b", "musicgen-large"])
def test_plain_attention_arch_matches_jax(jx, arch):
    """The four plain-attention archs (one ``attn`` kind, no window, no
    softcap; GQA or MHA) on their smoke configs and JAX's params: the
    teacher-forced forward's logits, then a 32-token prefill and one decode
    step's hidden, under the bf16 backbone rule; the in-place decode twin
    gives the functional step's hidden bit for bit."""
    jnp = jx["jnp"]
    jcfg, cfg = jx["config"](arch, smoke=True), get_config(arch, smoke=True)
    assert cfg.pattern == ("attn",) and cfg.attention.window is None
    jparams = jx["model"].init_model(jx["jax"].random.PRNGKey(0), jcfg)
    params = params_from_numpy(jx["jax"].tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 40))
    toks = toks.astype(np.int32)
    want, _, _ = jx["model"].forward(jparams, jnp.asarray(toks), jcfg,
                                     remat=False)
    got, _ = model.forward(params, torch.from_numpy(toks), cfg)
    assert got.shape == want.shape
    assert_bf16_backbone_close(got.numpy(), np.asarray(want))

    jcache = jx["model"].init_decode_cache(jcfg, 3, 40)
    _, jcache, _ = jx["model"].forward(
        jparams, jnp.asarray(toks[:, :32]), jcfg, cache=jcache,
        cache_pos=jnp.zeros((), jnp.int32), remat=False)
    want, _ = jx["model"].decode_step(jparams, jcache,
                                      jnp.asarray(toks[:, 32:33]),
                                      jnp.asarray(32, jnp.int32), jcfg,
                                      return_hidden=True)
    _, cache = prefill_step(params, torch.from_numpy(toks[:, :32]), cfg,
                            model.init_decode_cache(cfg, 3, 40, "cpu"))
    tok = torch.from_numpy(toks[:, 32:33])
    got, _ = model.decode_step(params, cache, tok, cfg, cache_pos=32,
                               return_hidden=True)
    assert_bf16_backbone_close(got.numpy(), np.asarray(want))
    mine, _ = model.decode_step_(params, cache, tok, cfg, cache_pos=32,
                                 return_hidden=True)
    assert torch.equal(mine, got)


def test_ring_prefill_then_decode_matches_jax(jx, smoke):
    """Prefill 12 tokens into caches of max_seq 18: the local layer's ring
    (8 slots) wraps.  The caches equal JAX's (the first layer bit for bit,
    the second under the bf16 backbone rule), then five decode steps'
    logits and caches meet the bf16 backbone rule."""
    jnp = jx["jnp"]
    jcfg, cfg, jparams, params = smoke
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 17))
    p, max_seq = 12, 18
    jcache = jx["model"].init_decode_cache(jcfg, 3, max_seq)
    jlog, jcache, _ = jx["model"].forward(
        jparams, jnp.asarray(toks[:, :p], jnp.int32), jcfg, cache=jcache,
        cache_pos=jnp.zeros((), jnp.int32), remat=False)
    cache = model.init_decode_cache(cfg, 3, max_seq, device="cpu")
    assert cache["periods"]["pos0"].k.shape[2] == 8       # the ring
    assert cache["periods"]["pos1"].k.shape[2] == max_seq
    logits, cache = prefill_step(params, torch.from_numpy(toks[:, :p]), cfg,
                                 cache)
    assert_bf16_backbone_close(logits.numpy(), np.asarray(jlog[:, -1]))
    for name, exact in (("pos0", True), ("pos1", False)):
        for got, want in zip(cache["periods"][name],
                             jcache["periods"][name]):
            if exact:
                np.testing.assert_array_equal(got.float().numpy(),
                                              _f32(jx, want))
            else:
                assert_bf16_backbone_close(got.float().numpy(),
                                           _f32(jx, want))
    for t in range(p, toks.shape[1]):
        tok = toks[:, t:t + 1]
        jlog, jcache = jx["model"].decode_step(
            jparams, jcache, jnp.asarray(tok, jnp.int32),
            jnp.asarray(t, jnp.int32), jcfg)
        logits, cache = model.decode_step(params, cache,
                                          torch.from_numpy(tok), cfg,
                                          cache_pos=t)
        assert_bf16_backbone_close(logits.numpy(), np.asarray(jlog))
    for name in cache["periods"]:
        for got, want in zip(cache["periods"][name],
                             jcache["periods"][name]):
            assert_bf16_backbone_close(got.float().numpy(), _f32(jx, want))


@pytest.mark.parametrize("seq,cache_pos", [(12, 0), (6, 5), (1, 13),
                                           (1, "per_slot")])
def test_cache_writes_copy_one_layer(smoke, seq, cache_pos):
    """Each branch's new cache owns storage of its own size: a period's
    cache is a view of the stacked (n_periods, …) leaves, and copying the
    whole stack for every layer (as ``slice_scatter`` on a view does) cost
    the 4160-token prefill of gemma2-27b 16 GiB on the card."""
    _, cfg, _, params = smoke
    if cache_pos == "per_slot":
        cache_pos = torch.tensor([13, 5, 0])
        positions = cache_pos[:, None]
    else:
        positions = cache_pos + torch.arange(seq)
    x = torch.randn((3, seq, cfg.d_model)).bfloat16()
    for j, kind in enumerate(cfg.pattern):
        layer = model._index(params["periods"][f"pos{j}"], 0)
        acfg = blocks._attn_cfg(cfg, kind)
        stacked = attn.init_cache(3, 20, acfg, lead=(4,), device="cpu")
        _, new = attn.attention(layer["mixer"], x, positions, acfg,
                                cache=model._index(stacked, 2),
                                cache_pos=cache_pos)
        for leaf in new:
            assert leaf.untyped_storage().nbytes() == leaf.numel() * 2, kind


def test_decode_step_needs_cache_pos(smoke):
    _, cfg, _, params = smoke
    cache = model.init_decode_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="cache_pos"):
        model.decode_step(params, cache, torch.zeros((1, 1), dtype=torch.long),
                          cfg)


def test_prefill_then_decode_equals_forward(smoke):
    """Within the port: a flash prefill of 12 tokens and 8 plain decode
    steps over the cache, against one cacheless forward over all 20 (the
    flash path): the same function, f32 sums in other orders, so the bf16
    backbone rule."""
    _, cfg, _, params = smoke
    toks = torch.from_numpy(
        np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 20)))
    full, _ = model.forward(params, toks, cfg)
    cache = model.init_decode_cache(cfg, 2, 20, device="cpu")
    logits, cache = model.forward(params, toks[:, :12], cfg, cache=cache,
                                  cache_pos=0)
    steps = [logits]
    for t in range(12, 20):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], cfg,
                                      cache_pos=t)
        steps.append(lg[:, None])
    assert_bf16_backbone_close(torch.cat(steps, 1).numpy(), full.numpy())


# ---------------------------------------------------- generate, engine

@pytest.fixture(scope="module")
def carried_head(jx, tmp_path_factory):
    """A sketch head frozen by the JAX package, saved as an archive."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(21)
    hc = jx["SketchHeadConfig"](n_rows=32, n_buckets=8, k=1, proj_dim=16,
                                bandwidth=2.0)
    kp = {"points": rng.standard_normal((128, 16)),
          "alphas": rng.standard_normal((128, 256)) * 0.01,
          "proj": rng.standard_normal((64, 16)) / 8.0}
    frozen = jx["head"].freeze_head(
        jx["jax"].random.PRNGKey(1),
        {k: jnp.asarray(v, jnp.float32) for k, v in kp.items()}, hc)
    path = tmp_path_factory.mktemp("gemma_head") / "head.npz"
    jx["head"].save_head(path, frozen, hc, backend="fused")
    return path


@pytest.mark.parametrize("kind", ["dense", "fused", "two_kernel"])
def test_generate_tokens_equal_jax(jx, smoke, carried_head, kind):
    jcfg, _, jparams, params = smoke
    prompts = np.random.default_rng(1).integers(0, 256, (3, 12)).astype(np.int32)
    lm = LM.from_config(ARCH, smoke=True, device="cpu", params=params)
    jhead = None
    if kind != "dense":
        head = SketchHead.load(carried_head, device="cpu").with_backend(kind)
        lm = lm.with_head(head)
        jhead = jx["load_head"](str(carried_head)).with_backend(kind)
    want = np.asarray(jx["generate"](jparams, jcfg, jx["jnp"].asarray(prompts),
                                     8, head=jhead))
    got = lm.generate(prompts, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.int32)


@pytest.mark.parametrize("kind", ["dense", "fused"])
def test_engine_equals_generate(smoke, carried_head, kind):
    _, _, _, params = smoke
    lm = LM.from_config(ARCH, smoke=True, device="cpu", params=params)
    if kind != "dense":
        lm = lm.with_head(SketchHead.load(carried_head, device="cpu"))
    prompts = np.stack([_prompt(i, 12) for i in range(3)])
    want = lm.generate(prompts, 6)[:, 12:].tolist()
    got = lm.serve([(p, 6) for p in prompts], n_slots=3)
    assert [got[i] for i in range(3)] == want


def test_engine_staggered_arrivals_match_solo_generate(smoke):
    """Recycled slots, per-slot positions and the ring at mixed depths:
    each request equals its own solo ``generate``."""
    _, _, _, params = smoke
    lm = LM.from_config(ARCH, smoke=True, device="cpu", params=params)
    stream = [(12, 6, 0), (5, 3, 0), (9, 8, 2), (12, 2, 5), (3, 9, 5)]
    engine = lm.engine(2, 21)
    reqs = [(engine.submit(_prompt(10 + i, n), g, arrival=a), n, g)
            for i, (n, g, a) in enumerate(stream)]
    out = engine.run()
    for rid, n, g in reqs:
        solo = lm.generate(_prompt(10 + rid, n)[None], g)[0, n:].tolist()
        assert out[rid] == solo
    assert engine.stats["admitted"] == 5 and engine.sched.n_free == 2


def test_slot_insert_leaves_other_slots_bitwise_unchanged(smoke):
    """The port's tests/test_engine.py case for gemma2 (prompt 12 > window
    8: the ring wraps in prefill): admitting into a free slot mid-decode
    leaves the other slots' next logits unchanged, bit for bit."""
    _, cfg, _, params = smoke
    plen, max_seq = 12, 18
    prompts = torch.from_numpy(np.stack([_prompt(i, plen) for i in range(2)]))
    with torch.no_grad():
        logits, filled = prefill_step(
            params, prompts, cfg, model.init_decode_cache(cfg, 2, max_seq, "cpu"))
        pool = model.cache_slot_insert(
            cfg, model.init_decode_cache(cfg, 3, max_seq, "cpu"), filled, [0, 1])
        tok = torch.cat([logits.argmax(-1), torch.zeros(1, dtype=torch.long)])[:, None]
        pos = torch.tensor([plen, plen, 0], dtype=torch.int32)
        partial = torch.tensor([True, True, False])
        l1, pool = serve_step(params, pool, tok, cfg, active=partial, pos=pos)
        tok = torch.cat([l1[:2].argmax(-1), torch.zeros(1, dtype=torch.long)])[:, None]
        pos = torch.tensor([plen + 1, plen + 1, 0], dtype=torch.int32)
        l_a, _ = serve_step(params, pool, tok, cfg, active=partial, pos=pos)

        new = torch.from_numpy(_prompt(9, plen))[None]
        nl, nfilled = prefill_step(params, new, cfg,
                                   model.init_decode_cache(cfg, 1, max_seq, "cpu"))
        pool_b = model.cache_slot_insert(cfg, pool, nfilled, [2])
        tok_b = tok.clone()
        tok_b[2, 0] = nl[0].argmax()
        pos_b = pos.clone()
        pos_b[2] = plen
        l_b, _ = serve_step(params, pool_b, tok_b, cfg,
                            active=torch.tensor([True, True, True]), pos=pos_b)
    assert torch.equal(l_a[:2], l_b[:2])


def test_decode_cache_carrier(jx, smoke):
    jcfg, cfg, _, _ = smoke
    rng = np.random.default_rng(3)
    jcache = jx["jax"].tree.map(
        lambda a: np.asarray(rng.standard_normal(a.shape), np.float32),
        jx["model"].init_decode_cache(jcfg, 2, 10))
    cache = decode_cache_from_numpy(jcache, "cpu")
    fresh = model.init_decode_cache(cfg, 2, 10, device="cpu")
    for name in fresh["periods"]:
        assert type(cache["periods"][name]) is attn.KVCache
        for got, want, shape in zip(cache["periods"][name],
                                    jcache["periods"][name],
                                    fresh["periods"][name]):
            assert got.shape == shape.shape
            np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="no port cache"):
        decode_cache_from_numpy({"periods": {"pos0": (np.zeros(2),)}}, "cpu")


@pytest.mark.parametrize("extra", [
    [], ["--sketch-head"], ["--engine", "--stats-json"],
    ["--engine", "--sketch-head", "--tenants", "2"]],
    ids=["dense", "sketch", "engine", "tenants"])
def test_serve_cli_gemma2_on_cpu(capsys, extra):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "12", "--gen", "4", "--seed", "3", *extra])
    out = capsys.readouterr().out
    assert "arch=gemma2-27b-smoke" in out
    assert ("head=sketch/fused" in out) == ("--sketch-head" in extra)


# ----------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: flash_attn is a CUDA C++ kernel "
                    "with no CPU mode; its plain version is tested above")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,hkv,dh,window,cap", [
    (96, 2, 2, 16, None, None), (200, 4, 2, 16, 64, None),
    (256, 4, 1, 32, 32, 30.0), (150, 2, 1, 160, 45, 50.0),
    (70, 2, 2, 256, None, 50.0), (32, 4, 2, 128, None, 50.0),
    (100, 8, 2, 64, None, None), (130, 4, 4, 64, 40, None),
    (77, 6, 2, 96, 30, None), (300, 4, 1, 256, 100, 20.0)] + [
    (130, 4, 2, dh, 40, cap) for dh in range(16, 257, 16) for cap in (None, 30.0)])
def test_cuda_flash_kernel_matches_plain(cuda, dtype, s, h, hkv, dh, window,
                                         cap):
    """The kernel against its plain version on the card, every element
    within ``flash_attn_tol`` (plus one bf16 ulp for bf16: the outputs of
    cancelling sums sit near zero, where one bf16 ulp of the value is below
    the f32 error of the sum; bf16 runs on the tensor cores, under their
    accumulation model); two launches give the same bits.  The bf16 path's
    edges: S below one query tile (32) and not a multiple of the key tile,
    GQA groups of 1, 2, 3 and 4, window bands that start mid-tile, and
    every dh it instantiates (16 to 256 by 16: each its own swizzle, key
    tile and register budget) at one shape, softcap on and off."""
    g = torch.Generator(cuda).manual_seed(s)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((2, s, h, dh), (2, s, hkv, dh), (2, s, hkv, dh)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=window, softcap=cap)
    again = flash_attention(q, k, v, window=window, softcap=cap)
    want = flash_attention_ref(q, k, v, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert torch.equal(got, again)
    assert_flash_attn_close(got, want, flash_attn_tol(q, k, v, window, cap))


@pytest.mark.cuda
def test_cuda_flash_bf16_needs_aligned_tensors(cuda):
    """The tensor-core path's TMA loads need 16-byte-aligned q, k, v: the
    wrapper raises on a contiguous view that starts 2 bytes in, and
    launches nothing."""
    flat = torch.zeros(2 * 32 * 2 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    q = flat[1:].view(2, 32, 2, 64)
    k = torch.zeros((2, 32, 1, 64), dtype=torch.bfloat16, device=cuda)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte-aligned"):
        flash_attention(q, k, k)
    assert flash_attention.launches == before
