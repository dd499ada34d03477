"""The port's Multi-head Latent Attention (``models/mla.py``) against the
JAX package's ``repro.models.mla``, on deepseek-v3-671b's smoke MLA config
(4 heads, q rank 32, latent rank 16, q/k head dim 16 + 8, v 16).

The same numpy-seeded inputs (x bf16, a latent cache in bf16) go through
both.  Tolerances, each with its reason:

* The cacheless branch: both materialise bf16 per-head K and V from the
  latent and attend in f32 (the port through ``flash_attention``'s plain
  version on the CPU), so only the f32 summation order differs, which
  moves a bf16 rounding by at most one ulp: one bf16 ulp (2⁻⁸) relative
  plus 2⁻⁸ of the largest magnitude.
* The fresh-cache prefill: the port runs the materialised form on
  ``flash_attn`` (bf16 K = c_kv·W_uk and V = c_kv·W_uv, rounded once
  more than the JAX package's absorbed f32 form), so the two meet the
  bf16 backbone rule of ``repro_torch.parity``; the latent written into
  the cache is one bf16 rounding of the same f32 products: one bf16 ulp.
* Decode (scalar and per-slot positions): both run the absorbed f32 form
  over the same bf16 cache: one bf16 ulp, as the cacheless branch.
* Slot insert and reset, and the paged view, commit and insert: copies,
  bit for bit.
* The in-place twin ``mla_attention_`` equals the functional per-slot
  decode bit for bit (the same ops on the same values).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla
from repro_torch.parity import assert_bf16_backbone_close

BF16_ULP = 2.0 ** -8
ARCH = "deepseek-v3-671b"
B, S, T = 3, 10, 16           # batch, prompt, cache length


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
    """The JAX package's MLA module, its smoke config and params (key 0)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jax_config
    from repro.models import mla as jmla
    jcfg = jax_config(ARCH, smoke=True)
    jparams = jmla.init_mla(jax.random.PRNGKey(0), jcfg.d_model, jcfg.mla)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return dict(jax=jax, jnp=jnp, mla=jmla, cfg=jcfg, jparams=jparams,
                params=params)


def _bf16(rng, shape, scale=1.0):
    """(numpy f32 values exactly representable in bf16, the torch bf16)."""
    t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).to(torch.bfloat16)
    return t.float().numpy(), t


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP,
                               atol=BF16_ULP * np.abs(want).max())


def _noise_cache(jx, rng, b=B, t=T):
    """The same bf16 noise as a JAX ``MLACache`` and the port's."""
    jnp, m = jx["jnp"], jx["cfg"].mla
    (ck, ckt), (cr, crt) = (_bf16(rng, (b, t, r), 0.5)
                            for r in (m.kv_lora_rank, m.qk_rope_head_dim))
    return (jx["mla"].MLACache(jnp.asarray(ck, jnp.bfloat16),
                               jnp.asarray(cr, jnp.bfloat16)),
            mla.MLACache(ckt, crt))


def test_config_and_params_match_jax(jx):
    cfg = get_config(ARCH, smoke=True)
    assert cfg.mla == cfg.mla.__class__(**vars(jx["cfg"].mla))
    assert cfg.mla.qk_head_dim == jx["cfg"].mla.qk_head_dim
    ours = mla.init_mla(torch.Generator().manual_seed(0), cfg.d_model, cfg.mla)
    assert set(ours) == set(jx["jparams"])
    for k, v in jx["jparams"].items():
        assert tuple(ours[k].shape) == v.shape and ours[k].dtype == torch.bfloat16


@pytest.mark.parametrize("s", [S, 1])
def test_cacheless_prefill_matches_jax(jx, s):
    """No cache: the materialised form on both sides (the port's on
    ``flash_attention``)."""
    jnp, cfg = jx["jnp"], jx["cfg"]
    x, xt = _bf16(np.random.default_rng(s), (B, s, cfg.d_model))
    want, jc = jx["mla"].mla_attention(jx["jparams"], jnp.asarray(
        x, jnp.bfloat16), jnp.arange(s), cfg.mla)
    got, c = mla.mla_attention(jx["params"], xt, torch.arange(s), cfg.mla)
    assert jc is None and c is None and got.dtype == torch.bfloat16
    _close(got, want)


def test_fresh_cache_prefill_matches_jax(jx):
    """Prefill into a fresh cache: the port's flash (materialised) form
    against the JAX package's absorbed form over the masked cache."""
    jnp, cfg = jx["jnp"], jx["cfg"]
    x, xt = _bf16(np.random.default_rng(2), (B, S, cfg.d_model))
    want, jc = jx["mla"].mla_attention(
        jx["jparams"], jnp.asarray(x, jnp.bfloat16), jnp.arange(S), cfg.mla,
        cache=jx["mla"].init_mla_cache(B, T, cfg.mla),
        cache_pos=jnp.zeros((), jnp.int32))
    fresh = mla.init_mla_cache(B, T, cfg.mla, device="cpu")
    got, c = mla.mla_attention(jx["params"], xt, torch.arange(S), cfg.mla,
                               cache=fresh, cache_pos=0)
    assert_bf16_backbone_close(got.float().numpy(), np.asarray(want, np.float32))
    for ours, theirs in zip(c, jc):
        _close(ours, theirs)
        assert not bool(ours[:, S:].any())
    assert not any(bool(leaf.any()) for leaf in fresh)    # inputs unchanged


@pytest.mark.parametrize("pos_kind", ["scalar", "per_slot"])
def test_decode_matches_jax(jx, pos_kind):
    """One token against a noise cache: the scalar branch at depth 9, the
    per-slot branch at depths (3, 9, 15)."""
    jnp, cfg = jx["jnp"], jx["cfg"]
    rng = np.random.default_rng(3)
    jcache, cache = _noise_cache(jx, rng)
    x, xt = _bf16(rng, (B, 1, cfg.d_model))
    if pos_kind == "scalar":
        jpos, jpositions, pos, positions = (
            jnp.asarray(9, jnp.int32), jnp.arange(9, 10), 9, torch.arange(9, 10))
    else:
        p = np.array([3, 9, 15], np.int32)
        jpos, jpositions = jnp.asarray(p), jnp.asarray(p)[:, None]
        pos = torch.from_numpy(p).long()
        positions = pos[:, None]
    want, jc = jx["mla"].mla_attention(
        jx["jparams"], jnp.asarray(x, jnp.bfloat16), jpositions, cfg.mla,
        cache=jcache, cache_pos=jpos)
    got, c = mla.mla_attention(jx["params"], xt, positions, cfg.mla,
                               cache=cache, cache_pos=pos)
    _close(got, want)
    for ours, theirs in zip(c, jc):
        _close(ours, theirs)


@pytest.mark.parametrize("masked", [False, True])
def test_in_place_decode_equals_functional(jx, masked):
    """``mla_attention_`` writes the latent at each row's position (an
    inactive row's position restored) and gives the per-slot branch's
    output, bit for bit."""
    cfg = jx["cfg"]
    rng = np.random.default_rng(4)
    _, cache = _noise_cache(jx, rng)
    _, xt = _bf16(rng, (B, 1, cfg.d_model))
    pos = torch.tensor([2, 7, 15])
    active = torch.tensor([True, False, True]) if masked else None
    want, new = mla.mla_attention(jx["params"], xt, pos[:, None], cfg.mla,
                                  cache=cache, cache_pos=pos)
    if masked:
        new = mla.MLACache(*(torch.where(active[:, None, None], n, o)
                             for n, o in zip(new, cache)))
    inplace = mla.MLACache(*(leaf.clone() for leaf in cache))
    got = mla.mla_attention_(jx["params"], xt, pos[:, None], cfg.mla, inplace,
                             pos, active)
    assert torch.equal(got, want)
    for a, b in zip(inplace, new):
        assert torch.equal(a, b)


def test_per_slot_prefill_raises_as_jax(jx):
    cfg = jx["cfg"]
    _, cache = _noise_cache(jx, np.random.default_rng(5))
    with pytest.raises(NotImplementedError, match="single-token"):
        mla.mla_attention(jx["params"], torch.zeros((B, 2, cfg.d_model),
                                                    dtype=torch.bfloat16),
                          torch.zeros((B, 2), dtype=torch.long), cfg.mla,
                          cache=cache, cache_pos=torch.zeros(B, dtype=torch.long))


@pytest.mark.parametrize("slots", [[2], [0, 3], [3, 1, 0]])
def test_slot_insert_and_reset_match_jax(jx, slots):
    jnp = jx["jnp"]
    rng = np.random.default_rng(6)
    jpool, pool = _noise_cache(jx, rng, b=4)
    jsrc, src = _noise_cache(jx, rng, b=len(slots))
    idx = jnp.asarray(slots)
    for ours, theirs in ((mla.slot_insert(pool, src, slots),
                          jx["mla"].slot_insert(jpool, jsrc, idx)),
                         (mla.slot_reset(pool, slots),
                          jx["mla"].slot_reset(jpool, idx))):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))


def test_paged_view_commit_insert_match_jax(jx):
    """The paged arenas of a latent cache, period-stacked (P = 2) in the
    port, through ``attention.paged_view``/``paged_commit``/
    ``paged_insert`` (leaf-generic), against the JAX package's
    ``mla.paged_*`` on each period's arena: bit for bit."""
    jnp, cfg = jx["jnp"], jx["cfg"]
    rng = np.random.default_rng(7)
    n_pages, ps, size = 9, 4, 10
    pt = np.array([[3, 1, 5, 0], [2, 0, 0, 0], [4, 6, 7, 8]], np.int32)
    arenas = [_noise_cache(jx, rng, b=n_pages, t=ps) for _ in range(2)]
    pages = mla.MLACache(*(torch.stack(leaves) for leaves in
                           zip(*(a[1] for a in arenas))))
    view = attn_mod.paged_view(pages, torch.from_numpy(pt), size)
    for p, (jarena, _) in enumerate(arenas):
        want = jx["mla"].paged_view(jarena, jnp.asarray(pt), size)
        for ours, theirs in zip(view, want):
            np.testing.assert_array_equal(ours[p].float().numpy(),
                                          np.asarray(theirs, np.float32))
    # A decode write at each slot's position, then the commit.
    wpos = np.array([9, 2, 6], np.int32)
    for leaf in view:
        leaf[:, np.arange(3), wpos] = torch.randn(
            (2, 3, leaf.shape[-1]), generator=torch.Generator().manual_seed(0)
        ).to(torch.bfloat16)
    attn_mod.paged_commit(pages, view, torch.from_numpy(pt),
                          torch.from_numpy(wpos).long())
    for p, (jarena, _) in enumerate(arenas):
        jview = mla.MLACache(*(jnp.asarray(leaf[p].float().numpy(),
                                           jnp.bfloat16) for leaf in view))
        want = jx["mla"].paged_commit(jarena, jx["mla"].MLACache(*jview),
                                      jnp.asarray(pt), jnp.asarray(wpos))
        for ours, theirs in zip(pages, want):
            np.testing.assert_array_equal(ours[p].float().numpy(),
                                          np.asarray(theirs, np.float32))
        arenas[p] = (want, None)
    # Freshly prefilled rows (P, G, size, r) into newly mapped pages.
    rows = [_noise_cache(jx, rng, b=2, t=size) for _ in range(2)]
    src = mla.MLACache(*(torch.stack(leaves) for leaves in
                         zip(*(r[1] for r in rows))))
    pt_rows = np.array([[1, 3, 5, 0], [2, 4, 6, 0]], np.int32)
    attn_mod.paged_insert(pages, src, torch.from_numpy(pt_rows))
    for p, ((jarena, _), (jsrc, _)) in enumerate(zip(arenas, rows)):
        want = jx["mla"].paged_insert(jarena, jsrc, jnp.asarray(pt_rows))
        for ours, theirs in zip(pages, want):
            np.testing.assert_array_equal(ours[p].float().numpy(),
                                          np.asarray(theirs, np.float32))


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the prefill's flash_attn kernel has "
                    "no CPU mode; its plain version is tested above")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_prefill_and_decode_match_cpu(cuda):
    """An MLA layer whose q/k head dim (32 + 16 = 48) suits the kernel: the
    fresh-cache prefill on ``flash_attn`` (one launch) against the same
    layer on the CPU (its plain version) within two bf16 ulps (2⁻⁷)
    relative plus 2⁻⁷ of the largest magnitude (the kernel's tensor-core
    sums and the plain f32 sums may round the attention output to bf16 an
    ulp apart, and the output projection rounds again), the latent bit
    for bit; then the in-place decode on the card equal to the functional
    one bit for bit."""
    from repro_torch.kernels.flash_attn.ops import flash_attention
    from repro_torch.models.config import MLAConfig
    cfg = MLAConfig(n_heads=8, q_lora_rank=64, kv_lora_rank=32,
                    qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
    g = torch.Generator().manual_seed(0)
    params = mla.init_mla(g, 128, cfg)
    x = torch.randn((2, 24, 128), generator=g).to(torch.bfloat16)
    out = {}
    for dev in ("cpu", cuda):
        p = {k: v.to(dev) for k, v in params.items()}
        cache = mla.init_mla_cache(2, 32, cfg, device=dev)
        before = flash_attention.launches
        y, c = mla.mla_attention(p, x.to(dev), torch.arange(24, device=dev),
                                 cfg, cache=cache, cache_pos=0)
        out[str(dev)] = (y.cpu(), [leaf.cpu() for leaf in c])
        assert flash_attention.launches - before == (dev != "cpu")
        if dev != "cpu":
            pos = torch.tensor([24, 24], device=dev)
            xd = torch.randn((2, 1, 128), generator=g).to(torch.bfloat16).to(dev)
            want, new = mla.mla_attention(p, xd, pos[:, None], cfg, cache=c,
                                          cache_pos=pos)
            got = mla.mla_attention_(p, xd, pos[:, None], cfg, c, pos)
            assert torch.equal(got, want)
            assert all(torch.equal(a, b) for a, b in zip(c, new))
    (yc, cc), (yg, cg) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(yg.float(), yc.float(), rtol=2 ** -7,
                               atol=2 ** -7 * float(yc.abs().max()))
    assert all(torch.equal(a, b) for a, b in zip(cg, cc))
