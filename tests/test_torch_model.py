"""The port's rwkv6 backbone against the JAX package's, on smoke configs.

JAX params travel to the port through ``repro_torch.convert`` and the same
numpy token stream goes through both (teacher forcing).  Tolerances:

* One layer against the JAX layer run eagerly (op by op, each op rounding
  to bf16 as the port's does): at most one bf16 ulp (2⁻⁸) relative plus
  2⁻⁸ of the largest magnitude — only the f32 WKV sums run in another
  order, and that can move a bf16 rounding by one ulp.
* The whole backbone against JAX's compiled forward: XLA keeps excess
  precision inside its fusions and skips some of each layer's dozen bf16
  roundings — ``repro_torch.parity``'s bf16 backbone rule (2⁻⁵ relative
  in norm, 2⁻⁴ of the largest magnitude at any element).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.models import blocks as jblocks
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models.config import SketchHeadConfig as JaxSketchHeadConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import blocks, model
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import SketchHeadConfig
from repro_torch.parity import assert_bf16_backbone_close

BF16_ULP = 2.0 ** -8
ARCH = "rwkv6-1.6b"


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
def setup():
    jcfg, cfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jparams = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 40))
    return jcfg, cfg, jparams, params, toks.astype(np.int32)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("arch", [ARCH, "gemma2-27b", "granite-8b",
                                  "stablelm-12b", "command-r-35b",
                                  "musicgen-large", "mixtral-8x7b",
                                  "jamba-v0.1-52b", "deepseek-v3-671b",
                                  "llama-3.2-vision-11b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_jax(smoke, arch):
    """Field by field (the port's own dataclasses, ``AttentionConfig`` and
    ``MLAConfig``, compare by their fields), the derived layer and FFN
    kinds of every layer, and the analytic parameter count."""
    from repro.models.config import param_count as jax_param_count
    from repro_torch.models.config import param_count
    cfg, jcfg = get_config(arch, smoke=smoke), jax_config(arch, smoke=smoke)
    assert [f.name for f in dataclasses.fields(cfg)] == [
        f.name for f in dataclasses.fields(jcfg)]
    for f in dataclasses.fields(cfg):
        ours, theirs = getattr(cfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(ours):
            ours, theirs = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        assert ours == theirs, f.name
    assert cfg.n_periods == jcfg.n_periods
    for j in range(cfg.n_layers):
        assert cfg.layer_kind(j) == jcfg.layer_kind(j), j
        assert cfg.ffn_kind(j) == jcfg.ffn_kind(j), j
    assert param_count(cfg) == jax_param_count(jcfg)
    assert dataclasses.asdict(SketchHeadConfig()) == dataclasses.asdict(
        JaxSketchHeadConfig())


def test_registry_ports_every_jax_arch():
    from repro.configs import arch_names
    from repro_torch.configs import _MODULES
    assert list(_MODULES) and set(_MODULES) == set(arch_names())


def test_unported_arch_names_what_is_ported():
    """Every arch of the JAX registry is ported, so an unknown name is
    what raises; the message names the ported archs."""
    with pytest.raises(KeyError, match="rwkv6-1.6b.*deepseek-v3-671b"):
        get_config("no-such-arch")


def test_convert_carries_bf16_bits(setup):
    _, _, jparams, params, _ = setup
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(jleaves) == len(jax.tree.leaves(params))
    for path, leaf in jleaves:
        t = params
        for key in path:
            t = t[key.key]
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)
        np.testing.assert_array_equal(t.float().numpy(), _f32(leaf))


def test_init_model_tree_matches_jax(setup):
    jcfg, cfg, jparams, _, _ = setup
    ours = model.init_model(cfg, torch.Generator("cpu").manual_seed(0))
    jflat = {jax.tree_util.keystr(p): l
             for p, l in jax.tree_util.tree_leaves_with_path(jparams)}
    oflat = {jax.tree_util.keystr(p): l
             for p, l in jax.tree_util.tree_leaves_with_path(ours)}
    assert set(oflat) == set(jflat)
    for k, leaf in jflat.items():
        assert tuple(oflat[k].shape) == leaf.shape, k
        assert str(oflat[k].dtype).split(".")[-1] == str(leaf.dtype), k


@pytest.mark.parametrize("seq", [40, 1])
def test_layer_matches_jax_eager(setup, seq):
    """Prefill-shaped (40 tokens: a full and a ragged WKV chunk) and
    decode-shaped (1 token against a non-zero cache) layers."""
    jcfg, cfg, jparams, params, _ = setup
    rng = np.random.default_rng(seq)
    x = jnp.asarray(rng.standard_normal((3, seq, cfg.d_model)), jnp.bfloat16)
    jcache = cache = None
    if seq == 1:
        c = [rng.standard_normal(s).astype(np.float32) * 0.5
             for s in ((3, 64), (3, 64), (3, 1, 64, 64))]
        from repro.models.rwkv import RWKVCache as JaxCache
        from repro_torch.models.rwkv import RWKVCache
        jcache = JaxCache(*(jnp.asarray(a) for a in c))
        cache = RWKVCache(*(torch.from_numpy(a) for a in c))
    for i in range(cfg.n_periods):
        jlayer = jax.tree.map(lambda t: t[i], jparams["periods"]["pos0"])
        with jax.disable_jit():
            jy, jc, _ = jblocks.apply_layer(jlayer, x, jnp.arange(seq), jcfg,
                                            "rwkv", "dense", cache=jcache)
        y, c = blocks.apply_layer(model._index(params["periods"]["pos0"], i),
                                  params_from_numpy(np.asarray(x), "cpu"),
                                  cfg, "rwkv", cache=cache)
        want, got = _f32(jy), y.float().numpy()
        np.testing.assert_allclose(got, want, rtol=BF16_ULP,
                                   atol=BF16_ULP * np.abs(want).max())
        if seq == 1:
            for a, b in zip(c, jc):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=BF16_ULP, atol=BF16_ULP)


@pytest.mark.parametrize("return_hidden", [False, True])
def test_forward_teacher_forced_matches_jax(setup, return_hidden):
    jcfg, cfg, jparams, params, toks = setup
    want, _, _ = jmodel.forward(jparams, jnp.asarray(toks), jcfg,
                                remat=False, return_hidden=return_hidden)
    got, _ = model.forward(params, torch.from_numpy(toks), cfg,
                           return_hidden=return_hidden)
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    assert_bf16_backbone_close(got.numpy(), np.asarray(want))


def test_prefill_then_decode_equals_forward(setup):
    """Within the port: prefill 33 tokens (a full and a 1-token WKV chunk),
    then 7 decode steps, against one forward over all 40.  The WKV sums
    chunk differently, so a bf16 result may move by one ulp."""
    _, cfg, _, params, toks = setup
    full, _ = model.forward(params, torch.from_numpy(toks), cfg)
    cache = model.init_decode_cache(cfg, 3, 40, device="cpu")
    logits, cache = model.forward(params, torch.from_numpy(toks[:, :33]), cfg,
                                  cache=cache)
    steps = [logits]
    for t in range(33, 40):
        lg, cache = model.decode_step(params, cache,
                                      torch.from_numpy(toks[:, t:t + 1]), cfg)
        steps.append(lg[:, None])
    dec = torch.cat(steps, dim=1)
    torch.testing.assert_close(dec, full, rtol=BF16_ULP,
                               atol=BF16_ULP * float(full.abs().max()))


def test_decode_step_hidden_matches_jax(setup):
    jcfg, cfg, jparams, params, toks = setup
    jcache = jmodel.init_decode_cache(jcfg, 3, 40)
    _, jcache, _ = jmodel.forward(jparams, jnp.asarray(toks[:, :32]), jcfg,
                                  cache=jcache,
                                  cache_pos=jnp.zeros((), jnp.int32),
                                  remat=False)
    want, _ = jmodel.decode_step(jparams, jcache, jnp.asarray(toks[:, 32:33]),
                                 jnp.asarray(32, jnp.int32), jcfg,
                                 return_hidden=True)
    cache = model.init_decode_cache(cfg, 3, 40, device="cpu")
    _, cache = model.forward(params, torch.from_numpy(toks[:, :32]), cfg,
                             cache=cache)
    got, _ = model.decode_step(params, cache,
                               torch.from_numpy(toks[:, 32:33]), cfg,
                               return_hidden=True)
    assert got.shape == (3, cfg.d_model) and got.dtype == torch.float32
    assert_bf16_backbone_close(got.numpy(), np.asarray(want))


# ------------------------------------------- layer order, MoE and Mamba archs

def test_layer_order_matches_jax_over_periods():
    """gemma2's smoke config at 6 layers (3 periods of a local and a global
    layer): the layers run period by period, as the JAX package's scan
    runs them, in the forward and in the in-place decode step (bf16
    backbone rule)."""
    jcfg = jax_config("gemma2-27b", smoke=True).scaled(n_layers=6)
    cfg = get_config("gemma2-27b", smoke=True).scaled(n_layers=6)
    jparams = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12))
    toks = toks.astype(np.int32)
    want, _, _ = jmodel.forward(jparams, jnp.asarray(toks), jcfg, remat=False)
    got, _ = model.forward(params, torch.from_numpy(toks), cfg)
    assert_bf16_backbone_close(got.numpy(), np.asarray(want))
    jcache = jmodel.init_decode_cache(jcfg, 2, 13)
    _, jcache, _ = jmodel.forward(jparams, jnp.asarray(toks), jcfg,
                                  cache=jcache,
                                  cache_pos=jnp.zeros((), jnp.int32),
                                  remat=False)
    jlog, _ = jmodel.decode_step(jparams, jcache, jnp.asarray(toks[:, :1]),
                                 jnp.asarray(12, jnp.int32), jcfg)
    cache = model.init_decode_cache(cfg, 2, 13, device="cpu")
    _, cache = model.forward(params, torch.from_numpy(toks), cfg,
                             cache=cache, cache_pos=0)
    log, _ = model.decode_step_(params, cache, torch.from_numpy(toks[:, :1]),
                                cfg, cache_pos=12)
    assert_bf16_backbone_close(log.numpy(), np.asarray(jlog))


MOE_ARCHS = ["mixtral-8x7b", "jamba-v0.1-52b", "deepseek-v3-671b"]


@pytest.fixture(scope="module")
def moe_setup():
    built = {}

    def get(arch):
        if arch not in built:
            jcfg, cfg = jax_config(arch, smoke=True), get_config(arch,
                                                                 smoke=True)
            jparams = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
            params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
            toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                     (3, 40))
            built[arch] = (jcfg, cfg, jparams, params, toks.astype(np.int32))
        return built[arch]

    return get


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_arch_params_match_jax(moe_setup, arch):
    """The init tree (shapes and dtypes: the router and mamba's ``a_log``,
    ``d_skip``, ``conv_b``, ``dt_bias`` f32, the rest bf16; deepseek's
    ``prologue`` list of dense layers) and the conversion of the JAX
    params, leaf for leaf and bit for bit."""
    _, cfg, jparams, params, _ = moe_setup(arch)
    ours = model.init_model(cfg, torch.Generator("cpu").manual_seed(0))
    jflat = {jax.tree_util.keystr(p): l
             for p, l in jax.tree_util.tree_leaves_with_path(jparams)}
    for tree in (ours, params):
        flat = {jax.tree_util.keystr(p): l
                for p, l in jax.tree_util.tree_leaves_with_path(tree)}
        assert set(flat) == set(jflat)
        for k, leaf in jflat.items():
            assert tuple(flat[k].shape) == leaf.shape, k
            assert str(flat[k].dtype).split(".")[-1] == str(leaf.dtype), k
    assert ("prologue" in params) == bool(cfg.n_dense_prologue)
    assert isinstance(params.get("prologue", []), list)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        t = params
        for key in path:
            t = t[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_array_equal(t.float().numpy(), _f32(leaf))


def _record_moe(monkeypatch, module, log):
    """Wrap ``module.moe_ffn`` to keep each call's input tokens."""
    inner = module.moe_ffn

    def recording(params, x, cfg):
        log.append((np.array(jnp.asarray(x).astype(jnp.float32))
                    if not torch.is_tensor(x) else x.float().numpy(),
                    np.array(params["router"], np.float32)))
        return inner(params, x, cfg)

    monkeypatch.setattr(module, "moe_ffn", recording)


def _masks(x, router, k):
    """Exact top-k threshold masks of the (B, S, d) tokens' f32 logits."""
    logits = torch.from_numpy(x).double() @ torch.from_numpy(router).double()
    return logits >= torch.topk(logits, k, dim=-1).values[..., -1:]


def _assert_flip_explained(xp, xj, router, k, tokens):
    """A routing that differs between two inputs (the port's and the JAX
    package's residual at one layer, bf16 ulps apart) may differ only
    where the exact top-k gap at one input is within what the two inputs
    move the logits (twice the largest change) plus both f32 bounds."""
    from repro_torch.parity import router_tol
    r = torch.from_numpy(router)
    lj, tj = router_tol(torch.from_numpy(xj), r)
    lp, tp = router_tol(torch.from_numpy(xp), r)
    top = torch.topk(lj, k + 1, dim=-1).values
    gap = top[..., k - 1] - top[..., k]
    moved = 2.0 * (lp - lj).abs().amax(dim=-1) + tj + tp
    assert bool((gap[tokens] <= moved[tokens]).all()), (
        f"routing differs at tokens whose top-{k} gap {gap[tokens]} exceeds "
        f"what the inputs explain {moved[tokens]}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_arch_layer_chain_matches_jax(moe_setup, arch, monkeypatch):
    """Teacher-forced layer by layer: each layer of the port takes the JAX
    package's residual (its layers run op by op, rounding where the port
    rounds) and matches the JAX layer within one bf16 ulp on every batch
    row whose routing agrees; the routing on the JAX layer's own MoE input
    agrees with the port's router except within ``check_router_choices``'
    bound."""
    from repro.models import blocks as jblocks
    from repro_torch.parity import check_router_choices
    jcfg, cfg, jparams, params, toks = moe_setup(arch)
    jlog, tlog = [], []
    _record_moe(monkeypatch, jblocks, jlog)
    _record_moe(monkeypatch, blocks, tlog)
    x = jnp.asarray(jparams["embed"])[jnp.asarray(toks)] * jnp.asarray(
        cfg.d_model ** 0.5, jnp.bfloat16)
    s = toks.shape[1]
    layers = [(jl, pl, cfg.pattern[0], "dense") for jl, pl in
              zip(jparams.get("prologue", []), params.get("prologue", []))]
    for i in range(cfg.n_periods):
        for j, kind in enumerate(cfg.pattern):
            layers.append((jax.tree.map(lambda t: t[i],
                                        jparams["periods"][f"pos{j}"]),
                           model._index(params["periods"][f"pos{j}"], i),
                           kind, model.period_ffn(cfg, j)))
    for jlayer, layer, kind, ffn in layers:
        with jax.disable_jit():
            jy, _, _ = jblocks.apply_layer(jlayer, x, jnp.arange(s), jcfg,
                                           kind, ffn)
        y, _ = blocks.apply_layer(
            layer, params_from_numpy(np.asarray(x), "cpu"), cfg, kind,
            ffn=ffn)
        rows = np.ones(toks.shape[0], bool)
        if ffn == "moe":
            (xj, router), (xp, _) = jlog[-1], tlog[-1]
            k = cfg.moe.top_k
            jmask = torch.from_numpy(np.array(jmoe._topk_mask(
                jnp.asarray(xj) @ jnp.asarray(router), k)))
            ours = moe_mod.route({"router": torch.from_numpy(router)},
                                 torch.from_numpy(xj), cfg.moe)[1]
            check_router_choices(ours, jmask, torch.from_numpy(xj),
                                 torch.from_numpy(router), k)
            pm, jm = _masks(xp, router, k), _masks(xj, router, k)
            diff = (pm != jm).any(-1)
            if bool(diff.any()):
                _assert_flip_explained(xp, xj, router, k, diff)
            rows = ~diff.any(-1).numpy()
        want, got = _f32(jy), y.float().numpy()
        np.testing.assert_allclose(got[rows], want[rows], rtol=BF16_ULP,
                                   atol=BF16_ULP * np.abs(want).max())
        x = jy


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_arch_forward_matches_jax(moe_setup, arch, monkeypatch):
    """The whole teacher-forced forward against the JAX package's, op by op
    (``jax.disable_jit``; XLA's compiled forward skips bf16 roundings and
    then routes some tokens otherwise, even against itself op by op).
    Routing is a threshold, so a token whose top-k gap is smaller than the
    layers' bf16 drift may route otherwise and its row then diverges: the
    rows whose routing agrees at every MoE layer meet the bf16 backbone
    rule, and every row that diverges does so at a token whose gap the
    two residuals explain (``_assert_flip_explained``)."""
    from repro.models import blocks as jblocks
    jcfg, cfg, jparams, params, toks = moe_setup(arch)
    jlog, tlog = [], []
    _record_moe(monkeypatch, jblocks, jlog)
    _record_moe(monkeypatch, blocks, tlog)
    with jax.disable_jit():
        want, _, _ = jmodel.forward(jparams, jnp.asarray(toks), jcfg,
                                    remat=False)
    got, _ = model.forward(params, torch.from_numpy(toks), cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert len(jlog) == len(tlog) > 0
    k = cfg.moe.top_k
    agree = np.ones(toks.shape[0], bool)
    for (xj, router), (xp, _) in zip(jlog, tlog):
        diff = (_masks(xp, router, k) != _masks(xj, router, k)).any(-1)
        new = diff.any(-1).numpy() & agree
        if new.any():
            _assert_flip_explained(xp, xj, router, k,
                                   diff & torch.from_numpy(new)[:, None])
        agree &= ~new
    assert agree.any(), "every row routed otherwise somewhere"
    assert_bf16_backbone_close(got.numpy()[agree], np.asarray(want)[agree])


def test_decode_cache_from_numpy_carries_prologue_and_mla_bits(moe_setup):
    """deepseek's JAX cache, filled with noise (a ``prologue`` list and the
    periods' ``MLACache``), through ``decode_cache_from_numpy``: the port's
    tree (a prologue layer a stack of one), the shapes of its own
    ``init_decode_cache``, and every latent bit for bit."""
    from repro_torch.convert import decode_cache_from_numpy
    jcfg, cfg, _, _, _ = moe_setup("deepseek-v3-671b")
    rng = np.random.default_rng(9)
    jcache = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype),
        jmodel.init_decode_cache(jcfg, 3, 44))
    cache = decode_cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    mine = model.init_decode_cache(cfg, 3, 44, device="cpu")
    assert len(cache["prologue"]) == len(jcache["prologue"]) == 1
    pairs = [(c, jc, (1,)) for c, jc in zip(cache["prologue"],
                                           jcache["prologue"])]
    pairs.append((cache["periods"]["pos0"], jcache["periods"]["pos0"], ()))
    for ours, theirs, lead in pairs:
        assert type(ours).__name__ == "MLACache" == type(theirs).__name__
        for a, b in zip(ours, theirs):
            assert tuple(a.shape) == lead + b.shape
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(a.reshape(b.shape).float().numpy(),
                                          _f32(b))
    assert [x.shape for x in model.cache_leaves(cache)] == [
        x.shape for x in model.cache_leaves(mine)]
