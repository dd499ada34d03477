"""The port's MoE FFN (``models/moe.py``) against the JAX package's.

The same numpy tokens go through ``repro.models.moe.moe_ffn`` and the
port's ``moe_ffn`` on the JAX package's params (``convert``), at the
mixtral and jamba smoke MoE configs and at variants that pad the last
routing group, drop tokens past capacity, add a shared expert and tie two
experts in the router.  Tolerances:

* Routing: the expert masks are equal except on tokens where
  ``repro_torch.parity.check_router_choices`` finds the k-th and (k+1)-th
  router logits within the f32 summation bound (asserted for every
  mismatch); groups with a mismatch are left out of the output check.
* Output: within one bf16 ulp (2⁻⁸ relative, plus 2⁻⁸ of the largest
  magnitude): the expert products accumulate in f32 in another order and
  may move a bf16 rounding by an ulp; where routing is equal the dispatch
  copies exact values and a two-term combine rounds once in f32.
* Aux loss: 1e-6 relative (means of the same f32 terms in other orders).

Within the port, the index-based dispatch equals the one-hot einsums
(``moe_ffn_onehot``) bit for bit: with k live terms a token, the combine
is a sum of two exact products rounded once.  With a tie the
threshold selects three experts, and three live terms may round in
another order: one bf16 ulp there.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe
from repro_torch.models.config import MoEConfig
from repro_torch.parity import check_router_choices

BF16_ULP = 2.0 ** -8

CASES = {
    # name: (arch whose smoke MoE config, overrides, (B, S))
    "mixtral": ("mixtral-8x7b", {}, (3, 40)),
    "jamba": ("jamba-v0.1-52b", {}, (3, 40)),
    "padded_groups": ("jamba-v0.1-52b", {"group_size": 16}, (2, 40)),
    "drops": ("mixtral-8x7b", {"capacity_factor": 0.5}, (2, 33)),
    "shared": ("jamba-v0.1-52b", {"n_shared_experts": 1}, (2, 17)),
    "decode": ("mixtral-8x7b", {}, (5, 1)),
}


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
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import moe as jmoe
    from repro.models.config import MoEConfig as JaxMoEConfig
    return dict(jax=jax, jnp=jnp, moe=jmoe, cfg=JaxMoEConfig)


@pytest.fixture(scope="module")
def case(jx):
    """Per case: both configs, the JAX params and the port's, bf16 tokens."""
    jax, jnp = jx["jax"], jx["jnp"]
    built = {}

    def get(name):
        if name not in built:
            arch, over, (b, s) = CASES[name]
            cfg = dataclasses.replace(get_config(arch, smoke=True).moe, **over)
            jcfg = jx["cfg"](**dataclasses.asdict(cfg))
            d = get_config(arch, smoke=True).d_model
            jparams = jx["moe"].init_moe(jax.random.PRNGKey(3), d, jcfg)
            params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       "cpu")
            x = jnp.asarray(np.random.default_rng(len(name)).standard_normal(
                (b, s, d)), jnp.bfloat16)
            built[name] = (jcfg, cfg, jparams, params, x,
                           params_from_numpy(np.asarray(x), "cpu"))
        return built[name]

    return get


def _f32(jnp, a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _jax_masks(jx, jparams, x, jcfg):
    """The JAX package's expert masks on its grouped tokens (G, s, E)."""
    jnp, jmoe = jx["jnp"], jx["moe"]
    b0, s0, d = x.shape
    gsz = min(s0, jcfg.group_size)
    pad = (-s0) % gsz
    xg = jnp.pad(x, ((0, 0), (0, pad), (0, 0))).reshape(-1, gsz, d)
    logits = jnp.einsum("bsd,de->bse", xg.astype(jnp.float32),
                        jparams["router"])
    return np.array(jmoe._topk_mask(logits, jcfg.top_k))


def _check_against_jax(jx, jcfg, cfg, jparams, params, x, xt):
    jnp = jx["jnp"]
    want, jaux = jx["moe"].moe_ffn(jparams, x, jcfg)
    got, aux = moe.moe_ffn(params, xt, cfg)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    xg, _ = moe._groups(xt, cfg)
    mask = moe.route(params, xg, cfg)[1]
    jmask = torch.from_numpy(_jax_masks(jx, jparams, x, jcfg))
    check_router_choices(mask, jmask, xg, params["router"], cfg.top_k)
    same = ~(mask != jmask).any(dim=-1).any(dim=-1)      # groups routed alike
    gs = xg.shape[1]
    rows = np.repeat(same.numpy().reshape(xt.shape[0], -1), gs, axis=1)
    rows = rows[:, :xt.shape[1]]
    w, g = _f32(jnp, want), got.float().numpy()
    np.testing.assert_allclose(g[rows], w[rows], rtol=BF16_ULP,
                               atol=BF16_ULP * np.abs(w).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    return mask, moe.route(params, xg, cfg)[4]


@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_matches_jax(jx, case, name):
    jcfg, cfg, jparams, params, x, xt = case(name)
    mask, in_cap = _check_against_jax(jx, jcfg, cfg, jparams, params, x, xt)
    if name == "drops":
        assert bool((mask & ~in_cap).any()), "no token was dropped"
    if name == "decode":                   # S = 1: capacity 1, nothing drops
        assert torch.equal(mask, in_cap)
    if name == "padded_groups":            # 40 = 16 + 16 + 8 (+ 8 padding)
        assert moe._groups(xt, cfg)[0].shape[:2] == (6, 16)


@pytest.mark.parametrize("name", list(CASES))
def test_index_dispatch_equals_onehot(case, name):
    _, cfg, _, params, _, xt = case(name)
    got, aux = moe.moe_ffn(params, xt, cfg)
    want, want_aux = moe.moe_ffn_onehot(params, xt, cfg)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)


def test_topk_mask_is_a_threshold_with_ties(jx, case):
    """Two experts with the same router column tie on every token: where
    they tie at the k-th place the threshold keeps both (three experts for
    top_k = 2), as the reference's ``_topk_mask`` does, and never topk's
    indices (which would keep one).  The port matches JAX at one bf16 ulp
    and its one-hot version at one bf16 ulp (three live combine terms)."""
    jcfg, cfg, jparams, params, x, xt = case("jamba")
    jnp = jx["jnp"]
    router = np.asarray(jparams["router"]).copy()
    router[:, 1] = router[:, 0]
    jparams = dict(jparams, router=jnp.asarray(router))
    params = dict(params, router=torch.from_numpy(router))
    xg, _ = moe._groups(xt, cfg)
    mask = moe.route(params, xg, cfg)[1]
    assert int(mask.sum(-1).max()) == 3, "no tie at the k-th place"
    _check_against_jax(jx, jcfg, cfg, jparams, params, x, xt)
    got, _ = moe.moe_ffn(params, xt, cfg)
    want, _ = moe.moe_ffn_onehot(params, xt, cfg)
    w = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(), w, rtol=BF16_ULP,
                               atol=BF16_ULP * np.abs(w).max())


def test_init_moe_tree_matches_jax(jx, case):
    _, cfg, jparams, _, _, _ = case("shared")
    ours = moe.init_moe(torch.Generator().manual_seed(0), 64, cfg)
    jflat = {jx["jax"].tree_util.keystr(p): leaf for p, leaf in
             jx["jax"].tree_util.tree_leaves_with_path(jparams)}
    oflat = {jx["jax"].tree_util.keystr(p): leaf for p, leaf in
             jx["jax"].tree_util.tree_leaves_with_path(ours)}
    assert set(oflat) == set(jflat)
    for k, leaf in jflat.items():
        assert tuple(oflat[k].shape) == leaf.shape, k
        assert str(oflat[k].dtype).split(".")[-1] == str(leaf.dtype), k


def test_router_rule_catches_a_real_mismatch():
    """A token whose k-th and (k+1)-th logits are far apart, routed to
    another expert: the rule raises; a choice split at an exact tie (the
    k-th and (k+1)-th logits equal) passes."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 4, 16)).astype(np.float32))
    router = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    logits = x @ router
    mask = logits >= torch.topk(logits, 2, dim=-1).values[..., -1:]
    flipped = mask.clone()
    flipped[0, 0] = ~flipped[0, 0]
    with pytest.raises(AssertionError, match="not at a top-2 tie"):
        check_router_choices(flipped, mask, x, router, 2)
    assert check_router_choices(mask, mask, x, router, 2) == 0
    ones = torch.ones((1, 1, 16))
    tied = torch.zeros((16, 4))
    tied[:, 0], tied[:, 1], tied[:, 2], tied[:, 3] = 0.5, -0.25, 0.25, 0.25
    threshold = torch.tensor([[[True, False, True, True]]])
    by_index = torch.tensor([[[True, False, True, False]]])
    assert check_router_choices(threshold, by_index, ones, tied, 2) == 1


def test_capacity_matches_the_reference_formula():
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=16)
    x = torch.zeros((1, 40, 4), dtype=torch.bfloat16)
    params = {"router": torch.zeros((4, 8))}
    assert moe.route(params, x, cfg)[5] == int(1.25 * 40 * 2 / 8)
    assert moe.route(params, x[:, :1], cfg)[5] == 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_moe_ffn_is_capturable_and_equals_eager(cuda):
    """The decode-shaped MoE FFN (S = 1) under CUDA-graph capture: no host
    sync and no data-dependent shape, and the replay equals the eager call
    bit for bit."""
    cfg = get_config("mixtral-8x7b", smoke=True).moe
    params = moe.init_moe(torch.Generator(cuda).manual_seed(0), 64, cfg)
    x = torch.randn((4, 1, 64), device=cuda).to(torch.bfloat16)
    want, _ = moe.moe_ffn(params, x, cfg)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe.moe_ffn(params, x, cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, _ = moe.moe_ffn(params, x, cfg)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
