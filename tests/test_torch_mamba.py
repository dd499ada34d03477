"""The port's Mamba-1 mixer (``models/mamba.py``) against the JAX package's.

The same numpy tokens go through ``repro.models.mamba.mamba_block`` and the
port's, on the JAX package's params (``convert``; ``conv_b`` and
``dt_bias`` redrawn non-zero so that they count), at jamba's smoke mamba
config: the decode branch against a random cache, and the chunked prefill
at S in {1, 7, 256, 300} (one chunk, one whole chunk, two chunks with a
padded last one) without a cache, from a zero cache (S >= 2) and from the
state a first prefill left.  Tolerances:

* Against the JAX block run op by op (``jax.disable_jit``), which rounds
  where the port rounds: the conv state bit for bit; the f32 SSM state
  within 2⁻²⁰ of its largest magnitude (``exp``, ``log1p`` and the f32
  einsum over d_state may round an ulp apart, and the scan carries it);
  the bf16 output within one bf16 ulp (2⁻⁸ relative plus 2⁻⁸ of the
  largest magnitude).
* Against the compiled JAX block: XLA keeps excess precision in its
  fusions (the conv sum, silu and the projections skip bf16 roundings, so
  Δ, B_t and x move by bf16 ulps), the bf16 backbone rule of
  ``repro_torch.parity`` on the output and on the state.

The combining tree of the in-chunk scan equals
``jax.lax.associative_scan``'s bit for bit (op by op; decays kept above
the subnormal range, which XLA flushes).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import mamba
from repro_torch.parity import assert_bf16_backbone_close

BF16_ULP = 2.0 ** -8
STATE_TOL = 2.0 ** -20
ARCH = "jamba-v0.1-52b"


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
    from repro.configs import get_config as jax_config
    from repro.models import mamba as jmamba
    return dict(jax=jax, jnp=jnp, mamba=jmamba, config=jax_config)


@pytest.fixture(scope="module")
def setup(jx):
    jax, jnp = jx["jax"], jx["jnp"]
    jcfg = jx["config"](ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    jparams = dict(jx["mamba"].init_mamba(jax.random.PRNGKey(3), cfg.d_model,
                                          jcfg.mamba))
    rng = np.random.default_rng(1)
    d_in = cfg.mamba.expand * cfg.d_model
    jparams["conv_b"] = jnp.asarray(rng.standard_normal(d_in) * 0.1,
                                    jnp.float32)
    jparams["dt_bias"] = jnp.asarray(rng.standard_normal(d_in) * 0.5,
                                     jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg.mamba, cfg.mamba, jparams, params, cfg.d_model


def _x(jx, seed, shape):
    return jx["jnp"].asarray(np.random.default_rng(seed).standard_normal(shape),
                             jx["jnp"].bfloat16)


def _torch(x):
    return params_from_numpy(np.asarray(x), "cpu")


def _run(jx, setup, x, jcache, jit):
    """(JAX out, JAX cache, port out, port cache) from the same cache."""
    jcfg, cfg, jparams, params, _ = setup
    fn = lambda p, xx, c: jx["mamba"].mamba_block(p, xx, jcfg, cache=c)
    if jit:
        jout, jnew = jx["jax"].jit(fn)(jparams, x, jcache)
    else:
        with jx["jax"].disable_jit():
            jout, jnew = fn(jparams, x, jcache)
    cache = mamba.MambaCache(*(torch.from_numpy(np.array(t)) for t in jcache))
    out, new = mamba.mamba_block(params, _torch(x), cfg, cache=cache)
    return jout, jnew, out, new


def _check(jx, jout, jnew, out, new, eager):
    jnp = jx["jnp"]
    want = np.asarray(jnp.asarray(jout).astype(jnp.float32))
    got = out.float().numpy()
    assert out.dtype == torch.bfloat16 and new.ssm.dtype == torch.float32
    assert new.conv.dtype == torch.float32
    np.testing.assert_array_equal(new.conv.numpy(), np.asarray(jnew.conv))
    ssm = np.asarray(jnew.ssm)
    if eager:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP,
                                   atol=BF16_ULP * np.abs(want).max())
        np.testing.assert_allclose(new.ssm.numpy(), ssm, rtol=0,
                                   atol=STATE_TOL * np.abs(ssm).max())
    else:
        assert_bf16_backbone_close(got, want)
        assert_bf16_backbone_close(new.ssm.numpy(), ssm)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "compiled"])
@pytest.mark.parametrize("seq", [2, 7, 256, 300])
def test_prefill_matches_jax(jx, setup, seq, jit):
    """The chunked branch from a zero cache (a single token against a
    cache is the decode branch, so the cached prefill starts at 2), then a
    second prefill (S=5) from the state the first left (the carried state
    enters position 0)."""
    _, _, _, _, d = setup
    jcache = jx["mamba"].init_mamba_cache(2, d, setup[0])
    jout, jnew, out, new = _run(jx, setup, _x(jx, seq, (2, seq, d)), jcache,
                                jit)
    _check(jx, jout, jnew, out, new, not jit)
    jout, jnew2, out, new2 = _run(jx, setup, _x(jx, seq + 1, (2, 5, d)),
                                  jnew, jit)
    _check(jx, jout, jnew2, out, new2, not jit)


@pytest.mark.parametrize("seq", [1, 7, 256, 300])
def test_prefill_without_cache_matches_jax(jx, setup, seq):
    """The chunked branch from no cache (a forward without one), S = 1
    included."""
    jcfg, cfg, jparams, params, d = setup
    x = _x(jx, 9, (2, seq, d))
    with jx["jax"].disable_jit():
        jout, jnone = jx["mamba"].mamba_block(jparams, x, jcfg)
    out, none = mamba.mamba_block(params, _torch(x), cfg)
    assert jnone is None and none is None
    want = np.asarray(jout.astype(jx["jnp"].float32))
    np.testing.assert_allclose(out.float().numpy(), want, rtol=BF16_ULP,
                               atol=BF16_ULP * np.abs(want).max())


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "compiled"])
def test_decode_matches_jax(jx, setup, jit):
    """The single-token branch against a random f32 cache, three steps."""
    jcfg, cfg, _, _, d = setup
    rng = np.random.default_rng(4)
    d_in = cfg.expand * d
    jnp = jx["jnp"]
    conv = jnp.asarray(rng.standard_normal((3, cfg.d_conv - 1, d_in)),
                       jnp.bfloat16).astype(jnp.float32)
    jcache = jx["mamba"].MambaCache(
        conv, jnp.asarray(rng.standard_normal((3, d_in, cfg.d_state)),
                          jnp.float32))
    for t in range(3):
        jout, jnew, out, new = _run(jx, setup, _x(jx, 20 + t, (3, 1, d)),
                                    jcache, jit)
        _check(jx, jout, jnew, out, new, not jit)
        jcache = jnew


def test_associative_scan_matches_jax(jx):
    jax, jnp = jx["jax"], jx["jnp"]
    rng = np.random.default_rng(0)
    comb = lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1])
    for n in (1, 2, 3, 7, 8, 255, 256):
        d = rng.uniform(0.9, 1.0, (2, n, 5, 3)).astype(np.float32)
        i = rng.standard_normal((2, n, 5, 3)).astype(np.float32)
        with jax.disable_jit():
            jd, ji = jax.lax.associative_scan(comb, (jnp.asarray(d),
                                                     jnp.asarray(i)), axis=1)
        td, ti = mamba.associative_scan(torch.from_numpy(d),
                                        torch.from_numpy(i))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_pad_positions_leave_the_state_alone(setup):
    """A prefill of 300 (a padded second chunk) leaves the state a prefill
    of the same 300 tokens as 256 + 44 leaves: the pad is an identity."""
    _, cfg, _, params, d = setup
    x = torch.randn((2, 300, d), generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    fresh = lambda: mamba.init_mamba_cache(2, d, cfg, device="cpu")
    _, whole = mamba.mamba_block(params, x, cfg, cache=fresh())
    _, first = mamba.mamba_block(params, x[:, :256], cfg, cache=fresh())
    _, second = mamba.mamba_block(params, x[:, 256:], cfg, cache=first)
    np.testing.assert_array_equal(whole.conv.numpy(), second.conv.numpy())
    np.testing.assert_allclose(whole.ssm.numpy(), second.ssm.numpy(), rtol=0,
                               atol=STATE_TOL * float(whole.ssm.abs().max()))


def test_init_mamba_tree_and_dtypes_match_jax(jx, setup):
    _, cfg, jparams, _, d = setup
    ours = mamba.init_mamba(torch.Generator().manual_seed(0), d, cfg)
    assert set(ours) == set(jparams)
    for k, leaf in jparams.items():
        assert tuple(ours[k].shape) == leaf.shape, k
        assert str(ours[k].dtype).split(".")[-1] == str(leaf.dtype), k
    np.testing.assert_array_equal(ours["a_log"].numpy(),
                                  np.asarray(jx["mamba"].init_mamba(
                                      jx["jax"].random.PRNGKey(0), d,
                                      setup[0])["a_log"]))
    cache = mamba.init_mamba_cache(3, d, cfg, device="cpu")
    jcache = jx["mamba"].init_mamba_cache(3, d, setup[0])
    for a, b in zip(cache, jcache):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        assert not bool(a.any())
