"""The port's seeded sampler and its key chain against the JAX package's.

``repro_torch.api.sampler`` replays ``jax.random``'s threefry2x32 chain as
JAX 0.9.0 runs it (partitionable mode): the keys of ``PRNGKey(seed)``, a
chain of splits, the random bits and the uniforms equal JAX's bit for bit
at seeds {0, 7, 2³¹−1} and shapes {(2,), (4, 256), (3, 1000)}.  The
Gumbel noise goes through each library's f32 ``log``: within the rule of
``repro_torch.parity.check_sampled_tokens`` (4u·(1 + |g|) a value).

On shared logits, ``Sampler(...).sample`` gives JAX's keys bit for bit,
the same top-k-filtered logits bit for bit, the same top-p-filtered
logits outside the rows ``parity.top_p_near_cut`` flags, and the same
tokens except where ``parity.check_sampled_tokens`` allows (asserted for
every mismatch).

The streams: the port's seeded ``generate`` (the per-token loop, the
megastep loop at decode_chunk 3, speculative decode at K = 4 with a
sketched and with the dense draft) and its engine (decode_chunk 1 and 4,
and spec K = 4), on rwkv6's smoke config with the JAX package's params,
against the reference's ``"seeded"`` sampler (tests/test_decode_loop.py,
tests/test_spec_decode.py: temperature 0.9, top-k 12, seed 7) fed the same
logits: for ``generate``, JAX's sampler walks its chain over the port's
logits teacher-forced along the port's stream; for the engine, the JAX
package's own ``ServeEngine`` runs on a backend that replays the port
engine's logits, so its scheduling decides when the chain splits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import LM, Sampler, SketchHead
from repro_torch.api import sampler as smp
from repro_torch.launch.steps import prefill_step, serve_step
from repro_torch.models import model
from repro_torch.models.config import SketchHeadConfig
from repro_torch.parity import check_sampled_tokens, top_p_near_cut

SEEDS = [0, 7, 2 ** 31 - 1]
SHAPES = [(2,), (4, 256), (3, 1000)]
SEEDED = dict(temperature=0.9, top_k=12, seed=7)
SPECS = [SEEDED, dict(temperature=1.0, seed=1),
         dict(temperature=0.7, top_p=0.9, seed=3),
         dict(temperature=0.5, top_k=40, top_p=0.8, seed=2),
         dict(temperature=1.3, top_p=0.5, seed=11)]
ARCH = "rwkv6-1.6b"
HEAD_CFG = SketchHeadConfig(n_rows=32, n_buckets=8, k=1, proj_dim=16,
                            bandwidth=2.0)


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
    from repro.api.sampler import Sampler as JaxSampler
    return dict(jax=jax, jnp=jnp, Sampler=JaxSampler)


def _u32(a):
    return np.asarray(a).astype(np.int64)


# ------------------------------------------------------------ the key chain

@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_key_chain_matches_jax(jx, seed, shape):
    jax, jnp = jx["jax"], jx["jnp"]
    jkey, key = jax.random.PRNGKey(seed), smp.prng_key(seed)
    np.testing.assert_array_equal(key.numpy(), _u32(jkey))
    for _ in range(3):                       # a chain of splits
        jkey, jsub = jax.random.split(jkey)
        keys = smp.split(key)
        np.testing.assert_array_equal(keys.numpy(),
                                      _u32(jnp.stack([jkey, jsub])))
        key, sub = keys[0], keys[1]
        np.testing.assert_array_equal(
            smp.random_bits(sub, shape).numpy(),
            _u32(jax.random.bits(jsub, shape, jnp.uint32)))
        tiny = float(jnp.finfo(jnp.float32).tiny)
        for lo in (0.0, tiny):
            np.testing.assert_array_equal(
                smp.uniform(sub, shape, lo, 1.0).numpy(),
                np.asarray(jax.random.uniform(jsub, shape, jnp.float32, lo,
                                              1.0)))
        g, jg = smp.gumbel(sub, shape).double(), np.asarray(
            jax.random.gumbel(jsub, shape), np.float64)
        assert np.all(np.abs(g.numpy() - jg)
                      <= 4 * 2.0 ** -24 * (1 + np.abs(jg)))
    assert tuple(smp.split(key, 5).shape) == (5, 2)
    np.testing.assert_array_equal(smp.split(key, 5).numpy(),
                                  _u32(jax.random.split(jkey, 5)))


def test_prng_key_wraps_like_jax(jx):
    for seed in (2 ** 31, 2 ** 32 + 5, -1):
        np.testing.assert_array_equal(smp.prng_key(seed).numpy(),
                                      _u32(jx["jax"].random.PRNGKey(seed)))


# ----------------------------------------------- the sampler on shared logits

def _logits(seed=5, b=64, v=300):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, v)) * 3).astype(np.float32)


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: Sampler(**s).describe())
def test_sample_matches_jax_on_shared_logits(jx, spec):
    """Keys bit for bit; the filters (a categorical's input) bit for bit
    outside near-cut top-p rows; tokens under the sampling rule."""
    jnp = jx["jnp"]
    logits = _logits()
    ours, theirs = Sampler(**spec), jx["Sampler"](**spec)
    key, jkey = ours.init_key(), theirs.init_key()
    for _ in range(4):
        pre = key
        key, tok = ours.sample(key, torch.from_numpy(logits))
        jkey, jtok = theirs.sample(jkey, jnp.asarray(logits))
        np.testing.assert_array_equal(key.numpy(), _u32(jkey))
        scaled = torch.from_numpy(logits) / torch.full((), spec["temperature"])
        kth = smp.filter_logits(Sampler(**dict(spec, top_p=1.0)), scaled)
        near = (top_p_near_cut(kth, spec["top_p"]) if spec.get("top_p")
                else None)
        final = smp.filter_logits(ours, scaled)
        from repro.api.sampler import _filter_logits
        jfinal = np.asarray(_filter_logits(theirs, jnp.asarray(
            scaled.numpy())))
        rows = np.ones(len(logits), bool) if near is None else ~near.numpy()
        np.testing.assert_array_equal(final.numpy()[rows], jfinal[rows])
        u = smp.uniform(smp.split(pre)[1], logits.shape, smp.F32_TINY, 1.0)
        check_sampled_tokens(tok, torch.from_numpy(np.array(jtok)), final,
                             u, near)


def test_greedy_leaves_the_key_and_takes_the_first_maximum():
    logits = torch.zeros((2, 5))
    logits[0, 3] = logits[0, 1] = 1.0
    key = smp.prng_key(3)
    out, tok = Sampler().sample(key, logits)
    assert out is key and tok.tolist() == [1, 0]


def test_sampling_rules_catch_a_real_mismatch():
    """A token far from the winner's Gumbel score raises; so does a top-p
    row whose nucleus cut is far from ``top_p``; a near-tie passes."""
    logits = torch.from_numpy(_logits(b=4))
    key = smp.prng_key(0)
    u = smp.uniform(key, logits.shape, smp.F32_TINY, 1.0)
    want = smp.categorical(key, logits)
    scores = smp.gumbel(key, logits.shape).double() + logits.double()
    worst = scores.argmin(dim=-1)
    with pytest.raises(AssertionError, match="beyond the Gumbel rounding"):
        check_sampled_tokens(worst, want, logits, u)
    near = top_p_near_cut(logits, 0.9)
    assert not bool(near.any())
    with pytest.raises(AssertionError):
        check_sampled_tokens(worst, want, logits, u, near)
    tied = logits.clone()                  # the runner-up moved onto the
    g = smp.gumbel(key, logits.shape)      # winner's score: a near-tie
    second = (g + tied).topk(2, dim=-1).indices[:, 1]
    rows = torch.arange(4)
    tied[rows, second] += (g + tied)[rows, want] - (g + tied)[rows, second]
    assert check_sampled_tokens(second, want, tied, u) == 4
    every_row_near_its_cut = torch.ones(4, dtype=torch.bool)
    assert check_sampled_tokens(worst, want, logits, u,
                                every_row_near_its_cut) == 0


# --------------------------------------------------------------- the streams

@pytest.fixture(scope="module")
def lms(jx):
    """rwkv6's smoke model on the JAX package's params, dense and with a
    frozen sketch head."""
    jax = jx["jax"]
    from repro.configs import get_config as jax_config
    from repro.models.model import init_model
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.sketch_lm_head import freeze_head
    jparams = init_model(jax.random.PRNGKey(0), jax_config(ARCH, smoke=True))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    dense = LM.from_config(ARCH, smoke=True, device="cpu", params=params)
    rng = np.random.default_rng(42)
    kp = {"points": rng.standard_normal((128, 16)),
          "alphas": rng.standard_normal((128, 256)) * 0.01,
          "proj": rng.standard_normal((64, 16)) / 8.0}
    kp = {k: torch.from_numpy(v.astype(np.float32)) for k, v in kp.items()}
    frozen = freeze_head(torch.Generator().manual_seed(42), kp, HEAD_CFG)
    return {"dense": dense, "fused": dense.with_head(
        SketchHead(cfg=HEAD_CFG, backend="fused", params=frozen))}


PROMPTS = np.random.default_rng(1).integers(0, 256, (3, 6)).astype(np.int32)
GEN = 9


def _teacher_forced_logits(lm, tokens):
    """The dense logits that picked each new token, recomputed along the
    stream (prefill, then the plain decode steps)."""
    cfg, p = lm.cfg, PROMPTS.shape[1]
    cache = model.init_decode_cache(cfg, len(PROMPTS), p + GEN, device="cpu")
    logits, cache = prefill_step(lm.params, torch.from_numpy(PROMPTS), cfg,
                                 cache)
    out = [logits]
    for t in range(GEN - 1):
        logits, cache = serve_step(lm.params, cache,
                                   tokens[:, p + t:p + t + 1], cfg)
        out.append(logits)
    return out


def _jax_chain(jx, spec, logits_seq):
    """JAX's sampler over the same logits: the root key samples the first
    token, one split a later step.  Returns (tokens, keys before each)."""
    sampler = jx["Sampler"](**spec)
    key, toks, pre = sampler.init_key(), [], []
    for lg in logits_seq:
        pre.append(key)
        key, tok = sampler.sample(key, jx["jnp"].asarray(lg.numpy()))
        toks.append(np.asarray(tok))
    return np.stack(toks, axis=1), pre


def _check_stream(jx, spec, tokens, logits_seq):
    """The port's stream against JAX's chain on the same logits: equal,
    or the first difference within the sampling rule (the streams part
    there and the rest is not comparable)."""
    want, pre = _jax_chain(jx, spec, logits_seq)
    got = tokens[:, PROMPTS.shape[1]:].numpy()
    sampler = Sampler(**spec)
    for t in range(GEN):
        if np.array_equal(got[:, t], want[:, t]):
            continue
        scaled = logits_seq[t] / torch.full((), spec["temperature"])
        final = smp.filter_logits(sampler, scaled)
        sub = smp.split(torch.from_numpy(_u32(pre[t])))[1]
        u = smp.uniform(sub, final.shape, smp.F32_TINY, 1.0)
        check_sampled_tokens(torch.from_numpy(got[:, t]),
                             torch.from_numpy(want[:, t]), final, u)
        return
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["host", "chunk3", "spec_fused",
                                  "spec_dense"])
def test_seeded_generate_matches_jax_chain(jx, lms, mode):
    """Every seeded ``generate`` variant gives the per-token loop's stream
    bit for bit (the same chain, the same logits), and that stream is
    JAX's sampler chain over its logits."""
    sampler = Sampler(**SEEDED)
    lm = lms["fused" if mode == "spec_fused" else "dense"]
    kw = {"host": {}, "chunk3": dict(decode_chunk=3),
          "spec_fused": dict(spec_decode=4),
          "spec_dense": dict(spec_decode=4)}[mode]
    tokens = lm.generate(PROMPTS, GEN, sampler=sampler, **kw)
    host = lms["dense"].generate(PROMPTS, GEN, sampler=sampler)
    assert torch.equal(tokens, host)
    _check_stream(jx, SEEDED, host, _teacher_forced_logits(lms["dense"],
                                                           host))
    other = lm.generate(PROMPTS, GEN, sampler=Sampler(**dict(SEEDED,
                                                             seed=8)), **kw)
    assert not torch.equal(other, tokens)       # another seed, another chain


def test_seeded_generate_reuses_its_memoized_loop(lms):
    """A memoized megastep loop gets the root key again on every call."""
    lm = lms["dense"].with_head(lms["dense"].head)
    sampler = Sampler(**SEEDED)
    a = lm.generate(PROMPTS, GEN, sampler=sampler, decode_chunk=4)
    b = lm.generate(PROMPTS, GEN, sampler=sampler, decode_chunk=4)
    assert len(lm._loops) == 1 and torch.equal(a, b)


class _Replay:
    """A JAX-engine backend that hands back the port engine's logits, call
    by call (prefill, then decode), so the JAX package's scheduling and
    sampler run on the port's numbers."""

    def __init__(self, jnp, prefills, decodes):
        self.jnp, self.prefills, self.decodes = jnp, list(prefills), \
            list(decodes)

    def init_pool(self, n_slots, max_seq):
        return None

    def prefill(self, prompts, max_seq):
        return self.jnp.asarray(self.prefills.pop(0)), None

    def insert(self, pool, filled, slots):
        return pool

    def reset(self, pool, slots):
        return pool

    def expand_rows(self, filled, inv):
        return filled

    def decode(self, pool, tokens, pos, active, head_params=None):
        return self.jnp.asarray(self.decodes.pop(0)), pool


def _stream():
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 256, 5).astype(np.int32)
    return [((shared if i % 3 == 2 else
              rng.integers(0, 256, 4 + i % 3).astype(np.int32)),
             3 + (i % 4), i // 2) for i in range(8)]


def _run_engine(lm, **kw):
    eng = lm.engine(3, 16, sampler=Sampler(**SEEDED), **kw)
    for p, g, a in _stream():
        eng.submit(p, g, arrival=a)
    return eng


def test_seeded_engine_matches_jax_engine_on_its_logits(jx, lms):
    """The port's seeded engine at decode_chunk 1 against the JAX
    package's engine replaying its logits: the same streams (the same
    scheduling splits the chain at the same calls; a difference must sit
    within the sampling rule); decode_chunk 4 and the speculative engine
    (K = 4, fused drafts) give decode_chunk 1's streams bit for bit."""
    from repro.launch.engine import ServeEngine as JaxEngine
    eng = _run_engine(lms["dense"])
    prefills, decodes = [], []
    be = eng.backend
    inner_prefill, inner_decode = be.prefill, be.decode

    def prefill(*a, **k):
        out = inner_prefill(*a, **k)
        prefills.append(out[0].numpy())
        return out

    def decode(*a, **k):
        out = inner_decode(*a, **k)
        decodes.append(out[0].numpy())
        return out

    be.prefill, be.decode = prefill, decode
    fin = eng.run()
    jeng = JaxEngine(_Replay(jx["jnp"], prefills, decodes), 3, 16,
                     sampler=jx["Sampler"](**SEEDED))
    for p, g, a in _stream():
        jeng.submit(p, g, arrival=a)
    jfin = jeng.run()
    assert set(jfin) == set(fin)
    if any(jfin[r] != fin[r] for r in fin):
        pytest.fail("the seeded engine's streams differ from the JAX "
                    "engine's on the same logits")
    assert _run_engine(lms["dense"], decode_chunk=4).run() == fin
    assert _run_engine(lms["fused"], spec_decode=4).run() == fin


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_key_chain_equals_cpu(cuda):
    """The card's keys, splits, bits and uniforms equal the CPU's bit for
    bit (integer ops; the uniform's arithmetic is exact)."""
    key, ckey = smp.prng_key(7, cuda), smp.prng_key(7)
    for _ in range(3):
        keys, ckeys = smp.split(key), smp.split(ckey)
        assert torch.equal(keys.cpu(), ckeys)
        assert torch.equal(smp.random_bits(keys[1], (4, 65536)).cpu(),
                           smp.random_bits(ckeys[1], (4, 65536)))
        assert torch.equal(
            smp.uniform(keys[1], (4, 65536), smp.F32_TINY, 1.0).cpu(),
            smp.uniform(ckeys[1], (4, 65536), smp.F32_TINY, 1.0))
        key, ckey = keys[0], ckeys[0]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [ARCH, "jamba-v0.1-52b"])
def test_cuda_seeded_generate_is_the_same_at_every_chunk(cuda, arch):
    """On the card, the seeded stream of the per-token loop equals the
    captured megastep's (decode_chunk 4) and speculative decode's (K = 4,
    the dense-head draft): the key lives in the graph's static buffer."""
    lm = LM.from_config(arch, smoke=True, device=cuda)
    prompts = torch.randint(0, lm.cfg.vocab_size, (3, 6), device=cuda,
                            generator=torch.Generator(cuda).manual_seed(1))
    sampler = Sampler(**SEEDED)
    host = lm.generate(prompts, GEN, sampler=sampler)
    assert torch.equal(lm.generate(prompts, GEN, sampler=sampler,
                                   decode_chunk=4), host)
    assert torch.equal(lm.generate(prompts, GEN, sampler=sampler,
                                   spec_decode=4), host)
    assert torch.equal(lm.generate(prompts, GEN, sampler=sampler,
                                   decode_chunk=4), host)   # memoized loop
