"""The port's continuous-batching engine, on the rwkv6 smoke config.

Against the JAX package: the slot operations (``cache_slot_insert``,
``cache_slot_reset``, ``cache_expand_rows``) bit for bit on the same
numpy caches, and the request queue's order on a 1k-request trace.
Within the port, the JAX package's own engine checks (tests/test_engine.py)
mirrored: the engine emits exactly the tokens of the static ``generate``
for the dense and both sketched heads, staggered arrivals equal solo
runs, an admission leaves other slots bitwise unchanged, and retired
slots reset to fresh rows.  Params come from the JAX package's init
through ``convert.params_from_numpy``.

The ``cuda`` case runs the engine on the card and skips without one; the
JAX package is imported inside fixtures, so that case also runs where JAX
is not installed (``python -m pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import LM, SketchHead
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.sketch_lm_head import freeze_head
from repro_torch.launch import serve
from repro_torch.launch.engine import Request, RequestQueue, ServeEngine
from repro_torch.launch.steps import prefill_step, serve_step
from repro_torch.models import model
from repro_torch.models.config import SketchHeadConfig
from repro_torch.models.rwkv import RWKVCache

ARCH = "rwkv6-1.6b"
HEAD_CFG = SketchHeadConfig(n_rows=32, n_buckets=8, k=1, proj_dim=16,
                            bandwidth=2.0)
HEADS = ["dense", "fused", "two_kernel"]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces these tests hold the port against."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as jax_config
    from repro.launch import engine as jengine
    from repro.models import model as jmodel
    from repro.models.rwkv import RWKVCache as JaxRWKVCache
    return dict(jax=jax, jnp=jnp, config=jax_config, engine=jengine,
                model=jmodel, cache=JaxRWKVCache)


@pytest.fixture(scope="module")
def smoke(jx):
    """JAX config and params, and the port's, on the CPU."""
    jcfg, cfg = jx["config"](ARCH, smoke=True), get_config(ARCH, smoke=True)
    jparams = jx["model"].init_model(jx["jax"].random.PRNGKey(0), jcfg)
    params = params_from_numpy(jx["jax"].tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, params


def _head(cfg, kind: str):
    """The serving head of one flavour: dense, or a frozen sketch head."""
    if kind == "dense":
        return None
    rng = np.random.default_rng(42)
    kp = {"points": rng.standard_normal((128, 16)),
          "alphas": rng.standard_normal((128, cfg.vocab_size)) * 0.01,
          "proj": rng.standard_normal((cfg.d_model, 16)) / np.sqrt(cfg.d_model)}
    kp = {k: torch.from_numpy(v.astype(np.float32)) for k, v in kp.items()}
    frozen = freeze_head(torch.Generator().manual_seed(42), kp, HEAD_CFG)
    return SketchHead(cfg=HEAD_CFG, backend=kind, params=frozen)


def _lm(smoke, kind="dense"):
    _, cfg, params = smoke
    lm = LM.from_config(ARCH, smoke=True, device="cpu", params=params)
    head = _head(cfg, kind)
    return lm if head is None else lm.with_head(head)


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def _random_cache(cfg, batch, seed):
    """A decode cache of the smoke config filled with numpy noise."""
    rng = np.random.default_rng(seed)
    fresh = model.init_decode_cache(cfg, batch, 8, device="cpu")
    return {"periods": {name: RWKVCache(*(
        rng.standard_normal(tuple(leaf.shape)).astype(np.float32)
        for leaf in c)) for name, c in fresh["periods"].items()}}


def _to_torch(cache):
    return {"periods": {n: RWKVCache(*(torch.from_numpy(x) for x in c))
                        for n, c in cache["periods"].items()}}


def _to_jax(jx, cache):
    return {"periods": {n: jx["cache"](*(jx["jnp"].asarray(x) for x in c))
                        for n, c in cache["periods"].items()}}


def _assert_caches_equal(got, want):
    for name in want["periods"]:
        for g, w in zip(got["periods"][name], want["periods"][name]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ------------------------------------------------ slot ops against JAX

@pytest.mark.parametrize("slots", [[2], [0, 3], [3, 1, 0]])
def test_cache_slot_insert_matches_jax(jx, smoke, slots):
    jcfg, cfg, _ = smoke
    pool, src = _random_cache(cfg, 4, 0), _random_cache(cfg, len(slots), 1)
    got = model.cache_slot_insert(cfg, _to_torch(pool), _to_torch(src), slots)
    want = jx["model"].cache_slot_insert(jcfg, _to_jax(jx, pool),
                                         _to_jax(jx, src),
                                         jx["jnp"].asarray(slots, "int32"))
    _assert_caches_equal(got, want)
    untouched = [s for s in range(4) if s not in slots]
    for g, p in zip(got["periods"]["pos0"], pool["periods"]["pos0"]):
        np.testing.assert_array_equal(g.numpy()[:, untouched], p[:, untouched])


@pytest.mark.parametrize("slots", [[1], [0, 2, 0]])
def test_cache_slot_reset_matches_jax(jx, smoke, slots):
    jcfg, cfg, _ = smoke
    pool = _random_cache(cfg, 3, 2)
    got = model.cache_slot_reset(cfg, _to_torch(pool), slots)
    want = jx["model"].cache_slot_reset(jcfg, _to_jax(jx, pool),
                                        jx["jnp"].asarray(slots, "int32"))
    _assert_caches_equal(got, want)
    fresh = model.init_decode_cache(cfg, 3, 8, device="cpu")
    for g, f in zip(got["periods"]["pos0"], fresh["periods"]["pos0"]):
        for s in set(slots):            # a reset row is a fresh row, bitwise
            assert torch.equal(g[:, s], f[:, s])


def test_cache_expand_rows_matches_jax(jx, smoke):
    jcfg, cfg, _ = smoke
    filled = _random_cache(cfg, 3, 3)
    inv = [0, 2, 2, 1, 0]
    got = model.cache_expand_rows(cfg, _to_torch(filled), inv)
    want = jx["model"].cache_expand_rows(jcfg, _to_jax(jx, filled),
                                         jx["jnp"].asarray(inv, "int32"))
    _assert_caches_equal(got, want)


def test_slot_ops_leave_their_inputs_unchanged(smoke):
    _, cfg, _ = smoke
    pool = _to_torch(_random_cache(cfg, 3, 4))
    keep = {n: RWKVCache(*(x.clone() for x in c))
            for n, c in pool["periods"].items()}
    model.cache_slot_insert(cfg, pool, _to_torch(_random_cache(cfg, 1, 5)), [1])
    model.cache_slot_reset(cfg, pool, [0, 2])
    _assert_caches_equal(pool, {"periods": keep})


# ------------------------------------------------------ request queue

def test_request_queue_matches_jax_on_1k_trace(jx):
    """Pops come out in the JAX queue's order on a 1k-request trace with
    heavy arrival ties: arrival-sorted, FIFO within a tick."""
    arrivals = np.random.default_rng(0).integers(0, 40, 1000)
    q, jq = RequestQueue(), jx["engine"].RequestQueue()
    for rid, a in enumerate(arrivals):
        q.push(Request(rid, np.zeros(1, np.int32), 1, int(a)))
        jq.push(jx["engine"].Request(rid, np.zeros(1, np.int32), 1, int(a)))
    assert len(q) == len(jq) == 1000
    assert q.peek().rid == jq.peek().rid
    order = [q.pop().rid for _ in range(1000)]
    assert order == [jq.pop().rid for _ in range(1000)]
    assert not q
    by_arrival = sorted(range(1000), key=lambda i: (arrivals[i], i))
    assert order == by_arrival


class _CounterBackend:
    """Numpy fake: each slot's "cache" is a counter and the emitted token
    the counter mod V, so a request's stream is ``(last_prompt_tok + 1 +
    i) % V`` and long traces run without a model."""

    vocab_size = 17

    def init_pool(self, n_slots, max_seq):
        return np.zeros(n_slots, np.int64)

    def prefill(self, prompts, max_seq):
        state = np.asarray(prompts)[:, -1].astype(np.int64) + 1
        logits = np.zeros((len(state), self.vocab_size), np.float32)
        logits[np.arange(len(state)), state % self.vocab_size] = 1.0
        return torch.from_numpy(logits), state

    def insert(self, pool, filled, slots):
        pool = pool.copy()
        pool[np.asarray(slots)] = filled
        return pool

    def reset(self, pool, slots):
        pool = pool.copy()
        pool[np.asarray(slots)] = 0
        return pool

    def expand_rows(self, filled, inv):
        return filled[np.asarray(inv)]

    def decode(self, pool, tokens, pos, active, head_params=None):
        nxt = (pool + 1) % self.vocab_size
        logits = np.zeros((len(nxt), self.vocab_size), np.float32)
        logits[np.arange(len(nxt)), nxt] = 1.0
        return torch.from_numpy(logits), np.where(active, pool + 1, pool)


def test_engine_drains_1k_request_trace():
    """A 1k-request stream through the scheduler (fake backend): every
    request retires once with its exact stream."""
    engine = ServeEngine(_CounterBackend(), n_slots=4, max_seq=16)
    rng = np.random.default_rng(1)
    reqs = []
    for _ in range(1000):
        last, gen = int(rng.integers(0, 17)), int(rng.integers(1, 6))
        rid = engine.submit(np.full(2, last, np.int32), gen,
                            arrival=int(rng.integers(0, 3000)))
        reqs.append((rid, last, gen))
    finished = engine.run()
    assert engine.stats["admitted"] == engine.stats["retired"] == 1000
    for rid, last, gen in reqs:
        assert finished[rid] == [(last + 1 + i) % 17 for i in range(gen)]


# ---------------------------------------------- engine against generate

@pytest.mark.parametrize("head", HEADS)
def test_engine_matches_static_generate(smoke, head):
    """Synchronized arrivals and equal lengths: the engine's tokens are
    exactly generate's."""
    lm = _lm(smoke, head)
    b, p, g = 2, 5, 4
    prompts = np.stack([_prompt(i, p, lm.cfg.vocab_size) for i in range(b)])
    expected = lm.generate(prompts, g)[:, p:].numpy()
    engine = lm.engine(b, p + g)
    rids = [engine.submit(prompts[i], g) for i in range(b)]
    out = engine.run()
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(out[rid], expected[i])
    assert engine.stats["admitted"] == engine.stats["retired"] == b
    assert engine.slot_utilization == 1.0


def test_engine_staggered_arrivals_match_solo_generate(smoke):
    """Recycled slots and per-slot depths: each request of a staggered,
    mixed-length stream emits exactly its own solo-generate tokens."""
    lm = _lm(smoke)
    engine = lm.engine(2, 16)
    reqs = []
    for i, (plen, gen, arrival) in enumerate([(4, 6, 0), (6, 3, 0),
                                              (5, 8, 2), (4, 2, 5)]):
        prompt = _prompt(10 + i, plen, lm.cfg.vocab_size)
        reqs.append((engine.submit(prompt, gen, arrival=arrival), prompt, gen))
    out = engine.run()
    for rid, prompt, gen in reqs:
        solo = lm.generate(prompt[None], gen)[0, len(prompt):].tolist()
        assert out[rid] == solo
    assert engine.stats["admitted"] == 4 and engine.sched.n_free == 2


def test_lm_serve_dedupes_identical_prompts(smoke):
    """Equal prompts admitted together prefill once; every request still
    gets its solo stream."""
    lm = _lm(smoke, "fused")
    a, b = _prompt(1, 6, lm.cfg.vocab_size), _prompt(2, 6, lm.cfg.vocab_size)
    requests = [(a, 3), (b, 5), (a, 4)]
    engine = lm.engine(3, 11)
    for prompt, gen in requests:
        engine.submit(prompt, gen)
    out = engine.run()
    assert engine.stats["dedup_saved"] == 1
    assert out == lm.serve(requests, n_slots=3)
    for rid, (prompt, gen) in enumerate(requests):
        assert out[rid] == lm.generate(prompt[None], gen)[0, 6:].tolist()


def test_slot_insert_leaves_other_slots_bitwise_unchanged(smoke):
    """Admitting into a free slot while others are mid-decode does not
    move the other slots' next logits by a bit."""
    _, cfg, params = smoke
    plen, max_seq = 6, 12
    prompts = torch.from_numpy(np.stack([_prompt(i, plen, cfg.vocab_size)
                                         for i in range(2)])).long()
    with torch.no_grad():
        logits, filled = prefill_step(params, prompts, cfg,
                                      model.init_decode_cache(cfg, 2, max_seq, "cpu"))
        pool = model.cache_slot_insert(
            cfg, model.init_decode_cache(cfg, 3, max_seq, "cpu"), filled, [0, 1])
        tok = torch.cat([logits.argmax(-1), torch.zeros(1, dtype=torch.long)])[:, None]
        partial = torch.tensor([True, True, False])
        l1, pool = serve_step(params, pool, tok, cfg, active=partial)
        tok = torch.cat([l1[:2].argmax(-1), torch.zeros(1, dtype=torch.long)])[:, None]
        l_a, _ = serve_step(params, pool, tok, cfg, active=partial)

        new = torch.from_numpy(_prompt(9, plen, cfg.vocab_size)).long()[None]
        nl, nfilled = prefill_step(params, new, cfg,
                                   model.init_decode_cache(cfg, 1, max_seq, "cpu"))
        pool_b = model.cache_slot_insert(cfg, pool, nfilled, [2])
        tok_b = tok.clone()
        tok_b[2, 0] = nl[0].argmax()
        l_b, _ = serve_step(params, pool_b, tok_b, cfg,
                            active=torch.tensor([True, True, True]))
    assert torch.equal(l_a[:2], l_b[:2])


def test_retired_slots_reset_to_fresh_cache(smoke):
    lm = _lm(smoke)
    engine = lm.engine(2, 10)
    engine.submit(_prompt(3, 6, lm.cfg.vocab_size), 4)
    engine.run()
    fresh = model.init_decode_cache(lm.cfg, 2, 10, device="cpu")
    _assert_caches_equal(engine.pool, fresh)


def test_engine_refuses_unported_modes(smoke):
    lm = _lm(smoke)
    for kw in ({"decode_chunk": 4}, {"spec_decode": 2}):
        with pytest.raises(NotImplementedError, match="item 8"):
            lm.engine(2, 10, **kw)
    with pytest.raises(NotImplementedError, match="item 9"):
        lm.engine(2, 10, paged=True)


def test_submit_contract(smoke):
    lm = _lm(smoke)
    engine = lm.engine(2, 10)
    with pytest.raises(ValueError, match="per-tenant engine"):
        engine.submit([1, 2], 3, tenant="tenant-0")
    with pytest.raises(ValueError, match="max_seq"):
        engine.submit([1] * 8, 4)
    with pytest.raises(ValueError, match="non-empty"):
        engine.submit([], 2)
    rid = engine.submit([1, 2], 2, rid=7)
    with pytest.raises(ValueError, match="already submitted"):
        engine.submit([1, 2], 2, rid=rid)


def test_engine_eos_retires_early(smoke):
    lm = _lm(smoke)
    prompt = _prompt(5, 6, lm.cfg.vocab_size)
    free = lm.serve([(prompt, 6)], n_slots=1)[0]
    out = lm.serve([(prompt, 6)], n_slots=1, eos_id=free[2])[0]
    stop = free.index(free[2]) + 1
    assert out == free[:stop]


def test_serve_cli_engine_mode(capsys):
    serve.main(["--smoke", "--device", "cpu", "--engine", "--batch", "2",
                "--requests", "5", "--prompt-len", "6", "--gen", "4",
                "--stats-json"])
    out = capsys.readouterr().out
    assert "engine served 5 requests over 2 slots" in out
    stats = [line for line in out.splitlines() if line.startswith("STATS_JSON")]
    assert len(stats) == 1 and '"retired": 5' in stats[0]
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--stats-json"])


def test_engine_stream_mix():
    """The CLI's synthetic stream, drawn as the JAX package's run_engine
    draws it: every 4th prompt shared, lengths gen and gen // 4, arrivals
    every ``arrival_every`` ticks."""
    stream = serve.engine_stream(256, 9, 5, 8, 2, 0)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 256, 5, dtype=np.int32)
    for i, (prompt, gen, arrival) in enumerate(stream):
        want = shared if i % 4 == 3 else rng.integers(0, 256, 5, dtype=np.int32)
        np.testing.assert_array_equal(prompt, want)
        assert gen == (8 if i % 2 else 2) and arrival == 2 * i


# ----------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine's sketched decode "
                    "launches the CUDA kernels")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_engine_launches_fused_decode_once_per_tick(cuda):
    from repro_torch.kernels.fused_decode.ops import fused_decode_logits

    lm = LM.from_config(ARCH, smoke=True, device=cuda)
    lm = lm.with_head(_head(lm.cfg, "fused").to(cuda))
    engine = lm.engine(2, 16)
    for i in range(4):
        engine.submit(_prompt(i, 6, lm.cfg.vocab_size), 3 + i, arrival=i)
    fused_decode_logits.launches = 0
    out = engine.run()
    assert fused_decode_logits.launches == engine.stats["decode_steps"] > 0
    assert sorted(len(v) for v in out.values()) == [3, 4, 5, 6]
