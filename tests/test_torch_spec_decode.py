"""The port's speculative decode against the JAX package, on smoke configs.

The serving head drafts K tokens a tick, the dense head verifies them and
the longest matching prefix plus the bonus token commits
(``launch/decode_loop.SpecLoop``).  The contract is the JAX package's
(tests/test_spec_decode.py): the tokens are dense decode's, bit for bit,
whatever the draft head; the draft only sets how many commit a tick.

Against the JAX package, on its params (``convert.params_from_numpy``)
and its frozen sketch head: the tokens and the stats (``decode_steps``,
``verify_calls``, ``draft_tokens``, ``accepted_draft_tokens``) of
``LM.generate(spec_decode=K)`` and of the engine's speculative ticks, for
K in {1, 4, 16} and every head backend; the random head rejects almost
every draft, so rejection mid-block is the steady state.  Within the port:
the same streams as dense decode, EOS mid-block, a dense-head draft that
accepts everything (its verify logits equal to its draft logits bit for
bit), gemma2's SWA ring wrapped (prompt 12 > window 8, and K = 16 > the
ring: draft steps that share a ring slot), jamba's mamba rows restored
from their snapshots and deepseek's MLA latent (a dense prologue layer's
among it) rewound by position (the tokens dense decode's, the rolled-back
cache that of the committed dense steps bit for bit), the bounded loop
memo, and the validation errors.

The ``cuda`` cases run the captured draft step on the card and skip
without one; they import no JAX (``python -m pytest --noconftest -m
cuda``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import LM, SketchHead
from repro_torch.core.sketch_lm_head import freeze_head
from repro_torch.kernels.fused_decode.ops import fused_decode_logits
from repro_torch.kernels.lsh_hash.ops import lsh_hash
from repro_torch.kernels.sketch_head.ops import sketch_head_logits
from repro_torch.launch import serve
from repro_torch.launch.decode_loop import (MAX_LOOPS, WARMUP_STEPS,
                                            SpecLoop)
from repro_torch.models import model
from repro_torch.models.config import SketchHeadConfig

KS = [1, 4, 16]
BACKENDS = ["fused", "two_kernel", "ref"]
HEAD = dict(n_rows=32, n_buckets=8, k=1, proj_dim=16, bandwidth=2.0)
HEAD_CFG = SketchHeadConfig(**HEAD)
PROMPT = {"rwkv6-1.6b": 5, "gemma2-27b": 12,    # gemma2: past its window 8
          "jamba-v0.1-52b": 6, "deepseek-v3-671b": 6}
GEN = 9


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
    from repro.api import LM as JaxLM, SketchHead as JaxSketchHead
    from repro.configs import get_config
    from repro.core.sketch_lm_head import freeze_head as jax_freeze
    from repro.models.config import SketchHeadConfig as JaxHeadConfig
    from repro.models.model import init_model
    return dict(jax=jax, jnp=jnp, LM=JaxLM, SketchHead=JaxSketchHead,
                config=get_config, freeze=jax_freeze, init=init_model,
                head_cfg=JaxHeadConfig(**HEAD))


@pytest.fixture(scope="module")
def served(jx):
    """Per arch: the JAX package's smoke params (key 0) and a head it froze
    (key 42, as tests/test_spec_decode.py), and both packages' LMs for
    each backend; built on first use."""
    from repro_torch.convert import params_from_numpy

    jax, jnp = jx["jax"], jx["jnp"]
    cache = {}

    def get(arch):
        if arch in cache:
            return cache[arch]
        jcfg = jx["config"](arch, smoke=True)
        jparams = jx["init"](jax.random.PRNGKey(0), jcfg)
        kp, ka, kj, kf = jax.random.split(jax.random.PRNGKey(42), 4)
        kparams = {
            "points": jax.random.normal(kp, (128, HEAD["proj_dim"])),
            "alphas": jax.random.normal(ka, (128, jcfg.vocab_size)) * 0.01,
            "proj": jax.random.normal(kj, (jcfg.d_model, HEAD["proj_dim"]))
            / np.sqrt(jcfg.d_model)}
        jfrozen = jx["freeze"](kf, kparams, jx["head_cfg"])
        frozen = {k: torch.from_numpy(np.array(v)) for k, v in jfrozen.items()}
        dense = LM.from_config(arch, smoke=True, device="cpu",
                               params=params_from_numpy(
                                   jax.tree.map(np.asarray, jparams), "cpu"))
        lms = {"dense": dense}
        jlms = {"dense": jx["LM"](jparams, jcfg)}
        for be in BACKENDS:
            lms[be] = dense.with_head(SketchHead(cfg=HEAD_CFG, backend=be,
                                                 params=frozen))
            jlms[be] = jx["LM"](jparams, jcfg, jx["SketchHead"](
                cfg=jx["head_cfg"], backend=be, params=jfrozen))
        prompts = np.asarray(jax.random.randint(
            jax.random.PRNGKey(1), (3, PROMPT[arch]), 0, jcfg.vocab_size))
        cache[arch] = dict(lms=lms, jlms=jlms, prompts=prompts, jnp=jnp)
        return cache[arch]

    return get


def _jax_generate(s, backend, k, **kw):
    tokens, stats = s["jlms"][backend].generate(
        s["jnp"].asarray(s["prompts"]), GEN, spec_decode=k,
        return_stats=True, **kw)
    return np.asarray(tokens), stats


# ------------------------------------------------ generate, against JAX


@pytest.mark.parametrize("backend", BACKENDS)
def test_generate_matches_jax_spec_and_dense(served, backend):
    """rwkv6: every K gives the JAX package's spec tokens and stats, and
    the port's dense tokens, bit for bit."""
    s = served("rwkv6-1.6b")
    prompts = torch.from_numpy(s["prompts"])
    dense = s["lms"]["dense"].generate(prompts, GEN)
    np.testing.assert_array_equal(
        dense.numpy(), np.asarray(s["jlms"]["dense"].generate(
            s["jnp"].asarray(s["prompts"]), GEN)))
    for k in KS:
        got, stats = s["lms"][backend].generate(prompts, GEN, spec_decode=k,
                                                return_stats=True)
        want, jstats = _jax_generate(s, backend, k)
        assert torch.equal(got, dense), k
        np.testing.assert_array_equal(got.numpy(), want)
        assert stats == jstats, k


@pytest.mark.parametrize("k", [4, 16])
def test_gemma2_wrapped_ring_matches_jax_and_dense(served, k):
    """gemma2 smoke, prompt 12 past its 8-slot ring: every draft write
    overwrites a ring slot of the previous lap, and at K = 16 steps share
    slots; the rollback restores them, and the tokens and stats are the
    JAX package's and the dense ones."""
    s = served("gemma2-27b")
    prompts = torch.from_numpy(s["prompts"])
    dense = s["lms"]["dense"].generate(prompts, GEN)
    got, stats = s["lms"]["fused"].generate(prompts, GEN, spec_decode=k,
                                            return_stats=True)
    want, jstats = _jax_generate(s, "fused", k)
    assert torch.equal(got, dense)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats == jstats


@pytest.mark.parametrize("k", [4])
def test_deepseek_spec_matches_jax_and_dense(served, k):
    """deepseek smoke: fused drafts over the MLA latent cache (rejected
    mid-block: the latent rewound by position, the prologue's with it)
    give the JAX package's spec tokens and stats, and the port's dense
    tokens."""
    s = served("deepseek-v3-671b")
    prompts = torch.from_numpy(np.array(s["prompts"]))
    dense = s["lms"]["dense"].generate(prompts, GEN)
    got, stats = s["lms"]["fused"].generate(prompts, GEN, spec_decode=k,
                                            return_stats=True)
    want, jstats = _jax_generate(s, "fused", k)
    assert torch.equal(got, dense)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats == jstats


def test_rejection_mid_block_accounting(served):
    """The random head's drafts are rejected mid-block: real rejections,
    at least one commit a verify, the JAX package's accounting, and the
    dense tokens."""
    s = served("rwkv6-1.6b")
    prompts = torch.from_numpy(s["prompts"])
    got, stats = s["lms"]["fused"].generate(prompts, GEN, spec_decode=4,
                                            return_stats=True)
    _, jstats = _jax_generate(s, "fused", 4)
    assert stats == jstats
    assert torch.equal(got, s["lms"]["dense"].generate(prompts, GEN))
    assert stats["verify_calls"] >= 2
    assert stats["accepted_draft_tokens"] < stats["draft_tokens"]
    assert stats["verify_calls"] <= GEN - 1
    assert stats["draft_tokens"] == 3 * stats["decode_steps"]


# -------------------------------------------------- engine, against JAX


def _engine_run(lm, reqs, **kw):
    engine = lm.engine(3, 5 + GEN, **kw)
    for p, g in reqs:
        engine.submit(p, g)
    out = engine.run()
    return {r: [int(t) for t in v] for r, v in out.items()}, engine.stats


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_matches_jax_spec_and_dense(served, backend):
    """Speculative engine ticks emit the dense engine's streams, the JAX
    package's and the port's, for every K (the JAX package's own tests
    hold its spec engine to its dense one); at K = 4 the JAX package's
    spec engine gives the same tokens and the same tick stats."""
    s = served("rwkv6-1.6b")
    reqs = [(s["prompts"][i], GEN) for i in range(3)]
    base, _ = _engine_run(s["lms"]["dense"], reqs)
    assert _engine_run(s["jlms"]["dense"], reqs)[0] == base
    for k in KS:
        got, stats = _engine_run(s["lms"][backend], reqs, spec_decode=k)
        assert got == base, k
        if k == 4:
            want, jstats = _engine_run(s["jlms"][backend], reqs,
                                       spec_decode=k)
            assert want == base
            for key in ("decode_steps", "megasteps", "host_syncs",
                        "verify_calls", "draft_tokens",
                        "accepted_draft_tokens", "active_slot_steps"):
                assert stats[key] == jstats[key], key


def test_engine_spec_staggered_matches_solo_generate(served):
    """Recycled slots under speculative ticks: every request of a
    staggered, mixed-length stream emits its solo dense stream (the draft
    length is clamped by budgets and arrivals)."""
    s = served("rwkv6-1.6b")
    lm, dense = s["lms"]["ref"], s["lms"]["dense"]
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, lm.cfg.vocab_size, 4 + (i % 3), dtype=np.int32),
             3 + 2 * (i % 3), i) for i in range(5)]
    engine = lm.engine(2, 12, spec_decode=4)
    for p, g, a in reqs:
        engine.submit(p, g, arrival=a)
    finished = engine.run()
    for rid, (prompt, gen, _) in enumerate(reqs):
        solo = dense.generate(prompt[None], gen)[0, len(prompt):].tolist()
        assert finished[rid] == solo
    st = engine.stats
    assert st["verify_calls"] == st["megasteps"]
    assert st["host_syncs"] == st["megasteps"] + st["prefill_batches"]
    assert 0 <= st["accepted_draft_tokens"] < st["draft_tokens"]
    assert engine.sched.n_free == 2


# ------------------------ jamba: mamba rollback; deepseek: the MLA latent

ROLLBACK_ARCHS = ["jamba-v0.1-52b", "deepseek-v3-671b"]


@pytest.mark.parametrize("k", [4, 16])
def test_jamba_spec_rolls_back_mamba_state(served, k):
    """jamba smoke (mamba and attention layers, MoE FFNs): the random head
    rejects drafts mid-block, so every tick restores the mamba rows from
    their snapshots; the tokens are dense decode's (deepseek's MLA
    rollback: ``test_deepseek_spec_matches_jax_and_dense``)."""
    s = served("jamba-v0.1-52b")
    prompts = torch.from_numpy(np.array(s["prompts"]))
    dense = s["lms"]["dense"].generate(prompts, GEN)
    got, stats = s["lms"]["fused"].generate(prompts, GEN, spec_decode=k,
                                            return_stats=True)
    assert torch.equal(got, dense)
    assert stats["verify_calls"] >= 2
    assert stats["accepted_draft_tokens"] < stats["draft_tokens"]


@pytest.mark.parametrize("arch", ROLLBACK_ARCHS)
def test_jamba_rollback_equals_dense_steps(served, arch):
    """One speculative tick that commits m < K steps leaves the cache (the
    mamba conv and state rows, the KV and MLA caches up to the rewound
    position) bit for bit where m dense decode steps leave it."""
    from repro_torch.launch.steps import prefill_step_, serve_step_
    s = served(arch)
    lm, dense = s["lms"]["fused"], s["lms"]["dense"]
    cfg, p = lm.cfg, s["prompts"].shape[1]
    prompts = torch.from_numpy(np.array(s["prompts"]))
    with torch.inference_mode():
        cache = model.init_decode_cache(cfg, 3, p + GEN, device="cpu")
        logits, cache = prefill_step_(lm.params, prompts, cfg, cache)
        ref = model.init_decode_cache(cfg, 3, p + GEN, device="cpu")
        _, ref = prefill_step_(lm.params, prompts, cfg, ref)
        tok = logits.argmax(-1)
        loop = SpecLoop(lm.params, cfg, lm.head, cache, k=4, masked=False,
                        per_slot=False)
        loop.load(tok, p)
        block, m, _, _ = loop.run(4)
        m = int(m)
        assert m < 4, "the random head accepted every draft"
        step_tok = tok
        for i in range(m):
            lg, ref = serve_step_(dense.params, ref, step_tok[:, None], cfg,
                                  pos=p + i)
            step_tok = lg.argmax(-1)
            assert torch.equal(step_tok, block[i])
    for key, c in model.cache_stacks(loop.cache):
        kind = model.stack_kind(cfg, key)
        for got, want in zip(c, ref[key[0]][key[1]]):
            if kind == "mamba":
                assert torch.equal(got, want), key
            else:                # positions past the rewound one are masked
                assert torch.equal(got[:, :, :p + m], want[:, :, :p + m])


# ------------------------------------------------------ EOS mid-block


def test_eos_mid_block_generate(served):
    """An EOS inside a draft block retires its row there: the padded
    stream of the dense host loop, at every K."""
    s = served("rwkv6-1.6b")
    lm, dense = s["lms"]["fused"], s["lms"]["dense"]
    prompts = torch.from_numpy(s["prompts"])
    p = prompts.shape[1]
    eos = int(dense.generate(prompts, GEN)[0, p + 3])
    base = dense.generate(prompts, GEN, eos_id=eos, pad_id=0)
    assert bool((base[0, p + 4:] == 0).all())
    for k in (4, 16):
        got = lm.generate(prompts, GEN, eos_id=eos, pad_id=0, spec_decode=k)
        assert torch.equal(got, base)


def test_eos_mid_block_engine(served):
    """Engine: an EOS from the verify mid-block retires the request with
    the dense stream, its slot reset and reused."""
    s = served("rwkv6-1.6b")
    lm, dense = s["lms"]["fused"], s["lms"]["dense"]
    reqs = [(s["prompts"][i], GEN) for i in range(3)]
    eos = int(dense.generate(torch.from_numpy(s["prompts"]), GEN)[0, 5 + 3])
    base = dense.serve(reqs, n_slots=3, eos_id=eos)
    assert any(t[-1] == eos and len(t) < GEN for t in base.values())
    for k in (4, 16):
        engine = lm.engine(3, 5 + GEN, eos_id=eos, spec_decode=k)
        rids = [engine.submit(p, g) for p, g in reqs]
        got = engine.run()
        assert {r: got[r] for r in rids} == base
        assert engine.stats["admitted"] == engine.stats["retired"] == 3
        assert engine.sched.n_free == 3


# ------------------------------------------------- a dense-head draft


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "gemma2-27b",
                                  "jamba-v0.1-52b", "deepseek-v3-671b"])
@pytest.mark.parametrize("gen_len,k", [(2, 1), (7, 3), (12, 4)])
def test_dense_draft_accepts_everything(served, arch, gen_len, k):
    """With the dense head as the draft, every draft is its own verify:
    the acceptance rate is exactly 1.0, the tokens are dense decode's, and
    the verify logits equal the draft steps' logits bit for bit (the same
    (B, 1, d) unembed)."""
    s = served(arch)
    lm = s["lms"]["dense"]
    prompts = torch.from_numpy(s["prompts"][:2, :4])
    out, stats = lm.generate(prompts, gen_len, spec_decode=k,
                             return_stats=True)
    assert stats["accepted_draft_tokens"] == stats["draft_tokens"]
    assert stats["verify_calls"] == -(-(gen_len - 1) // k)
    assert torch.equal(out, lm.generate(prompts, gen_len))
    cache = model.init_decode_cache(lm.cfg, 2, 4 + gen_len, device="cpu")
    with torch.inference_mode():
        from repro_torch.launch.steps import prefill_step_
        logits, cache = prefill_step_(lm.params, prompts, lm.cfg, cache)
        loop = SpecLoop(lm.params, lm.cfg, lm.head, cache, k=k,
                        masked=False, per_slot=False, record_logits=True)
        loop.load(logits.argmax(-1), 4)
        block, m, acc, _ = loop.run(min(k, gen_len - 1))
    kk = block.shape[0]
    assert int(m) == kk and acc.tolist() == [kk, kk]
    assert torch.equal(loop.verify_logits, loop.draft_logits[:kk])


# ---------------------------------------------- the memo and its bound


def test_generate_memo_stays_bounded():
    """The fault the memo had: a loop (and its decode cache) for every
    prompt length.  Now one loop per (kind, depth, batch size, retirement
    spec), a new max_seq replacing it, at most MAX_LOOPS in all; the
    tokens stay the per-token loop's."""
    lm = LM.from_config("gemma2-27b", smoke=True, device="cpu")
    rng = np.random.default_rng(3)
    for p in (4, 9, 17):
        prompts = torch.from_numpy(rng.integers(0, 256, (2, p)))
        want = lm.generate(prompts, 8)
        assert torch.equal(lm.generate(prompts, 8, decode_chunk=4), want)
        assert torch.equal(lm.generate(prompts, 8, spec_decode=4), want)
        assert sorted(key[0] for key in lm._loops) == ["chunk", "spec"]
        for loop in lm._loops.values():      # the last max_seq replaced
            assert loop.cache["periods"]["pos1"].k.shape[2] == p + 8
    for b in (1, 3, 4, 5):
        lm.generate(torch.zeros((b, 4), dtype=torch.long), 3, decode_chunk=2)
        assert len(lm._loops) <= MAX_LOOPS
    assert len(lm._loops) == MAX_LOOPS
    assert all(loop.cache is not None for loop in lm._loops.values())


def test_generate_prefills_into_the_loops_cache():
    """``generate`` at decode_chunk > 1 writes its prefill into the loop's
    own static cache (no second cache), and the cache it leaves equals
    the per-token loop's final cache."""
    lm = LM.from_config("rwkv6-1.6b", smoke=True, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(4).integers(0, 256,
                                                                 (2, 6)))
    lm.generate(prompts, 5, decode_chunk=4)
    (loop,) = lm._loops.values()
    ptrs = [x.data_ptr() for c in loop.cache["periods"].values() for x in c]
    lm.generate(prompts, 5, decode_chunk=4)
    assert [x.data_ptr() for c in loop.cache["periods"].values()
            for x in c] == ptrs
    with torch.inference_mode():
        cache = model.init_decode_cache(lm.cfg, 2, 11, device="cpu")
        from repro_torch.launch.steps import prefill_step, prefill_step_
        want_logits, want = prefill_step(lm.params, prompts, lm.cfg, cache)
        got_logits, got = prefill_step_(lm.params, prompts, lm.cfg, cache)
    assert got is cache and torch.equal(got_logits, want_logits)
    for a, b in zip(model.cache_leaves(got), model.cache_leaves(want)):
        assert torch.equal(a, b)


# ---------------------------------------------------------- validation


def test_spec_decode_validation_surfaces():
    lm = LM.from_config("rwkv6-1.6b", smoke=True, device="cpu")
    prompts = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="mutually exclusive"):
        lm.generate(prompts, 4, spec_decode=4, decode_chunk=4)
    with pytest.raises(ValueError, match="spec_decode"):
        lm.generate(prompts, 4, spec_decode=-2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        lm.engine(2, 8, spec_decode=4, decode_chunk=4)
    with pytest.raises(ValueError, match="spec_decode"):
        lm.engine(2, 8, spec_decode=-1)
    cache = model.init_decode_cache(lm.cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="k >= 1"):
        SpecLoop(lm.params, lm.cfg, lm.head, cache, k=0, masked=False,
                 per_slot=False)
    loop = SpecLoop(lm.params, lm.cfg, lm.head, cache, k=2, masked=False,
                    per_slot=False)
    with pytest.raises(ValueError, match="k <= 2"):
        loop.run(3)
    for argv in (["--spec-decode", "2", "--decode-chunk", "2"],
                 ["--spec-decode", "-1"]):
        with pytest.raises(SystemExit):
            serve.main(["--smoke", "--device", "cpu"] + argv)


def test_serve_cli_spec_decode(capsys):
    """``--spec-decode``: the per-token loop's sample tokens, and the
    acceptance rate in the banner, for generate and the engine."""
    base = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
            "6", "--gen", "5"]
    lines = []
    for extra in ([], ["--spec-decode", "3"]):
        serve.main(base + extra)
        out = capsys.readouterr().out
        lines.append([ln for ln in out.splitlines()
                      if ln.startswith("sample token ids")])
    assert lines[0] == lines[1] and "speculative: K=3" in out
    serve.main(base + ["--engine", "--spec-decode", "3", "--stats-json"])
    out = capsys.readouterr().out
    assert "speculative: K=3" in out and '"verify_calls"' in out


# ----------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the draft step is captured as a "
                    "CUDA graph, which has no CPU mode; the eager spec loop "
                    "is tested above")
    return torch.device("cuda")


def _card_head(cfg, dev, backend):
    rng = np.random.default_rng(42)
    kp = {"points": rng.standard_normal((128, 16)),
          "alphas": rng.standard_normal((128, cfg.vocab_size)) * 0.01,
          "proj": rng.standard_normal((cfg.d_model, 16)) / np.sqrt(cfg.d_model)}
    kp = {k: torch.from_numpy(v.astype(np.float32)).to(dev)
          for k, v in kp.items()}
    return SketchHead(cfg=HEAD_CFG, backend=backend, params=freeze_head(
        torch.Generator(dev).manual_seed(42), kp, HEAD_CFG))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "gemma2-27b"])
@pytest.mark.parametrize("backend", ["fused", "two_kernel"])
def test_cuda_spec_generate_equals_dense(cuda, arch, backend):
    """On the card: spec streams equal the dense eager stream at every K,
    the draft step is a captured graph, and each draft step launches the
    head's kernels once (the capture's warm-up steps once a loop)."""
    lm = LM.from_config(arch, smoke=True, device=cuda)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, lm.cfg.vocab_size, (3, PROMPT[arch]))).to(cuda)
    want = lm.generate(prompts, GEN)
    spec = lm.with_head(_card_head(lm.cfg, cuda, backend))
    wrappers = ([fused_decode_logits] if backend == "fused"
                else [lsh_hash, sketch_head_logits])
    for k in KS:
        for w in wrappers:
            w.launches = 0
        got, stats = spec.generate(prompts, GEN, spec_decode=k,
                                   return_stats=True)
        assert torch.equal(got, want), k
        loop = next(v for key, v in spec._loops.items() if key[1] == k)
        assert loop.graph is not None
        for w in wrappers:
            assert w.launches == stats["decode_steps"] + WARMUP_STEPS, k


@pytest.mark.cuda
def test_cuda_spec_engine_equals_dense_engine(cuda):
    lm = LM.from_config("rwkv6-1.6b", smoke=True, device=cuda)
    spec = lm.with_head(_card_head(lm.cfg, cuda, "fused"))
    rng = np.random.default_rng(7)
    # Prompt lengths differ between requests that arrive on one tick, so
    # every prefill is a batch of one in both engines.
    reqs = [(rng.integers(0, lm.cfg.vocab_size, 4 + i, dtype=np.int32),
             3 + 2 * (i % 3), i) for i in range(6)]
    base = lm.serve(reqs, n_slots=2)
    engine = spec.engine(2, 16, spec_decode=4)
    for p, g, a in reqs:
        engine.submit(p, g, arrival=a)
    fused_decode_logits.launches = 0
    assert engine.run() == base
    assert fused_decode_logits.launches == (engine.stats["decode_steps"]
                                            + WARMUP_STEPS)
