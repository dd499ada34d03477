"""The port's in-place decode twins and its decode loop (megasteps).

Within the port, on smoke configs:

* The in-place twins (``decode_step_``/``serve_step_``,
  ``mask_cache_update_``, ``cache_slot_insert_``, ``cache_slot_reset_``)
  equal the functional functions bit for bit, for the rwkv, attention and
  SWA-ring kinds, with scalar and per-slot positions, and write into the
  cache they are given.
* ``generate(decode_chunk=K)`` for K in {1, 4, 16} equals K = 1 bit for
  bit, with and without ``eos_id``; the engine at ``decode_chunk=4``
  equals static ``generate``; staggered requests under chunked ticks
  equal solo ``generate`` (the JAX package's tests/test_decode_loop.py,
  mirrored).

Against the JAX package: the last-position prefill (``prefill_step``
unembeds only the last position) under the bf16 backbone rule
(``repro_torch.parity``), for every ported arch.

The ``cuda`` cases run the captured megastep on the card (its streams
equal the eager K = 1 stream, its launch counts the eager ones times the
replays; a capture that fails raises) and skip without one; the JAX
package is imported inside fixtures, so they also run where JAX is not
installed (``python -m pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import LM, HeadCache, Sampler, SketchHead
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.sketch_lm_head import freeze_head
from repro_torch.kernels.fused_decode.ops import fused_decode_logits
from repro_torch.launch import serve
from repro_torch.launch.decode_loop import (WARMUP_STEPS, DecodeLoop,
                                            decode_chunks)
from repro_torch.launch.steps import prefill_step, serve_step, serve_step_
from repro_torch.models import model
from repro_torch.models.config import SketchHeadConfig
from repro_torch.parity import assert_bf16_backbone_close

ARCHS = ["rwkv6-1.6b", "gemma2-27b"]
PLAIN_ATTN = ["granite-8b", "stablelm-12b", "command-r-35b", "musicgen-large"]
HEAD_CFG = SketchHeadConfig(n_rows=32, n_buckets=8, k=1, proj_dim=16,
                            bandwidth=2.0)
PROMPT, GEN = 12, 16          # prompt 12 > gemma2 smoke's window 8


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
    from repro.configs import get_config as jax_config
    from repro.launch.steps import prefill_step as jax_prefill
    from repro.models import model as jmodel
    return dict(jax=jax, jnp=jnp, config=jax_config, prefill=jax_prefill,
                model=jmodel)


def _frozen(cfg, seed=42, device="cpu"):
    rng = np.random.default_rng(seed)
    kp = {"points": rng.standard_normal((128, 16)),
          "alphas": rng.standard_normal((128, cfg.vocab_size)) * 0.01,
          "proj": rng.standard_normal((cfg.d_model, 16)) / np.sqrt(cfg.d_model)}
    kp = {k: torch.from_numpy(v.astype(np.float32)).to(device)
          for k, v in kp.items()}
    return freeze_head(torch.Generator(device).manual_seed(seed), kp, HEAD_CFG)


def _head(cfg, kind, device="cpu"):
    if kind == "dense":
        return None
    return SketchHead(cfg=HEAD_CFG, backend=kind,
                      params=_frozen(cfg, device=device))


@pytest.fixture(scope="module")
def lms():
    """Random smoke models of the port (seed 0), on the CPU."""
    return {a: LM.from_config(a, smoke=True, device="cpu")
            for a in ARCHS + PLAIN_ATTN}


def _served(lms, arch, kind):
    lm = lms[arch]
    head = _head(lm.cfg, kind)
    return lm if head is None else lm.with_head(head)


def _prompts(cfg, b=3, p=PROMPT, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, p)))


def _random_cache(cfg, b, max_seq, seed):
    """A decode cache filled with noise (bf16 KV, f32 rwkv state)."""
    g = torch.Generator().manual_seed(seed)
    cache = model.init_decode_cache(cfg, b, max_seq, device="cpu")
    for c in cache["periods"].values():
        for leaf in c:
            leaf.copy_(torch.randn(leaf.shape, generator=g) * 0.5)
    return cache


def _leaves(cache):
    return [leaf for c in cache["periods"].values() for leaf in c]


def _clone(cache):
    return {"periods": {n: type(c)(*(x.clone() for x in c))
                        for n, c in cache["periods"].items()}}


def _assert_same(got, want):
    for a, b in zip(_leaves(got), _leaves(want)):
        assert torch.equal(a, b)


# ------------------------------------------------ in-place twins, bitwise


@pytest.mark.parametrize("arch", ARCHS + ["granite-8b"])
@pytest.mark.parametrize("pos_kind", ["scalar", "per_slot"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["dense", "fused"])
def test_serve_step_in_place_equals_functional(lms, arch, pos_kind, masked,
                                               kind):
    """Three decode steps from a noise-filled cache (max_seq 20: gemma2's
    local ring of 8 wraps): ``serve_step_`` gives ``serve_step``'s logits
    and (masked) cache bit for bit, writes into the cache it was given and
    returns it; the functional step leaves its input unchanged."""
    lm = _served(lms, arch, kind)
    cfg, b = lm.cfg, 3
    cache = _random_cache(cfg, b, 20, seed=7)
    mine = _clone(cache)
    ptrs = [x.data_ptr() for x in _leaves(mine)]
    tok = torch.tensor([[3], [5], [7]])
    active = torch.tensor([True, False, True]) if masked else None
    for t in range(3):
        pos = (13 + t if pos_kind == "scalar"
               else torch.tensor([13 + t, 5 + t, 0 + t]))
        keep = _clone(cache)
        want, new = serve_step(lm.params, cache, tok, cfg, head=lm.head,
                               active=active, pos=pos)
        _assert_same(cache, keep)                     # never mutated
        got, out = serve_step_(lm.params, mine, tok, cfg, head=lm.head,
                               active=active, pos=pos)
        assert out is mine
        assert [x.data_ptr() for x in _leaves(mine)] == ptrs
        assert torch.equal(got, want)
        _assert_same(mine, new)
        cache, tok = new, want.argmax(-1)[:, None]


@pytest.mark.parametrize("arch", ARCHS + ["granite-8b"])
def test_decode_step_hidden_in_place_equals_functional(lms, arch):
    lm = lms[arch]
    cache = _random_cache(lm.cfg, 2, 20, seed=8)
    mine = _clone(cache)
    tok = torch.tensor([[1], [2]])
    want, new = model.decode_step(lm.params, cache, tok, lm.cfg,
                                  cache_pos=9, return_hidden=True)
    got, _ = model.decode_step_(lm.params, mine, tok, lm.cfg,
                                cache_pos=torch.tensor(9), return_hidden=True)
    assert torch.equal(got, want)
    _assert_same(mine, new)


@pytest.mark.parametrize("arch", ARCHS + ["granite-8b"])
def test_slot_ops_in_place_equal_functional(lms, arch):
    """``cache_slot_insert_``, ``cache_slot_reset_`` and
    ``mask_cache_update_`` against their functional twins, bit for bit,
    on the same tensors they were given."""
    cfg = lms[arch].cfg
    pool, src = _random_cache(cfg, 4, 10, 1), _random_cache(cfg, 2, 10, 2)
    mine = _clone(pool)
    want = model.cache_slot_insert(cfg, pool, src, [3, 1])
    assert model.cache_slot_insert_(cfg, mine, src, [3, 1]) is mine
    _assert_same(mine, want)
    want = model.cache_slot_reset(cfg, want, [0, 3])
    assert model.cache_slot_reset_(cfg, mine, [0, 3]) is mine
    _assert_same(mine, want)
    new = _random_cache(cfg, 4, 10, 3)
    active = torch.tensor([False, True, True, False])
    want = model.mask_cache_update(want, new, active)
    assert model.mask_cache_update_(mine, new, active) is mine
    _assert_same(mine, want)


def test_decode_step_in_place_needs_cache_pos(lms):
    lm = lms["gemma2-27b"]
    cache = model.init_decode_cache(lm.cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="cache_pos"):
        model.decode_step_(lm.params, cache,
                           torch.zeros((1, 1), dtype=torch.long), lm.cfg)


# --------------------------------------------- last-position prefill vs JAX


@pytest.mark.parametrize("arch", ARCHS + PLAIN_ATTN)
def test_prefill_step_last_position_matches_jax(jx, arch):
    """``prefill_step`` unembeds the last position only; its logits meet
    the bf16 backbone rule against JAX's ``prefill_step`` (which unembeds
    every position and keeps the last), on JAX's params, and against the
    port's own full forward."""
    jnp = jx["jnp"]
    jcfg, cfg = jx["config"](arch, smoke=True), get_config(arch, smoke=True)
    jparams = jx["model"].init_model(jx["jax"].random.PRNGKey(0), jcfg)
    params = params_from_numpy(jx["jax"].tree.map(np.asarray, jparams), "cpu")
    toks = _prompts(cfg, 2, 20, seed=4).numpy().astype(np.int32)
    want, _ = jx["prefill"](jparams, jnp.asarray(toks), jcfg,
                            cache=jx["model"].init_decode_cache(jcfg, 2, 24))
    got, cache = prefill_step(params, torch.from_numpy(toks), cfg,
                              model.init_decode_cache(cfg, 2, 24, "cpu"))
    assert got.shape == (2, cfg.vocab_size) and got.dtype == torch.float32
    assert_bf16_backbone_close(got.numpy(), np.asarray(want))
    full, _ = model.forward(params, torch.from_numpy(toks), cfg)
    assert_bf16_backbone_close(got.numpy(), full[:, -1].numpy())


# ------------------------------------------------ generate(decode_chunk=K)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["dense", "fused"])
@pytest.mark.parametrize("chunk", [1, 4, 16])
@pytest.mark.parametrize("eos", [False, True])
def test_generate_chunks_equal_host_loop(lms, arch, kind, chunk, eos):
    """The JAX package's test_decode_chunk_invariance: every K gives the
    K = 1 tokens bit for bit, and with ``eos_id`` (row 0 emits it at its
    third token) the same padded stream."""
    lm = _served(lms, arch, kind)
    prompts = _prompts(lm.cfg)
    free = lm.generate(prompts, GEN)
    kw = {}
    if eos:
        kw = dict(eos_id=int(free[0, PROMPT + 2]), pad_id=-1)
    want = lm.generate(prompts, GEN, **kw)
    got = lm.generate(prompts, GEN, decode_chunk=chunk, **kw)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    if eos:
        assert bool((got[0, PROMPT + 3:] == -1).all())


def test_generate_all_rows_finished_pads_at_chunk_granularity(lms):
    """Every row emits EOS at once: the remaining chunks are skipped and
    the tail is padding, as in the host loop."""
    lm = lms["rwkv6-1.6b"]
    prompts = _prompts(lm.cfg, 1)
    free = lm.generate(prompts, GEN)
    eos = int(free[0, PROMPT + 1])
    want = lm.generate(prompts, GEN, eos_id=eos, pad_id=-1)
    for chunk in (2, 4, 16):
        got = lm.generate(prompts, GEN, eos_id=eos, pad_id=-1,
                          decode_chunk=chunk)
        assert torch.equal(got, want)
    assert bool((want[0, PROMPT + 2:] == -1).all())


def test_generate_memoizes_its_loop(lms):
    """One loop per batch shape and retirement spec, whatever K; a new
    head starts a new memo."""
    lm = lms["gemma2-27b"]
    prompts = _prompts(lm.cfg)
    lm._loops.clear()
    for chunk in (4, 16, 3):
        lm.generate(prompts, GEN, decode_chunk=chunk)
    assert len(lm._loops) == 1
    lm.generate(prompts[:2], GEN, decode_chunk=4)
    lm.generate(prompts, GEN, decode_chunk=4, eos_id=5)
    assert len(lm._loops) == 3
    assert lm.with_head(_head(lm.cfg, "fused"))._loops == {}


def test_decode_chunks_without_memo_and_contract(lms):
    lm = lms["rwkv6-1.6b"]
    prompts = _prompts(lm.cfg)
    want = lm.generate(prompts, 6)[:, PROMPT:]
    cache = model.init_decode_cache(lm.cfg, 3, PROMPT + 6, device="cpu")
    with torch.inference_mode():
        logits, cache = prefill_step(lm.params, prompts, lm.cfg, cache)
        got = decode_chunks(lm.params, cache, logits, cfg=lm.cfg,
                            head=lm.head, sampler=Sampler(), gen_len=6,
                            start_pos=PROMPT, chunk=4)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="decode_chunk"):
        lm.generate(prompts, 4, decode_chunk=0)
    with pytest.raises(ValueError, match="masked"):
        DecodeLoop(lm.params, lm.cfg, lm.head, cache, masked=False, eos_id=3,
                   per_slot=False)
    loop = DecodeLoop(lm.params, lm.cfg, lm.head, cache, masked=False,
                      per_slot=False)
    assert loop.graph is None and loop.launches_per_step() == {}
    with pytest.raises(ValueError, match="k >= 1"):
        loop.run(0)


# ---------------------------------------------- the engine's megasteps


def _prompt(seed, n, vocab):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["dense", "fused"])
def test_engine_chunked_matches_static_generate(lms, arch, kind):
    lm = _served(lms, arch, kind)
    b, g = 3, 9
    prompts = np.stack([_prompt(i, PROMPT, lm.cfg.vocab_size)
                        for i in range(b)])
    want = lm.generate(prompts, g)[:, PROMPT:].tolist()
    engine = lm.engine(b, PROMPT + g, decode_chunk=4)
    rids = [engine.submit(p, g) for p in prompts]
    out = engine.run()
    assert [out[r] for r in rids] == want
    # 8 decode steps in megasteps of 4 tokens, one block fetch each.
    assert engine.stats["decode_steps"] == g - 1
    assert engine.stats["megasteps"] == engine.stats["host_syncs"] - 1 == 2


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("chunk", [4, 16])
def test_engine_staggered_chunked_matches_solo_generate(lms, arch, chunk):
    """Recycled slots, per-slot depths, EOS-free budgets of mixed length:
    under chunked ticks every request still emits its solo tokens."""
    lm = lms[arch]
    engine = lm.engine(2, 21, decode_chunk=chunk)
    stream = [(12, 6, 0), (5, 3, 0), (9, 8, 2), (12, 2, 5), (3, 9, 5)]
    reqs = [(engine.submit(_prompt(10 + i, n, lm.cfg.vocab_size), g,
                           arrival=a), n, g)
            for i, (n, g, a) in enumerate(stream)]
    out = engine.run()
    for rid, n, g in reqs:
        solo = lm.generate(_prompt(10 + rid, n, lm.cfg.vocab_size)[None],
                           g)[0, n:].tolist()
        assert out[rid] == solo
    assert engine.stats["megasteps"] < engine.stats["decode_steps"]
    assert engine.sched.n_free == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_chunked_eos_and_lm_serve(lms, arch):
    """``LM.serve(decode_chunk=4)`` equals ``decode_chunk=1``, with a
    mid-chunk EOS retiring a slot, and every retired slot ends as a fresh
    row of the one pool the engine keeps."""
    lm = lms[arch]
    reqs = [(_prompt(30 + i, 7, lm.cfg.vocab_size), 9, i) for i in range(5)]
    free = lm.serve(reqs, n_slots=2)
    eos = free[1][3]
    want = lm.serve(reqs, n_slots=2, eos_id=eos)
    assert len(want[1]) == free[1].index(eos) + 1
    assert lm.serve(reqs, n_slots=2, eos_id=eos, decode_chunk=4) == want
    engine = lm.engine(2, 16, decode_chunk=4)
    pool = engine.pool
    ptrs = [x.data_ptr() for x in _leaves(pool)]
    for p, g, a in reqs:
        engine.submit(p, g, arrival=a)
    engine.run()
    assert engine.pool is pool and [x.data_ptr() for x in _leaves(pool)] == ptrs
    _assert_same(pool, model.init_decode_cache(lm.cfg, 2, 16, device="cpu"))


def test_per_tenant_engine_chunked_matches_per_token(lms):
    """Three tenants over a capacity-2 HeadCache (evictions, bank rows
    rebound between megasteps): ``decode_chunk=4`` emits the per-token
    engine's tokens."""
    lm = lms["rwkv6-1.6b"]
    archive = {f"tenant-{t}": _frozen(lm.cfg, seed=100 + t) for t in range(3)}
    spec = lm.with_head(SketchHead(cfg=HEAD_CFG, backend="fused"))
    outs = []
    for chunk in (1, 4):
        cache = HeadCache(archive.__getitem__, 2)
        engine = spec.engine(2, 16, head_cache=cache, decode_chunk=chunk)
        for i in range(6):
            engine.submit(_prompt(40 + i, 6, lm.cfg.vocab_size), 3 + i % 4,
                          arrival=i, tenant=f"tenant-{i % 3}")
        outs.append(engine.run())
        assert cache.stats["evictions"] > 0
    assert outs[0] == outs[1]


def test_serve_cli_decode_chunk(capsys):
    """``--decode-chunk`` for generate and ``--engine``: the sample tokens
    equal the per-token loop's."""
    base = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
            "6", "--gen", "5"]
    lines = []
    for extra in ([], ["--decode-chunk", "4"]):
        serve.main(base + extra)
        out = capsys.readouterr().out
        lines.append([ln for ln in out.splitlines()
                      if ln.startswith("sample token ids")])
        assert f"decode chunk {4 if extra else 1}" in out
    assert lines[0] == lines[1] and len(lines[0]) == 1
    serve.main(base + ["--engine", "--decode-chunk", "4", "--stats-json"])
    out = capsys.readouterr().out
    assert "(chunk 4)" in out and '"megasteps"' in out
    with pytest.raises(SystemExit):
        serve.main(base + ["--decode-chunk", "0"])


# ----------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured decode step is a CUDA "
                    "graph, which has no CPU mode; the eager loop is tested "
                    "above")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["dense", "fused"])
def test_cuda_megastep_equals_eager(cuda, arch, kind):
    """K in {1, 4, 16}: the replayed graph's stream equals the eager K = 1
    loop's, and the kernel wrappers' counts equal the eager ones (one
    fused_decode a step), recorded at the capture and added per replay.
    The capture's warm-up steps launch too: WARMUP_STEPS more, once."""
    lm = LM.from_config(arch, smoke=True, device=cuda)
    head = _head(lm.cfg, kind, device=cuda)
    if head is not None:
        lm = lm.with_head(head)
    prompts = _prompts(lm.cfg).to(cuda)
    fused_decode_logits.launches = 0
    want = lm.generate(prompts, GEN)
    first = True
    eager = fused_decode_logits.launches
    assert eager == (GEN - 1 if kind == "fused" else 0)
    for chunk in (16, 1, 4, 16):
        with torch.inference_mode():
            cache = model.init_decode_cache(lm.cfg, 3, PROMPT + GEN,
                                            device=cuda)
            logits, cache = prefill_step(lm.params, prompts, lm.cfg, cache)
            fused_decode_logits.launches = 0
            got = decode_chunks(lm.params, cache, logits, cfg=lm.cfg,
                                head=lm.head, sampler=Sampler(),
                                gen_len=GEN, start_pos=PROMPT, chunk=chunk,
                                loops=lm._loops)
        assert torch.equal(got, want[:, PROMPT:]), chunk
        warm = WARMUP_STEPS * (eager // (GEN - 1)) if first else 0
        assert fused_decode_logits.launches == eager + warm, chunk
        first = False
    (loop,) = lm._loops.values()
    assert loop.graph is not None
    assert loop.launches_per_step() == (
        {"fused_decode_logits": 1} if kind == "fused" else {})


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_engine_megastep_equals_per_token(cuda, arch):
    lm = LM.from_config(arch, smoke=True, device=cuda)
    lm = lm.with_head(_head(lm.cfg, "fused", device=cuda))
    reqs = [(_prompt(50 + i, 7, lm.cfg.vocab_size), 3 + 2 * i, i)
            for i in range(6)]
    outs, launches = [], []
    for chunk in (1, 4):
        engine = lm.engine(2, 20, decode_chunk=chunk)
        for p, g, a in reqs:
            engine.submit(p, g, arrival=a)
        fused_decode_logits.launches = 0
        outs.append(engine.run())
        launches.append((fused_decode_logits.launches,
                         engine.stats["decode_steps"]))
    assert outs[0] == outs[1]
    # One fused_decode a decode step; the megastep engine's one capture
    # warms its step up WARMUP_STEPS times first.
    assert launches[0][0] == launches[0][1] == launches[1][1]
    assert launches[1][0] == launches[1][1] + WARMUP_STEPS


_SYNCING_CAPTURE = """
import torch
from repro_torch.api import LM
from repro_torch.launch.decode_loop import DecodeLoop
from repro_torch.models import model


class SyncingHead:
    needs_hidden = True
    params = None

    def apply(self, params, hidden):
        hidden.sum().item()                      # a host sync
        return hidden[:, :1].float()


lm = LM.from_config("rwkv6-1.6b", smoke=True, device="cuda")
cache = model.init_decode_cache(lm.cfg, 2, 8, device="cuda")
try:
    DecodeLoop(lm.params, lm.cfg, SyncingHead(), cache, masked=False,
               per_slot=False)
except RuntimeError as e:
    print("capture raised:", str(e).splitlines()[0])
else:
    print("captured")
"""


@pytest.mark.cuda
def test_cuda_failed_capture_raises(cuda):
    """A step that syncs with the host cannot be captured: the loop raises
    and never runs it eagerly instead.  In a process of its own: a failed
    capture leaves PyTorch's CUDA generator in its capture state."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", _SYNCING_CAPTURE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "capture raised:" in out.stdout, out.stdout


@pytest.mark.parametrize("chunk", [1, 4])
def test_engine_slot_past_its_cache_end_stays_parked(lms, chunk):
    """A request that uses its whole budget (prompt + max_new_tokens =
    max_seq + 1) leaves its slot one past the cache's end; while the slot is
    parked the other slot decodes on, and both streams equal solo runs."""
    lm = lms["gemma2-27b"]
    engine = lm.engine(2, 10, decode_chunk=chunk)
    a, b = _prompt(60, 6, lm.cfg.vocab_size), _prompt(61, 4, lm.cfg.vocab_size)
    ra, rb = engine.submit(a, 5), engine.submit(b, 7)
    out = engine.run()
    assert out[ra] == lm.generate(a[None], 5)[0, 6:].tolist()
    assert out[rb] == lm.generate(b[None], 7)[0, 4:].tolist()
