"""The port's paged engine and prefix cache, on smoke configs.

The JAX package's tests/test_paging.py, mirrored on the port: the paged
engine (page-table gather, the same in-place decode step as the
contiguous engine, the commit of the written position) emits the
contiguous engine's streams bit for bit, on unique and on repeated
prompts, for gemma2-27b (a SWA ring beside global attention: two page
geometries), rwkv6-1.6b (state only, no arena), jamba-v0.1-52b (mamba
state rows beside one paged attention layer, MoE FFNs) and
deepseek-v3-671b (MLA latent arenas, a dense prologue layer's among them,
MoE FFNs); repeated prompts hit
the prefix cache and skip their prefill, and shared pages are copied
before a divergent write (COW).  Page hygiene on the device: the zero page
reads zero after traffic, and an insert leaves every other page bitwise
frozen.  Params come from the JAX package's init through
``convert.params_from_numpy``.

Against the JAX package: the paged cache ops (insert, gather, commit, the
COW copy) bit for bit on the same numpy arenas, and the host bookkeeping
(``PagePool``, ``PrefixCache``) state for state over a seeded sequence of
admissions, hits, COW forks, retirements and evictions, with
``check_invariants`` after every step (``tests/test_paging_properties.py``
needs hypothesis, which may be absent).

The ``cuda`` case runs the paged engine on the card and skips without one
(not on deepseek's smoke config: its q/k head dim of 24 is not a multiple
of 16, which the flash_attn kernel needs).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import LM, SketchHead
from repro_torch.core.sketch_lm_head import freeze_head
from repro_torch.launch import serve
from repro_torch.launch.paging import ZERO_PAGE, PagePool, PrefixCache
from repro_torch.models import model
from repro_torch.models.config import SketchHeadConfig

CUDA_ARCHS = ["gemma2-27b", "rwkv6-1.6b", "jamba-v0.1-52b"]
ARCHS = CUDA_ARCHS + ["deepseek-v3-671b"]
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
    """The JAX package's pieces these tests hold the port against."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch import paging as jpaging
    from repro.models import model as jmodel
    return dict(jax=jax, jnp=jnp, config=get_config, model=jmodel,
                paging=jpaging)


_LMS = {}


def _lm(jx, arch):
    """The port's smoke LM on the JAX package's params (key 0), on the
    CPU; one per arch for the module."""
    if arch not in _LMS:
        from repro_torch.convert import params_from_numpy
        jcfg = jx["config"](arch, smoke=True)
        jparams = jx["model"].init_model(jx["jax"].random.PRNGKey(0), jcfg)
        _LMS[arch] = LM.from_config(
            arch, smoke=True, device="cpu", params=params_from_numpy(
                jx["jax"].tree.map(np.asarray, jparams), "cpu"))
    return _LMS[arch]


@pytest.fixture(params=ARCHS)
def served(jx, request):
    return _lm(jx, request.param)


def _sketch(cfg):
    rng = np.random.default_rng(42)
    kp = {"points": rng.standard_normal((128, 16)),
          "alphas": rng.standard_normal((128, cfg.vocab_size)) * 0.01,
          "proj": rng.standard_normal((cfg.d_model, 16)) / np.sqrt(cfg.d_model)}
    kp = {k: torch.from_numpy(v.astype(np.float32)) for k, v in kp.items()}
    return SketchHead(cfg=HEAD_CFG, backend="fused", params=freeze_head(
        torch.Generator().manual_seed(42), kp, HEAD_CFG))


def _serve_both(lm, reqs, *, n_slots=4, max_seq=32, page_size=4):
    """The same trace through the contiguous and the paged engine:
    (contiguous outputs, paged outputs, contiguous engine, paged engine)."""
    outs, engines = [], []
    for paged in (False, True):
        engine = lm.engine(n_slots, max_seq, paged=paged, page_size=page_size)
        for rid, (prompt, gen, arrival) in enumerate(reqs):
            engine.submit(prompt, gen, arrival=arrival, rid=rid)
        outs.append(engine.run())
        engines.append(engine)
    return outs[0], outs[1], engines[0], engines[1]


def _unique_reqs(cfg, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, cfg.vocab_size, rng.integers(4, 12),
                          dtype=np.int32),
             int(rng.integers(2, 7)), i // 2) for i in range(n)]


def _zipf_reqs(cfg, n=12, seed=1):
    """Repeated prompts: 4 base prompts reused across the stream."""
    rng = np.random.default_rng(seed)
    base = [rng.integers(1, cfg.vocab_size, plen, dtype=np.int32)
            for plen in (5, 9, 5, 13)]
    return [(base[int(rng.integers(0, len(base)))],
             int(rng.integers(2, 7)), i // 3) for i in range(n)]


# ---------------------------------------------------- streams, bit for bit


def test_paged_matches_contiguous_unique_prompts(served):
    contiguous, paged, _, engine = _serve_both(served,
                                               _unique_reqs(served.cfg))
    assert contiguous == paged
    assert engine.stats["prefix_hits"] == 0
    assert engine.pool is None and engine.sched.n_free == 4


def test_paged_matches_contiguous_repeated_prompts(served):
    """Repeated prompts: hits restore the stored first logits, state rows
    and shared pages; the streams are the contiguous engine's, the paged
    run prefills less, and (with arenas) divergent decode writes forked
    shared pages first."""
    contiguous, paged, c_engine, engine = _serve_both(
        served, _zipf_reqs(served.cfg))
    assert contiguous == paged
    st = engine.stats
    assert 0 < st["prefix_hits"] <= st["prefix_queries"] == 12
    assert st["prefill_batches"] < c_engine.stats["prefill_batches"]
    assert 0 < st["pages_in_use"] <= st["pages_in_use_peak"]
    if any(k.startswith("attn") or k == "mla" for k in served.cfg.pattern):
        assert st["cow_copies"] > 0
    else:
        assert st["cow_copies"] == 0        # rwkv: no arena to write
    engine.page_pool.check_invariants(engine.prefix.external_refs())


def test_paged_matches_contiguous_fused_head(jx):
    lm = _lm(jx, "gemma2-27b")
    lm = lm.with_head(_sketch(lm.cfg))
    contiguous, paged, _, engine = _serve_both(lm, _zipf_reqs(lm.cfg))
    assert contiguous == paged
    assert engine.stats["prefix_hits"] > 0


def test_dedupe_identical_prompts_in_one_admission_batch(served):
    """Duplicates in one admission batch prefill once, on both pools, and
    every copy gets the solo stream."""
    cfg = served.cfg
    rng = np.random.default_rng(5)
    shared = rng.integers(1, cfg.vocab_size, 6, dtype=np.int32)
    other = rng.integers(1, cfg.vocab_size, 6, dtype=np.int32)
    for paged in (False, True):
        engine = served.engine(4, 16, paged=paged, page_size=4)
        rids = [engine.submit(p, 4) for p in (shared, shared, other, shared)]
        out = engine.run()
        assert engine.stats["dedup_saved"] == 2
        assert engine.stats["prefill_batches"] == 1
        assert out[rids[0]] == out[rids[1]] == out[rids[3]]
        assert out[rids[0]] == served.generate(shared[None], 4)[0, 6:].tolist()


# ----------------------------------------------------------- page hygiene


def _leaves(tree):
    return list(model.cache_leaves(tree))


def test_zero_page_reads_zero_after_traffic(jx):
    """After a run (allocations, COW copies, recycled pages) a gather
    through an all-unmapped table reads zeros: page 0 was never written."""
    lm = _lm(jx, "gemma2-27b")
    engine = lm.engine(4, 32, paged=True, page_size=4)
    for rid, (p, g, a) in enumerate(_zipf_reqs(lm.cfg)):
        engine.submit(p, g, arrival=a, rid=rid)
    engine.run()
    assert engine.stats["cow_copies"] > 0
    unmapped = torch.zeros_like(torch.from_numpy(engine.page_pool.table))
    view = model.paged_gather_cache(lm.cfg, engine.pages, unmapped, 32)
    assert all(not bool(x.any()) for x in _leaves(view))
    assert all(not bool(x[:, ZERO_PAGE].any()) for x in _leaves(engine.pages))


def test_paged_insert_freezes_unrelated_pages(jx):
    lm = _lm(jx, "gemma2-27b")
    cfg, num_pages, size = lm.cfg, 9, 8
    g = torch.Generator().manual_seed(1)
    pages = model.init_paged_cache(cfg, num_pages, 4, device="cpu")
    for x in _leaves(pages):
        x.copy_(torch.randn(x.shape, generator=g))
    src = model.init_decode_cache(cfg, 1, size, device="cpu")
    for x in _leaves(src):
        x.copy_(torch.randn(x.shape, generator=g))
    before = [x.clone() for x in _leaves(pages)]
    out = model.paged_insert_cache(cfg, pages, src, torch.tensor([[1, 2]]))
    assert out is pages
    for b, a in zip(before, _leaves(pages)):
        for pid in range(num_pages):
            if pid not in (1, 2):
                assert torch.equal(a[:, pid], b[:, pid]), pid
        assert not torch.equal(a[:, 1], b[:, 1])


@pytest.mark.parametrize("arch", ["gemma2-27b", "deepseek-v3-671b"])
def test_paged_ops_match_jax(jx, arch):
    """gemma2's paged ops (KV arenas, a ring among them) and deepseek's
    (MLA latent arenas, the prologue layer's one page arena of its own)
    against the JAX package's on the same numpy arenas: insert, gather
    (mapped, shared and unmapped entries), commit at ring-adjusted
    positions (one slot parked at the cache's end) and the COW copy, bit
    for bit."""
    from repro_torch.convert import decode_cache_from_numpy

    jnp, jmodel = jx["jnp"], jx["model"]
    lm = _lm(jx, arch)
    cfg, jcfg = lm.cfg, jx["config"](arch, smoke=True)
    num_pages, ps, max_seq = 12, 4, 20
    rng = np.random.default_rng(2)

    def noise(path, x):
        page0 = (0,) if path[0].key == "prologue" else (slice(None), 0)
        return jnp.asarray(rng.standard_normal(x.shape), x.dtype).at[
            page0].set(0)

    jpages = jx["jax"].tree_util.tree_map_with_path(
        noise, jmodel.init_paged_cache(jcfg, num_pages, ps))
    jsrc = jx["jax"].tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype),
        jmodel.init_decode_cache(jcfg, 2, max_seq))
    pages = decode_cache_from_numpy(
        jx["jax"].tree.map(np.asarray, jpages), "cpu")
    src = decode_cache_from_numpy(jx["jax"].tree.map(np.asarray, jsrc), "cpu")

    def same(got, want):
        for (sec, key), c in model.cache_stacks(got):
            for a, b in zip(c, want[sec][key]):
                np.testing.assert_array_equal(
                    a.view(torch.int16).numpy().reshape(np.shape(b)),
                    np.asarray(b).view(np.int16))

    pt_rows = np.asarray([[1, 2, 3, 4, 5, 0], [6, 7, 0, 0, 0, 0]], np.int32)
    jpages = jmodel.paged_insert_cache(jcfg, jpages, jsrc, jnp.asarray(pt_rows))
    model.paged_insert_cache(cfg, pages, src, torch.from_numpy(pt_rows))
    same(pages, jpages)
    table = np.asarray([[1, 2, 3, 4, 5, 0], [6, 2, 0, 0, 0, 0],
                        [0, 0, 0, 0, 0, 0]], np.int32)
    jview = jmodel.paged_gather_cache(jcfg, jpages, jnp.asarray(table),
                                      max_seq)
    view = model.paged_gather_cache(cfg, pages, torch.from_numpy(table),
                                    max_seq)
    same(view, jview)
    pos = np.asarray([13, 6, 19], np.int32)
    jview = jx["jax"].tree.map(lambda x: x + 1, jview)
    for x in _leaves(view):
        x.add_(1)
    jpages = jmodel.paged_commit_cache(jcfg, jpages, jview, jnp.asarray(table),
                                       jnp.asarray(pos), max_seq)
    model.paged_commit_cache(cfg, pages, view, torch.from_numpy(table),
                             torch.from_numpy(pos).long(), max_seq)
    same(pages, jpages)
    src_ids, dst_ids = np.asarray([2, 6]), np.asarray([8, 9])
    jpages = jmodel.paged_copy_pages(jcfg, jpages, jnp.asarray(src_ids),
                                     jnp.asarray(dst_ids))
    model.paged_copy_pages(cfg, pages, torch.from_numpy(src_ids),
                           torch.from_numpy(dst_ids))
    same(pages, jpages)


# ------------------------------------------- host bookkeeping against JAX


def _pool_state(pool, prefix):
    return (pool.refcount.tolist(), pool.table.tolist(), list(pool._free),
            pool.page_allocs, pool.peak_in_use, prefix.hits, prefix.queries,
            [(k, e.page_ids) for k, e in prefix._entries.items()])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_pool_and_prefix_cache_match_jax(jx, seed):
    """A seeded sequence of engine-like operations on both packages'
    ``PagePool``/``PrefixCache``: the same page ids, refcounts, tables,
    free lists and stats after every step, refcounts equal to the live
    references, and a numpy arena written through the tables (the device
    commit's indexing, COW before a shared write) leaves every page that
    another slot or an entry refers to unchanged."""
    jpaging = jx["paging"]
    n_slots, npp, num_pages = 4, 4, 14
    rng = np.random.default_rng(seed)
    mine = PagePool(num_pages, n_slots, npp)
    theirs = jpaging.PagePool(num_pages, n_slots, npp)
    pools = [(mine, PrefixCache(mine)), (theirs, jpaging.PrefixCache(theirs))]
    arena = np.zeros((num_pages, 4), np.int64)
    live = {}                               # slot -> prompt key
    stamp = 0
    for _ in range(300):
        op = rng.integers(0, 4)
        free = [s for s in range(n_slots) if s not in live]
        if op == 0 and free:                # admit: hit, or miss + register
            slot, key = free[0], bytes([int(rng.integers(0, 6))])
            n = int(rng.integers(1, npp + 1))
            results = []
            for pool, prefix in pools:
                entry = prefix.get(key)
                if entry is not None:
                    pool.map_slot(slot, entry.page_ids, owned=False)
                    results.append(("hit", entry.page_ids))
                    continue
                ids = pool.alloc(n)
                while ids is None and prefix.evict_lru():
                    ids = pool.alloc(n)
                if ids is None:
                    results.append(("full",))
                    continue
                pool.map_slot(slot, ids, owned=True)
                prefix.register(key, ids, None, np.zeros(1), n)
                results.append(("miss", tuple(ids)))
            assert results[0] == results[1]
            if results[0][0] != "full":
                live[slot] = key
        elif op == 1 and live:              # a decode write, COW first
            slot = sorted(live)[int(rng.integers(0, len(live)))]
            j = int(rng.integers(0, npp))
            ok = []
            for pool, prefix in pools:
                pid = int(pool.table[slot, j])
                if pid == ZERO_PAGE or pool.refcount[pid] > 1:
                    new = pool.alloc(1)
                    while new is None and prefix.evict_lru():
                        new = pool.alloc(1)
                    if new is None:
                        ok.append(False)
                        continue
                    if pid == ZERO_PAGE:
                        pool.map_index(slot, j, new[0])
                    else:
                        pool.remap(slot, j, new[0])
                        if pool is mine:
                            arena[new[0]] = arena[pid]
                ok.append(True)
            assert ok[0] == ok[1]
            if ok[0]:
                pid = int(mine.table[slot, j])
                others = {int(p) for s, row in enumerate(mine.table)
                          if s != slot for p in row}
                others |= set(pools[0][1].external_refs())
                assert pid not in others
                frozen = {p: arena[p].copy() for p in others if p}
                stamp += 1
                arena[pid] = stamp
                for p, v in frozen.items():
                    assert (arena[p] == v).all()
        elif op == 2 and live:              # retire
            slot = sorted(live)[int(rng.integers(0, len(live)))]
            for pool, _ in pools:
                pool.clear_slot(slot)
            del live[slot]
        elif op == 3:                       # evict under pressure
            assert pools[0][1].evict_lru() == pools[1][1].evict_lru()
        assert _pool_state(*pools[0]) == _pool_state(*pools[1])
        for pool, prefix in pools:
            pool.check_invariants(prefix.external_refs())
        assert not arena[ZERO_PAGE].any()


def test_zero_page_is_never_handed_out():
    pool = PagePool(4, 1, 2)
    assert sorted(pool.alloc(3)) == [1, 2, 3] and pool.alloc(1) is None
    with pytest.raises(AssertionError):
        pool.decref(ZERO_PAGE)
    with pytest.raises(ValueError, match="num_pages"):
        PagePool(1, 1, 1)


# ------------------------------------------------ configuration errors


def test_paged_excludes_megastep_and_spec_decode(jx):
    lm = _lm(jx, "rwkv6-1.6b")
    with pytest.raises(ValueError, match="paged"):
        lm.engine(2, 16, paged=True, decode_chunk=4)
    with pytest.raises(ValueError, match="paged"):
        lm.engine(2, 16, paged=True, spec_decode=2)
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--paged"])


def test_page_pool_exhaustion_raises(jx):
    """A pool below the working set fails loudly once LRU eviction has
    nothing left to reclaim, instead of sharing a page it should not."""
    lm = _lm(jx, "gemma2-27b")
    engine = lm.engine(2, 16, paged=True, page_size=4, num_pages=3)
    rng = np.random.default_rng(9)
    for i in range(2):
        engine.submit(rng.integers(1, lm.cfg.vocab_size, 8, dtype=np.int32),
                      4, rid=i)
    with pytest.raises(RuntimeError, match="page pool exhausted"):
        engine.run()


def test_serve_cli_paged(capsys):
    """``--engine --paged``: the contiguous engine's sample tokens, prefix
    hits and COW copies in the banner and in ``--stats-json``."""
    base = ["--arch", "gemma2-27b", "--smoke", "--device", "cpu", "--batch",
            "2", "--prompt-len", "6", "--gen", "8", "--engine", "--requests",
            "8", "--stats-json"]
    samples = []
    for extra in ([], ["--paged", "--page-size", "4"]):
        serve.main(base + extra)
        out = capsys.readouterr().out
        samples.append([ln for ln in out.splitlines()
                        if ln.startswith("sample token ids")])
    assert samples[0] == samples[1]
    assert "prefix hits" in out and "COW copies" in out
    assert '"prefix_hits": 1' in out and '"cow_copies"' in out


# ----------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the paged engine's CPU run is "
                    "tested above")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", CUDA_ARCHS)
def test_cuda_paged_engine_equals_contiguous(cuda, arch):
    """On the card, a trace with repeated prompts whose prefills are
    batches of one in both engines (one arrival a tick): the paged streams
    equal the contiguous ones, with prefix hits (and COW copies where
    there are arenas)."""
    lm = LM.from_config(arch, smoke=True, device=cuda)
    rng = np.random.default_rng(1)
    base = [rng.integers(1, lm.cfg.vocab_size, n, dtype=np.int32)
            for n in (5, 9, 13)]
    reqs = [(base[i % 3], 3 + i % 4, i) for i in range(9)]
    contiguous, paged, _, engine = _serve_both(lm, reqs)
    assert contiguous == paged
    assert engine.stats["prefix_hits"] > 0
    if arch == "gemma2-27b":
        assert engine.stats["cow_copies"] > 0
