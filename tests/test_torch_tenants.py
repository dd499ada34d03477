"""Per-tenant sketch heads and online refresh in the port, against the JAX
package and mirroring tests/test_tenants.py.

Against the JAX package, on the same numpy inputs (heads frozen by the JAX
package and carried across as arrays): ``stack_heads`` and
``select_tenant_rows`` bit for bit; ``apply_head(tenant_ids=…)`` on all
three backends under ``repro_torch.parity``'s rules; ``refresh_head``
(``alphas=`` and ``targets=``) with its hash indices under the boundary
rule and its counts within ``race_update_tol`` of the JAX package's
``race_update_ref`` applied to the port's own indices; and ``HeadCache``
against the JAX ``HeadCache`` on the same hypothesis operation sequences.

Within the port: a per-tenant engine emits, for every request, the
stream of a single-tenant engine bound to that request's head; eviction
and reload are invisible; refreshes change nothing a decode reads until
``publish``; a quantized refresh then publish tracks an offline
re-freeze.  The ``cuda`` case counts the per-tenant engine's launches on
the card and skips without one; the JAX package is imported inside
fixtures, so that case also runs where JAX is not installed
(``python -m pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from hypothesis import given, settings, strategies as st

from repro_torch.api import LM, HeadCache, SketchHead
from repro_torch.convert import params_from_numpy
from repro_torch.core import sketch_lm_head as head_mod
from repro_torch.kernels.common import select_tenant_rows
from repro_torch.kernels.lsh_hash.ops import lsh_hash_ref
from repro_torch.kernels.sketch_head.ops import (dequantize_sketch_ref,
                                                 sketch_head_ref)
from repro_torch.parity import (check_hash_indices, gather_atol,
                                race_update_tol)

ARCH = "rwkv6-1.6b"
HEAD = dict(n_rows=32, n_buckets=8, k=1, proj_dim=16, bandwidth=2.0)
CFG = head_mod.SketchHeadConfig(**HEAD)
QUANTS = [None, "int8", "int4"]
BACKENDS = ["fused", "two_kernel", "ref"]


def _kernel_params(seed, d, v, m=128):
    rng = np.random.default_rng(seed)
    return {"points": rng.standard_normal((m, CFG.proj_dim)).astype(np.float32),
            "alphas": (rng.standard_normal((m, v)) * 0.01).astype(np.float32),
            "proj": (rng.standard_normal((d, CFG.proj_dim))
                     / np.sqrt(d)).astype(np.float32)}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces these tests hold the port against."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.api import HeadCache as JaxHeadCache
    from repro.configs import get_config
    from repro.core import sketch_lm_head as jhead
    from repro.kernels import common as jcommon
    from repro.kernels.race_update.ref import race_update_ref
    from repro.models import model as jmodel
    from repro.models.config import SketchHeadConfig
    return dict(jax=jax, jnp=jnp, HeadCache=JaxHeadCache, config=get_config,
                head=jhead, common=jcommon, race_ref=race_update_ref,
                model=jmodel, cfg=SketchHeadConfig(**HEAD))


def _jax_head(jx, seed, kp, quant=None):
    """A head frozen by the JAX package, as numpy arrays."""
    head = jx["head"].freeze_head(
        jx["jax"].random.PRNGKey(seed),
        {k: jx["jnp"].asarray(v) for k, v in kp.items()}, jx["cfg"],
        quant=quant)
    return {k: np.asarray(v) for k, v in head.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _port_tenants(d, v, n, quant=None):
    """Per-tenant heads frozen by the port: the same anchors, one hash bank
    per tenant from its own generator."""
    kp = {k: torch.from_numpy(a) for k, a in _kernel_params(3, d, v).items()}
    return {f"tenant-{t}": head_mod.freeze_head(
        torch.Generator().manual_seed(100 + t), kp, CFG, quant=quant)
        for t in range(n)}


def _hidden(seed, b, d):
    return np.random.default_rng(seed).standard_normal((b, d)).astype(np.float32)


def _check_rows(jx, got, want, head, hidden, quant):
    """parity's rules for one head's rows: the two packages' indices under
    the boundary rule, then logits within the gather bound against the
    plain gather at the port's indices, and against JAX where the indices
    agree."""
    h = torch.from_numpy(hidden)
    ours = lsh_hash_ref(h @ head["proj"], head["w"], head["b"], CFG.bandwidth,
                        CFG.n_buckets)
    theirs = jx["head"].lsh_hash(
        jx["jnp"].asarray(hidden) @ head["proj"].numpy(), head["w"].numpy(),
        head["b"].numpy(), bandwidth=CFG.bandwidth, n_buckets=CFG.n_buckets,
        backend="ref")
    check_hash_indices(ours, torch.from_numpy(np.array(theirs)), h,
                       head["w"], head["b"], CFG.bandwidth, proj=head["proj"])
    deq = (head["array"] if quant is None
           else dequantize_sketch_ref(head["array"], head["scale"], quant))
    atol = gather_atol(CFG.n_rows, float(deq.abs().max()))
    torch.testing.assert_close(
        got, sketch_head_ref(head["array"], ours, head.get("scale"), quant),
        rtol=0, atol=atol)
    same = (ours.numpy() == np.asarray(theirs)).all(axis=1)
    np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same],
                               rtol=0, atol=atol)


# ------------------------------------------------- bank ops against JAX

@pytest.mark.parametrize("quant", QUANTS)
def test_stack_heads_matches_jax(jx, quant):
    kp = _kernel_params(1, 24, 64)
    heads = [_jax_head(jx, 7 + t, kp, quant) for t in range(3)]
    got = head_mod.stack_heads([_t(h) for h in heads])
    want = jx["head"].stack_heads(heads)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="different leaves"):
        head_mod.stack_heads([_t(heads[0]), _t(_jax_head(jx, 9, kp, "int8"
                                                         if quant is None
                                                         else None))])


def test_select_tenant_rows_matches_jax(jx):
    rng = np.random.default_rng(0)
    per_tenant = rng.standard_normal((3, 7, 11)).astype(np.float32)
    ids = rng.integers(0, 3, 7).astype(np.int32)
    got = select_tenant_rows(torch.from_numpy(per_tenant), torch.from_numpy(ids))
    want = jx["common"].select_tenant_rows(jx["jnp"].asarray(per_tenant),
                                           jx["jnp"].asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("quant", QUANTS)
def test_apply_head_tenants_matches_jax(jx, backend, quant):
    """Each row through its own tenant's bank row: against JAX's per-tenant
    apply under parity's rules, and bitwise the port's single-tenant apply
    of that tenant's head."""
    d, v = 24, 64
    kp = _kernel_params(2, d, v)
    heads = [_jax_head(jx, 11 + t, kp, quant) for t in range(3)]
    bank = head_mod.stack_heads([_t(h) for h in heads])
    ids = np.asarray([2, 0, 1, 0, 2, 2], np.int32)
    hidden = _hidden(4, len(ids), d)
    got = head_mod.apply_head(bank, torch.from_numpy(hidden), CFG,
                              backend=backend, quant=quant,
                              tenant_ids=torch.from_numpy(ids))
    jnp = jx["jnp"]
    want = jx["head"].apply_head(jx["head"].stack_heads(heads),
                                 jnp.asarray(hidden), jx["cfg"],
                                 backend=backend, quant=quant,
                                 tenant_ids=jnp.asarray(ids))
    assert got.shape == (len(ids), v) and got.dtype == torch.float32
    for t, head in enumerate(heads):
        rows = ids == t
        head = _t(head)
        _check_rows(jx, got[rows], np.asarray(want)[rows], head,
                    hidden[rows], quant)
        solo = head_mod.apply_head(head, torch.from_numpy(hidden), CFG,
                                   backend=backend, quant=quant)
        assert torch.equal(got[rows], solo[rows])


# ------------------------------------------------- refresh against JAX

@pytest.mark.parametrize("mode", ["alphas", "targets"])
def test_refresh_head_matches_jax(jx, mode):
    """The fold's indices under the boundary rule, its residual weights
    against JAX's ref head under the gather bound, and its counts within
    ``race_update_tol`` of JAX's race_update_ref at the port's own indices
    and weights; the other leaves are the input's."""
    d, v, m, lr = 24, 64, 40, 0.5
    jhead, jnp = jx["head"], jx["jnp"]
    head_np = _jax_head(jx, 7, _kernel_params(1, d, v, m=48))
    head = _t(head_np)
    hidden = _hidden(2, m, d)
    rng = np.random.default_rng(5)
    extra = (rng.standard_normal((m, v)) * (0.05 if mode == "alphas" else 1.0)
             ).astype(np.float32)
    kw = {mode: torch.from_numpy(extra)}
    got = head_mod.refresh_head(head, CFG, torch.from_numpy(hidden), lr=lr,
                                **kw)
    want = jhead.refresh_head(head_np, jx["cfg"], jnp.asarray(hidden), lr=lr,
                              **{mode: jnp.asarray(extra)})
    for k in ("proj", "w", "b"):
        assert got[k] is head[k]
        np.testing.assert_array_equal(np.asarray(want[k]), head_np[k])

    h = torch.from_numpy(hidden)
    idx = lsh_hash_ref(h @ head["proj"], head["w"], head["b"], CFG.bandwidth,
                       CFG.n_buckets)
    jidx = jhead.lsh_hash(jnp.asarray(hidden) @ head_np["proj"], head_np["w"],
                          head_np["b"], bandwidth=CFG.bandwidth,
                          n_buckets=CFG.n_buckets, backend="pallas")
    check_hash_indices(idx, torch.from_numpy(np.array(jidx)), h, head["w"],
                       head["b"], CFG.bandwidth, proj=head["proj"])
    if mode == "alphas":
        alphas = torch.from_numpy(extra)
    else:
        pred = head_mod.apply_head(head, h, CFG, backend="ref")
        jpred = jhead.apply_head(head_np, jnp.asarray(hidden), jx["cfg"],
                                 backend="ref")
        _check_rows(jx, pred, np.asarray(jpred), head, hidden, None)
        alphas = lr * (torch.from_numpy(extra) - pred)
    ref = jx["race_ref"](jnp.moveaxis(jnp.asarray(head_np["array"]), -1, 0),
                    jnp.asarray(idx.numpy()), jnp.asarray(alphas.numpy()))
    ref = np.moveaxis(np.asarray(ref), 0, -1)
    tol = race_update_tol(head["array"], alphas, -1).numpy()
    assert (np.abs(got["array"].numpy().astype(np.float64) - ref) <= tol).all()
    if (idx.numpy() == np.asarray(jidx)).all():
        dev = np.abs(got["array"].numpy() - np.asarray(want["array"]))
        if mode == "alphas":
            assert (dev <= tol).all()
        else:        # plus M terms of the residual's gather bound, times lr
            bound = gather_atol(CFG.n_rows, float(np.abs(head_np["array"]).max()))
            assert (dev <= tol + m * lr * bound).all()


def test_refresh_alphas_matches_freeze_over_augmented_anchors():
    """The streaming fold is freeze_head over the augmented anchors: the
    same hash bank, counts equal up to f32 summation order."""
    d, v = 24, 64
    kp = {k: torch.from_numpy(a) for k, a in _kernel_params(1, d, v, m=48).items()}
    head0 = head_mod.freeze_head(torch.Generator().manual_seed(7), kp, CFG)
    hidden = torch.from_numpy(_hidden(2, 16, d))
    new = torch.from_numpy(np.random.default_rng(4).standard_normal((16, v))
                           .astype(np.float32) * 0.05)
    incremental = head_mod.refresh_head(head0, CFG, hidden, alphas=new)
    augmented = head_mod.freeze_head(torch.Generator().manual_seed(7), {
        "points": torch.cat([kp["points"], hidden @ kp["proj"]]),
        "alphas": torch.cat([kp["alphas"], new]), "proj": kp["proj"]}, CFG)
    for k in ("proj", "w", "b"):
        assert torch.equal(incremental[k], augmented[k])
    np.testing.assert_allclose(incremental["array"].numpy(),
                               augmented["array"].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_refresh_targets_is_the_residual_fold(jx):
    d, v = 24, 64
    head0 = _t(_jax_head(jx, 7, _kernel_params(1, d, v, m=48)))
    hidden = torch.from_numpy(_hidden(2, 8, d))
    targets = torch.from_numpy(_hidden(5, 8, v))
    pred = head_mod.apply_head(head0, hidden, CFG, backend="ref")
    via_targets = head_mod.refresh_head(head0, CFG, hidden, targets=targets,
                                        lr=0.5)
    via_alphas = head_mod.refresh_head(head0, CFG, hidden,
                                       alphas=0.5 * (targets - pred))
    assert torch.equal(via_targets["array"], via_alphas["array"])


def test_refresh_in_place_into_out(jx):
    d, v = 24, 64
    head0 = _t(_jax_head(jx, 7, _kernel_params(1, d, v, m=48)))
    hidden = torch.from_numpy(_hidden(2, 8, d))
    alphas = torch.from_numpy(_hidden(6, 8, v))
    want = head_mod.refresh_head(head0, CFG, hidden, alphas=alphas)
    shadow = {k: t.clone() for k, t in head0.items()}
    got = head_mod.refresh_head(shadow, CFG, hidden, alphas=alphas,
                                out=shadow["array"])
    assert got["array"] is shadow["array"]
    assert torch.equal(shadow["array"], want["array"])
    assert not torch.equal(head0["array"], want["array"])


def test_refresh_rejects_quantized_working_copy(jx):
    d, v = 24, 64
    head_q = _t(_jax_head(jx, 7, _kernel_params(1, d, v, m=48), "int8"))
    hidden = torch.from_numpy(_hidden(2, 4, d))
    with pytest.raises(ValueError, match="dequantize the head first"):
        head_mod.refresh_head(head_q, CFG, hidden, alphas=torch.zeros(4, v))
    with pytest.raises(ValueError, match="exactly one of"):
        head_mod.refresh_head(head_mod.dequantize_head(head_q, "int8"), CFG,
                              hidden)


# --------------------------------------------- HeadCache against JAX

def _cache_loader(np_side):
    def load(tenant):
        t = int(tenant.split("-")[1])
        arrays = {"array": np.full((2, 3), t, np.float32),
                  "w": np.full((4,), 10 * t, np.float32)}
        return arrays if np_side else _t(arrays)
    return load


_ops = st.lists(st.tuples(st.sampled_from(["acquire", "release", "publish"]),
                          st.integers(0, 5)), max_size=60)


@given(ops=_ops, capacity=st.integers(1, 4))
@settings(max_examples=60, deadline=None)
def test_head_cache_matches_jax(jx, ops, capacity):
    """The same operations on both caches: the same results and errors,
    residency in the same LRU order, the same stats, and every resident
    row holding its own tenant's params."""
    ours = HeadCache(_cache_loader(False), capacity)
    theirs = jx["HeadCache"](_cache_loader(True), capacity)
    for kind, i in ops:
        t = f"tenant-{i}"
        results = []
        for cache, np_side in ((ours, False), (theirs, True)):
            args = (t,) if kind != "publish" else (t, _cache_loader(np_side)(t))
            try:
                results.append(getattr(cache, kind)(*args))
            except (RuntimeError, ValueError, KeyError) as e:
                results.append(type(e))
        assert results[0] == results[1], (kind, t, results)
        assert ours.resident() == theirs.resident()
        assert ours.stats == theirs.stats
        for r in ours.resident():
            assert ours.slot(r) == theirs.slot(r)
            mine = ours.tenant_params(r)
            for k, v in theirs.tenant_params(r).items():
                np.testing.assert_array_equal(mine[k].numpy(), np.asarray(v))


def test_tenant_params_are_clones():
    """What tenant_params returns is not the bank: a later publish or an
    eviction into the same row leaves it as it was."""
    cache = HeadCache(_cache_loader(False), 1)
    cache.acquire("tenant-1")
    held = cache.tenant_params("tenant-1")
    cache.publish("tenant-1", _cache_loader(False)("tenant-3"))
    assert bool((held["array"] == 1).all())
    cache.release("tenant-1")
    cache.acquire("tenant-2")                       # evicts into row 0
    assert bool((held["array"] == 1).all())
    bank = cache.bank_params([0])
    assert bool((bank["array"][0] == 2).all()) and bank["tenant_ids"].dtype == torch.int32


# --------------------------------------------- per-tenant engine

@pytest.fixture(scope="module")
def served(jx):
    jcfg = jx["config"](ARCH, smoke=True)
    jparams = jx["model"].init_model(jx["jax"].random.PRNGKey(0), jcfg)
    params = params_from_numpy(jx["jax"].tree.map(np.asarray, jparams), "cpu")
    lm = LM.from_config(ARCH, smoke=True, device="cpu", params=params)
    return lm, _port_tenants(lm.cfg.d_model, lm.cfg.vocab_size, 3)


def _requests(cfg, n, plen=5):
    return [np.random.default_rng(20 + i).integers(0, cfg.vocab_size, plen)
            .astype(np.int32) for i in range(n)]


def _run_multi(lm, archive, reqs, tenants, *, backend, quant=None,
               capacity=None, n_slots=None, gen=4):
    cache = HeadCache(archive.__getitem__, capacity or len(archive))
    engine = lm.with_head(SketchHead(cfg=CFG, backend=backend, quant=quant)
                          ).engine(n_slots or len(reqs), len(reqs[0]) + gen,
                                   head_cache=cache)
    rids = [engine.submit(p, gen, tenant=t) for p, t in zip(reqs, tenants)]
    return engine.run(), rids, cache


def _run_single(lm, head_params, reqs, *, backend, quant=None, n_slots=None,
                gen=4):
    head = SketchHead(cfg=CFG, backend=backend, quant=quant, params=head_params)
    engine = lm.with_head(head).engine(n_slots or len(reqs),
                                       len(reqs[0]) + gen)
    rids = [engine.submit(p, gen) for p in reqs]
    return engine.run(), rids


@pytest.mark.parametrize("backend", BACKENDS)
def test_multi_tenant_matches_single_tenant(served, backend):
    lm, archive = served
    reqs = _requests(lm.cfg, 3)
    tenants = [f"tenant-{t}" for t in range(3)]
    multi, rids, cache = _run_multi(lm, archive, reqs, tenants, backend=backend)
    assert cache.stats["loads"] == 3 and cache.stats["evictions"] == 0
    for t, tenant in enumerate(tenants):
        solo, solo_rids = _run_single(lm, archive[tenant], reqs, backend=backend)
        assert multi[rids[t]] == solo[solo_rids[t]], (backend, tenant)


def test_eviction_and_reload_are_bitwise_transparent(served):
    lm, archive = served
    reqs = _requests(lm.cfg, 6)
    tenants = [f"tenant-{i % 3}" for i in range(6)]
    multi, rids, cache = _run_multi(lm, archive, reqs, tenants,
                                    backend="fused", capacity=1, n_slots=1)
    assert cache.stats["loads"] == 6 and cache.stats["evictions"] == 5
    for t in range(3):
        mine = [i for i in range(6) if tenants[i] == f"tenant-{t}"]
        solo, solo_rids = _run_single(lm, archive[f"tenant-{t}"],
                                      [reqs[i] for i in mine],
                                      backend="fused", n_slots=1)
        for j, i in enumerate(mine):
            assert multi[rids[i]] == solo[solo_rids[j]]


def test_inflight_decodes_unchanged_until_publish(served):
    """The double buffer on an f32 bank: the refresh folds into a clone of
    the bank row, so the bank row and every decode stay bitwise unchanged
    until publish; after it, new decodes serve the folded head exactly as
    a fresh engine loading it would."""
    lm, archive = served
    reqs = _requests(lm.cfg, 1)
    gen = 8
    baseline, rids, _ = _run_multi(lm, archive, reqs, ["tenant-0"],
                                   backend="fused", gen=gen)
    cache = HeadCache(archive.__getitem__, 1)
    engine = lm.with_head(SketchHead(cfg=CFG, backend="fused")).engine(
        1, len(reqs[0]) + gen, head_cache=cache)
    rid = engine.submit(reqs[0], gen, tenant="tenant-0")
    engine.step()
    engine.step()
    row = cache.tenant_params("tenant-0")
    hidden = torch.from_numpy(_hidden(9, 32, lm.cfg.d_model))
    alphas = torch.from_numpy(_hidden(11, 32, lm.cfg.vocab_size))
    engine.refresh("tenant-0", hidden, alphas=alphas)
    shadow = engine.pending_refresh("tenant-0")
    assert all(shadow[k].data_ptr() != v.data_ptr()
               for k, v in cache.bank_params([0]).items() if k in shadow)
    out = engine.run()
    assert out[rid] == baseline[rids[0]]
    for k, v in cache.tenant_params("tenant-0").items():
        assert torch.equal(v, row[k])
        assert torch.equal(v, archive["tenant-0"][k])

    engine.publish("tenant-0")
    published = cache.tenant_params("tenant-0")
    assert not torch.equal(published["array"], archive["tenant-0"]["array"])
    rid2 = engine.submit(reqs[0], gen, tenant="tenant-0")
    after = engine.run()
    fresh, fresh_rids, _ = _run_multi(lm, {"tenant-0": published}, reqs,
                                      ["tenant-0"], backend="fused", gen=gen)
    assert after[rid2] == fresh[fresh_rids[0]]
    assert engine.stats["refreshes"] == 1 and engine.stats["publishes"] == 1


def test_quantized_refresh_publish_matches_offline_refreeze(served):
    """An int8 bank: dequantize into the f32 shadow, fold, re-quantize on
    publish; the published head tracks re-freezing the augmented anchors
    with quant="int8" (tests/test_tenants.py's thresholds)."""
    lm, _ = served
    cfg = lm.cfg
    kp = {k: torch.from_numpy(a)
          for k, a in _kernel_params(3, cfg.d_model, cfg.vocab_size).items()}
    archive = {"tenant-0": head_mod.freeze_head(
        torch.Generator().manual_seed(100), kp, CFG, quant="int8")}
    cache = HeadCache(archive.__getitem__, 1)
    engine = lm.with_head(SketchHead(cfg=CFG, backend="fused", quant="int8")
                          ).engine(1, 16, head_cache=cache)
    engine.submit(_requests(cfg, 1)[0], 2, tenant="tenant-0")
    engine.run()
    hidden = torch.from_numpy(_hidden(9, 24, cfg.d_model))
    alphas = torch.from_numpy(_hidden(11, 24, cfg.vocab_size) * 0.01)
    engine.refresh("tenant-0", hidden, alphas=alphas)
    engine.publish("tenant-0")
    published = cache.tenant_params("tenant-0")
    offline = head_mod.freeze_head(torch.Generator().manual_seed(100), {
        "points": torch.cat([kp["points"], hidden @ kp["proj"]]),
        "alphas": torch.cat([kp["alphas"], alphas]), "proj": kp["proj"]},
        CFG, quant="int8")
    probe = torch.from_numpy(_hidden(13, 32, cfg.d_model))
    got = head_mod.apply_head(published, probe, CFG, backend="ref",
                              quant="int8").numpy()
    want = head_mod.apply_head(offline, probe, CFG, backend="ref",
                               quant="int8").numpy()
    assert np.mean(np.abs(got - want)) < 2e-3, np.mean(np.abs(got - want))
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.9


def test_refresh_requires_per_tenant_engine(served):
    lm, archive = served
    engine = lm.with_head(SketchHead(cfg=CFG, params=archive["tenant-0"])
                          ).engine(1, 16)
    with pytest.raises(ValueError, match="per-tenant engine"):
        engine.refresh("tenant-0", torch.zeros(1, lm.cfg.d_model),
                       alphas=torch.zeros(1, lm.cfg.vocab_size))
    per_tenant = lm.with_head(SketchHead(cfg=CFG)).engine(
        1, 16, head_cache=HeadCache(archive.__getitem__, 1))
    with pytest.raises(ValueError, match="no pending refresh"):
        per_tenant.publish("tenant-0")
    with pytest.raises(ValueError, match="every submit needs tenant="):
        per_tenant.submit([1, 2], 2)
    with pytest.raises(ValueError, match="SketchHead spec"):
        lm.engine(1, 16, head_cache=HeadCache(archive.__getitem__, 1))


def test_per_tenant_head_describes_itself(served):
    lm, archive = served
    engine = lm.with_head(SketchHead(cfg=CFG, quant="int8")).engine(
        1, 16, head_cache=HeadCache(archive.__getitem__, 1))
    assert engine.backend.head.describe() == "sketch/fused/int8/tenants"
    with pytest.raises(ValueError, match="tenant_ids"):
        engine.backend.head.apply({"w": archive["tenant-0"]["w"]},
                                  torch.zeros(1, lm.cfg.d_model))


# ----------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: per-tenant decode launches the "
                    "CUDA kernels once per bank row")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_per_tenant_engine_launches(cuda):
    """fused_decode runs once per bank row per tick; a refresh launches
    lsh_hash and race_update once each."""
    from repro_torch.kernels.fused_decode.ops import fused_decode_logits
    from repro_torch.kernels.lsh_hash.ops import lsh_hash
    from repro_torch.kernels.race_update.ops import race_update

    lm = LM.from_config(ARCH, smoke=True, device=cuda)
    archive = {k: {n: t.to(cuda) for n, t in h.items()} for k, h in
               _port_tenants(lm.cfg.d_model, lm.cfg.vocab_size, 3).items()}
    cache = HeadCache(archive.__getitem__, 2)
    engine = lm.with_head(SketchHead(cfg=CFG)).engine(2, 12, head_cache=cache)
    for i, req in enumerate(_requests(lm.cfg, 6)):
        engine.submit(req, 4, arrival=i, tenant=f"tenant-{i % 3}")
    fused_decode_logits.launches = 0
    engine.run()
    assert fused_decode_logits.launches == 2 * engine.stats["decode_steps"]
    assert cache.stats["evictions"] > 0
    lsh_hash.launches = race_update.launches = 0
    hidden = torch.randn(16, lm.cfg.d_model, device=cuda)
    engine.refresh("tenant-0" if "tenant-0" in cache.resident()
                   else cache.resident()[0], hidden,
                   alphas=torch.randn(16, lm.cfg.vocab_size, device=cuda))
    assert lsh_hash.launches == 1 and race_update.launches == 1
