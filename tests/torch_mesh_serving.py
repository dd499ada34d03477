"""The sharded-serving scenarios of ``test_torch_sharded_serving*.py``.

Each rank of a 2×2 gloo mesh (``tests/torch_mesh.py`` spawns them) runs
:func:`serving_ranks` or :func:`spec_ranks` (the paged engine, speculative
decode, quantized streams: a spawn of its own, so that no test file of the
run outgrows its time) for one smoke arch: together the twins of every case of
``tests/test_sharded_serving.py`` (the JAX package's 4×2 forced-CPU mesh;
4 ranks is what fits beside the test run's other workers on an 8-core
machine), each through the port's normal entry points (``LM.with_mesh``,
``generate``, ``serve``, ``engine``, ``apply_head`` on placed params).  Rank 0
returns every result as numpy values and the test files assert on them;
values that differ per rank (local shapes) are gathered from every rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api import LM, HeadCache, Sampler, SketchHead
from repro_torch.core.sketch_lm_head import (apply_head, freeze_head,
                                             quantize_head)
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models.config import SketchHeadConfig
from repro_torch.sharding.ctx import replicated, serving
from repro_torch.sharding.local import spec_of
from repro_torch.sharding.rules import (cache_shardings, to_placements,
                                        tree_paths)

HEAD_CFG = SketchHeadConfig(n_rows=32, n_buckets=8, k=1, proj_dim=16,
                            bandwidth=2.0)


def head_params(d_model: int, vocab: int, seed: int = 42) -> dict:
    """A frozen head of random kernel params (numpy seed ``seed``)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    kparams = {"points": f32(rng.standard_normal((128, HEAD_CFG.proj_dim))),
               "alphas": f32(rng.standard_normal((128, vocab)) * 0.01),
               "proj": f32(rng.standard_normal((d_model, HEAD_CFG.proj_dim))
                           / np.sqrt(d_model))}
    return freeze_head(torch.Generator().manual_seed(seed), kparams, HEAD_CFG)


def _heads(hp):
    return {"dense": None,
            "sketch-ref": SketchHead(cfg=HEAD_CFG, backend="ref", params=hp),
            "sketch-fused": SketchHead(cfg=HEAD_CFG, backend="fused",
                                       params=hp)}


def _lm(meshed, head):
    """The backbone already placed on the mesh, serving ``head`` (whose
    arrays ``with_head`` places)."""
    return meshed if head is None else meshed.with_head(head)


def _prompts(seed, vocab, b=4, p=6):
    return np.random.default_rng(seed).integers(0, vocab, (b, p))


def _gather(obj):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _placed(pool, mesh) -> bool:
    """Every pool leaf on its ``cache_shardings`` placements."""
    specs = dict(tree_paths(cache_shardings(pool, mesh)))
    return all(tuple(leaf.placements) == to_placements(specs[path], mesh)
               for path, leaf in tree_paths(pool))


def _setup(arch: str):
    mesh = parse_mesh("2x2", "cpu")
    base_lm = LM.from_config(arch, smoke=True, device="cpu")
    hp = head_params(base_lm.cfg.d_model, base_lm.cfg.vocab_size)
    return mesh, base_lm, base_lm.with_mesh(mesh), hp, _heads(hp)


def serving_ranks(rank: int, world: int, arch: str) -> dict:
    """Dense, sampled, engine, staggered, pooled, chunked and per-tenant
    streams, the sharded head and its placements, the CLI."""
    mesh, base_lm, dense_mesh, hp, heads = _setup(arch)
    cfg, r = base_lm.cfg, {}

    # -- token streams ----------------------------------------------------
    prompts = _prompts(1, cfg.vocab_size)
    r["dense/base"] = base_lm.generate(prompts, 5).numpy()
    r["dense/mesh"] = dense_mesh.generate(prompts, 5).numpy()
    # and back off the mesh: the gathered params give the same stream
    r["dense/unmeshed"] = dense_mesh.with_mesh(None).generate(
        prompts, 5).numpy()

    sampler = Sampler(temperature=0.8, top_k=8, seed=3)
    prompts = _prompts(2, cfg.vocab_size)
    for kind, head in heads.items():
        lm = _lm(dense_mesh, head)
        r[f"determinism/{kind}"] = [
            lm.generate(prompts, 5, sampler=sampler).numpy()
            for _ in range(2)]

    prompts = _prompts(3, cfg.vocab_size)
    for kind, head in heads.items():
        lm = _lm(dense_mesh, head)
        r[f"engine/{kind}/static"] = lm.generate(prompts, 5).numpy()
        r[f"engine/{kind}/served"] = lm.serve(
            [(prompts[i], 5) for i in range(4)], n_slots=4)

    lm = _lm(dense_mesh, SketchHead(cfg=HEAD_CFG, backend="ref", params=hp))
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, 6, dtype=np.int32),
             3 + (i % 3), i) for i in range(6)]
    r["staggered/served"] = lm.serve(reqs, n_slots=4)
    r["staggered/solo"] = [lm.generate(p[None], g).numpy()[0, len(p):]
                           for p, g, _ in reqs]

    # -- the sharded head: logits and placement ----------------------------
    hidden = torch.tensor(np.random.default_rng(7).standard_normal(
        (4, cfg.d_model)), dtype=torch.float32)
    placed = _lm(dense_mesh, heads["sketch-fused"]).head.params
    for backend in ("ref", "two_kernel", "fused"):
        r[f"head/{backend}/base"] = apply_head(
            hp, hidden, HEAD_CFG, backend=backend).numpy()
        with serving(mesh):
            r[f"head/{backend}/mesh"] = replicated(apply_head(
                placed, hidden, HEAD_CFG, backend=backend)).numpy()
    r["head/placements"] = {k: spec_of(v) for k, v in placed.items()}
    r["head/local_shapes"] = _gather(
        {k: tuple(v.to_local().shape) for k, v in placed.items()})

    hidden = torch.tensor(np.random.default_rng(11).standard_normal(
        (4, cfg.d_model)), dtype=torch.float32)
    for quant in ("int8", "int4"):
        qhead = quantize_head(hp, quant)
        qplaced = _lm(dense_mesh, SketchHead(cfg=HEAD_CFG, quant=quant,
                                             params=qhead)).head.params
        r[f"quant/{quant}/max_scale"] = float(qhead["scale"].max())
        for backend in ("two_kernel", "fused"):
            r[f"quant/{quant}/{backend}/base"] = apply_head(
                qhead, hidden, HEAD_CFG, backend=backend,
                quant=quant).numpy()
            with serving(mesh):
                r[f"quant/{quant}/{backend}/mesh"] = replicated(apply_head(
                    qplaced, hidden, HEAD_CFG, backend=backend,
                    quant=quant)).numpy()
                r[f"quant/{quant}/{backend}/f32"] = replicated(apply_head(
                    placed, hidden, HEAD_CFG, backend=backend)).numpy()

    lm = _lm(dense_mesh, SketchHead(cfg=HEAD_CFG, params=hp).quantized("int8"))
    r["quant/int8/dtype"] = str(lm.head.params["array"].dtype)
    r["quant/int8/placements"] = {k: spec_of(v)
                                  for k, v in lm.head.params.items()}
    r["quant/int8/scale_local"] = _gather(
        tuple(lm.head.params["scale"].to_local().shape))

    r["params/embed"] = spec_of(dense_mesh.params["embed"])
    r["params/local"] = _gather({
        path: tuple(leaf.to_local().shape)
        for path, leaf in tree_paths(dense_mesh.params)})

    # -- the slot pool stays placed -----------------------------------------
    lm = _lm(dense_mesh, SketchHead(cfg=HEAD_CFG, backend="ref", params=hp))
    engine = lm.engine(n_slots=4, max_seq=12)
    r["pool/fresh"] = _placed(engine.pool, mesh)
    rng = np.random.default_rng(1)
    for i in range(5):
        engine.submit(rng.integers(0, cfg.vocab_size, 6, dtype=np.int32), 4,
                      arrival=i)
    engine.run()
    r["pool/after"] = _placed(engine.pool, mesh)

    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, cfg.vocab_size, 6, dtype=np.int32), 5)
            for _ in range(4)]
    r["chunked/base"] = lm.serve(reqs, n_slots=4)
    engine = lm.engine(n_slots=4, max_seq=11, decode_chunk=4)
    for prompt, gen in reqs:
        engine.submit(prompt, gen)
    r["chunked/got"] = engine.run()
    r["chunked/placed"] = _placed(engine.pool, mesh)

    # -- per-tenant heads: the bank placed, each tenant its own head ---------
    heads_t = {f"t{t}": head_params(cfg.d_model, cfg.vocab_size, seed=50 + t)
               for t in range(2)}
    cache = HeadCache(heads_t.__getitem__, capacity=2, mesh=mesh)
    spec = SketchHead(cfg=HEAD_CFG, backend="fused")
    lm = _lm(dense_mesh, spec)
    engine = lm.engine(4, 11, head_cache=cache)
    prompts = _prompts(17, cfg.vocab_size)
    for i in range(4):
        engine.submit(prompts[i], 5, tenant=f"t{i % 2}")
    r["tenants/served"] = engine.run()
    r["tenants/solo"] = [
        _lm(dense_mesh, SketchHead(cfg=HEAD_CFG, backend="fused",
                                   params=heads_t[f"t{i % 2}"]))
        .generate(prompts[i:i + 1], 5).numpy()[0, 6:] for i in range(4)]
    r["tenants/bank"] = {k: spec_of(v) for k, v in cache._bank.items()}

    # -- mesh specs ----------------------------------------------------------
    r["mesh/none"] = parse_mesh(None) is None
    r["mesh/same"] = parse_mesh(mesh) is mesh
    m = parse_mesh("2x2", "cpu")
    r["mesh/dims"] = dict(zip(m.mesh_dim_names, tuple(m.shape)))
    for bad in ("banana", "64x64", "4x2"):
        try:
            parse_mesh(bad, "cpu")
            r[f"mesh/{bad}"] = None
        except ValueError as e:
            r[f"mesh/{bad}"] = str(e)

    # -- the serve CLI with --mesh, as torchrun would run it (last: ranks
    # other than 0 stop printing) ------------------------------------------
    import contextlib
    import io

    from repro_torch.launch import serve
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--mesh",
                    "2x2", "--batch", "4", "--prompt-len", "6", "--gen", "4"])
    r["cli"] = text.getvalue()
    return r


def spec_ranks(rank: int, world: int, arch: str) -> dict:
    """The paged engine, speculative decode and quantized heads' streams
    on the mesh."""
    mesh, base_lm, dense_mesh, hp, heads = _setup(arch)
    cfg, r = base_lm.cfg, {}
    rng = np.random.default_rng(4)
    base = [rng.integers(0, cfg.vocab_size, plen, dtype=np.int32)
            for plen in (5, 9, 5, 13)]
    reqs = [(base[int(rng.integers(0, len(base)))], int(rng.integers(2, 7)),
             i // 3) for i in range(12)]
    for kind in ("dense", "sketch-fused"):
        lm = _lm(dense_mesh, heads[kind])
        for paged in (False, True):
            engine = lm.engine(4, 32, sampler=Sampler(temperature=1.0,
                                                      seed=7),
                               paged=paged, page_size=4)
            for rid, (prompt, gen, arrival) in enumerate(reqs):
                engine.submit(prompt, gen, arrival=arrival, rid=rid)
            r[f"paged/{kind}/{paged}"] = engine.run()
            if paged:
                r[f"paged/{kind}/hits"] = engine.stats["prefix_hits"]

    prompts = _prompts(5, cfg.vocab_size)
    samplers = (Sampler(), Sampler(temperature=0.9, top_k=12, seed=7))
    reqs = [(prompts[i], 5) for i in range(4)]
    r["spec/dense"] = [dense_mesh.generate(prompts, 5, sampler=smp).numpy()
                       for smp in samplers]
    r["spec/engine/dense"] = dense_mesh.serve(reqs, n_slots=4)
    for kind in ("sketch-ref", "sketch-fused"):
        lm = _lm(dense_mesh, heads[kind])
        for si, smp in enumerate(samplers):
            for k in (1, 4):
                r[f"spec/{kind}/{si}/{k}"] = lm.generate(
                    prompts, 5, sampler=smp, spec_decode=k).numpy()
        r[f"spec/{kind}/engine/spec"] = lm.serve(reqs, n_slots=4,
                                                 spec_decode=4)

    prompts = _prompts(13, cfg.vocab_size)
    for quant in ("int8", "int4"):
        head = SketchHead(cfg=HEAD_CFG, params=hp).quantized(quant)
        lm = _lm(dense_mesh, head)
        r[f"quantgen/{quant}/static"] = lm.generate(prompts, 5).numpy()
        r[f"quantgen/{quant}/again"] = lm.generate(prompts, 5).numpy()
        r[f"quantgen/{quant}/served"] = lm.serve(
            [(prompts[i], 5) for i in range(4)], n_slots=4)
    return r
