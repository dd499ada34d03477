"""The port's sharding rules against the JAX package's, leaf by leaf.

Every spec the port's ``sharding/rules.py`` gives (params, ZeRO-1
optimizer state, the frozen head and a tenant bank, the batch, the decode
cache and the page arenas) is held against the JAX function's on stand-in
meshes of (16, 16), (2, 16, 16), (4, 2), (2, 2) and (1, 1), for every arch
at full width: the port's leaves come from ``init_model`` under
``FakeTensorMode`` (nothing allocated), the JAX leaves from
``jax.eval_shape``.  The rules read only a mesh's axis names and sizes, so
no process group is made.  The JAX rules wrap each spec in a
``NamedSharding``, which needs a real mesh; the tests read the bare spec
instead by standing ``repro.sharding.rules.NamedSharding`` in with a
function that returns it.  ~25 s on one thread.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.models.model import (init_decode_cache, init_model,
                                      init_paged_cache)
from repro_torch.sharding import rules
from repro_torch.sharding.rules import (P, _fit_spec, batch_spec,
                                        cache_shardings, head_bank_shardings,
                                        head_param_shardings, head_param_spec,
                                        head_rule_matches,
                                        page_pool_shardings, param_spec,
                                        params_shardings, to_placements,
                                        tree_paths, zero1_shardings)

ARCHS = ["rwkv6-1.6b", "gemma2-27b", "granite-8b", "stablelm-12b",
         "command-r-35b", "musicgen-large", "mixtral-8x7b", "jamba-v0.1-52b",
         "deepseek-v3-671b", "llama-3.2-vision-11b"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (it shares the machine
    with the other pytest workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class PortMesh:
    """What the port's rules read of a ``DeviceMesh``."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.shape = shape


class JaxMesh:
    """What the JAX rules read of a ``jax.sharding.Mesh``."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape, dtype=object)


def _meshes(name):
    shape, names = MESHES[name]
    return PortMesh(shape, names), JaxMesh(shape, names)


@pytest.fixture(scope="module")
def jr():
    """The JAX rules, their NamedSharding stood in by the bare spec."""
    pytest.importorskip("jax")
    import repro.sharding.rules as jrules

    saved = jrules.NamedSharding
    jrules.NamedSharding = lambda mesh, spec: spec
    yield jrules
    jrules.NamedSharding = saved


_TREES = {}


def _trees(arch):
    """(port params, port cache, port arenas, JAX params, JAX cache, JAX
    arenas) of ``arch`` at full width, shapes only."""
    if arch not in _TREES:
        import jax

        from repro.configs import get_config as jget
        from repro.models import model as jm

        cfg, jcfg = get_config(arch), jget(arch)
        with FakeTensorMode():
            params = init_model(cfg, torch.Generator())
            cache = init_decode_cache(cfg, 8, 64, device="cpu")
            pages = init_paged_cache(cfg, 16, 4, device="cpu")
        _TREES[arch] = (
            params, cache, pages,
            jax.eval_shape(lambda: jm.init_model(jax.random.PRNGKey(0), jcfg)),
            jax.eval_shape(lambda: jm.init_decode_cache(jcfg, 8, 64)),
            jax.eval_shape(lambda: jm.init_paged_cache(jcfg, 16, 4)))
    return _TREES[arch]


def _jax_leaves(jr, tree):
    import jax

    return {jr._path_str(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_specs(tree):
    return dict(tree_paths(tree))


def _as_tuple(spec):
    return tuple(spec)


# --------------------------------------------------------------------------
# every leaf of every arch, on every mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_match_jax(jr, arch, mesh):
    pmesh, jmesh = _meshes(mesh)
    params, _, _, jparams, _, _ = _trees(arch)
    jleaves = _jax_leaves(jr, jparams)
    port = dict(tree_paths(params))
    assert sorted(port) == sorted(jleaves)
    got = _port_specs(params_shardings(params, pmesh))
    got_z = _port_specs(zero1_shardings(params, pmesh))
    want_z = _jax_leaves(jr, jr.zero1_shardings(jparams, jmesh))
    for path, leaf in jleaves.items():
        scanned = "periods/" in path
        want = jr.param_spec(path, leaf.shape, jmesh, scanned)
        assert tuple(port[path].shape) == tuple(leaf.shape), path
        assert _as_tuple(param_spec(path, tuple(leaf.shape), pmesh,
                                    scanned)) == tuple(want), path
        assert _as_tuple(got[path]) == tuple(want), path
        assert _as_tuple(got_z[path]) == tuple(want_z[path]), path


def _strip_prologue(path, spec):
    """A port prologue stack carries a leading layer axis of 1 (never
    sharded) that the JAX package's prologue cache has not."""
    if path.startswith("prologue/"):
        assert spec[0] is None, (path, spec)
        return tuple(spec[1:])
    return tuple(spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_page_pool_specs_match_jax(jr, arch, mesh):
    pmesh, jmesh = _meshes(mesh)
    _, cache, pages, _, jcache, jpages = _trees(arch)
    for batch_size in (8, None):
        got = _port_specs(cache_shardings(cache, pmesh, batch_size))
        want = _jax_leaves(jr, jr.cache_shardings(jcache, jmesh, batch_size))
        assert sorted(got) == sorted(want)
        for path, spec in want.items():
            assert _strip_prologue(path, got[path]) == tuple(spec), path
    got = _port_specs(page_pool_shardings(pages, pmesh))
    want = _jax_leaves(jr, jr.page_pool_shardings(jpages, jmesh))
    assert sorted(got) == sorted(want)
    for path, spec in want.items():
        assert _strip_prologue(path, got[path]) == tuple(spec), path


def _head_trees(quant):
    """(port head, JAX head) of one frozen config, shapes only."""
    import jax
    import jax.numpy as jnp

    from repro.core.sketch_lm_head import freeze_head as jfreeze
    from repro.models.config import SketchHeadConfig as JCfg

    from repro_torch.core.sketch_lm_head import freeze_head
    from repro_torch.models.config import SketchHeadConfig

    kw = dict(n_rows=32, n_buckets=8, k=2, proj_dim=16, bandwidth=2.0)
    m, v, d = 64, 256, 48
    kp = {"points": torch.zeros((m, 16)), "alphas": torch.zeros((m, v)),
          "proj": torch.zeros((d, 16))}
    port = freeze_head(torch.Generator().manual_seed(0), kp,
                       SketchHeadConfig(**kw), quant=quant)
    jkp = {"points": jnp.zeros((m, 16)), "alphas": jnp.zeros((m, v)),
           "proj": jnp.zeros((d, 16))}
    jax_head = jax.eval_shape(lambda: jfreeze(jax.random.PRNGKey(0), jkp,
                                              JCfg(**kw), quant=quant))
    return port, jax_head


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_head_and_bank_specs_match_jax(jr, mesh, quant):
    pmesh, jmesh = _meshes(mesh)
    port, jhead = _head_trees(quant)
    assert sorted(port) == sorted(jhead)
    got = head_param_shardings(port, pmesh)
    for name, leaf in jhead.items():
        want = jr.head_param_spec(name, leaf.shape, jmesh)
        assert _as_tuple(got[name]) == tuple(want), name
        assert head_rule_matches(name) == jr.head_rule_matches(name)
    for n_rows in (10, 32, 64, 4096):
        assert tuple(head_param_spec("array", (n_rows, 8, 256), pmesh)) == \
            tuple(jr.head_param_spec("array", (n_rows, 8, 256), jmesh))
    bank = {k: torch.zeros((3, *v.shape), dtype=v.dtype)
            for k, v in port.items()}
    bank["tenant_ids"] = torch.zeros((4,), dtype=torch.int32)
    jbank = {k: np.zeros(tuple(v.shape)) for k, v in bank.items()}
    got = head_bank_shardings(bank, pmesh)
    want = jr.head_bank_shardings(jbank, jmesh)
    for name in bank:
        assert _as_tuple(got[name]) == tuple(want[name]), name


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_matches_jax(jr, mesh):
    pmesh, jmesh = _meshes(mesh)
    for b in (1, 2, 3, 4, 6, 8, 16, 32, 64, 256, 512):
        assert batch_spec(b, pmesh) == jr.batch_spec(b, jmesh), b
    assert rules.data_axes(pmesh) == jr.data_axes(jmesh)


def test_rule_tables_are_the_reference_tables(jr):
    """The same regexes in the same order, with the same specs."""
    def norm(table):
        return [(pat, tuple(tuple(s) for s in spec)
                 if isinstance(spec, tuple) and spec
                 and not isinstance(spec[0], (str, type(None))) else
                 tuple(spec)) for pat, spec in table]
    assert norm(rules._PARAM_RULES) == norm(jr._PARAM_RULES)
    assert norm(rules._HEAD_RULES) == norm(jr._HEAD_RULES)


# --------------------------------------------------------------------------
# twins of tests/test_sharding.py
# --------------------------------------------------------------------------

MESH = PortMesh((16, 16), ("data", "model"))
POD = PortMesh((2, 16, 16), ("pod", "data", "model"))


def test_fit_spec_drops_nondivisible():
    assert tuple(_fit_spec(P("model", None), (100, 8), MESH)) == (None, None)
    assert tuple(_fit_spec(P("model", None), (1600, 8), MESH)) == (
        "model", None)


def test_dense_ffn_specs():
    s = param_spec("periods/pos0/ffn/w_gate", (40, 5120, 13824), MESH, True)
    assert tuple(s) == (None, None, "model")
    s = param_spec("periods/pos0/ffn/w_down", (40, 13824, 5120), MESH, True)
    assert tuple(s) == (None, "model", None)


def test_moe_expert_specs_ep_vs_tp():
    s = param_spec("periods/pos0/ffn/w_gate", (58, 256, 7168, 2048), MESH,
                   True)
    assert tuple(s) == (None, "model", "data", None)
    s = param_spec("periods/pos0/ffn/w_gate", (32, 8, 4096, 14336), MESH,
                   True)
    assert tuple(s) == (None, None, "data", "model")
    s = param_spec("periods/pos0/ffn/w_down", (32, 8, 14336, 4096), MESH,
                   True)
    assert tuple(s) == (None, None, "model", "data")


def test_attention_specs():
    s = param_spec("periods/pos0/mixer/wq", (40, 5120, 5120), MESH, True)
    assert tuple(s) == (None, None, "model")
    s = param_spec("periods/pos0/mixer/wo", (40, 5120, 5120), MESH, True)
    assert tuple(s) == (None, "model", None)


def test_embed_head_specs():
    assert tuple(param_spec("embed", (100352, 5120), MESH, False)) == (
        "model", None)
    assert tuple(param_spec("head", (100352, 5120), MESH, False)) == (
        "model", None)


def test_norms_replicated():
    assert tuple(param_spec("periods/pos0/norm1", (40, 5120), MESH, True)
                 ) in ((None,), (None, None))


def test_batch_spec_divisibility():
    assert batch_spec(256, MESH) == "data"
    assert batch_spec(256, POD) == ("pod", "data")
    assert batch_spec(1, MESH) is None
    assert batch_spec(32, POD) == ("pod", "data")
    assert batch_spec(16, POD) == "data"


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_head_rules_cover_sketch_tree_exactly_once(quant):
    """Every leaf of the frozen sketch-head tree matches exactly ONE head
    rule: no overlap, and no leaf falling through to replication."""
    from repro_torch.core.sketch_lm_head import freeze_head
    from repro_torch.models.config import SketchHeadConfig

    cfg = SketchHeadConfig(n_rows=32, n_buckets=8, k=2, proj_dim=16,
                           bandwidth=2.0)
    head = freeze_head(torch.Generator().manual_seed(0),
                       {"points": torch.zeros((64, 16)),
                        "alphas": torch.zeros((64, 128)),
                        "proj": torch.zeros((48, 16))}, cfg, quant=quant)
    assert len(head) == (4 if quant is None else 5)
    for name in head:
        assert len(head_rule_matches(name)) == 1, name


def test_head_param_specs_shard_count_arrays_over_model():
    assert tuple(head_param_spec("array", (32, 8, 256), MESH)) == (
        "model", None, None)
    assert tuple(head_param_spec("array", (10, 8, 256), MESH)) == (
        None, None, None)
    assert tuple(head_param_spec("proj", (64, 16), MESH)) == (None, None)
    assert tuple(head_param_spec("w", (32, 2, 16), MESH)) == (
        None, None, None)
    assert tuple(head_param_spec("b", (32, 2), MESH)) == (None, None)
    assert tuple(head_param_spec("extra_state", (8, 8), MESH)) == (None, None)


def test_head_count_arrays_not_silently_replicated():
    spec = head_param_spec("array", (64, 16, 4096), MESH)
    assert "model" in {n for e in spec if e is not None
                       for n in (e if isinstance(e, tuple) else (e,))}


def test_cache_shardings_types():
    """The same tree as the cache, a spec per leaf, None stacks kept."""
    mesh = PortMesh((1, 1), ("data", "model"))
    for arch in ("stablelm-12b", "deepseek-v3-671b", "rwkv6-1.6b",
                 "jamba-v0.1-52b", "llama-3.2-vision-11b"):
        cfg = get_config(arch, smoke=True)
        cache = init_decode_cache(cfg, 2, 8, device="meta")
        specs = cache_shardings(cache, mesh, 2)
        assert sorted(dict(tree_paths(cache))) == sorted(
            dict(tree_paths(specs)))
        for (path, leaf), (_, spec) in zip(tree_paths(cache),
                                           tree_paths(specs)):
            assert isinstance(spec, P) and len(spec) == leaf.dim(), path


def test_to_placements():
    """A spec's DTensor placements: Shard(d) on each mesh dim a tensor dim
    names, Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    assert to_placements(P("model", None), MESH) == (Replicate(), Shard(0))
    assert to_placements(P(None, "data", "model"), MESH) == (Shard(1),
                                                             Shard(2))
    assert to_placements(P(("pod", "data"), None), POD) == (
        Shard(0), Shard(0), Replicate())
    assert to_placements(P(), MESH) == (Replicate(), Replicate())
    # a mesh dim of one rank shards all the same (its shard is the whole
    # tensor), so that DTensor propagates the placements of a larger mesh
    one = PortMesh((1, 1), ("data", "model"))
    assert to_placements(P("data", "model"), one) == (Shard(0), Shard(1))
