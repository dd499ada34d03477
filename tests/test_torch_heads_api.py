"""The port's head API against the JAX package's ``repro.api``.

The registry (``HEAD_KINDS``, ``register_head``, ``get_head_class``), the
``LogitHead`` base, ``without_params``, ``SketchHead.quantized``,
``SketchHead.from_archive``, ``load_head``'s dispatch on an archive's
stored kind (and its fallback to a class's ``load``) and
``Sampler.greedy``: the same calls on the same ``.npz`` archives in both
packages give the same kinds, specs, errors and arrays, bit for bit.
~10 s on one thread.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.api as japi
import repro_torch.api as tapi
from repro.core import sketch_lm_head as jhead
from repro.models.config import SketchHeadConfig as JCfg
from repro_torch.core import sketch_lm_head as thead
from repro_torch.models.config import SketchHeadConfig as TCfg

CFG = dict(n_rows=16, n_buckets=8, k=1, proj_dim=8, bandwidth=2.0)
D_MODEL, VOCAB = 12, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frozen():
    """A frozen f32 head of the JAX package (its arrays as numpy)."""
    kp, ka, kj, kf = jax.random.split(jax.random.PRNGKey(5), 4)
    kparams = {
        "points": jax.random.normal(kp, (32, CFG["proj_dim"])),
        "alphas": jax.random.normal(ka, (32, VOCAB)) * 0.01,
        "proj": jax.random.normal(kj, (D_MODEL, CFG["proj_dim"])),
    }
    return {k: np.asarray(v)
            for k, v in jhead.freeze_head(kf, kparams, JCfg(**CFG)).items()}


def _archive(tmp_path, frozen, *, kind="sketch", backend="fused",
             quant=None, name="head.npz"):
    """An archive written by the JAX package's ``save_head``."""
    params = {k: jax.numpy.asarray(v) for k, v in frozen.items()}
    if quant is not None:
        params = jhead.quantize_head(params, quant)
    path = tmp_path / name
    jhead.save_head(path, params, JCfg(**CFG), kind=kind, backend=backend,
                    quant=quant)
    return path


def _equal_params(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


def _t2n(params: dict) -> dict:
    return {k: v.numpy() for k, v in params.items()}


def _cfg_fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


# ---------------------------------------------------------------- registry

def test_registry_kinds_and_classes_equal_jax():
    assert sorted(tapi.HEAD_KINDS) == sorted(japi.HEAD_KINDS) == [
        "dense", "sketch"]
    for kind in ("dense", "sketch"):
        tcls, jcls = tapi.get_head_class(kind), japi.get_head_class(kind)
        assert tcls.__name__ == jcls.__name__
        assert tcls.kind == jcls.kind == kind
        assert tcls.needs_hidden == jcls.needs_hidden
        assert issubclass(tcls, tapi.LogitHead)
    for api in (tapi, japi):
        with pytest.raises(KeyError, match="unknown head kind 'nope'"):
            api.get_head_class("nope")


def test_logit_head_base_equals_jax():
    for api in (tapi, japi):
        base = api.LogitHead()
        assert base.kind == "abstract" and base.describe() == "abstract"
        assert not base.needs_hidden and base.params is None
        assert base.without_params() is base
        assert base.with_params(None) is base
        with pytest.raises(ValueError, match="LogitHead is stateless"):
            base.with_params({"x": 1})
        with pytest.raises(NotImplementedError):
            base.apply(None, None)
        dense = api.DenseHead()
        assert dense.without_params() is dense
        with pytest.raises(ValueError, match="DenseHead is stateless"):
            dense.with_params({"x": 1})
        with pytest.raises(RuntimeError, match="unembed"):
            dense.apply(None, None)


@pytest.mark.parametrize("has_from_archive", [True, False])
def test_load_head_dispatches_on_a_registered_kind(tmp_path, frozen,
                                                   has_from_archive):
    """An archive stored with a custom kind loads through the class
    registered for it: its ``from_archive`` with the one read's triple, or,
    lacking one, its ``load(path)``."""
    path = _archive(tmp_path, frozen, kind="custom")
    got = {}
    for name, api in (("port", tapi), ("jax", japi)):
        calls = []

        class Custom(api.LogitHead):
            kind = "custom"

            if has_from_archive:
                @classmethod
                def from_archive(cls, params, cfg, meta):
                    calls.append(("from_archive", meta["kind"],
                                  meta["backend"], meta["quant"]))
                    return cls()
            else:
                @classmethod
                def load(cls, path):
                    calls.append(("load", str(path)))
                    return cls()

        api.register_head("custom")(Custom)
        try:
            assert api.get_head_class("custom") is Custom
            head = (api.load_head(path, "cpu") if api is tapi
                    else api.load_head(path))
            assert isinstance(head, Custom)
        finally:
            del api.HEAD_KINDS["custom"]
        got[name] = calls
    assert got["port"] == got["jax"] and len(got["port"]) == 1
    for api in (tapi, japi):
        with pytest.raises(KeyError, match="unknown head kind 'custom'"):
            api.load_head(path, "cpu") if api is tapi else api.load_head(path)


def test_load_head_of_a_class_without_load_raises(tmp_path, frozen):
    path = _archive(tmp_path, frozen, kind="bare")
    for api in (tapi, japi):
        class Bare(api.LogitHead):
            kind = "bare"

        api.register_head("bare")(Bare)
        try:
            with pytest.raises(TypeError, match="does not support load"):
                api.load_head(path, "cpu") if api is tapi \
                    else api.load_head(path)
        finally:
            del api.HEAD_KINDS["bare"]


# ------------------------------------------------------- archives and specs

@pytest.mark.parametrize("quant,backend", [(None, "fused"),
                                           (None, "two_kernel"),
                                           ("int8", "ref"),
                                           ("int4", "fused")])
def test_load_head_and_from_archive_equal_jax(tmp_path, frozen, quant,
                                              backend):
    path = _archive(tmp_path, frozen, quant=quant, backend=backend)
    want = japi.load_head(path)
    for got in (tapi.load_head(path, "cpu"),
                tapi.SketchHead.load(path, "cpu"),
                tapi.SketchHead.from_archive(
                    *thead.load_head_full(path, "cpu"))):
        assert isinstance(got, tapi.SketchHead)
        assert (got.kind, got.backend, got.quant, got.describe()) == (
            want.kind, want.backend, want.quant, want.describe())
        assert _cfg_fields(got.cfg) == _cfg_fields(want.cfg)
        _equal_params(_t2n(got.params), want.params)


def test_without_params_keys_the_spec_as_jax(tmp_path, frozen):
    """The bare spec drops the arrays; equality and hash ignore them, so a
    loaded head equals the bare spec with its arrays attached."""
    path = _archive(tmp_path, frozen, backend="two_kernel")
    for api, load in ((tapi, lambda p: tapi.load_head(p, "cpu")),
                      (japi, japi.load_head)):
        head = load(path)
        bare = head.without_params()
        assert bare.params is None and head.params is not None
        assert bare.without_params() is bare
        assert bare == head and hash(bare) == hash(head)
        assert head == bare.with_params(head.params)
        assert bare.describe() == "sketch/two_kernel"


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_equals_jax(frozen, quant):
    """``SketchHead.quantized`` on the same f32 arrays: the same storage,
    bit for bit, and the same spec."""
    jh = japi.SketchHead(cfg=JCfg(**CFG),
                         params={k: jax.numpy.asarray(v)
                                 for k, v in frozen.items()})
    th = tapi.SketchHead(cfg=TCfg(**CFG),
                         params={k: torch.from_numpy(v.copy())
                                 for k, v in frozen.items()})
    jq, tq = jh.quantized(quant), th.quantized(quant)
    assert (tq.quant, tq.describe()) == (jq.quant, jq.describe())
    assert sorted(tq.params) == sorted(jq.params)
    _equal_params(_t2n(tq.params), {k: np.asarray(v)
                                    for k, v in jq.params.items()})
    # The f32 head is untouched, and a bare spec quantizes without arrays.
    _equal_params(_t2n(th.params), frozen)
    assert th.without_params().quantized(quant).params is None


def test_quantized_no_op_and_requantize_raise_as_jax(frozen):
    for api, cfg, params in (
            (japi, JCfg(**CFG),
             {k: jax.numpy.asarray(v) for k, v in frozen.items()}),
            (tapi, TCfg(**CFG),
             {k: torch.from_numpy(v.copy()) for k, v in frozen.items()})):
        head = api.SketchHead(cfg=cfg, params=params)
        assert head.quantized(None) is head
        q8 = head.quantized("int8")
        assert q8.quantized("int8") is q8
        for other in ("int4", None):
            with pytest.raises(ValueError,
                               match="already int8-quantized; cannot "
                                     f"re-quantize to {other!r}"):
                q8.quantized(other)


def test_port_archive_loads_in_jax(tmp_path, frozen):
    """A head the port saves loads in the JAX package's ``load_head`` with
    the same identity and arrays."""
    th = tapi.SketchHead(cfg=TCfg(**CFG), backend="ref",
                         params={k: torch.from_numpy(v.copy())
                                 for k, v in frozen.items()}).quantized("int8")
    th.save(tmp_path / "port.npz")
    jh = japi.load_head(tmp_path / "port.npz")
    assert (jh.kind, jh.backend, jh.quant) == ("sketch", "ref", "int8")
    _equal_params(_t2n(th.params), {k: np.asarray(v)
                                    for k, v in jh.params.items()})


def test_sampler_greedy_equals_jax():
    from repro.api.sampler import Sampler as JSampler
    from repro_torch.api.sampler import Sampler as TSampler

    for cls in (TSampler, JSampler):
        g = cls.greedy()
        assert g == cls() and g.is_greedy
        assert (g.temperature, g.top_k, g.top_p, g.seed) == (0.0, 0, 1.0, 0)
    assert dataclasses.asdict(TSampler.greedy()) == dataclasses.asdict(
        JSampler.greedy())
