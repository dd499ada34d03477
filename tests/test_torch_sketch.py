"""The port's Representer Sketch, its LSH families, ``race_query`` and the
paper's pure-math and data modules against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; JAX
states (hash params, built arrays) are carried across with
``repro_torch.convert``.  The JAX side runs ``race_query`` on its Pallas
backend (interpret mode on the CPU, as tests/test_kernels.py runs it) and
on ``ref``; the port's wrappers run their plain versions on CPU tensors.
Tolerances (``repro_torch.parity``):

* ``race_query``: ``race_query_tol`` — the group sums in another order and
  the midpoint's rounding; a bf16 sketch read by JAX's ``ref`` also rounds
  each group mean and the midpoint to bf16, two roundings of at most
  2⁻⁸ relative, so that comparison adds ``2·2⁻⁸·max_g |mean|``.
* Hash indices: equal, or different only at a floor() boundary within the
  f32 summation error bound (SRP: only where a projection lies within that
  bound of 0).
* Built arrays and masses: on every sketch row whose point indices agree,
  twice ``n_chunks·race_update_tol`` (each side folds the same weights in
  ``n_chunks`` folds, each within ``race_update_tol`` of exact).
* Queries: ``race_query_tol`` on every query whose indices agree.
* Closed-form kernels (``erf``, ``exp``, ``arccos`` in f32): 1e-6 absolute
  on probabilities in [0, 1] (a few f32 ulps of each library's
  transcendental functions), raised to the K-th power.
* ``make_dataset`` and the theory formulas: equal.

``race_query_ordered_ref`` (the kernel's summation order in plain PyTorch)
is held to the same tolerances here.  The ``cuda`` cases hold the
``race_query`` kernel equal to it bit for bit, and within ``race_query_tol``
of its plain version, on the card and skip without one; they import no JAX (``python -m pytest
--noconftest -m cuda tests/test_torch_sketch.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import sketch_state_from_numpy
from repro_torch.core import theory
from repro_torch.core.lsh import (AchlioptasL2LSH, L2LSH, LSHConfig, SRPLSH,
                                  make_lsh)
from repro_torch.core.sketch import (RepresenterSketch, SketchConfig,
                                     mom_estimate)
from repro_torch.data.tabular import DATASETS, make_dataset
from repro_torch.kernels.lsh_hash.ops import lsh_hash_ref
from repro_torch.kernels.race_query.ops import (race_query,
                                                race_query_ordered_ref,
                                                race_query_ref)
from repro_torch.launch.paper_repro import FULL
from repro_torch.parity import (U32, _gamma, check_hash_indices,
                                race_query_tol, race_update_tol)

BF16_U = 2.0 ** -8        # unit roundoff of bf16 (8 significant bits)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's functions (imported here, so that the cuda cases
    of this file also run where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import lsh as jlsh
    from repro.core import sketch as jsketch
    from repro.core import theory as jtheory
    from repro.data import tabular as jtab
    from repro.kernels.lsh_hash.ops import lsh_hash as jhash
    from repro.kernels.race_query.ops import race_query as jrq
    return dict(jax=jax, jnp=jnp, lsh=jlsh, sketch=jsketch, theory=jtheory,
                tab=jtab, race_query=jrq, hash=jhash)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the distillation and
    training loops are thousands of tiny eager ops, and PyTorch's default
    (a thread per core in every pytest worker) oversubscribes the machine
    under ``-n 6`` and slows them by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: race_query is a CUDA C++ kernel "
                    "with no CPU mode; its plain version is tested above")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    """A JAX pytree of arrays as numpy (dicts kept)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_query_close(got, want, sketch, idx, n_groups, extra=None):
    """``got`` (port) within ``race_query_tol`` (+ ``extra``) of ``want``;
    NaN exactly where ``want`` is NaN."""
    got = got.to(torch.float64)
    want = torch.as_tensor(np.asarray(want, np.float64))
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    tol = race_query_tol(sketch, idx, n_groups)
    if extra is not None:
        tol = tol + extra
    err = (got - want).abs()
    assert bool((err[~nan] <= tol[~nan]).all()), (
        f"largest error {float(err[~nan].max())}, tol there "
        f"{float(tol[~nan].flatten()[err[~nan].argmax()])}")


# -- race_query ---------------------------------------------------------------

_SHAPES = [(4, 1, 8, 4, 2), (33, 5, 40, 16, 8), (128, 2, 100, 20, 10),
           (5, 3, 24, 12, 6), (33, 2, 18, 10, 1), (130, 4, 50, 6, 5),
           (17, 2, 43, 9, 8),          # L % g != 0: three tail rows dropped
           (9, 1, 64, 4, 64)]          # the most groups the kernel takes


@pytest.mark.parametrize("b,c,l,r,g", _SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_race_query_matches_jax(jx, b, c, l, r, g, dtype):
    jnp = jx["jnp"]
    rng = np.random.default_rng(b * 31 + l)
    sketch = rng.standard_normal((c, l, r)).astype(np.float32)
    idx = rng.integers(0, r, (b, l)).astype(np.int32)
    js = jnp.asarray(sketch, dtype=getattr(jnp, dtype))
    ts = _t(sketch).to(getattr(torch, dtype))
    got = race_query(ts, _t(idx), n_groups=g)
    assert got.dtype == torch.float32 and got.shape == (b, c)
    pallas = jx["race_query"](js, jnp.asarray(idx), n_groups=g, block_b=16,
                              backend="pallas")
    ref = jx["race_query"](js, jnp.asarray(idx), n_groups=g, backend="ref")
    _assert_query_close(got, np.asarray(pallas, np.float32), ts, _t(idx), g)
    extra = None
    if dtype == "bfloat16":
        reads = ts.to(torch.float64)[:, torch.arange(l), _t(idx).long()]
        m = l // g
        grouped = reads.permute(1, 0, 2)[..., : g * m].reshape(b, c, g, m)
        means = grouped.mean(dim=-1).abs().amax(dim=-1)
        extra = 2 * BF16_U * means
    _assert_query_close(got, np.asarray(ref.astype(jnp.float32)), ts,
                        _t(idx), g, extra)


@pytest.mark.parametrize("means,g,want", [
    ([1.0, 2.0, 3.0, 10.0], 4, 2.5),     # even g: midpoint, not torch's 2.0
    ([10.0, 3.0, 1.0, 2.0], 4, 2.5),
    ([1.0, 2.0, 10.0], 3, 2.0),          # odd g: the middle value
    ([-1.0, 4.0], 2, 1.5),
    ([2.0, 2.0, 2.0, 7.0, 7.0, 7.0], 6, 4.5),
    ([5.0], 1, 5.0)])
def test_race_query_even_median_is_midpoint(jx, means, g, want):
    """One read per group (R = 1, L = g), so the group means are the given
    values: the median of an even count is the average of the two middle
    ones, as jnp.median computes it."""
    jnp = jx["jnp"]
    sketch = np.asarray(means, np.float32).reshape(1, g, 1)
    idx = np.zeros((3, g), np.int32)
    got = race_query(_t(sketch), _t(idx), n_groups=g)
    assert torch.equal(got, torch.full((3, 1), want))
    assert torch.equal(race_query_ordered_ref(_t(sketch), _t(idx), g),
                       torch.full((3, 1), want))
    for backend in ("pallas", "ref"):
        j = jx["race_query"](jnp.asarray(sketch), jnp.asarray(idx),
                             n_groups=g, backend=backend)
        np.testing.assert_array_equal(np.asarray(j), np.full((3, 1), want))
    if g % 2 == 0:      # torch.median (the lower middle value) would differ
        assert float(torch.median(torch.tensor(means))) != want


def test_race_query_fewer_rows_than_groups_is_nan(jx):
    jnp = jx["jnp"]
    rng = np.random.default_rng(0)
    sketch = rng.standard_normal((2, 5, 4)).astype(np.float32)
    idx = rng.integers(0, 4, (3, 5)).astype(np.int32)
    got = race_query(_t(sketch), _t(idx), n_groups=8)
    want = jx["race_query"](jnp.asarray(sketch), jnp.asarray(idx),
                            n_groups=8, backend="ref")
    assert bool(torch.isnan(got).all()) and bool(np.isnan(want).all())
    assert bool(torch.isnan(race_query_ordered_ref(_t(sketch), _t(idx),
                                                   8)).all())


def _zero_bucket(sketch, idx):
    """(sketch, idx) with an all-zero bucket R appended and every index
    outside [0, R) sent to it: the plain version of a zero read."""
    c, n_rows, r = sketch.shape
    padded = torch.cat([sketch, torch.zeros((c, n_rows, 1))], dim=-1)
    return padded, torch.where((idx >= 0) & (idx < r), idx, r)


@pytest.mark.parametrize("b,c,l,r,g", _SHAPES)
def test_race_query_ordered_matches_jax(jx, b, c, l, r, g):
    """The kernel's order in plain PyTorch against JAX's race_query
    (pallas in interpret mode, and ref) and against race_query_ref, within
    race_query_tol; a bf16 sketch gives the bits of its f32 cast."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(b * 37 + l)
    sketch = rng.standard_normal((c, l, r)).astype(np.float32)
    idx = rng.integers(0, r, (b, l)).astype(np.int32)
    got = race_query_ordered_ref(_t(sketch), _t(idx), g)
    assert got.dtype == torch.float32 and got.shape == (b, c)
    for backend in ("pallas", "ref"):
        want = jx["race_query"](jnp.asarray(sketch), jnp.asarray(idx),
                                n_groups=g, block_b=16, backend=backend)
        _assert_query_close(got, np.asarray(want), _t(sketch), _t(idx), g)
    _assert_query_close(got, race_query_ref(_t(sketch), _t(idx), g).numpy(),
                        _t(sketch), _t(idx), g)
    bf = _t(sketch).to(torch.bfloat16)
    assert torch.equal(race_query_ordered_ref(bf, _t(idx), g),
                       race_query_ordered_ref(bf.float(), _t(idx), g))


def _paper_query_shape(name):
    """(C, L, R) of a dataset's query at the FULL budget (run_dataset's
    sizing)."""
    spec = DATASETS[name]
    regression = spec.task == "regression"
    return (1 if regression else 2, FULL["rows"] * (2 if regression else 1),
            64 if regression else max(spec.rs_R // 10, 16))


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_race_query_ordered_paper_shapes(name):
    """Each dataset's FULL-budget query shape (g = 8, B cut to 48):
    within race_query_tol of race_query_ref."""
    c, l, r = _paper_query_shape(name)
    rng = np.random.default_rng(len(name))
    sketch = _t(rng.standard_normal((c, l, r)).astype(np.float32))
    idx = _t(rng.integers(0, r, (48, l)).astype(np.int32))
    got = race_query_ordered_ref(sketch, idx, 8)
    _assert_query_close(got, race_query_ref(sketch, idx, 8).numpy(), sketch,
                        idx, 8)


@pytest.mark.parametrize("g", [1, 5, 8])
def test_race_query_ordered_out_of_range_reads_zero(jx, g):
    """L % g != 0 and indices outside [0, R): such an index reads a zero
    count, as JAX's Pallas kernel's one-hot does (its ref backend fills
    with NaN instead), and as race_query_ref does on a sketch with a zero
    bucket in their place."""
    jnp = jx["jnp"]
    b, c, l, r = 21, 2, 83, 9
    rng = np.random.default_rng(g)
    sketch = rng.standard_normal((c, l, r)).astype(np.float32)
    idx = rng.integers(-2, r + 2, (b, l)).astype(np.int32)
    got = race_query_ordered_ref(_t(sketch), _t(idx), g)
    padded, zidx = _zero_bucket(_t(sketch), _t(idx))
    assert torch.equal(got, race_query_ordered_ref(padded, zidx, g))
    _assert_query_close(got, race_query_ref(padded, zidx, g).numpy(), padded,
                        zidx, g)
    want = jx["race_query"](jnp.asarray(sketch), jnp.asarray(idx),
                            n_groups=g, block_b=16, backend="pallas")
    _assert_query_close(got, np.asarray(want), padded, zidx, g)


@pytest.mark.parametrize("g", [1, 2, 5, 8])
def test_mom_estimate_matches_jax(jx, g):
    """Random reads and reads with many tied means (values in {0, 1})."""
    rng = np.random.default_rng(g)
    for reads in (rng.standard_normal((7, 3, 41)).astype(np.float32),
                  rng.integers(0, 2, (7, 3, 16)).astype(np.float32)):
        got = mom_estimate(_t(reads), g)
        want = np.asarray(jx["sketch"].mom_estimate(jx["jnp"].asarray(reads),
                                                    g))
        m = reads.shape[-1] // g
        mag = np.abs(reads[..., : g * m]).reshape(7, 3, g, m).sum(-1) / m
        tol = 2 * (_gamma(m) + 3 * U32) * mag.max(-1)
        assert np.all(np.abs(got.numpy() - want) <= tol)


# -- LSH families --------------------------------------------------------------

_LSH = LSHConfig(n_rows=12, n_buckets=16, k=3, dim=7, bandwidth=1.5)


def _srp_check(got, want, x, w):
    """SRP indices may differ only where a projection lies within the f32
    error bound of 0."""
    mism = (got != want).any()
    if not bool(mism):
        return
    x64, w64 = x.to(torch.float64), w.to(torch.float64)
    proj = torch.einsum("bd,lkd->blk", x64, w64)
    mag = torch.einsum("bd,lkd->blk", x64.abs(), w64.abs())
    near = (proj.abs() <= _gamma(w.shape[-1]) * mag).any(-1)
    assert bool(near[got != want].all())


@pytest.mark.parametrize("kind", ["l2", "achlioptas", "srp"])
def test_make_lsh_hash_matches_jax(jx, kind):
    jax = jx["jax"]
    fam = make_lsh(kind, _LSH)
    assert type(fam) is {"l2": L2LSH, "achlioptas": AchlioptasL2LSH,
                         "srp": SRPLSH}[kind]
    jfam = jx["lsh"].make_lsh(kind, jx["lsh"].LSHConfig(**vars(_LSH)))
    params = _np(jfam.params(jax.random.PRNGKey(3)))
    x = np.random.default_rng(1).standard_normal((40, 7)).astype(np.float32)
    want = _t(np.asarray(jfam.hash(params, x)))
    tparams = {k: _t(v) for k, v in params.items()}
    got = fam.hash(tparams, _t(x))
    assert got.dtype == torch.int32 and got.shape == (40, 12)
    assert bool(((got >= 0) & (got < 16)).all())
    if kind == "srp":
        _srp_check(got, want, _t(x), tparams["w"])
    else:
        check_hash_indices(got, want, _t(x), tparams["w"], tparams["b"], 1.5)
    with pytest.raises(ValueError, match="unknown LSH kind"):
        make_lsh("cosine", _LSH)


@pytest.mark.parametrize("k,dp", [(1, 32), (3, 32), (3, 4), (2, 9)])
def test_lsh_hash_ref_paper_pairs_match_jax(jx, k, dp):
    """The paper's (K, d') pairs (adult; phishing and yearmsd; skin; susy)
    at small B and L, r = 2: lsh_hash_ref against JAX's L2LSH.hash and its
    lsh_hash op (pallas in interpret mode, and ref) under the boundary
    rule."""
    n_rows, n_buckets, bw = 37, 50, 2.0
    rng = np.random.default_rng(k * 100 + dp)
    x = rng.standard_normal((45, dp)).astype(np.float32)
    w = rng.standard_normal((n_rows, k, dp)).astype(np.float32)
    b = (rng.random((n_rows, k)) * bw).astype(np.float32)
    got = lsh_hash_ref(_t(x), _t(w), _t(b), bw, n_buckets)
    assert got.dtype == torch.int32 and got.shape == (45, n_rows)
    jl = jx["lsh"].L2LSH(jx["lsh"].LSHConfig(n_rows=n_rows,
                                             n_buckets=n_buckets, k=k, dim=dp,
                                             bandwidth=bw))
    wants = [jl.hash({"w": w, "b": b}, jx["jnp"].asarray(x))]
    wants += [jx["hash"](jx["jnp"].asarray(x), w, b, bandwidth=bw,
                         n_buckets=n_buckets, backend=backend)
              for backend in ("pallas", "ref")]
    for want in wants:
        check_hash_indices(got, _t(np.asarray(want)), _t(x), _t(w), _t(b), bw)


def test_srp_folds_when_bits_exceed_buckets(jx):
    cfg = LSHConfig(n_rows=4, n_buckets=8, k=5, dim=6)
    jfam = jx["lsh"].SRPLSH(jx["lsh"].LSHConfig(**vars(cfg)))
    params = _np(jfam.params(jx["jax"].random.PRNGKey(0)))
    x = np.random.default_rng(2).standard_normal((30, 6)).astype(np.float32)
    got = SRPLSH(cfg).hash({"w": _t(params["w"])}, _t(x))
    _srp_check(got, _t(np.asarray(jfam.hash(params, x))), _t(x),
               _t(params["w"]))


def test_lsh_params_shapes_and_distribution():
    gen = torch.Generator().manual_seed(0)
    cfg = LSHConfig(n_rows=64, n_buckets=16, k=4, dim=96, bandwidth=2.0)
    p = AchlioptasL2LSH(cfg).params(gen)
    assert p["w"].shape == (64, 4, 96) and p["b"].shape == (64, 4)
    vals, counts = torch.unique(p["w"], return_counts=True)
    np.testing.assert_allclose(vals.numpy(), [-3 ** 0.5, 0.0, 3 ** 0.5],
                               rtol=1e-6)
    np.testing.assert_allclose(counts.numpy() / p["w"].numel(),
                               [1 / 6, 2 / 3, 1 / 6], atol=0.02)
    assert bool(((p["b"] >= 0) & (p["b"] < 2.0)).all())
    assert SRPLSH(cfg).params(gen)["w"].shape == (64, 4, 96)


@pytest.mark.parametrize("kind,k", [("l2", 1), ("l2", 3), ("achlioptas", 2),
                                    ("srp", 1), ("srp", 4)])
def test_collision_probability_matches_jax(jx, kind, k):
    cfg = LSHConfig(n_rows=1, n_buckets=2, k=k, dim=4, bandwidth=1.7)
    jfam = jx["lsh"].make_lsh(kind, jx["lsh"].LSHConfig(**vars(cfg)))
    if kind == "srp":
        x = np.linspace(-1.2, 1.2, 97).astype(np.float32)   # cos similarity
    else:
        x = np.concatenate([[0.0, 1e-12, 1e-9, 2e-9],
                            np.geomspace(1e-4, 50.0, 93)]).astype(np.float32)
    got = make_lsh(kind, cfg).collision_probability(_t(x))
    want = np.asarray(jfam.collision_probability(jx["jnp"].asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * k)
    assert float(got.max()) <= 1.0 and float(got.min()) >= 0.0


def test_collision_probability_has_gradients():
    dist = torch.tensor([0.5, 1.0, 3.0], requires_grad=True)
    L2LSH(LSHConfig(1, 2, 2, 4, 2.0)).collision_probability(dist).sum(
        ).backward()
    assert bool((dist.grad < 0).all())       # farther → less likely to collide


# -- RepresenterSketch ----------------------------------------------------------

_SK = dict(n_rows=48, n_buckets=16, k=2, dim=6, n_outputs=3, bandwidth=1.5,
           n_groups=8)


def _sketch_pair(jx, kind, **over):
    cfg = dict(_SK, lsh_kind=kind, **over)
    jsk = jx["sketch"].RepresenterSketch(jx["sketch"].SketchConfig(**cfg))
    return jsk, RepresenterSketch(SketchConfig(**cfg))


def _data(seed, m=200, b=60, dim=6, c=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, dim)).astype(np.float32),
            rng.standard_normal((m, c)).astype(np.float32),
            rng.standard_normal((b, dim)).astype(np.float32))


def _check_indices(kind, got, want, x, hash_params):
    if kind == "srp":
        _srp_check(got, want, x, hash_params["w"])
    else:
        check_hash_indices(got, want, x, hash_params["w"], hash_params["b"],
                           _SK["bandwidth"])


@pytest.mark.parametrize("kind", ["l2", "achlioptas", "srp"])
@pytest.mark.parametrize("chunk", [4096, 64])
def test_build_matches_jax(jx, kind, chunk):
    """build_streaming from a carried JAX init state: the port's indices
    under the boundary rule; every row whose point indices agree, and the
    mass, within twice the bound of one side against the exact sums (each
    side folds the same M weights in n_chunks folds of at most
    race_update_tol each)."""
    jsk, sk = _sketch_pair(jx, kind)
    points, alphas, _ = _data(4)
    jstate = jsk.init(jx["jax"].random.PRNGKey(5))
    want = _np(jsk.build_streaming(jstate, points, alphas, chunk=chunk))
    state = sketch_state_from_numpy(_np(jstate), "cpu")
    got = sk.build_streaming(state, _t(points), _t(alphas), chunk=chunk)
    assert got["array"].shape == (3, 48, 16) and got["hash"] is state["hash"]
    gi = sk.lsh.hash(state["hash"], _t(points))
    wi = _t(np.asarray(jsk.lsh.hash(jstate["hash"], points)))
    _check_indices(kind, gi, wi, _t(points), state["hash"])
    rows = (gi == wi).all(dim=0)
    n_chunks = -(-points.shape[0] // chunk)
    tol = 2 * n_chunks * race_update_tol(state["array"], _t(alphas), 0)
    err = (got["array"] - _t(want["array"])).abs().double()
    assert bool((err[:, rows] <= tol[:, rows]).all())
    mass_tol = 2 * n_chunks * _gamma(points.shape[0]) * np.abs(alphas).sum(0)
    assert np.all(np.abs(got["mass"].numpy() - want["mass"]) <= mass_tol)


def test_build_one_dim_alphas_and_chunks_compose():
    sk = RepresenterSketch(SketchConfig(**dict(_SK, n_outputs=1)))
    state = sk.init(torch.Generator().manual_seed(0))
    points, alphas, _ = _data(6, c=1)
    whole = sk.build(state, _t(points), _t(alphas[:, 0]))
    parts = sk.build_streaming(state, _t(points), _t(alphas[:, 0]), chunk=50)
    tol = race_update_tol(state["array"], _t(alphas), 0)
    assert bool(((whole["array"] - parts["array"]).abs().double()
                 <= 2 * tol).all())
    np.testing.assert_allclose(whole["mass"].numpy(), alphas.sum(0),
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["l2", "achlioptas", "srp"])
@pytest.mark.parametrize("mom", [True, False])
def test_query_matches_jax(jx, kind, mom):
    """query on a carried built JAX state: indices under the boundary rule,
    every query whose indices agree within race_query_tol of JAX's
    ``query`` (computed on the debiased array, which is the reference's
    debias of each read, element for element)."""
    jsk, sk = _sketch_pair(jx, kind)
    points, alphas, queries = _data(7)
    jstate = jsk.build(jsk.init(jx["jax"].random.PRNGKey(8)), points, alphas)
    want = np.asarray(jsk.query(jstate, queries, mom=mom))
    state = sketch_state_from_numpy(_np(jstate), "cpu")
    got = sk.query(state, _t(queries), mom=mom)
    gi = sk.lsh.hash(state["hash"], _t(queries))
    wi = _t(np.asarray(jsk.lsh.hash(jstate["hash"], queries)))
    _check_indices(kind, gi, wi, _t(queries), state["hash"])
    same = (gi == wi).all(dim=1)
    g = _SK["n_groups"] if mom else 1
    _assert_query_close(got[same], want[same.numpy()], sk.debiased(state),
                        gi[same], g)
    reads = sk.row_reads(state, _t(queries))
    jreads = np.asarray(jsk.row_reads(jstate, queries))
    assert reads.shape == (60, 3, 48)
    np.testing.assert_array_equal(reads[same].numpy(), jreads[same.numpy()])


def test_debiased_is_the_reference_expression():
    sk = RepresenterSketch(SketchConfig(**_SK))
    state = sk.build(sk.init(torch.Generator().manual_seed(1)),
                     *(_t(a) for a in _data(9)[:2]))
    r = _SK["n_buckets"]
    want = (state["array"] - state["mass"][:, None, None] / r) / (1 - 1 / r)
    assert torch.equal(sk.debiased(state), want)


def test_exact_weighted_kde_matches_jax(jx):
    jsk, sk = _sketch_pair(jx, "l2")
    points, alphas, queries = _data(10, m=80, b=30)
    got = sk.exact_weighted_kde(_t(points), _t(alphas), _t(queries))
    want = np.asarray(jsk.exact_weighted_kde(points, alphas, queries))
    tol = 1e-6 * _SK["k"] * np.abs(alphas).sum(0)   # per-term kernel atol
    assert np.all(np.abs(got.numpy() - want) <= tol)


def test_sketch_query_estimates_the_kde():
    """Theorem 1: the debiased sketch is unbiased for the weighted KDE, so
    the plain mean over many rows lands near it (MoM error bound of
    Theorem 2 at δ = 1e-3, σ from Theorem 1's variance bound)."""
    cfg = SketchConfig(n_rows=4000, n_buckets=64, k=1, dim=4, n_outputs=1,
                       bandwidth=2.0, n_groups=8)
    sk = RepresenterSketch(cfg)
    rng = np.random.default_rng(11)
    points = rng.standard_normal((60, 4)).astype(np.float32)
    alphas = np.abs(rng.standard_normal((60, 1))).astype(np.float32)
    queries = rng.standard_normal((20, 4)).astype(np.float32)
    state = sk.build(sk.init(torch.Generator().manual_seed(2)), _t(points),
                     _t(alphas))
    got = sk.query(state, _t(queries))
    exact = sk.exact_weighted_kde(_t(points), _t(alphas), _t(queries))
    sigma = float(alphas.sum())         # √var ≤ Σ α √K ≤ Σ α
    bound = theory.mom_error_bound(sigma, cfg.n_rows, 1e-3)
    assert float((got - exact).abs().max()) <= bound


# -- theory and data --------------------------------------------------------------

def test_theory_matches_jax(jx):
    jt = jx["theory"]
    for args in [(1.3, 400, 0.05), (0.2, 2000, 1e-3)]:
        assert theory.mom_error_bound(*args) == jt.mom_error_bound(*args)
    for args in [(1.0, 0.1, 0.05), (2.5, 0.3, 1e-4)]:
        assert theory.rows_for_error(*args) == jt.rows_for_error(*args)
    for delta in (0.5, 0.05, 1e-6):
        assert theory.mom_groups(delta) == jt.mom_groups(delta)
    assert theory.size_sketch(1.0, 0.2, 0.01, 16, 3) == jt.size_sketch(
        1.0, 0.2, 0.01, 16, 3)
    rng = np.random.default_rng(12)
    sk = rng.random((5, 9)).astype(np.float32)
    for alphas in (rng.standard_normal(9).astype(np.float32),
                   rng.standard_normal((9, 2)).astype(np.float32)):
        got = theory.variance_bound(_t(alphas), _t(sk)).numpy()
        want = np.asarray(jt.variance_bound(jx["jnp"].asarray(alphas),
                                            jx["jnp"].asarray(sk)))
        np.testing.assert_allclose(got, want, rtol=4 * _gamma(9))


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_make_dataset_equals_jax_in_process(jx, name):
    assert vars(DATASETS[name]) == vars(jx["tab"].DATASETS[name])
    for got, want in zip(make_dataset(DATASETS[name], seed=3),
                         jx["tab"].make_dataset(jx["tab"].DATASETS[name],
                                                seed=3)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# -- on the card ------------------------------------------------------------------

def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,l,r,g", [(5000, 2, 2000, 50, 8),   # adult FULL
                                       (800, 1, 4000, 64, 8),    # abalone
                                       (5000, 2, 2000, 100, 8),  # susy
                                       (777, 2, 2003, 30, 5),
                                       (64, 3, 40, 16, 1),
                                       (33, 5, 100, 20, 64),
                                       (300, 2, 2000, 50, 1),    # slice > smem
                                       (9, 1, 5, 16, 8),         # L < g: NaN
                                       (40, 2, 30000, 16, 1)])   # general path
def test_cuda_race_query_kernel(cuda, b, c, l, r, g):
    """The kernel equal to race_query_ordered_ref bit for bit and within
    race_query_tol of its plain version, two launches bit for bit equal,
    one launch each."""
    gen = torch.Generator(cuda).manual_seed(b + l)
    sketch = torch.randn((c, l, r), generator=gen, device=cuda)
    idx = torch.randint(0, r, (b, l), generator=gen, device=cuda,
                        dtype=torch.int32)
    race_query.launches = 0
    got = race_query(sketch, idx, n_groups=g)
    again = race_query(sketch, idx, n_groups=g)
    want = race_query_ref(sketch, idx, g)
    torch.cuda.synchronize()
    assert race_query.launches == 2
    assert _same_bits(got, again)
    assert _same_bits(got, race_query_ordered_ref(sketch, idx, g))
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    err = (got - want).abs().double()
    assert bool((err <= race_query_tol(sketch, idx, g))[~nan].all())
    bf = race_query(sketch.to(torch.bfloat16), idx, n_groups=g)
    torch.cuda.synchronize()
    assert _same_bits(bf, race_query(sketch.to(torch.bfloat16).float(), idx,
                                     n_groups=g))


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 5, 8])
def test_cuda_race_query_out_of_range_reads_zero(cuda, g):
    """Indices outside [0, R) read a zero count on the card too: the kernel
    equals race_query_ordered_ref bit for bit."""
    gen = torch.Generator(cuda).manual_seed(g)
    sketch = torch.randn((2, 2003, 50), generator=gen, device=cuda)
    idx = torch.randint(-3, 53, (1000, 2003), generator=gen, device=cuda,
                        dtype=torch.int32)
    got = race_query(sketch, idx, n_groups=g)
    torch.cuda.synchronize()
    assert _same_bits(got, race_query_ordered_ref(sketch, idx, g))


@pytest.mark.cuda
def test_cuda_sketch_build_query_launch_kernels(cuda):
    """build and query on CUDA tensors launch lsh_hash, race_update and
    race_query once per call, and agree with the same sketch on the CPU
    (indices under the boundary rule, estimates within race_query_tol)."""
    from repro_torch.kernels.lsh_hash.ops import lsh_hash
    from repro_torch.kernels.race_update.ops import race_update

    sk = RepresenterSketch(SketchConfig(**_SK))
    state = sk.init(torch.Generator(cuda).manual_seed(0))
    points, alphas, queries = (_t(a).to(cuda) for a in _data(13))
    lsh_hash.launches = race_update.launches = race_query.launches = 0
    state = sk.build(state, points, alphas)
    got = sk.query(state, queries)
    torch.cuda.synchronize()
    assert (lsh_hash.launches, race_update.launches,
            race_query.launches) == (2, 1, 1)
    cpu_state = {"hash": {k: v.cpu() for k, v in state["hash"].items()},
                 "array": state["array"].cpu(), "mass": state["mass"].cpu()}
    idx = sk.lsh.hash(state["hash"], queries).cpu()
    want = race_query_ref(sk.debiased(cpu_state), idx, _SK["n_groups"])
    err = (got.cpu() - want).abs().double()
    assert bool((err <= race_query_tol(sk.debiased(cpu_state), idx,
                                       _SK["n_groups"])).all())


def test_race_query_refuses_bad_operands():
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="cpu or cuda"):
            race_query(torch.zeros((1, 4, 2), device="meta"),
                       torch.zeros((2, 4), dtype=torch.int32, device="meta"),
                       n_groups=2)
        return
    dev = torch.device("cuda")
    with pytest.raises(ValueError, match="n_groups"):
        race_query(torch.zeros((1, 4, 2), device=dev),
                   torch.zeros((2, 4), dtype=torch.int32, device=dev),
                   n_groups=65)
    with pytest.raises(TypeError, match="int32"):
        race_query(torch.zeros((1, 4, 2), device=dev),
                   torch.zeros((2, 4), dtype=torch.int64, device=dev),
                   n_groups=2)
