"""int8 error-feedback gradient compression against the JAX package's.

``compressed_psum`` runs over four spawned gloo ranks (``tests/torch_mesh.py``,
one CPU thread each) and must equal the JAX package's bit for bit: the JAX
side binds its ``"data"`` axis with ``jax.vmap(..., axis_name="data")``
over the four stacked gradients, so it needs no forced devices, and runs
op by op: under ``jax.jit`` XLA's CPU backend turns the division of the
amax by 127 into a product by the reciprocal, one f32 ulp off for some
values (rank 3's bias leaf here), while the eager ops are the reference's
arithmetic as written.  Two rounds run, the second on the first's error
feedback.  Twins of the int8
round-trip cases and of the one-rank case of ``tests/test_optim.py`` run
here too (the one-rank group is a subgroup of each spawned rank).  ~10 s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pathlib import Path

from repro_torch.optim.compress import (compress_grad_leaf, dequantize_int8,
                                        init_error_feedback, quantize_int8,
                                        quantize_symmetric)

WORLD = 4
SHAPES = {"w": (64, 24), "b": (24,), "deep": {"u": (7, 5, 3)}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grads(seed):
    """Per-rank gradient trees (numpy f32), rank r's scaled by 1 + r."""
    rng = np.random.default_rng(seed)

    def tree(shapes, r):
        return {k: tree(v, r) if isinstance(v, dict) else
                (rng.standard_normal(v) * (1 + r)).astype(np.float32)
                for k, v in shapes.items()}
    return [tree(SHAPES, r) for r in range(WORLD)]


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _to_numpy(tree):
    return {k: _to_numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def compress_ranks(rank, world):
    """Two rounds of ``compressed_psum`` over the world, the second on the
    first's error; then the one-rank case.  Returns every rank's means and
    errors (gathered)."""
    import torch.distributed as dist

    from repro_torch.optim.compress import compressed_psum

    out = {}
    err = init_error_feedback(_to_torch(_grads(0)[rank]))
    for rnd in range(2):
        g = _to_torch(_grads(rnd)[rank])
        mean, err = compressed_psum(g, err)
        gathered = [None] * world
        dist.all_gather_object(gathered, (_to_numpy(mean), _to_numpy(err)))
        out[f"round{rnd}"] = gathered
    solo = [dist.new_group([i]) for i in range(world)][rank]
    g = {"w": torch.linspace(-1, 1, 32)}
    mean, new_e = compressed_psum(g, init_error_feedback(g), group=solo)
    gathered = [None] * world
    dist.all_gather_object(gathered, (mean["w"] + new_e["w"] - g["w"])
                           .abs().max().item())
    out["solo"] = gathered
    return out


@pytest.fixture(scope="module")
def ranks():
    from torch_mesh import run_ranks

    return run_ranks(str(Path(__file__)), "compress_ranks", world=WORLD,
                     timeout=120)


@pytest.fixture(scope="module")
def jax_rounds():
    """The JAX package's two rounds, its data axis bound by vmap, op by
    op (see the module docstring)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.optim.compress import compressed_psum as jpsum
    from repro.optim.compress import init_error_feedback as jinit

    f = jax.vmap(lambda g, e: jpsum(g, e, "data"), axis_name="data")
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    err = stack([jinit(jax.tree.map(jnp.asarray, t)) for t in _grads(0)])
    rounds = []
    for rnd in range(2):
        mean, err = f(stack([jax.tree.map(jnp.asarray, t)
                             for t in _grads(rnd)]), err)
        rounds.append(jax.tree.map(np.asarray, (mean, err)))
    return rounds


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("rnd", [0, 1])
def test_compressed_psum_matches_jax_bitwise(ranks, jax_rounds, rnd):
    jmean, jerr = jax_rounds[rnd]
    jm, je = dict(_leaves(jmean)), dict(_leaves(jerr))
    for r, (mean, err) in enumerate(ranks[f"round{rnd}"]):
        for path, got in _leaves(mean):
            np.testing.assert_array_equal(got, jm[path][r], err_msg=path)
        for path, got in _leaves(err):
            np.testing.assert_array_equal(got, je[path][r], err_msg=path)


def test_compressed_psum_mean_is_replicated(ranks):
    """Every rank gets the same mean bits (the all-reduced int32 sum)."""
    for rnd in (0, 1):
        means = [dict(_leaves(m)) for m, _ in ranks[f"round{rnd}"]]
        for path in means[0]:
            for m in means[1:]:
                np.testing.assert_array_equal(m[path], means[0][path])


def test_compressed_psum_single_rank_group(ranks):
    """On a one-rank group the mean plus the new error is the gradient
    (``tests/test_optim.py``'s one-device mesh)."""
    assert max(ranks["solo"]) <= 1e-5


def test_quantize_roundtrip_error_bounded():
    x = torch.tensor(np.random.default_rng(0).standard_normal(1000) * 3.0,
                     dtype=torch.float32)
    q, scale = quantize_int8(x)
    err = (dequantize_int8(q, scale) - x).abs().numpy()
    assert err.max() <= float(scale) / 2 + 1e-6


def test_error_feedback_is_lossless_in_sum():
    """Σ_t dequant(q_t) == Σ_t g_t up to one residual: EF telescopes."""
    rng = np.random.default_rng(1)
    g_total = torch.zeros(64)
    sent_total = torch.zeros(64)
    err = torch.zeros(64)
    for _ in range(50):
        g = torch.tensor(rng.standard_normal(64), dtype=torch.float32)
        q, scale, err = compress_grad_leaf(g, err)
        sent_total = sent_total + dequantize_int8(q, scale)
        g_total = g_total + g
    np.testing.assert_allclose((sent_total + err).numpy(), g_total.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_quantize_int8_and_grad_leaf_match_jax():
    jnp = pytest.importorskip("jax.numpy")
    from repro.optim import compress as jc

    rng = np.random.default_rng(2)
    x = (rng.standard_normal((33, 17)) * 5).astype(np.float32)
    e = (rng.standard_normal((33, 17)) * 0.1).astype(np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    jq, js = jc.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np.float32(s) == np.asarray(js)
    got = compress_grad_leaf(torch.from_numpy(x), torch.from_numpy(e))
    want = jc.compress_grad_leaf(jnp.asarray(x), jnp.asarray(e))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("bits,axis", [(8, None), (8, -1), (4, -1),
                                       (4, (1, 2))])
def test_quantize_symmetric_matches_jax(bits, axis):
    """The one copy the sketch head's storage and the gradients share."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.optim import compress as jc

    x = (np.random.default_rng(3).standard_normal((6, 5, 9)) * 4).astype(
        np.float32)
    x[2] = 0.0                                     # an all-zero slice
    q, s = quantize_symmetric(torch.from_numpy(x), bits=bits, axis=axis)
    jq, js = jc.quantize_symmetric(jnp.asarray(x), bits=bits, axis=axis)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
