"""The plain-attention archs not run elsewhere on a 2×2 gloo mesh, and the
mesh's tokens against the JAX package.

stablelm-12b (head dim 160, partial rotary), musicgen-large and
command-r-35b at smoke size: ``LM.with_mesh`` serves the dense stream of
the single-device model at decode_chunk 1 and 4 and through the engine
(``test_torch_sharded_archs.arch_ranks``).  Then rwkv6-1.6b and gemma2-27b
smoke with the JAX package's own params (``init_model`` at key 0): the
mesh's greedy tokens equal the JAX package's ``generate`` on the same
params and prompts (those of ``test_torch_attention``'s token test, whose
single-device tokens equal the JAX package's).  One module fixture spawns four gloo ranks
(``tests/torch_mesh.py``, one CPU thread each); the JAX side runs in this
process.  ~60 s on an idle machine.
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pathlib import Path

from test_torch_sharded_archs import check_streams

ARCHS = ["stablelm-12b", "musicgen-large", "command-r-35b"]
JAX_ARCHS = ["rwkv6-1.6b", "gemma2-27b"]
# test_torch_attention's JAX token test's prompts and length: 3 rows, so
# the batch replicates over data here (every other mesh stream splits it).
PROMPTS = np.random.default_rng(1).integers(0, 256, (3, 12)).astype(np.int32)
GEN = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dense_ranks(rank, world, params_file, *archs):
    """``archs``' streams (``arch_ranks``), and the mesh's greedy tokens
    for each JAX_ARCHS model whose numpy params ``params_file`` holds."""
    from test_torch_sharded_archs import arch_ranks

    from repro_torch.api import LM
    from repro_torch.convert import params_from_numpy

    out = arch_ranks(rank, world, *archs)
    with open(params_file, "rb") as f:
        trees = pickle.load(f)
    for arch in JAX_ARCHS:
        lm = LM.from_config(arch, smoke=True, device="cpu",
                            params=params_from_numpy(trees[arch], "cpu"))
        out[f"{arch}/jax-params/mesh"] = lm.with_mesh("2x2").generate(
            PROMPTS, GEN).numpy()
    return out


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's params (numpy) and greedy tokens per arch."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch.serve import generate
    from repro.models import model

    trees, tokens = {}, {}
    for arch in JAX_ARCHS:
        cfg = get_config(arch, smoke=True)
        params = model.init_model(jax.random.PRNGKey(0), cfg)
        trees[arch] = jax.tree.map(np.asarray, params)
        tokens[arch] = np.asarray(generate(params, cfg, jnp.asarray(PROMPTS),
                                           GEN))
    path = tmp_path_factory.mktemp("jax_params") / "params.pkl"
    with open(path, "wb") as f:
        pickle.dump(trees, f)
    return path, tokens


@pytest.fixture(scope="module")
def r(jax_runs):
    from torch_mesh import run_ranks

    return run_ranks(str(Path(__file__)), "dense_ranks", world=4, timeout=240,
                     args=(str(jax_runs[0]), *ARCHS))


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_stream_on_mesh_equals_one_device(r, arch):
    check_streams(r, arch)


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_mesh_tokens_equal_jax_generate(r, jax_runs, arch):
    np.testing.assert_array_equal(r[f"{arch}/jax-params/mesh"],
                                  jax_runs[1][arch])
