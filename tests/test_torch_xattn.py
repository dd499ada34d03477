"""Cross-attention to encoder states (the ``xattn`` layers of
llama-3.2-vision-11b) against the JAX package, on its smoke config (5
layers: 4 self-attention, 1 cross-attention; 16 encoder states a sample).

The vision frontend is a stub in both packages: the encoder states are
numpy-seeded bf16 values, the same for both.  Tolerances, each with its
reason:

* One cross-attention layer (``attention(kv_source=)``, JAX's run op by
  op): both project in bf16 and attend in f32 with the same roundings;
  the f32 sums may run in another order, which moves a bf16 rounding by
  at most one ulp: one bf16 ulp (2⁻⁸) relative plus 2⁻⁸ of the largest
  magnitude.
* The whole teacher-forced forward against JAX's compiled one: the bf16
  backbone rule of ``repro_torch.parity`` (XLA keeps excess precision
  inside its fusions).
* Greedy streams (``generate`` at decode_chunk 1 and 4, speculative
  decode): token for token, the JAX package's and the port's own dense
  stream.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import LM, SketchHead
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks, model
from repro_torch.models.config import SketchHeadConfig
from repro_torch.parity import assert_bf16_backbone_close

BF16_ULP = 2.0 ** -8
ARCH = "llama-3.2-vision-11b"
PROMPT, GEN = 7, 9
HEAD = dict(n_rows=32, n_buckets=8, k=1, proj_dim=16, bandwidth=2.0)


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
    """The JAX package's smoke model (key 0), a sketch head it froze (key
    42), the port's LMs on its params, prompts and encoder states."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.api import LM as JaxLM, SketchHead as JaxSketchHead
    from repro.configs import get_config
    from repro.core.sketch_lm_head import freeze_head
    from repro.models import attention as jattn
    from repro.models import model as jmodel
    from repro.models.config import SketchHeadConfig as JaxHeadConfig

    jcfg = get_config(ARCH, smoke=True)
    jparams = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    kp, ka, kj, kf = jax.random.split(jax.random.PRNGKey(42), 4)
    kparams = {"points": jax.random.normal(kp, (128, HEAD["proj_dim"])),
               "alphas": jax.random.normal(ka, (128, jcfg.vocab_size)) * 0.01,
               "proj": jax.random.normal(kj, (jcfg.d_model, HEAD["proj_dim"]))
               / np.sqrt(jcfg.d_model)}
    jfrozen = freeze_head(kf, kparams, JaxHeadConfig(**HEAD))
    frozen = {k: torch.from_numpy(np.array(v)) for k, v in jfrozen.items()}
    lm = LM.from_config(ARCH, smoke=True, device="cpu", params=params)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, jcfg.vocab_size, (3, PROMPT)).astype(np.int32)
    enc = torch.from_numpy(rng.standard_normal(
        (3, jcfg.n_encoder_tokens, jcfg.d_model)).astype(np.float32)).to(
            torch.bfloat16)
    return dict(
        jax=jax, jnp=jnp, attn=jattn, model=jmodel, cfg=jcfg,
        jparams=jparams, lm=lm,
        fused=lm.with_head(SketchHead(cfg=SketchHeadConfig(**HEAD),
                                      backend="fused", params=frozen)),
        jlm=JaxLM(jparams, jcfg),
        jfused=JaxLM(jparams, jcfg, JaxSketchHead(
            cfg=JaxHeadConfig(**HEAD), backend="fused", params=jfrozen)),
        prompts=prompts, enc=enc,
        jenc=jnp.asarray(enc.float().numpy(), jnp.bfloat16))


def test_pattern_has_a_cacheless_xattn_layer(jx):
    cfg = jx["lm"].cfg
    assert cfg.pattern[-1] == "xattn" and cfg.n_encoder_tokens == 16
    cache = model.init_decode_cache(cfg, 2, 12, device="cpu")
    assert cache["periods"]["pos4"] is None
    assert blocks.paged_geometry(cfg, "xattn", 12) is None
    assert not blocks.cache_needs_snapshot(cfg, "xattn", None)


@pytest.mark.parametrize("s", [PROMPT, 1])
def test_cross_attention_matches_jax(jx, s):
    """The ``kv_source`` branch of one layer's attention (no RoPE, no
    mask, grouped heads), JAX's run op by op."""
    jax, jnp, cfg = jx["jax"], jx["jnp"], jx["lm"].cfg
    a = blocks._attn_cfg(cfg, "xattn")
    assert a.window is None and not a.use_rope
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.standard_normal((3, s, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    jlayer = jax.tree.map(lambda t: t[0], jx["jparams"]["periods"]["pos4"])
    with jax.disable_jit():
        want, jc = jx["attn"].attention(
            jlayer["mixer"], jnp.asarray(x.float().numpy(), jnp.bfloat16),
            jnp.arange(s), jx["cfg"].attention.__class__(**vars(a)),
            kv_source=jx["jenc"])
    params = model._index(jx["lm"].params["periods"]["pos4"], 0)["mixer"]
    got, c = attn_mod.attention(params, x, torch.arange(s), a,
                                kv_source=jx["enc"])
    assert jc is None and c is None
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP,
                               atol=BF16_ULP * np.abs(want).max())


@pytest.mark.parametrize("with_states", [True, False])
def test_forward_teacher_forced_matches_jax(jx, with_states):
    """The whole smoke forward, teacher-forced, with the encoder states
    and (as the JAX package allows) without them, when the ``xattn``
    layer is cacheless causal self-attention without RoPE."""
    jnp = jx["jnp"]
    toks = np.random.default_rng(5).integers(0, jx["cfg"].vocab_size,
                                             (3, 20)).astype(np.int32)
    want, _, _ = jx["model"].forward(
        jx["jparams"], jnp.asarray(toks), jx["cfg"], remat=False,
        encoder_states=jx["jenc"] if with_states else None)
    got, _ = model.forward(jx["lm"].params, torch.from_numpy(toks),
                           jx["lm"].cfg,
                           encoder_states=jx["enc"] if with_states else None)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert_bf16_backbone_close(got.numpy(), np.asarray(want))


def test_decode_step_matches_jax(jx):
    """A bulk prefill into a fresh cache, then one decode step (the
    ``xattn`` layer recomputes the encoder keys and values): the last
    hidden against JAX's under the bf16 rule, and the in-place step equal
    to the functional one bit for bit."""
    jnp, cfg, lm = jx["jnp"], jx["cfg"], jx["lm"]
    toks = jx["prompts"]
    jcache = jx["model"].init_decode_cache(cfg, 3, PROMPT + 1)
    _, jcache, _ = jx["model"].forward(
        jx["jparams"], jnp.asarray(toks), cfg, cache=jcache,
        cache_pos=jnp.zeros((), jnp.int32), remat=False,
        encoder_states=jx["jenc"])
    want, _ = jx["model"].decode_step(
        jx["jparams"], jcache, jnp.asarray(toks[:, :1]),
        jnp.asarray(PROMPT, jnp.int32), cfg, encoder_states=jx["jenc"],
        return_hidden=True)
    cache = model.init_decode_cache(lm.cfg, 3, PROMPT + 1, device="cpu")
    _, cache = model.forward(lm.params, torch.from_numpy(toks), lm.cfg,
                             cache=cache, cache_pos=0, encoder_states=jx["enc"])
    got, _ = model.decode_step(lm.params, cache, torch.from_numpy(toks[:, :1]),
                               lm.cfg, cache_pos=PROMPT, return_hidden=True,
                               encoder_states=jx["enc"])
    assert_bf16_backbone_close(got.numpy(), np.asarray(want))
    got_, _ = model.decode_step_(lm.params, cache,
                                 torch.from_numpy(toks[:, :1]), lm.cfg,
                                 cache_pos=PROMPT, return_hidden=True,
                                 encoder_states=jx["enc"])
    assert torch.equal(got_, got)


@pytest.mark.parametrize("chunk", [1, 4])
def test_generate_with_encoder_states_matches_jax(jx, chunk):
    jnp = jx["jnp"]
    want = np.asarray(jx["jlm"].generate(jnp.asarray(jx["prompts"]), GEN,
                                         encoder_states=jx["jenc"],
                                         decode_chunk=chunk))
    got = jx["lm"].generate(torch.from_numpy(jx["prompts"]), GEN,
                            encoder_states=jx["enc"], decode_chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    # Another set of states gives another stream (the states are read).
    other = jx["lm"].generate(torch.from_numpy(jx["prompts"]), GEN,
                              encoder_states=-jx["enc"], decode_chunk=chunk)
    assert not torch.equal(other, got)


@pytest.mark.parametrize("k", [1, 4])
def test_spec_decode_equals_dense_and_jax(jx, k):
    """Fused drafts verified by the dense head: the dense stream, and the
    JAX package's spec tokens and stats."""
    jnp = jx["jnp"]
    prompts = torch.from_numpy(jx["prompts"])
    dense = jx["lm"].generate(prompts, GEN, encoder_states=jx["enc"])
    got, stats = jx["fused"].generate(prompts, GEN, encoder_states=jx["enc"],
                                      spec_decode=k, return_stats=True)
    want, jstats = jx["jfused"].generate(jnp.asarray(jx["prompts"]), GEN,
                                         encoder_states=jx["jenc"],
                                         spec_decode=k, return_stats=True)
    assert torch.equal(got, dense)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == jstats


def test_decode_loop_rejects_other_encoder_shapes(jx):
    """A memoized loop keeps a static buffer of the states' shape; a call
    with another number of states builds another loop."""
    lm = jx["lm"]
    prompts = torch.from_numpy(jx["prompts"])
    a = lm.generate(prompts, GEN, encoder_states=jx["enc"], decode_chunk=4)
    b = lm.generate(prompts, GEN, encoder_states=jx["enc"][:, :8],
                    decode_chunk=4)
    assert a.shape == b.shape
    loop = next(iter(lm._loops.values()))
    with pytest.raises(ValueError, match="encoder states of shape"):
        loop.load(a[:, -1], PROMPT, encoder_states=jx["enc"])


def test_engine_raises_as_jax(jx):
    """Neither package's engine serves an encoder-conditioned arch: its
    requests carry no encoder states."""
    from repro.launch.engine import EngineBackend as JaxBackend
    with pytest.raises(NotImplementedError) as theirs:
        JaxBackend(jx["jparams"], jx["cfg"])
    with pytest.raises(NotImplementedError) as ours:
        jx["lm"].engine(2, PROMPT + GEN)
    assert str(ours.value) == str(theirs.value)


def test_serve_cli_stub_encoder_states(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "6", "--gen", "4", "--decode-chunk", "2"])
    out = capsys.readouterr().out
    assert "arch=llama-3.2-vision-11b-smoke" in out and "decode chunk 2" in out


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured decode step is a CUDA "
                    "graph; the eager loop is tested above")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_generate_with_encoder_states(cuda):
    """llama-vision's smoke model on the card: the captured decode step
    (the encoder states in its static buffer, refilled by ``load``) gives
    the eager stream at decode_chunk 4, and spec decode gives it too; new
    states give another stream through the same captured loop."""
    lm = LM.from_config(ARCH, smoke=True, device=cuda)
    g = torch.Generator(cuda).manual_seed(3)
    prompts = torch.randint(0, lm.cfg.vocab_size, (3, PROMPT), generator=g,
                            device=cuda)
    enc = torch.randn((3, lm.cfg.n_encoder_tokens, lm.cfg.d_model),
                      generator=g, device=cuda).to(torch.bfloat16)
    eager = lm.generate(prompts, GEN, encoder_states=enc)
    assert torch.equal(lm.generate(prompts, GEN, encoder_states=enc,
                                   decode_chunk=4), eager)
    assert torch.equal(lm.generate(prompts, GEN, encoder_states=enc,
                                   spec_decode=4), eager)
    loop = next(v for k, v in lm._loops.items() if k[0] == "chunk")
    assert loop.graph is not None
    other = lm.generate(prompts, GEN, encoder_states=-enc, decode_chunk=4)
    assert torch.equal(other, lm.generate(prompts, GEN, encoder_states=-enc))
    assert next(v for k, v in lm._loops.items() if k[0] == "chunk") is loop
