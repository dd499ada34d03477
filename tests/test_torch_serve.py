"""The port's serving path against the JAX package, on smoke configs.

Sketch heads travel between the packages as ``.npz`` archives, both ways.
Hash indices and logits are held to ``repro_torch.parity``'s rules;
the bf16 backbone is compared teacher-forced on one token stream, with
``test_torch_model``'s tolerance.  Free-running sketched streams are not
compared: a bf16 ulp in the hidden can flip a floor() bucket.
"""

import dataclasses
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.api.heads import load_head as jax_load_head
from repro.api.sampler import Sampler as JaxSampler
from repro.configs import get_config as jax_config
from repro.core import sketch_lm_head as jhead
from repro.models import model as jmodel
from repro.models.config import SketchHeadConfig as JaxSketchHeadConfig
from repro_torch.api import LM, Sampler, SketchHead, load_head
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import sketch_lm_head as head_mod
from repro_torch.kernels.lsh_hash.ops import lsh_hash_ref
from repro_torch.parity import (assert_bf16_backbone_close,
                                check_hash_indices, gather_atol)
from repro_torch.kernels.sketch_head.ops import (dequantize_sketch_ref,
                                                 sketch_head_ref)
from repro_torch.launch import serve
from repro_torch.launch.steps import prefill_step, serve_step
from repro_torch.models import model
from repro_torch.models.config import SketchHeadConfig

REPO = Path(__file__).resolve().parents[1]
ARCH = "rwkv6-1.6b"
HEAD_CFG = dict(n_rows=9, n_buckets=5, k=2, proj_dim=8, bandwidth=2.0)
QUANTS = [None, "int8", "int4"]


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


def _kernel_params(seed, d, v, m=32, dp=8):
    rng = np.random.default_rng(seed)
    return {"points": rng.standard_normal((m, dp)).astype(np.float32),
            "alphas": rng.standard_normal((m, v)).astype(np.float32) * 0.1,
            "proj": (rng.standard_normal((d, dp)) / np.sqrt(d)).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_archives(tmp_path_factory):
    """Heads frozen and saved by the JAX package, at the smoke widths
    (d_model 64, vocab 256), plus the checked-in v1 archive."""
    d = tmp_path_factory.mktemp("jax_heads")
    cfg = JaxSketchHeadConfig(**HEAD_CFG)
    kp = {k: jnp.asarray(v) for k, v in _kernel_params(0, 64, 256).items()}
    paths = {}
    for quant in QUANTS:
        frozen = jhead.freeze_head(jax.random.PRNGKey(1), kp, cfg, quant=quant)
        paths[quant] = d / f"head_{quant}.npz"
        jhead.save_head(paths[quant], frozen, cfg, backend="two_kernel",
                        quant=quant)
    paths["legacy"] = REPO / "tests" / "data" / "legacy_head_v1.npz"
    return paths


def _hidden(seed, b, d, dtype=jnp.bfloat16):
    return jnp.asarray(np.random.default_rng(seed).standard_normal((b, d)),
                       dtype)


def check_head_logits(got, want, head, hidden, cfg, quant):
    """The boundary rule on the two packages' indices, then logits within
    the gather bound on rows whose indices agree, and on every row against
    the plain gather at the port's own indices."""
    h32 = hidden.to(torch.float32)
    ours = lsh_hash_ref(h32 @ head["proj"], head["w"], head["b"],
                        cfg.bandwidth, cfg.n_buckets)
    theirs = jhead.lsh_hash(jnp.asarray(h32.numpy()) @ np.asarray(head["proj"]),
                            np.asarray(head["w"]), np.asarray(head["b"]),
                            bandwidth=cfg.bandwidth, n_buckets=cfg.n_buckets,
                            backend="ref")
    check_hash_indices(ours, torch.from_numpy(np.array(theirs)), h32,
                       head["w"], head["b"], cfg.bandwidth, proj=head["proj"])
    deq = (head["array"] if quant is None
           else dequantize_sketch_ref(head["array"], head["scale"], quant))
    atol = gather_atol(cfg.n_rows, float(deq.abs().max()))
    torch.testing.assert_close(
        got, sketch_head_ref(head["array"], ours, head.get("scale"), quant),
        rtol=0, atol=atol)
    same = (ours.numpy() == np.asarray(theirs)).all(axis=1)
    np.testing.assert_allclose(got.numpy()[same], np.asarray(want)[same],
                               rtol=0, atol=atol)


# -------------------------------------------------------- head archives

@pytest.mark.parametrize("which", QUANTS + ["legacy"])
def test_jax_archive_loads_in_port(jax_archives, which):
    jparams, jcfg, jmeta = jhead.load_head_full(jax_archives[which])
    params, cfg, meta = head_mod.load_head_full(jax_archives[which], "cpu")
    assert meta == jmeta
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert set(params) == set(jparams)
    for k, v in jparams.items():
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(v))
    head = SketchHead.load(jax_archives[which], device="cpu")
    assert (head.backend, head.quant) == (jmeta["backend"], jmeta["quant"])


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_dequantize_head_matches_jax(jax_archives, quant):
    jparams, _, _ = jhead.load_head_full(jax_archives[quant])
    params, _, _ = head_mod.load_head_full(jax_archives[quant], "cpu")
    want = jhead.dequantize_head(jparams, quant)
    got = head_mod.dequantize_head(params, quant)
    assert set(got) == set(want) == {"proj", "w", "b", "array"}
    np.testing.assert_array_equal(got["array"].numpy(), np.asarray(want["array"]))


@pytest.mark.parametrize("backend", ["fused", "two_kernel", "ref"])
@pytest.mark.parametrize("which", QUANTS + ["legacy"])
def test_apply_head_matches_jax(jax_archives, which, backend):
    jparams, jcfg, meta = jhead.load_head_full(jax_archives[which])
    params, cfg, _ = head_mod.load_head_full(jax_archives[which], "cpu")
    d = params["proj"].shape[0]
    hid = _hidden(7, 3, d)
    want = jhead.apply_head(jparams, hid, jcfg, backend=backend,
                            quant=meta["quant"])
    h32 = torch.from_numpy(np.array(hid.astype(jnp.float32)))
    got = head_mod.apply_head(params, h32.to(torch.bfloat16), cfg,
                              backend=backend, quant=meta["quant"])
    assert got.dtype == torch.float32 and got.shape == want.shape
    check_head_logits(got, want, params, h32, cfg, meta["quant"])


@pytest.mark.parametrize("quant", QUANTS)
def test_port_archive_loads_in_jax(tmp_path, quant):
    cfg = SketchHeadConfig(**HEAD_CFG)
    kp = {k: torch.from_numpy(v) for k, v in _kernel_params(3, 64, 256).items()}
    frozen = head_mod.freeze_head(torch.Generator().manual_seed(0), kp, cfg,
                                  quant=quant)
    path = tmp_path / "port_head.npz"
    SketchHead(cfg=cfg, backend="fused", quant=quant, params=frozen).save(path)
    jh = jax_load_head(path)
    assert (jh.kind, jh.backend, jh.quant) == ("sketch", "fused", quant)
    assert dataclasses.asdict(jh.cfg) == dataclasses.asdict(cfg)
    for k, v in frozen.items():
        np.testing.assert_array_equal(np.asarray(jh.params[k]), v.numpy())
    hid = _hidden(8, 4, 64, jnp.float32)
    h32 = torch.from_numpy(np.array(hid))
    check_head_logits(head_mod.apply_head(frozen, h32, cfg, quant=quant),
                      jh.apply(jh.params, hid), frozen, h32, cfg, quant)


def test_freeze_head_sums_anchor_weights_per_bucket():
    """array[l, r, v] = Σ_m [idx[m, l] = r]·α[m, v], with idx from the JAX
    package's L2LSH on the bank the port drew."""
    cfg = SketchHeadConfig(**HEAD_CFG)
    kp = _kernel_params(4, 64, 256)
    frozen = head_mod.freeze_head(
        torch.Generator().manual_seed(1),
        {k: torch.from_numpy(v) for k, v in kp.items()}, cfg)
    from repro.core.lsh import L2LSH, LSHConfig
    jl = L2LSH(LSHConfig(n_rows=9, n_buckets=5, k=2, dim=8, bandwidth=2.0))
    idx = np.asarray(jl.hash({"w": frozen["w"].numpy(),
                              "b": frozen["b"].numpy()}, kp["points"]))
    onehot = np.eye(5)[idx]                                  # (M, L, R)
    want = np.einsum("mlr,mv->lrv", onehot, kp["alphas"].astype(np.float64))
    # f32 sums of M = 32 terms against float64: γ_32 · Σ|α|.
    tol = 32 * 2.0 ** -24 * np.abs(kp["alphas"]).sum(0).max() * 1.01
    np.testing.assert_allclose(frozen["array"].numpy(), want, rtol=0, atol=tol)


# -------------------------------------------------------------- sampler

def test_greedy_tokens_exact_on_identical_logits():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((16, 300)).astype(np.float32)
    logits = np.array(jnp.asarray(logits, jnp.bfloat16).astype(jnp.float32))
    logits[:, 17] = logits[:, 250] = logits.max() + 1.0   # a tie: first wins
    logits[3, :] = 0.0                                     # all tied
    _, want = JaxSampler().sample(jax.random.PRNGKey(0), jnp.asarray(logits))
    key = Sampler().init_key()
    key_out, got = Sampler().sample(key, torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0] == 17 and got[3] == 0
    assert key_out is key                     # greedy never splits the key


def test_sampler_is_greedy_only():
    """The reference's checks and ``describe()``: the same ``ValueError``
    for a negative temperature or top_k and a top_p outside (0, 1], and
    the same summary for every policy (a seeded one no longer raises)."""
    for bad in (dict(temperature=-1.0), dict(top_k=-1), dict(top_p=0),
                dict(top_p=1.5)):
        with pytest.raises(ValueError) as ours:
            Sampler(**bad)
        with pytest.raises(ValueError) as theirs:
            JaxSampler(**bad)
        assert str(ours.value) == str(theirs.value)
    for spec in (dict(), dict(temperature=0.8, top_k=40, seed=1),
                 dict(temperature=1.0, top_p=0.9, seed=3),
                 dict(temperature=0.5, top_k=3, top_p=0.25)):
        assert Sampler(**spec).describe() == JaxSampler(**spec).describe()
    assert not Sampler(temperature=0.8).is_greedy


# ------------------------------------------------------------- generate

@pytest.fixture(scope="module")
def smoke_models():
    jcfg, cfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jparams = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    prompts = np.random.default_rng(1).integers(0, 256, (3, 12)).astype(np.int32)
    return jcfg, cfg, jparams, params, prompts


@pytest.mark.parametrize("kind,which", [("dense", None), ("sketch", None),
                                        ("sketch", "int8")])
def test_generate_teacher_forced_against_jax(smoke_models, jax_archives,
                                             kind, which):
    """The port's stream, fed back through both packages step by step: the
    dense logits (and, sketched, the hiddens) agree with JAX's within the
    bf16 tolerance, each sketched step's logits agree with JAX's head on
    the port's hidden, and every emitted token is the argmax of the port's
    own logits."""
    _teacher_forced_against_jax(smoke_models, jax_archives, kind, which, 1)


@pytest.mark.parametrize("kind,which", [("dense", None), ("sketch", None),
                                        ("sketch", "int8")])
def test_chunked_generate_teacher_forced_against_jax(smoke_models,
                                                     jax_archives, kind,
                                                     which):
    """The same check on the stream of ``generate(decode_chunk=3)``: two
    megasteps (3 and 1 steps) after the prefill's token."""
    _teacher_forced_against_jax(smoke_models, jax_archives, kind, which, 3)


def _teacher_forced_against_jax(smoke_models, jax_archives, kind, which,
                                decode_chunk):
    jcfg, cfg, jparams, params, prompts = smoke_models
    head = None
    lm = LM.from_config(ARCH, smoke=True, device="cpu", params=params)
    if kind == "sketch":
        head = SketchHead.load(jax_archives[which], device="cpu")
        jh = jax_load_head(jax_archives[which])
        lm = lm.with_head(head)
    gen = 5
    tokens = lm.generate(prompts, gen, decode_chunk=decode_chunk)
    assert tokens.shape == (3, 12 + gen) and tokens.dtype == torch.int64
    np.testing.assert_array_equal(tokens[:, :12].numpy(), prompts)

    b, p = prompts.shape
    cache = model.init_decode_cache(cfg, b, p + gen, device="cpu")
    logits, cache = prefill_step(params, torch.from_numpy(prompts), cfg, cache)
    jcache = jmodel.init_decode_cache(jcfg, b, p + gen)
    jlogits, jcache, _ = jmodel.forward(jparams, jnp.asarray(prompts), jcfg,
                                        cache=jcache,
                                        cache_pos=jnp.zeros((), jnp.int32),
                                        remat=False)
    assert_bf16_backbone_close(logits.numpy(), np.asarray(jlogits[:, -1]))
    for t in range(gen):
        nxt = tokens[:, p + t]
        np.testing.assert_array_equal(nxt.numpy(), logits.argmax(-1).numpy())
        if t == gen - 1:
            break
        prev = cache                 # the port's steps never mutate a cache
        logits, cache = serve_step(params, prev, nxt[:, None], cfg, head=head)
        jtok = jnp.asarray(nxt.numpy()[:, None].astype(np.int32))
        pos = jnp.asarray(p + t, jnp.int32)
        if head is None:
            jlog, jcache = jmodel.decode_step(jparams, jcache, jtok, pos, jcfg)
            assert_bf16_backbone_close(logits.numpy(), np.asarray(jlog))
            continue
        jhid, jcache = jmodel.decode_step(jparams, jcache, jtok, pos, jcfg,
                                          return_hidden=True)
        hid, _ = model.decode_step(params, prev, nxt[:, None], cfg,
                                   return_hidden=True)
        assert_bf16_backbone_close(hid.numpy(), np.asarray(jhid))
        check_head_logits(logits, jh.apply(jh.params, jnp.asarray(hid.numpy())),
                          head.params, hid, head.cfg, head.quant)


def test_generate_eos_pads_finished_rows(smoke_models):
    _, _, _, params, prompts = smoke_models
    lm = LM.from_config(ARCH, smoke=True, device="cpu", params=params)
    free = lm.generate(prompts, 6)
    eos = int(free[0, 12 + 2])                 # row 0 emits it at step 2
    out = lm.generate(prompts, 6, eos_id=eos, pad_id=-1)
    assert out.shape == free.shape
    for row in range(3):
        hits = (free[row, 12:] == eos).nonzero()
        stop = 12 + (int(hits[0]) + 1 if len(hits) else 6)
        np.testing.assert_array_equal(out[row, :stop].numpy(),
                                      free[row, :stop].numpy())
        assert bool((out[row, stop:] == -1).all())


# ---------------------------------------------------- port boundaries

def test_port_imports_no_jax_and_no_repro():
    """Every repro_torch module and chip_smoke.py import in a fresh process
    without loading jax or any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(sum(n.startswith('repro_torch') for n in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_entry_points_default_to_cuda(tmp_path, jax_archives):
    for fn in (LM.from_config, SketchHead.load, load_head,
               head_mod.load_head_full, model.init_decode_cache):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM.from_config(ARCH, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--smoke"])
    with pytest.raises((RuntimeError, AssertionError)):
        SketchHead.load(jax_archives[None])


def test_serve_cli_on_cpu(tmp_path, jax_archives, capsys):
    serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "3"])
    assert "head=dense" in capsys.readouterr().out
    serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "3", "--sketch-head",
                "--head-path", str(jax_archives[None]), "--quant", "int4",
                "--backend", "fused"])
    assert "head=sketch/fused/int4" in capsys.readouterr().out
    # Without --head-path the head is distilled in process.
    serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "3", "--sketch-head"])
    out = capsys.readouterr().out
    assert "distill MSE" in out and "head=sketch/fused" in out
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--sketch-head",
                    "--tenants", "2"])
    assert "--tenants needs --engine" in capsys.readouterr().err
