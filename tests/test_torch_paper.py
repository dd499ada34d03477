"""The paper's recipe in the port (teacher → distill → freeze → query), the
in-process head distillation and the serve CLI that uses it, against the
JAX package where the two compute the same thing.

``jax.random`` draws cannot be replayed in torch, so the JAX package's
params and hash params are carried across (``repro_torch.convert``) and
both packages run the same deterministic functions on the same numpy
inputs.  Tolerances:

* ``mlp_forward``: each layer's f32 products of n terms, in any order,
  are within ``γ_{n+1}`` of the summed magnitudes; the bound is propagated
  through the layers in float64 (ReLU is 1-Lipschitz) and the two packages
  may differ by twice it.
* ``KernelModel.apply``: ``1e-5·Σ_j |α_j|`` per output — every kernel
  value is a probability in [0, 1], and with the anchors at least 0.3 from
  every query the f32 distance's relative error (the expansion
  ‖q‖² − 2q·x + ‖x‖² cancels to ≤ γ·norms²/dist²) keeps each within 1e-5.
* Losses ``4·γ_B`` relative (a mean of B f32 terms); gradients
  ``4·γ_{B·M}`` of each leaf's largest gradient (autograd sums over the
  batch and the anchors in its own order); one Adam step within ``16u``
  of its operands per element, ``|p| + |Δp|`` for the params (a handful of
  f32 roundings), plus, on the step, the conditioning of the f32 bias
  corrections 1 − βᵗ to a one-ulp difference of βᵗ (``_kappa``).
* The whole slice: hash indices under the boundary rule, estimates within
  ``race_query_tol`` (``repro_torch.parity``) on every query whose
  indices agree and whose buckets no build mismatch touched; the others
  against the port's own plain version.

The port's own ``run_dataset`` is held to tests/test_distill.py's
relations (kernel ≥ teacher − 0.08, sketch ≥ kernel − 0.10).  The ``cuda``
case runs the recipe on the card and skips without one; it imports no JAX
(``python -m pytest --noconftest -m cuda tests/test_torch_paper.py``).
"""

import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import LM
from repro_torch.convert import (kernel_params_from_numpy,
                                 sketch_state_from_numpy, teacher_from_numpy)
from repro_torch.core import distill as distill_mod
from repro_torch.core import sketch_lm_head as head_mod
from repro_torch.core.kernel_model import (KernelModel, KernelModelConfig,
                                           mlp_flops, mlp_memory_params)
from repro_torch.core.sketch import RepresenterSketch
from repro_torch.core.teacher import (MLPConfig, accuracy, init_mlp, mae,
                                      mlp_forward, mlp_loss, train_mlp)
from repro_torch.data.tabular import DATASETS, make_dataset
from repro_torch.kernels.race_query.ops import race_query_ref
from repro_torch.launch import paper_repro, serve
from repro_torch.models.config import SketchHeadConfig
from repro_torch.parity import U32, _gamma, check_hash_indices, race_query_tol

ARCH = "rwkv6-1.6b"


@pytest.fixture(scope="module")
def jx():
    """The JAX package's functions (imported here, so that the cuda case
    also runs where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import kernel_model as jkm
    from repro.core import sketch_lm_head as jhead
    from repro.core import teacher as jteacher
    return dict(jax=jax, jnp=jnp, km=jkm, teacher=jteacher, head=jhead,
                distill=importlib.import_module("repro.core.distill"))


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
        pytest.skip("needs a CUDA device: the sketch's hash, fold and query "
                    "are CUDA C++ kernels with no CPU mode")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return np.asarray(tree)


def _mlp_bound(params, x):
    """Float64 bound on one f32 evaluation's error of ``mlp_forward``."""
    mag = np.abs(x).astype(np.float64)
    err = np.zeros_like(mag)
    for layer in params:
        w = np.abs(layer["w"]).astype(np.float64)
        mag = mag @ w + np.abs(layer["b"])
        err = err @ w + _gamma(w.shape[0] + 1) * mag
    return err


def _kernel_model(seed=0, d=12, dp=6, m=40, c=3, k=2):
    cfg = dict(in_dim=d, proj_dim=dp, n_points=m, n_outputs=c, bandwidth=2.0,
               k=k)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((50, d)).astype(np.float32)
    params = {"proj": (rng.standard_normal((d, dp)) / np.sqrt(d)
                       ).astype(np.float32),
              "alphas": rng.standard_normal((m, c)).astype(np.float32)}
    # Anchors near (not on) projected samples: every distance >= 0.3.
    params["points"] = (x[:m] @ params["proj"]
                        + 0.3 * np.sign(rng.standard_normal((m, dp)))
                        ).astype(np.float32)
    return cfg, params, x


# -- the MLP teacher and the kernel model ----------------------------------------

def test_mlp_forward_matches_jax(jx):
    rng = np.random.default_rng(1)
    cfg = jx["teacher"].MLPConfig(12, (32, 16), 3)
    params = _np(jx["teacher"].init_mlp(jx["jax"].random.PRNGKey(1), cfg))
    for layer in params:
        layer["b"] = (0.1 * rng.standard_normal(layer["b"].shape)
                      ).astype(np.float32)
    x = rng.standard_normal((50, 12)).astype(np.float32)
    got = mlp_forward(teacher_from_numpy(params, "cpu"), _t(x)).numpy()
    want = np.asarray(jx["teacher"].mlp_forward(params, x))
    assert np.all(np.abs(got - want) <= 2 * _mlp_bound(params, x))
    y = rng.integers(0, 3, 50).astype(np.int32)
    tparams = teacher_from_numpy(params, "cpu")
    assert accuracy(tparams, _t(x), _t(y)) == pytest.approx(
        jx["teacher"].accuracy(params, x, y), abs=1 / 50 + 1e-9)
    assert mae(tparams, _t(x), _t(y.astype(np.float32))) == pytest.approx(
        jx["teacher"].mae(params, x, y.astype(np.float32)), rel=1e-5)


def test_init_mlp_shapes():
    params = init_mlp(torch.Generator().manual_seed(0), MLPConfig(5, (8, 4), 2))
    assert [tuple(p["w"].shape) for p in params] == [(5, 8), (8, 4), (4, 2)]
    assert all(float(p["b"].abs().sum()) == 0 for p in params)


def test_kernel_model_apply_matches_jax(jx):
    cfg, params, x = _kernel_model()
    jm = jx["km"].KernelModel(jx["km"].KernelModelConfig(**cfg))
    model = KernelModel(KernelModelConfig(**cfg))
    tparams = kernel_params_from_numpy(params, "cpu")
    got = model.apply(tparams, _t(x)).numpy()
    want = np.asarray(jm.apply(params, x))
    tol = 1e-5 * np.abs(params["alphas"]).sum(0)
    assert np.all(np.abs(got - want) <= tol)
    np.testing.assert_array_equal(
        model.transform(tparams, _t(x)).numpy().shape, (50, cfg["proj_dim"]))
    for rows, buckets in ((800, 16), (2000, 50)):
        assert model.sketch_memory_params(rows, buckets) == \
            jm.sketch_memory_params(rows, buckets)
        assert model.sketch_flops(rows, buckets) == jm.sketch_flops(rows,
                                                                    buckets)
    assert vars(model.sketch_config(64, 16, 4)) == vars(
        jm.sketch_config(64, 16, 4))
    sizes = (123, 512, 256, 128, 2)
    assert mlp_memory_params(sizes) == jx["km"].mlp_memory_params(sizes)
    assert mlp_flops(sizes) == jx["km"].mlp_flops(sizes)


def test_kernel_model_init_shapes():
    cfg = KernelModelConfig(in_dim=9, proj_dim=4, n_points=20, n_outputs=2)
    p = KernelModel(cfg).init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "points": (20, 4), "alphas": (20, 2), "proj": (9, 4)}


# -- losses, gradients and one Adam step ------------------------------------------

def _close_grads(got, want, n_terms):
    for key in want:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert np.all(np.abs(g - w) <= 4 * _gamma(n_terms) * np.abs(w).max())


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_teacher_loss_and_grads_match_jax(jx, task):
    jax, jnp = jx["jax"], jx["jnp"]
    rng = np.random.default_rng(2)
    cfg = jx["teacher"].MLPConfig(12, (32, 16), 3 if task == "classification"
                                  else 1)
    params = _np(jx["teacher"].init_mlp(jax.random.PRNGKey(2), cfg))
    x = rng.standard_normal((50, 12)).astype(np.float32)
    y = (rng.integers(0, 3, 50).astype(np.int32) if task == "classification"
         else rng.standard_normal(50).astype(np.float32))

    def jloss(p):
        out = jx["teacher"].mlp_forward(p, x)
        if task == "classification":
            logp = jax.nn.log_softmax(out)
            return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                                 axis=1))
        return jnp.mean((out[:, 0] - y) ** 2)

    jl, jg = jax.value_and_grad(jloss)(params)
    tl, tg = distill_mod.value_and_grad(
        lambda p: mlp_loss(p, _t(x), _t(y), task),
        teacher_from_numpy(params, "cpu"))
    assert float(tl) == pytest.approx(float(jl), rel=4 * _gamma(50))
    for g, w in zip(tg, jg):
        _close_grads(g, w, 50 * 32)


@pytest.mark.parametrize("alpha_l1", [0.0, 1e-3])
def test_distill_loss_and_grads_match_jax(jx, alpha_l1):
    jax, jnp = jx["jax"], jx["jnp"]
    cfg, params, x = _kernel_model(3)
    yb = np.random.default_rng(3).standard_normal((50, 3)).astype(np.float32)
    jm = jx["km"].KernelModel(jx["km"].KernelModelConfig(**cfg))
    model = KernelModel(KernelModelConfig(**cfg))

    def jloss(p):
        mse = jnp.mean((jm.apply(p, x) - yb) ** 2)
        if alpha_l1:
            mse = mse + alpha_l1 * jnp.mean(jnp.abs(p["alphas"]))
        return mse

    jl, jg = jax.value_and_grad(jloss)(params)
    dcfg = distill_mod.DistillConfig(alpha_l1=alpha_l1)
    tl, tg = distill_mod.value_and_grad(
        lambda p: distill_mod.distill_loss(model, dcfg, p, _t(x), _t(yb)),
        kernel_params_from_numpy(params, "cpu"))
    assert float(tl) == pytest.approx(float(jl), rel=4 * _gamma(150))
    _close_grads(tg, jg, 50 * cfg["n_points"])


def _kappa(beta, t):
    """Relative change of 1 − βᵗ when the f32 power βᵗ moves by one
    rounding either way (two f32 pow implementations may differ by one
    ulp): 2u·βᵗ / (1 − βᵗ)."""
    return 2 * U32 * beta ** t / (1 - beta ** t)


@pytest.mark.parametrize("t,wd", [(0, 0.0), (3, 1e-2)])
def test_adam_step_matches_jax(jx, t, wd):
    rng = np.random.default_rng(4 + t)
    _, params, _ = _kernel_model(4)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    if t:
        mu = {k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()}
        nu = {k: rng.random(v.shape).astype(np.float32)
              for k, v in params.items()}
        jstate = {"mu": mu, "nu": nu, "t": jx["jnp"].asarray(t, np.int32)}
    else:
        jstate = jx["distill"]._adam_init(params)
    want, wstate = jx["distill"]._adam_update(params, grads, jstate, 5e-3, wd)
    state = {"mu": kernel_params_from_numpy(_np(jstate["mu"]), "cpu"),
             "nu": kernel_params_from_numpy(_np(jstate["nu"]), "cpu"),
             "t": t}
    got, gstate = distill_mod._adam_update(
        kernel_params_from_numpy(params, "cpu"),
        kernel_params_from_numpy(grads, "cpu"), state, 5e-3, wd)
    assert gstate["t"] == int(wstate["t"]) == t + 1
    mu0, nu0 = _np(jstate["mu"]), _np(jstate["nu"])
    for k in params:
        new = np.asarray(want[k])
        step = np.abs(new - params[k])
        assert np.all(np.abs(got[k].numpy() - new)
                      <= 16 * U32 * (np.abs(params[k]) + step)
                      + step * (_kappa(0.9, t + 1) + _kappa(0.999, t + 1) / 2)
                      ), k
        # Each moment is a sum of two products: within a few roundings of
        # its operands' magnitudes.
        for name, operands in (
                ("mu", 0.9 * np.abs(mu0[k]) + 0.1 * np.abs(grads[k])),
                ("nu", 0.999 * nu0[k] + 0.001 * grads[k] ** 2)):
            moment = np.asarray(wstate[name][k])
            assert np.all(np.abs(gstate[name][k].numpy() - moment)
                          <= 16 * U32 * operands), (k, name)


def test_adam_init_is_zeros():
    state = distill_mod._adam_init([{"w": torch.ones(2, 3)}])
    assert state["t"] == 0 and float(state["mu"][0]["w"].abs().sum()) == 0


# -- the whole slice ---------------------------------------------------------------

def test_freeze_and_query_match_jax(jx):
    """A JAX teacher and a JAX distillation on a small skin slice; the
    port freezes the carried kernel params with JAX's carried hash params
    and queries the carried transform of the test inputs; estimates against
    JAX's ``sk.query(state, model.transform(kparams, xte))``."""
    jax, jnp = jx["jax"], jx["jnp"]
    spec = DATASETS["skin"]
    xtr, ytr, xte, _ = make_dataset(spec, seed=1)
    xtr, ytr, xte = xtr[:2000], ytr[:2000], xte[:400]
    jt, jkm = jx["teacher"], jx["km"]
    teacher, _ = jt.train_mlp(jax.random.PRNGKey(0),
                              jt.MLPConfig(spec.n_features, (32, 16), 2),
                              jnp.asarray(xtr), jnp.asarray(ytr), n_steps=150)
    cfg = dict(in_dim=spec.n_features, proj_dim=4, n_points=64, n_outputs=2,
               bandwidth=2.0, k=2)
    jm = jkm.KernelModel(jkm.KernelModelConfig(**cfg))
    kparams, _ = jx["distill"].distill(
        jax.random.PRNGKey(1), lambda x: jt.mlp_forward(teacher, x),
        jnp.asarray(xtr), jm, jx["distill"].DistillConfig(n_steps=150,
                                                           lr=5e-3))
    jsk, jstate = jm.freeze(jax.random.PRNGKey(2), kparams, n_rows=200,
                            n_buckets=16)
    want = np.asarray(jsk.query(jstate, jm.transform(kparams, xte)))

    model = KernelModel(KernelModelConfig(**cfg))
    tk = kernel_params_from_numpy(_np(kparams), "cpu")
    sk = RepresenterSketch(model.sketch_config(200, 16))
    init = dict(_np(jstate), array=np.zeros_like(jstate["array"]),
                mass=np.zeros_like(jstate["mass"]))
    state = sk.build_streaming(sketch_state_from_numpy(init, "cpu"),
                               tk["points"], tk["alphas"])
    got = sk.query(state, model.transform(tk, _t(xte)))
    assert got.shape == (400, 2) and bool(got.isfinite().all())

    w, b = state["hash"]["w"], state["hash"]["b"]
    pidx = sk.lsh.hash(state["hash"], tk["points"])
    jpidx = _t(np.asarray(jsk.lsh.hash(jstate["hash"], kparams["points"])))
    check_hash_indices(pidx, jpidx, tk["points"], w, b, 2.0)
    qidx = sk.lsh.hash(state["hash"], model.transform(tk, _t(xte)))
    jqidx = _t(np.asarray(jsk.lsh.hash(jstate["hash"],
                                       jm.transform(kparams, xte))))
    check_hash_indices(qidx, jqidx, _t(xte), w, b, 2.0, proj=tk["proj"])
    # Buckets a build mismatch touched, per row: (l, bucket) pairs.
    bad = set()
    for m_, l_ in (pidx != jpidx).nonzero().tolist():
        bad |= {(l_, int(pidx[m_, l_])), (l_, int(jpidx[m_, l_]))}
    rows = torch.arange(qidx.shape[1])
    clean = (qidx == jqidx).all(dim=1) & torch.tensor([
        not any((l_, int(r_)) in bad for l_, r_ in zip(rows.tolist(), q))
        for q in qidx.tolist()])
    deb = sk.debiased(state)
    g = sk.config.n_groups
    err = (got.double() - _t(want).double()).abs()
    assert bool((err[clean] <= race_query_tol(deb, qidx, g)[clean]).all())
    own = race_query_ref(deb, qidx, g)
    assert bool(((got - own).abs().double()
                 <= race_query_tol(deb, qidx, g)).all())


def test_run_dataset_end_to_end_on_cpu():
    """The port's own recipe at a small budget on a classification set,
    held to tests/test_distill.py's relations; and a regression set runs."""
    budget = dict(nn_steps=800, distill_steps=1200, n_points=128, rows=800,
                  train_cap=4000, test_cap=1000)
    r = paper_repro.run_dataset("skin", budget, seed=1, device="cpu")
    assert r["nn"] > 0.75
    assert r["kernel"] > r["nn"] - 0.08, r
    assert r["rs"] > r["kernel"] - 0.10, r
    assert r["mem_reduction"] > 0 and r["flop_reduction"] > 1
    assert set(r["stage_seconds"]) == {"teacher", "distill", "freeze", "query"}
    assert r["n_rows"] == 800 and r["n_buckets"] == 30
    small = dict(budget, nn_steps=50, distill_steps=50, n_points=32, rows=100,
                 train_cap=500, test_cap=100)
    reg = paper_repro.run_dataset("abalone", small, seed=0, device="cpu")
    assert reg["task"] == "regression" and np.isfinite(reg["rs"])
    assert reg["n_rows"] == 200 and reg["n_buckets"] == 64


def test_paper_repro_cli(monkeypatch, capsys):
    monkeypatch.setattr(paper_repro, "FAST", dict(
        nn_steps=20, distill_steps=20, n_points=16, rows=40, train_cap=300,
        test_cap=50))
    paper_repro.main(["--dataset", "phishing", "--device", "cpu"])
    out = capsys.readouterr().out
    record = json.loads(out.strip().splitlines()[-1])
    assert record["dataset"] == "phishing" and "Sketch" in out
    assert paper_repro.FULL["rows"] == 2000 and paper_repro.FULL["nn_steps"] \
        == 4000 and paper_repro.FULL["n_points"] == 512
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            paper_repro.run_dataset("skin")


def test_train_mlp_learns():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((400, 6)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.int32)
    params, m = train_mlp(torch.Generator().manual_seed(0),
                          MLPConfig(6, (16,), 2), _t(x), _t(y), n_steps=200,
                          lr=1e-2)
    assert m["last_loss"] < m["first_loss"]
    assert accuracy(params, _t(x), _t(y)) > 0.9


# -- the LM head --------------------------------------------------------------------

def test_distill_head_on_smoke_config():
    lm = LM.from_config(ARCH, smoke=True, device="cpu")
    cfg = SketchHeadConfig(n_rows=32, n_buckets=8, k=1, proj_dim=16,
                           bandwidth=2.0)
    table = lm.params["head"]
    v, d = table.shape
    hiddens = torch.randn((256, d), generator=torch.Generator().manual_seed(0))
    kparams, metrics = head_mod.distill_head(
        torch.Generator().manual_seed(1), table, hiddens, cfg, n_points=64,
        distill_cfg=distill_mod.DistillConfig(n_steps=60, lr=5e-3))
    assert {k: tuple(p.shape) for k, p in kparams.items()} == {
        "points": (64, 16), "alphas": (64, v), "proj": (d, 16)}
    assert metrics["last_loss"] < metrics["first_loss"]
    assert np.isfinite(metrics["final_mse"])
    head = head_mod.freeze_head(torch.Generator().manual_seed(2), kparams, cfg)
    logits = head_mod.apply_head(head, hiddens[:4], cfg)
    assert logits.shape == (4, v) and bool(logits.isfinite().all())


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_head_costs_match_jax(jx, quant):
    cfg = SketchHeadConfig(n_rows=128, n_buckets=16, k=1, proj_dim=32,
                           bandwidth=2.0)
    assert head_mod.head_costs(cfg, 2048, 65536, quant=quant) == \
        jx["head"].head_costs(
            jx["head"].SketchHeadConfig(**vars(cfg)), 2048, 65536,
            quant=quant)


def test_serve_cli_distills_and_serves_tenants(capsys):
    serve.main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
                "8", "--gen", "3", "--sketch-head"])
    out = capsys.readouterr().out
    assert "distill MSE" in out and "head=sketch/fused device=cpu" in out
    serve.main(["--smoke", "--device", "cpu", "--engine", "--tenants", "3",
                "--sketch-head", "--batch", "2", "--prompt-len", "8", "--gen",
                "4", "--requests", "9", "--stats-json"])
    out = capsys.readouterr().out
    stats = json.loads(out.split("STATS_JSON ")[1].splitlines()[0])
    assert stats["head"] == "sketch/fused/tenants" and stats["requests"] == 9
    assert stats["tenants"]["n_tenants"] == 3
    assert stats["tenants"]["capacity"] == 2 and stats["tenants"]["evictions"]
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--engine", "--tenants",
                    "2", "--sketch-head", "--head-path", "x.npz"])
    assert "--head-path is not supported" in capsys.readouterr().err


def test_build_tenant_heads_share_anchors():
    lm = LM.from_config(ARCH, smoke=True, device="cpu")
    spec, heads = serve.build_tenant_heads(lm.params, lm.cfg, 2,
                                           distill_steps=5)
    assert spec.params is None and set(heads) == {"tenant-0", "tenant-1"}
    a, b = heads["tenant-0"], heads["tenant-1"]
    assert torch.equal(a["proj"], b["proj"]) and not torch.equal(a["w"],
                                                                 b["w"])


# -- on the card ----------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_run_dataset_launches_the_kernels(cuda):
    from repro_torch.kernels.lsh_hash.ops import lsh_hash
    from repro_torch.kernels.race_query.ops import race_query
    from repro_torch.kernels.race_update.ops import race_update

    budget = dict(nn_steps=200, distill_steps=300, n_points=128, rows=400,
                  train_cap=4000, test_cap=1000)
    lsh_hash.launches = race_update.launches = race_query.launches = 0
    r = paper_repro.run_dataset("skin", budget, seed=1, device=cuda)
    assert (lsh_hash.launches, race_update.launches,
            race_query.launches) == (2, 1, 1)
    assert r["rs"] > 0.5 and np.isfinite(r["kernel"])
    sk, state, q = (r["parts"][k] for k in ("sketch", "state", "queries"))
    idx = sk.lsh.hash(state["hash"], q)
    got = race_query(sk.debiased(state), idx, n_groups=8)
    want = race_query_ref(sk.debiased(state), idx, 8)
    torch.cuda.synchronize()
    assert bool(((got - want).abs().double()
                 <= race_query_tol(sk.debiased(state), idx, 8)).all())
