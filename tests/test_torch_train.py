"""The port's training path against the JAX package's: AdamW, the schedule,
the data pipeline, ``train_step``, checkpoints, the runtime policies and
the train CLI.

Inputs are made with numpy from a seed and handed to both packages; params
and optimizer state travel through ``convert.params_from_numpy`` and
``convert.opt_state_from_numpy``.  Tolerances:

* ``adamw_update`` from one state and the same grads: each f32 result (mu,
  nu, master) of either package lies within ``_adamw_bounds`` of the exact
  value of the same formulas (float64 here), so the two within twice
  that.  The bound follows each operation: one rounding each (u = 2⁻²⁴),
  the global norm a sum of n squares (γ_{n+1}) that, when clipping is
  active, moves the scale and every clipped grad by as much, f32 ``pow``
  in the bias corrections and ``cos`` in the schedule within 2 and 8 ulps
  (neither XLA's nor torch's is correctly rounded).  A bf16 result (a
  bf16 param, a lean moment) may differ only where its exact value lies
  within that bound of a bf16 rounding boundary (``check_hash_indices``'
  rule for a rounding).
* ``lr_schedule`` within 2·8 ulps relative.
* ``synthetic_batch`` and the prefetching loader: bit for bit.
* ``train_step`` for three steps from one carried-across state at
  ``grad_accum`` 1 and 2: loss and ce each step within one bf16 ulp
  (2⁻⁸) relative, lr within the schedule's bound, the grad norm within
  2⁻⁵ relative and the final moments leaf by leaf under ``parity``'s bf16
  backbone rule (the grads are a bf16 network's, tests/test_torch_grad.py);
  the final params and master leaf by leaf within 2⁻⁵ relative in norm.
  Adam's early steps move each param by about lr·sign(grad), so a param
  whose grad is near 0 may move the other way in the other package: the
  largest-element half of the rule does not apply to them.
* Checkpoints, the resumed training run and the runtime policies: exact.
"""

import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.manager import CheckpointManager, flatten_with_keys
from repro_torch.configs import get_config
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.data.pipeline import (DataConfig, PrefetchingLoader,
                                       synthetic_batch)
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.optim.adamw import (AdamWState, OptimizerConfig,
                                     adamw_update, init_adamw, lr_schedule,
                                     tree_leaves)
from repro_torch.parity import BF16_MAX_TOL, BF16_NORM_TOL, bf16_backbone_errors
from repro_torch.runtime import elastic, failure
from repro_torch.runtime.supervisor import Supervisor, SupervisorConfig

U = 2.0 ** -24
BF16_ULP = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (its tensors are small):
    the suite runs several test processes on one machine, and torch's
    default of a thread per core each makes them contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.checkpoint import manager as jckpt
    from repro.configs import get_config as config
    from repro.data import pipeline as jdata
    from repro.launch import steps as jsteps
    from repro.models import model as jmodel
    from repro.optim import adamw as jadamw
    from repro.runtime import elastic as jelastic
    from repro.runtime import failure as jfailure
    from repro.runtime import supervisor as jsup
    return dict(jax=jax, jnp=jnp, ckpt=jckpt, config=config, data=jdata,
                steps=jsteps, model=jmodel, adamw=jadamw, elastic=jelastic,
                failure=jfailure, sup=jsup)


def _gamma(n):
    return n * U / (1 - n * U)


def _f32(a):
    return np.asarray(a, np.float64)


# -- AdamW -----------------------------------------------------------------


def _random_state(rng, lean):
    """Params (f32 and bf16 leaves, a nested list), grads of their dtypes,
    and a nonzero AdamW state at step 5, all numpy (bf16 via ml_dtypes)."""
    import ml_dtypes
    bf16 = ml_dtypes.bfloat16
    shapes = {"a": ((7, 5), np.float32), "b": ((33,), bf16),
              "c": [{"w": ((4, 6), bf16)}, {"w": ((3,), np.float32)}]}

    def make(spec, fn):
        if isinstance(spec, dict):
            return {k: make(v, fn) for k, v in spec.items()}
        if isinstance(spec, list):
            return [make(v, fn) for v in spec]
        return fn(*spec)

    params = make(shapes, lambda s, dt: rng.standard_normal(s).astype(dt))
    grads = make(shapes, lambda s, dt: (0.3 * rng.standard_normal(s))
                 .astype(dt))
    mdt = bf16 if lean else np.float32
    mu = make(shapes, lambda s, dt: (0.05 * rng.standard_normal(s))
              .astype(mdt))
    nu = make(shapes, lambda s, dt: (0.01 * rng.random(s)).astype(mdt))
    master = None if lean else make(
        shapes, lambda s, dt: rng.standard_normal(s).astype(np.float32))
    if master is not None:   # the bf16 params are the master's rounding
        params = _map(lambda m, g: m.astype(g.dtype), master, grads)
    return params, grads, (np.int32(5), mu, nu, master)


def _map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, list):
        return [_map(fn, *leaves) for leaves in zip(*trees)]
    return fn(*trees)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _adamw_bounds(cfg, params, grads, state):
    """(exact mu, nu, new params, and one evaluation's bound on each) in
    float64, leaf lists in ``_flat`` order."""
    step, mu, nu, master = state
    ref = _flat(master if master is not None else params)
    g64 = [_f32(g) for g in _flat(grads)]
    n = sum(g.size for g in g64)
    gnorm = math.sqrt(sum(float((g * g).sum()) for g in g64))
    active = cfg.grad_clip / (gnorm + 1e-9) < 1.0
    scale = min(1.0, cfg.grad_clip / (gnorm + 1e-9))
    e_s = (_gamma(n + 1) + 3 * U) if active else 0.0
    t = int(step) + 1
    bc = [1 - cfg.b1 ** t, 1 - cfg.b2 ** t]
    e_bc = [2 * U * cfg.b1 ** t / bc[0] + U, 2 * U * cfg.b2 ** t / bc[1] + U]
    warm = min(t / max(cfg.warmup_steps, 1), 1.0)
    tt = min(max((t - cfg.warmup_steps)
                 / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
    lr = cfg.lr * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * tt)))
    e_lr = 16 * U
    out = []
    for g, m, v, p in zip(g64, map(_f32, _flat(mu)), map(_f32, _flat(nu)),
                          map(_f32, ref)):
        gs = np.abs(g) * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g * scale
        v_new = cfg.b2 * v + (1 - cfg.b2) * (g * scale) ** 2
        tm = U * (np.abs(m_new) + cfg.b1 * np.abs(m)) + (1 - cfg.b1) * gs * (
            e_s + 2 * U)
        tv = U * (np.abs(v_new) + cfg.b2 * np.abs(v)) + (1 - cfg.b2) * gs ** 2 * (
            2 * e_s + 4 * U)
        mhat, vhat = m_new / bc[0], v_new / bc[1]
        tmh = (tm + np.abs(mhat) * bc[0] * e_bc[0]) / bc[0] + U * np.abs(mhat)
        tvh = (tv + vhat * bc[1] * e_bc[1]) / bc[1] + U * vhat
        root = np.sqrt(vhat)
        den = root + cfg.eps
        tden = tvh / (2 * np.maximum(root, 1e-30)) + U * root + U * den
        r = mhat / den
        tr = tmh / den + np.abs(r) * tden / den + U * np.abs(r)
        upd = r + cfg.weight_decay * p
        tu = tr + U * cfg.weight_decay * np.abs(p) + U * np.abs(upd)
        p_new = p - lr * upd
        tp = (e_lr * lr * np.abs(upd) + lr * tu + U * lr * np.abs(upd)
              + U * np.abs(p_new))
        out.append((m_new, tm, v_new, tv, p_new, tp))
    return out


def _bf16_boundary_dist(x):
    """Distance of each float64 value to the nearest bf16 rounding
    boundary (a midpoint between neighbouring bf16 values)."""
    a = np.abs(x)
    e = np.floor(np.log2(np.maximum(a, 1e-38)))
    ulp = 2.0 ** (e - 7)
    return np.abs(a / ulp - np.floor(a / ulp) - 0.5) * ulp


def _check(got, want, exact, tol, what):
    """An f32 result within twice one evaluation's bound; a bf16 one equal,
    or its exact value within the bound of a bf16 rounding boundary."""
    g64 = got.float().numpy().astype(np.float64)
    if got.dtype == torch.float32:
        bad = np.abs(g64 - want) > 2 * tol
        assert not bad.any(), (what, np.abs(g64 - want).max())
    else:
        diff = g64 != want
        assert (_bf16_boundary_dist(exact[diff]) <= tol[diff]).all(), (
            what, int(diff.sum()))


@pytest.mark.parametrize("lean", [False, True])
@pytest.mark.parametrize("clip", [0.5, 100.0])
def test_adamw_update_matches_jax(jx, lean, clip):
    """One update from a random state at step 5 with the same grads, lean
    and not, with clipping active (clip 0.5) and not: mu, nu, master and
    the new params within the bounds above."""
    jax, jnp, ja = jx["jax"], jx["jnp"], jx["adamw"]
    rng = np.random.default_rng(3 + lean)
    params, grads, state = _random_state(rng, lean)
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=3, total_steps=20,
                          grad_clip=clip, lean=lean)
    jcfg = ja.OptimizerConfig(**dataclasses.asdict(cfg))
    jstate = ja.AdamWState(jnp.asarray(state[0]), *(
        None if t is None else jax.tree.map(jnp.asarray, t)
        for t in state[1:]))
    jp, js, jm = ja.adamw_update(jax.tree.map(jnp.asarray, grads), jstate,
                                 jcfg, params=jax.tree.map(jnp.asarray,
                                                           params))
    tstate = opt_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    tparams = params_from_numpy(params, "cpu")
    tp, ts, tm = adamw_update(params_from_numpy(grads, "cpu"), tstate, cfg,
                              params=tparams)
    assert all(a is b for a, b in zip(tree_leaves(tp), tree_leaves(tparams)))
    assert int(ts.step) == 6
    bounds = _adamw_bounds(cfg, params, grads, state)
    results = [("mu", ts.mu, js.mu, 0, 1), ("nu", ts.nu, js.nu, 2, 3),
               ("param", tp, jp, 4, 5)]
    if not lean:
        results.append(("master", ts.master, js.master, 4, 5))
    for name, ours, theirs, ie, it in results:
        for i, (got, want) in enumerate(zip(_flat(ours), _flat(theirs))):
            want = np.asarray(jnp.asarray(want).astype(jnp.float32),
                              np.float64)
            assert (got.dtype == torch.bfloat16) == (
                theirs is not None and _flat(theirs)[i].dtype == jnp.bfloat16)
            _check(got, want, bounds[i][ie], bounds[i][it], (name, i))
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= (
        2 * _gamma(sum(g.size for g in _flat(grads)) + 2) * float(
            jm["grad_norm"]))


def test_lr_schedule_matches_jax(jx):
    jnp, ja = jx["jnp"], jx["adamw"]
    cfg = OptimizerConfig(lr=3e-4, warmup_steps=7, total_steps=50)
    jcfg = ja.OptimizerConfig(**dataclasses.asdict(cfg))
    for s in range(cfg.total_steps + 3):
        want = float(ja.lr_schedule(jnp.asarray(s, jnp.int32), jcfg))
        got = float(lr_schedule(torch.tensor(s, dtype=torch.int32), cfg))
        assert abs(got - want) <= 2 * 16 * U * cfg.lr, (s, got, want)


def test_init_adamw_matches_jax_structure(jx):
    params = {"a": torch.ones((2, 3), dtype=torch.bfloat16),
              "b": [torch.zeros(4)]}
    st = init_adamw(params)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert st.master["a"].dtype == torch.float32
    assert st.master["a"].data_ptr() != params["a"].data_ptr()
    lean = init_adamw(params, lean=True)
    assert lean.master is None and lean.mu["a"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="a param of"):
        adamw_update(params, lean, OptimizerConfig(lean=True),
                     {"a": params["a"].float(), "b": params["b"]})


# -- data ------------------------------------------------------------------


def test_synthetic_batch_and_loader_match_jax(jx):
    jd = jx["data"]
    # seed 0: both packages' counter hash (the reference's code, copied)
    # overflows numpy's conversion of its uint64 seed term for seed >= 1.
    kw = dict(vocab_size=97, seq_len=24, global_batch=6, seed=0,
              n_hosts=2, host_id=1, n_encoder_tokens=5, d_model=8)
    ours, theirs = DataConfig(**kw), jd.DataConfig(**kw)
    for step in (0, 1, 17):
        a, b = synthetic_batch(ours, step), jd.synthetic_batch(theirs, step)
        assert sorted(a) == sorted(b) == ["encoder_states", "labels",
                                          "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    loader = PrefetchingLoader(ours, start_step=4)
    try:
        for want_step in (4, 5, 6):
            step, batch = next(loader)
            assert step == want_step
            np.testing.assert_array_equal(
                batch["tokens"], jd.synthetic_batch(theirs, step)["tokens"])
    finally:
        loader.close()
    assert not loader._thread.is_alive()


# -- train_step ------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(jx, accum):
    """Three steps of musicgen's smoke model from one state (the JAX init
    and AdamW state carried across) on the same batches."""
    jax, jnp = jx["jax"], jx["jnp"]
    arch = "musicgen-large"
    jcfg, cfg = jx["config"](arch, smoke=True), get_config(arch, smoke=True)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=10,
                           grad_accum=accum)
    jocfg = jx["adamw"].OptimizerConfig(**dataclasses.asdict(ocfg))
    jp = jx["model"].init_model(jax.random.PRNGKey(0), jcfg)
    js = jx["adamw"].init_adamw(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    jstep = jax.jit(lambda p, o, b: jx["steps"].train_step(
        p, o, b, cfg=jcfg, opt_cfg=jocfg))
    for s in range(3):
        batch = synthetic_batch(data, s)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, ts, tm = steps.train_step(
            tp, ts, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
            ocfg)
        for k in ("loss", "ce"):
            assert abs(float(tm[k]) - float(jm[k])) <= BF16_ULP * abs(
                float(jm[k])), (s, k)
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 2 * 16 * U * ocfg.lr
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= (
            BF16_NORM_TOL * float(jm["grad_norm"]))
    assert int(ts.step) == int(js.step) == 3
    for tree_t, tree_j, elementwise in (
            (tp, jp, False), (ts.master, js.master, False),
            (ts.mu, js.mu, True), (ts.nu, js.nu, True)):
        for (key, got), want in zip(flatten_with_keys(tree_t),
                                    jax.tree.leaves(tree_j)):
            norm_err, max_err = bf16_backbone_errors(
                got.detach().float().numpy(),
                np.asarray(jnp.asarray(want).astype(jnp.float32)))
            assert norm_err <= BF16_NORM_TOL, (key, norm_err)
            assert max_err <= BF16_MAX_TOL or not elementwise, (key, max_err)


def test_opt_config_for_matches_jax(jx):
    for arch in ("musicgen-large", "deepseek-v3-671b"):
        ours = steps.opt_config_for(get_config(arch), lr=1e-3)
        theirs = jx["steps"].opt_config_for(jx["config"](arch), lr=1e-3)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


# -- checkpoints -----------------------------------------------------------


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32),
                  "h": torch.randn(6, generator=torch.Generator()
                                   .manual_seed(0)).to(torch.bfloat16)},
            "l": [torch.zeros(2), torch.full((1,), 7.0)]}


def _equal_trees(a, b):
    la, lb = flatten_with_keys(a), flatten_with_keys(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def test_checkpoint_roundtrip_and_keys(tmp_path):
    tree = (_tree(), init_adamw({"w": torch.ones(3, dtype=torch.bfloat16)}))
    cm = CheckpointManager(tmp_path)
    cm.save(10, tree, blocking=True)
    template = (_tree(), init_adamw({"w": torch.zeros(3,
                                                      dtype=torch.bfloat16)}))
    for _, leaf in flatten_with_keys(template):
        leaf.zero_()
    restored, step = cm.restore(template)
    assert step == 10 and restored is template
    _equal_trees(restored, tree)
    manifest = json.loads((tmp_path / "step_000000010" / "MANIFEST.json")
                          .read_text())
    assert manifest["keys"][:3] == ["[0]['a']", "[0]['b']['c']",
                                    "[0]['b']['h']"]
    assert "[1].step" in manifest["keys"] and "[1].mu['w']" in \
        manifest["keys"]


def test_checkpoint_copies_before_returning(tmp_path):
    """``save`` takes host copies at once: the caller's in-place updates
    after it do not reach the file."""
    tree = _tree()
    cm = CheckpointManager(tmp_path)
    cm.save(1, tree)
    want = {k: v.clone() for k, v in flatten_with_keys(tree)}
    tree["a"].add_(1.0)
    cm.wait()
    restored, _ = cm.restore(_tree())
    assert torch.equal(restored["a"], want["['a']"])


def test_checkpoint_incomplete_step_is_ignored(tmp_path):
    tree = _tree()
    cm = CheckpointManager(tmp_path)
    cm.save(10, tree, blocking=True)
    cm.save(20, tree, blocking=True)
    (tmp_path / "step_000000030").mkdir()
    np.savez(tmp_path / "step_000000030" / "shard_00000.npz",
             **{"x": np.zeros(3)})
    assert cm.latest_step() == 20
    assert cm.restore(tree)[1] == 20


def test_checkpoint_gc_async_and_missing(tmp_path):
    tree = _tree()
    cm = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, tree)
    cm.wait()
    assert cm.complete_steps() == [3, 4]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(tree)


def test_checkpoint_validates_dtype_and_shape(tmp_path):
    tree = _tree()
    cm = CheckpointManager(tmp_path)
    cm.save(1, tree, blocking=True)
    bad = _tree()
    bad["a"] = torch.zeros((2, 2))
    with pytest.raises(ValueError, match="shape"):
        cm.restore(bad)
    bad = _tree()
    bad["a"] = bad["a"].double()
    with pytest.raises(ValueError, match="float64"):
        cm.restore(bad)
    bad = _tree()
    bad["b"]["h"] = bad["b"]["h"].float()
    with pytest.raises(ValueError):
        cm.restore(bad)


def test_jax_checkpoint_restores_in_the_port(jx, tmp_path):
    """(params, AdamWState) of musicgen's smoke model written by the JAX
    package restore into the port's tree bit for bit, and the port's
    checkpoint of it restores in the JAX package."""
    jax = jx["jax"]
    jcfg, cfg = jx["config"]("musicgen-large", smoke=True), get_config(
        "musicgen-large", smoke=True)
    jp = jx["model"].init_model(jax.random.PRNGKey(1), jcfg)
    js = jx["adamw"].init_adamw(jp)
    jx["ckpt"].CheckpointManager(tmp_path / "jax").save(
        7, jax.tree.map(np.asarray, (jp, js)), blocking=True)
    from repro_torch.models.model import init_model
    tp = init_model(cfg, torch.Generator().manual_seed(0))
    (rp, rs), step = CheckpointManager(tmp_path / "jax").restore(
        (tp, init_adamw(tp)))
    assert step == 7
    want = (params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
            opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu"))
    _equal_trees((rp, rs), want)
    CheckpointManager(tmp_path / "port").save(8, (rp, rs), blocking=True)
    (bp, bs), _ = jx["ckpt"].CheckpointManager(tmp_path / "port").restore(
        (jp, js))
    for a, b in zip(jax.tree.leaves((bp, bs)), jax.tree.leaves((jp, js))):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


# -- the train entry point -------------------------------------------------


def test_resumed_run_equals_continuous(tmp_path):
    """musicgen's smoke model through ``launch.train.train``: six steps
    saving at step 3, then a new run from that checkpoint: its final
    params, optimizer state and losses equal the continuous run's bit for
    bit."""
    kw = dict(smoke=True, steps=6, batch=4, seq=16, device="cpu",
              ckpt_every=3, log=lambda line: None)
    cont = train_cli.train("musicgen-large", ckpt_dir=str(tmp_path), **kw)
    assert CheckpointManager(tmp_path).complete_steps() == [3]
    lines = []
    resumed = train_cli.train("musicgen-large", ckpt_dir=str(tmp_path),
                              **dict(kw, log=lines.append))
    assert lines[0] == "restored step 3" and resumed["start"] == 4
    assert resumed["losses"] == cont["losses"][4:]
    _equal_trees((resumed["params"], resumed["opt_state"]),
                 (cont["params"], cont["opt_state"]))


def test_train_cli_loss_falls(capsys):
    train_cli.main(["--arch", "musicgen-large", "--smoke", "--device", "cpu",
                    "--steps", "20", "--log-every", "5"])
    out = capsys.readouterr().out.splitlines()
    steps_ = [line for line in out if line.startswith("step ")]
    assert [int(line.split()[1]) for line in steps_] == [0, 5, 10, 15]
    first = float(steps_[0].split()[3])
    final = float(out[-1].rsplit(" ", 1)[1])
    assert out[-1].startswith("done: 20 steps") and final < first - 0.05


def test_train_refuses_model_parallel_and_a_missing_card():
    # --model-parallel needs a process group to make its mesh over
    with pytest.raises(ValueError, match="process group"):
        train_cli.train("musicgen-large", smoke=True, model_parallel=2,
                        device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.train("musicgen-large", smoke=True, steps=1)


# -- runtime policies ------------------------------------------------------


def test_failure_and_elastic_decisions_match_jax(jx):
    """The scenarios of tests/test_runtime.py through both packages: the
    same missing hosts, recovery plans, stragglers, evictions, mesh plans
    and shard owners."""
    jf, je = jx["failure"], jx["elastic"]
    for mod in (failure, jf):
        reg = mod.HeartbeatRegistry([0, 1, 2], timeout_s=10)
        for h, t in ((0, 100.0), (1, 100.0), (2, 85.0)):
            reg.beat(h, now=t)
        assert (reg.missing(now=100.0), reg.healthy(now=100.0)) == ([2],
                                                                   [0, 1])
    for args, kw in (((8, []), dict(hosts_per_replica=2, n_replicas=4)),
                     ((16, [3]), dict(hosts_per_replica=2, n_replicas=8)),
                     ((8, [0, 2, 4, 6]), dict(hosts_per_replica=2,
                                              n_replicas=4)),
                     ((8, [0, 1, 2, 3, 4, 5, 6, 7]),
                      dict(hosts_per_replica=2, n_replicas=4))):
        a, b = failure.decide_recovery(*args, **kw), jf.decide_recovery(
            *args, **kw)
        assert (a.action.value, a.healthy_hosts, a.new_data_parallel,
                a.reason) == (b.action.value, b.healthy_hosts,
                              b.new_data_parallel, b.reason)
    trackers = [failure.StragglerTracker(threshold=1.5, evict_after=2),
                jf.StragglerTracker(threshold=1.5, evict_after=2)]
    for _ in range(4):
        flagged = []
        for t in trackers:
            for h, dt in ((0, 1.0), (1, 1.0), (2, 3.0)):
                t.record(h, dt)
            flagged.append(t.stragglers())
        assert flagged[0] == flagged[1]
    assert trackers[0].to_evict() == trackers[1].to_evict() == [2]
    for n_hosts, per, batch, dead in ((8, 2, 16, [0]), (12, 3, 24, [4, 11]),
                                      (8, 1, 8, [5])):
        plans = []
        for mod in (elastic, je):
            p = mod.initial_plan(n_hosts, per, batch)
            p2 = mod.shrink_plan(p, dead, batch)
            plans.append((dataclasses.astuple(p), dataclasses.astuple(p2),
                          mod.reassign_shards(p2, 16)))
        assert plans[0] == plans[1]


def _supervisors(jx, tmp_path, total, deaths):
    """The same scripted run through both supervisors: the port's on a
    torch state, the JAX package's on its own."""
    jnp, js = jx["jnp"], jx["sup"]
    port = (Supervisor, SupervisorConfig,
            lambda: {"w": torch.zeros(4),
                     "step_count": torch.zeros((), dtype=torch.int32)},
            lambda: torch.ones(4) * 0.1)
    ref = (js.Supervisor, js.SupervisorConfig,
           lambda: {"w": jnp.zeros((4,)),
                    "step_count": jnp.zeros((), jnp.int32)},
           lambda: jnp.ones((4,)) * 0.1)
    out = []
    for name, (cls, cfg_cls, init, ones) in (("port", port), ("jax", ref)):
        pending = dict(deaths)
        sup = cls(cfg_cls(total_steps=total, ckpt_every=5,
                          ckpt_dir=str(tmp_path / name), n_hosts=4,
                          hosts_per_replica=1),
                  init_state=init,
                  step_fn=lambda st, b: {"w": st["w"] + b["g"],
                                         "step_count": st["step_count"] + 1},
                  batch_fn=lambda step, ones=ones: {"g": ones()},
                  fault_hook=lambda s: pending.pop(s, []))
        out.append((sup, sup.run()))
    return out


@pytest.mark.parametrize("deaths", [{}, {8: [0, 1, 2]}, {7: [3]}])
def test_supervisor_events_match_jax(jx, tmp_path, deaths):
    """A clean run, a restart from the step-5 checkpoint and a shrink: the
    same audit log and final step count as the JAX package's."""
    (ps, pstate), (js_, jstate) = _supervisors(jx, tmp_path, 12, deaths)
    norm = lambda ev: [tuple(x.value if hasattr(x, "value") else x
                             for x in e) for e in ev]
    assert norm(ps.events) == norm(js_.events)
    assert int(pstate["step_count"]) == int(jstate["step_count"]) == 12
    np.testing.assert_allclose(pstate["w"].numpy(), np.asarray(jstate["w"]),
                               rtol=1e-6)


def test_supervisor_resumes_across_runs(tmp_path):
    def make(total):
        return Supervisor(
            SupervisorConfig(total_steps=total, ckpt_every=5,
                             ckpt_dir=str(tmp_path), n_hosts=4),
            init_state=lambda: {"w": torch.zeros(4),
                                "step_count": torch.zeros(
                                    (), dtype=torch.int32)},
            step_fn=lambda st, b: {"w": st["w"] + b["g"],
                                   "step_count": st["step_count"] + 1},
            batch_fn=lambda step: {"g": torch.ones(4) * 0.1})
    make(11).run()
    sup2 = make(20)
    state = sup2.run()
    assert ("restored", 10) in sup2.events
    assert int(state["step_count"]) == 20
