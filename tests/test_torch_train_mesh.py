"""Training on a 2×2 gloo mesh against one process.

``train(model_parallel=2)`` runs two steps of musicgen-large smoke SPMD over
four spawned gloo ranks (``tests/torch_mesh.py``, one CPU thread each):
params placed by ``params_shardings``, the AdamW moments and master by
``zero1_shardings``, the batch split by ``batch_spec``.  The same two steps
run in this process without a group.  The mesh reassociates f32 sums
(the row-sharded products' partial sums, the all-reduced gradient norm,
the vocab-parallel log-sum-exp), so the two agree within stated bounds,
not bit for bit:

* the losses within 1e-4 (relative and absolute);
* every f32 master weight within 4·lr: an AdamW step moves a weight by
  about lr·m̂/(√v̂ + eps), ±lr at the first step, so where a gradient is
  near zero its reassociated value may flip that move's sign (2·lr a
  step, two steps); and all but 1 % of them within 1e-5;
* the bf16 params, rounded from those masters, within the same 4·lr plus
  one bf16 ulp.  ~25 s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pathlib import Path

ARCH = "musicgen-large"
KW = dict(smoke=True, steps=2, batch=4, seq=16, device="cpu")
LR = 3e-4                     # train()'s default


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def train_ranks(rank, world):
    """Two steps on the 2×2 mesh; the losses, the full params and state
    (gathered), and every rank's local shapes of the state."""
    from repro_torch.launch.train import train
    from repro_torch.sharding.local import spec_of
    from repro_torch.sharding.rules import tree_paths

    res = train(ARCH, model_parallel=2, log=lambda s: None, **KW)
    st = res["opt_state"]
    out = {"losses": res["losses"],
           "params": {p: t.detach().full_tensor().float().numpy()
                      for p, t in tree_paths(res["params"])},
           "master": {p: t.full_tensor().numpy()
                      for p, t in tree_paths(st.master)}}
    for name in ("mu", "nu", "master", "params"):
        tree = res["params"] if name == "params" else getattr(st, name)
        out[f"spec/{name}"] = {p: spec_of(t) for p, t in tree_paths(tree)}
    import torch.distributed as dist
    local = [None] * world
    dist.all_gather_object(local, {p: tuple(t.to_local().shape)
                                   for p, t in tree_paths(st.mu)})
    out["mu_local"] = local
    return out


@pytest.fixture(scope="module")
def mesh_run():
    from torch_mesh import run_ranks

    return run_ranks(str(Path(__file__)), "train_ranks", world=4,
                     timeout=200)


@pytest.fixture(scope="module")
def solo_run():
    from repro_torch.launch.train import train
    from repro_torch.sharding.rules import tree_paths

    res = train(ARCH, log=lambda s: None, **KW)
    return {"losses": res["losses"],
            "params": {p: t.detach().float().numpy()
                       for p, t in tree_paths(res["params"])},
            "master": {p: t.numpy()
                       for p, t in tree_paths(res["opt_state"].master)}}


def test_mesh_training_matches_one_process(mesh_run, solo_run):
    np.testing.assert_allclose(mesh_run["losses"], solo_run["losses"],
                               rtol=1e-4, atol=1e-4)
    assert sorted(mesh_run["params"]) == sorted(solo_run["params"])
    n_far = n_all = 0
    for path, want in solo_run["master"].items():
        diff = np.abs(mesh_run["master"][path] - want)
        assert diff.max() <= 4 * LR, (path, diff.max())
        n_far += int((diff > 1e-5).sum())
        n_all += diff.size
    assert n_far <= 0.01 * n_all, (n_far, n_all)
    for path, want in solo_run["params"].items():
        np.testing.assert_allclose(mesh_run["params"][path], want,
                                   rtol=2 ** -7, atol=4 * LR, err_msg=path)


def test_zero1_placements_of_mu_nu_master(mesh_run):
    """The moments and master are laid out by ``zero1_shardings`` (each
    leaf's param spec plus the data axis on its largest free dim), the
    params by ``params_shardings``; every rank holds its own block."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_model
    from repro_torch.sharding.rules import (params_shardings, tree_paths,
                                            zero1_shardings)

    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (2, 2)

    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = init_model(get_config(ARCH, smoke=True), torch.Generator())
    z1 = {p: tuple(s) for p, s in tree_paths(zero1_shardings(params, Mesh))}
    ps = {p: tuple(s) for p, s in tree_paths(params_shardings(params, Mesh))}
    for name in ("mu", "nu", "master"):
        got = {p: tuple(s) for p, s in mesh_run[f"spec/{name}"].items()}
        assert got == z1, name
    assert {p: tuple(s) for p, s in mesh_run["spec/params"].items()} == ps
    assert any("data" in s for s in z1.values())
    shapes = dict(tree_paths(params))
    for local in mesh_run["mu_local"]:
        for path, shape in local.items():
            spec = z1[path]
            want = tuple(d // (2 if e is not None else 1)
                         for d, e in zip(shapes[path].shape, spec))
            assert shape == want, path


def test_model_parallel_without_a_group_raises():
    """``--model-parallel`` other than 1 needs a process group; there is
    no single-device fallback."""
    import torch.distributed as dist

    from repro_torch.launch.train import train

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="process group"):
        train(ARCH, model_parallel=2, log=lambda s: None, **KW)


def test_checkpoints_on_a_mesh_raise(tmp_path):
    """A mesh run's checkpoints need the mesh's process group: without one,
    ``model_parallel=2`` with ``ckpt_dir`` raises before it builds or
    writes anything.  (With a group, a mesh run saves and restores:
    ``test_torch_train_ckpt_mesh.py``.)"""
    from repro_torch.launch.train import train

    with pytest.raises(ValueError, match="process group"):
        train(ARCH, model_parallel=2, ckpt_dir=str(tmp_path),
              log=lambda s: None, **KW)
    assert not any(tmp_path.iterdir())
