"""Checkpoints of a training run on a 2×2 gloo mesh.

``train(model_parallel=2, ckpt_dir=)`` runs musicgen-large smoke SPMD over
four spawned gloo ranks (``tests/torch_mesh.py``, one CPU thread each).
Every rank gathers each DTensor leaf for a save and rank 0 writes the
reference's layout; a restore copies each rank's own block of each leaf.

* Six steps saving at step 3, then a rerun from that checkpoint: the
  resumed run's losses, params, ``mu``, ``nu`` and ``master`` equal the
  continuous mesh run's bit for bit.
* The continuous run's final state saved on the mesh restores off the
  mesh (one process, no group) to the same full tensors, bit for bit.
* A checkpoint written by the JAX package's train CLI (``python -m
  repro.launch.train --smoke --ckpt-dir``, same arch, three steps on the
  CPU) restores into the port's mesh run leaf for leaf, bit for bit.

~20 s (the JAX CLI ~8 s, then the four ranks).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
ARCH = "musicgen-large"
KW = dict(smoke=True, batch=4, seq=16, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(tree) -> dict:
    """Every leaf's full tensor (gathered) as numpy, bf16 as its int16
    bits, by checkpoint key."""
    from repro_torch.checkpoint.manager import flatten_with_keys
    from repro_torch.sharding.ctx import replicated

    out = {}
    for key, leaf in flatten_with_keys(tree):
        full = replicated(leaf.detach())
        if full.dtype == torch.bfloat16:
            full = full.view(torch.int16)
        out[key] = full.numpy().copy()
    return out


def ckpt_ranks(rank, world, cont_dir, final_dir, jax_dir):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.train import train

    quiet = dict(KW, model_parallel=2, log=lambda s: None)
    cont = train(ARCH, steps=6, ckpt_every=3, ckpt_dir=cont_dir, **quiet)
    CheckpointManager(final_dir).save(6, (cont["params"], cont["opt_state"]),
                                      blocking=True)
    lines = []
    resumed = train(ARCH, steps=6, ckpt_dir=cont_dir,
                    **dict(quiet, log=lines.append))
    # The JAX CLI's latest step is 2: a run of 3 steps restores it and
    # takes none.
    from_jax = train(ARCH, steps=3, ckpt_dir=jax_dir, **quiet)
    return {
        "cont/losses": cont["losses"], "resumed/losses": resumed["losses"],
        "resumed/start": resumed["start"], "resumed/first_line": lines[0],
        "cont/state": _bits((cont["params"], cont["opt_state"])),
        "resumed/state": _bits((resumed["params"], resumed["opt_state"])),
        "jax/start": from_jax["start"],
        "jax/state": _bits((from_jax["params"], from_jax["opt_state"])),
        "cont/steps": CheckpointManager(cont_dir).complete_steps(),
    }


# The JAX package's train CLI as ``python -m repro.launch.train`` runs it,
# its host mesh made with Auto axes: jax 0.9's ``jax.make_mesh`` makes
# Explicit axes by default, which the reference's embedding gather refuses
# (the same quirk as its dry run's, test_torch_dryrun.py).
_JAX_CLI = r"""
import runpy, sys
import jax
from jax.sharding import AxisType
make_mesh = jax.make_mesh
jax.make_mesh = lambda shape, names, **kw: make_mesh(
    shape, names, axis_types=(AxisType.Auto,) * len(shape), **kw)
sys.argv = ["repro.launch.train", *sys.argv[1:]]
runpy.run_module("repro.launch.train", run_name="__main__")
"""


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """The JAX package's train CLI: 3 steps of the same arch and data,
    saving at steps 1 and 2."""
    out = tmp_path_factory.mktemp("jax_ckpt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", _JAX_CLI, "--arch", ARCH,
         "--smoke", "--steps", "3", "--batch", "4", "--seq", "16",
         "--ckpt-every", "1", "--ckpt-dir", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return out


@pytest.fixture(scope="module")
def mesh_run(jax_ckpt, tmp_path_factory):
    from torch_mesh import run_ranks

    dirs = [tmp_path_factory.mktemp(n) for n in ("cont", "final")]
    res = run_ranks(str(Path(__file__)), "ckpt_ranks", world=4, timeout=300,
                    args=[str(d) for d in (*dirs, jax_ckpt)])
    res["final_dir"] = dirs[1]
    return res


def _assert_bits_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype, key
        assert got[key].tobytes() == arr.tobytes(), key


def test_resumed_mesh_run_equals_continuous(mesh_run):
    assert mesh_run["cont/steps"] == [3]
    assert mesh_run["resumed/first_line"] == "restored step 3"
    assert mesh_run["resumed/start"] == 4
    assert mesh_run["resumed/losses"] == mesh_run["cont/losses"][4:]
    state = mesh_run["cont/state"]
    assert any(".mu" in k for k in state) and any(".master" in k
                                                   for k in state)
    _assert_bits_equal(mesh_run["resumed/state"], state)


def test_mesh_checkpoint_restores_off_the_mesh(mesh_run):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_model
    from repro_torch.optim.adamw import init_adamw

    params = init_model(get_config(ARCH, smoke=True),
                        torch.Generator().manual_seed(1))
    tree, step = CheckpointManager(mesh_run["final_dir"]).restore(
        (params, init_adamw(params)))
    assert step == 6
    _assert_bits_equal(_bits(tree), mesh_run["cont/state"])


def test_jax_checkpoint_restores_into_a_mesh_run(mesh_run, jax_ckpt):
    """Leaf for leaf, the mesh run's state after its restore is the JAX
    CLI's step-2 file, bit for bit (bf16 as its uint16 bits)."""
    assert mesh_run["jax/start"] == 3
    with np.load(jax_ckpt / "step_000000002" / "shard_00000.npz") as data:
        want = {k: data[k] for k in data.files}
    got = mesh_run["jax/state"]
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        assert got[key].shape == arr.shape, key
        assert got[key].tobytes() == arr.tobytes(), key
