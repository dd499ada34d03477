"""The dry run on a mesh with a ``pod`` axis: the batch of the local-block
cores (attention, WKV, flash attention) stays over every data axis.

The rules shard a batch, and a decode cache's, over ``("pod", "data")``
(``sharding/rules.batch_spec``); the per-(batch, head) cores run on each
rank's own rows (``sharding/local.on_local_blocks``).  Two smoke decode
cells trace on a fake 8-rank group as a (2, 2, 2) ``("pod", "data",
"model")`` mesh and on a fake 4-rank (2, 2) mesh: splitting the batch over
one more axis moves no more collective bytes a rank, and halves the
rank's FLOPs.  The same cells are held against JAX's ``build_cell`` on a
(2, 2, 2) Auto mesh of 8 placeholder devices (compiled in a subprocess:
the device count is fixed before JAX starts): the argument bytes equal
(less the reference's 4-byte ``pos``) and the FLOPs equal.  Last, on 8
real gloo ranks as a (2, 2, 2) mesh, ``sharding.ctx.replicated`` (the
logits before the sampler, a checkpoint's leaves) gathers a DTensor in one
all-gather to the same full tensor as ``full_tensor``'s stages.  ~25 s
alone, ~45 s beside the other workers.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("granite-8b", "decode_32k"), ("musicgen-large", "decode_32k")]
POD = ((2, 2, 2), ("pod", "data", "model"))
FLAT = ((2, 2), ("data", "model"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX_CELLS = r"""
import json, os, sys
import repro.launch.dryrun as dryrun       # asks for 512 devices at import
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType
from repro.launch.hlo_analysis import analyze
from repro.sharding.ctx import activation_sharding
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(AxisType.Auto,) * 3)
out = {}
for cell in sys.argv[1:]:
    arch, shape = cell.split(":")
    with mesh, activation_sharding(mesh):
        jitted, args, cfg = dryrun.build_cell(arch, shape, mesh, smoke=True)
        compiled = jitted.lower(*args).compile()
    hl = analyze(compiled.as_text())
    out[cell] = {"flops": hl["flops"], "coll": hl["collective_bytes"],
                 "argument_size_bytes":
                     compiled.memory_analysis().argument_size_in_bytes}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", _JAX_CELLS, *(f"{a}:{s}" for a, s in CELLS)],
        cwd=ROOT, capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _port_cell(arch, shape, layout):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun import (_strided_shard_bookkeeping_real,
                                           build_cell, fake_group)
    from repro_torch.launch.hlo_analysis import analyze

    shape_, names = layout
    with fake_group(math.prod(shape_)):
        mesh = init_device_mesh("cpu", shape_, mesh_dim_names=names)
        with FakeTensorMode(), _strided_shard_bookkeeping_real():
            step, args, cfg = build_cell(arch, shape, mesh, smoke=True,
                                         device="cpu")
            return analyze(step, *args), cfg


@pytest.fixture(scope="module")
def port_cells():
    return {(arch, shape, mesh): _port_cell(arch, shape, layout)
            for arch, shape in CELLS
            for mesh, layout in (("pod", POD), ("flat", FLAT))}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_pod_axis_moves_no_more_than_the_flat_mesh(port_cells, arch, shape):
    pod, _ = port_cells[(arch, shape, "pod")]
    flat, _ = port_cells[(arch, shape, "flat")]
    print(f"{arch} {shape} collective bytes a rank: (2, 2, 2) "
          f"{pod['collective_bytes']}, (2, 2) {flat['collective_bytes']}")
    assert (pod["collective_bytes"]["total"]
            <= flat["collective_bytes"]["total"])
    # Half the rows a rank: half the products.
    assert 2 * pod["flops"] == flat["flops"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_pod_cell_against_jax(port_cells, jax_cells, arch, shape):
    from repro_torch.models.blocks import SEQ_KINDS

    want = jax_cells[f"{arch}:{shape}"]
    got, cfg = port_cells[(arch, shape, "pod")]
    print(f"{arch} {shape} on (2, 2, 2): collective bytes JAX "
          f"{want['coll']}, port {got['collective_bytes']}")
    # The reference's 0-d int32 ``pos``, which the port's scalar decode
    # takes on the host (test_torch_dryrun.py).
    pos = 4 if set(cfg.pattern) & set(SEQ_KINDS) else 0
    assert got["memory"]["argument_size_bytes"] == (
        want["argument_size_bytes"] - pos)
    assert got["flops"] == want["flops"]


def gather_ranks(rank, world):
    """Each layout of a (12, 8) and an uneven (13, 8) tensor on the
    (2, 2, 2) mesh: ``replicated`` against the tensor and ``full_tensor``
    on every rank, and the collective bytes of each."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.sharding.ctx import replicated

    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    S, R = Shard, Replicate
    out = {}
    for rows in (12, 13):
        full = torch.arange(rows * 8, dtype=torch.float32).reshape(rows, 8)
        for name, pl in (("S0 S0 S1", (S(0), S(0), S(1))),
                         ("S1 R S0", (S(1), R(), S(0))),
                         ("R S0 R", (R(), S(0), R())),
                         ("S0 S1 S0", (S(0), S(1), S(0))),
                         ("R R R", (R(), R(), R()))):
            dt = DTensor.from_local(full, mesh, [R()] * 3,
                                    run_check=False).redistribute(mesh, pl)
            got = replicated(dt)
            ok = [bool(torch.equal(got, full)
                       and torch.equal(dt.full_tensor(), full))]
            every = [None] * world
            dist.all_gather_object(every, ok[0])
            coll = {f: analyze(f, dt)["collective_bytes"]["total"]
                    for f in (replicated, DTensor.full_tensor)}
            out[f"{rows} {name}"] = (all(every), coll[replicated],
                                     coll[DTensor.full_tensor])
    return out


def test_replicated_gathers_once_on_a_pod_mesh():
    """Sharded over every mesh dim, evenly: one all-gather, the full
    tensor's bytes, fewer than ``full_tensor``'s stages; a layout with a
    replicated mesh dim, or uneven shards, takes ``full_tensor``'s way.
    Every rank gets the full tensor in each case."""
    from torch_mesh import run_ranks

    res = run_ranks(str(Path(__file__)), "gather_ranks", world=8,
                    timeout=240)
    for key, (equal, once, staged) in res.items():
        rows, layout = key.split(" ", 1)
        assert equal, key
        if rows == "12" and "R" not in layout:
            assert once == int(rows) * 8 * 4 < staged, key
        else:
            assert once == staged, key


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k", "train_4k"])
def test_mla_heads_the_model_axis_does_not_divide(shape):
    """deepseek's smoke MLA (4 heads) on a fake (1, 8) group: its query,
    key and value heads are split after a feature gather and its absorbed
    weights gathered before their head split, as attention's heads are
    (DTensor has no layout for a head split between ranks), so every cell
    traces."""
    rec, _ = _port_cell("deepseek-v3-671b", shape, ((1, 8), ("data", "model")))
    assert rec["flops"] > 0
