"""The port's dry run (``launch/dryrun.py``) against the JAX package's.

Its cells and shapes, the abstract inputs of every arch at full width
(fake tensors against ``jax.eval_shape``, leaf by leaf) and the active
parameter count equal the reference's.  The reference's table of four
smoke cells is traced on a fake 2×2 group and held against JAX's
``build_cell`` on a 2×2 mesh of placeholder devices (compiled in a
subprocess: the device count is fixed before JAX starts): the per-rank
argument bytes equal, and the FLOPs equal or differ by products derived
here from the shapes, each named with its reason.  Last, the reference's
four ``test_dryrun`` cells run through the port's CLI on the fake 256-
and 512-rank production meshes.

The port traces fake CPU tensors here (``--device cpu``, the kernels'
plain versions): a CPU-only build of torch cannot index a fake CUDA
tensor, and the card runs the CUDA trace (``chip_smoke.py``).  ~60 s on
one thread, most of it the two JAX and four CLI subprocesses.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, arch_names, cells, get_config
from repro_torch.launch import steps
from repro_torch.models.config import active_param_count
from repro_torch.sharding.rules import tree_paths

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("granite-8b", "train_4k"), ("granite-8b", "decode_32k"),
         ("rwkv6-1.6b", "long_500k"), ("mixtral-8x7b", "prefill_32k")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (it shares the machine
    with the other pytest workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


def test_shapes_and_cells_equal_jax():
    """The same shapes and cells (each registry lists its archs in its
    own order)."""
    import repro.configs as jcfg
    assert SHAPES == jcfg.SHAPES
    assert sorted(arch_names()) == sorted(jcfg.arch_names())
    for skipped in (False, True):
        got = list(cells(skipped))
        assert len(set(got)) == len(got)
        assert sorted(got) == sorted(jcfg.cells(skipped))


def _jax_leaves(tree) -> dict:
    import jax
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name",
                                                     getattr(k, "idx", k))))
                       for k in path)
        out[key] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _port_leaves(tree) -> dict:
    return {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in tree_paths(tree)}


@pytest.mark.parametrize("arch", arch_names())
def test_abstract_inputs_equal_jax(arch):
    """Every leaf of ``abstract_params`` and of each shape's
    ``input_specs`` (full size), by path: the same shape and dtype.  One
    layout differs on purpose: a prologue layer's decode cache is a stack
    of one here (``models/model.py``), (1, B, …) for the reference's
    (B, …), the same elements."""
    from repro.configs import get_config as jax_config
    from repro.launch import steps as jsteps

    assert (_port_leaves(steps.abstract_params(get_config(arch)))
            == _jax_leaves(jsteps.abstract_params(jax_config(arch))))
    for shape in SHAPES:
        strip = lambda spec: {k: v for k, v in spec.items()
                              if k not in ("cfg", "kind", "seq", "batch")}
        want = _jax_leaves(strip(jsteps.input_specs(arch, shape)))
        got = _port_leaves(strip(steps.input_specs(arch, shape)))
        assert set(got) == set(want)
        for path, (shape_, dtype) in got.items():
            if path.startswith("cache/prologue/"):
                assert shape_[0] == 1
                shape_ = shape_[1:]
            assert (shape_, dtype) == want[path], path


@pytest.mark.parametrize("arch", arch_names())
def test_active_param_count_equals_jax(arch):
    from repro.configs import get_config as jax_config
    from repro.models.config import active_param_count as jax_count
    assert active_param_count(get_config(arch)) == jax_count(jax_config(arch))


_JAX_CELLS = r"""
import json, os, sys
import repro.launch.dryrun as dryrun       # asks for 512 devices at import
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from jax.sharding import AxisType
from repro.launch.hlo_analysis import analyze
from repro.sharding.ctx import activation_sharding
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
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
    """JAX's per-device figures of the four cells on a 2×2 Auto mesh
    (jax 0.9's ``jax.make_mesh`` makes Explicit axes by default, which the
    reference's ``with_sharding_constraint`` refuses)."""
    res = subprocess.run(
        [sys.executable, "-c", _JAX_CELLS, *(f"{a}:{s}" for a, s in CELLS)],
        cwd=ROOT, capture_output=True, text=True, timeout=600, env=_env())
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _port_cell(arch, shape):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun import build_cell, fake_group
    from repro_torch.launch.hlo_analysis import analyze

    with fake_group(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            step, args, cfg = build_cell(arch, shape, mesh, smoke=True,
                                         device="cpu")
            return analyze(step, *args), cfg


def _formulation_difference(arch, shape, cfg) -> int:
    """The port's FLOPs less JAX's on the 2×2 mesh (data 2, model 2),
    from the shapes: the products the two count differently."""
    seq, batch, _ = SHAPES[shape]
    b, m = batch // 2, 2                    # local batch rows, model axis
    a, d, n_layers = cfg.attention, cfg.d_model, cfg.n_layers
    heads = a.n_heads // m
    if shape == "train_4k":
        # The plain backward (flash_attention_bwd_ref) recomputes the
        # scores q·kᵀ, which XLA's gradient of the rematerialised forward
        # takes from the recomputed forward.
        return n_layers * 2 * b * heads * seq * seq * a.head_dim
    if shape == "prefill_32k":
        mo = cfg.moe
        # Attention: the plain version's two products over every (query,
        # key) square, against _attend_banded's over each 1024-query
        # chunk's band of window + 1024 keys.
        chunk = 1024
        plain = 4 * b * heads * seq * seq * a.head_dim
        banded = (4 * b * heads * math.ceil(seq / chunk) * chunk
                  * (a.window + chunk) * a.head_dim)
        # The reference dispatches and combines the MoE with one-hot
        # einsums over (G, s, E, C); the port gathers.
        gsz = min(seq, mo.group_size)
        capacity = max(1, int(mo.capacity_factor * gsz * mo.top_k
                              / mo.n_experts))
        one_hot = 2 * (2 * (b * seq // gsz) * gsz * (mo.n_experts // m)
                       * capacity * d)
        # GSPMD splits the router's logits over the model axis; the
        # router's rule (P(None, None)) replicates them here.
        router = 2 * b * seq * d * mo.n_experts * (m - 1) // m
        # The reference's cacheless prefill unembeds every position and
        # keeps the last; the port unembeds the last alone.
        unembed = 2 * b * (seq - 1) * (cfg.vocab_size // m) * d
        return (n_layers * (plain - banded - one_hot + router) - unembed)
    return 0


@pytest.mark.parametrize("arch,shape", CELLS)
def test_smoke_cell_on_2x2_against_jax(jax_cells, arch, shape):
    want = jax_cells[f"{arch}:{shape}"]
    got, cfg = _port_cell(arch, shape)
    print(f"{arch} {shape} collective bytes: JAX {want['coll']}, "
          f"port {got['collective_bytes']}; flops JAX {want['flops']:.6e}, "
          f"port {got['flops']:.6e}")
    # The decode cells' 0-d int32 ``pos``: the port's scalar decode takes
    # the position on the host (an int), no argument tensor.  The
    # reference counts it where the model reads it (jax.jit drops an
    # unused argument: rwkv's recurrent decode reads no position).
    from repro_torch.models.blocks import SEQ_KINDS
    pos = 4 if (shape.startswith(("decode", "long"))
                and set(cfg.pattern) & set(SEQ_KINDS)) else 0
    assert got["memory"]["argument_size_bytes"] == (
        want["argument_size_bytes"] - pos)
    if arch.startswith("rwkv6"):
        # Batch 1 does not divide the data axis: GSPMD spreads seven of
        # each layer's products over it as well, and rewrites the WKV
        # recurrence's products with a unit dimension as elementwise ops;
        # DTensor replicates a batch the axis cannot split.  Printed, not
        # gated (PERF.md §6).
        assert got["flops"] > 0
        return
    assert got["flops"] - want["flops"] == _formulation_difference(
        arch, shape, cfg)


@pytest.mark.parametrize("arch,shape,mesh", [
    ("granite-8b", "train_4k", "single"),
    ("granite-8b", "decode_32k", "multi"),
    ("mixtral-8x7b", "train_4k", "multi"),
    ("rwkv6-1.6b", "long_500k", "single"),
])
def test_reference_cells_through_the_cli(arch, shape, mesh):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--smoke", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, env=_env())
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads((ROOT / "results" / "dryrun_torch"
                      / f"{arch}__{shape}__{mesh}.json").read_text())
    assert out["flops"] > 0
    assert out["n_devices"] == (512 if mesh == "multi" else 256)
    assert out["device"] == "cpu"


# ---------------------------------------------- the mesh paths it found

class _StubMesh:
    """What the activation context reads of a mesh."""
    mesh_dim_names = ("data", "model")
    shape = (1, 4)


def test_remat_recompute_sees_the_activation_context_on_another_thread():
    """``checkpoint``'s recompute runs inside the backward, on the
    autograd engine's device thread for CUDA tensors: the context the
    forward ran under goes with it (``recompute_contexts``)."""
    import threading

    from repro_torch.sharding.ctx import (active_mesh, activation_sharding,
                                          recompute_contexts)

    mesh = _StubMesh()
    with activation_sharding(mesh):
        _, recompute = recompute_contexts()
    seen = []

    def backward_thread():
        seen.append(active_mesh())
        with recompute:
            seen.append(active_mesh())
        seen.append(active_mesh())

    t = threading.Thread(target=backward_thread)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert seen == [None, mesh, None]


def test_expanded_kv_heads_attend_alike():
    """On a mesh whose model axis does not divide the KV heads, train and
    prefill repeat each KV head over its query group (the JAX package's
    rule): the same attention, bit for bit."""
    import numpy as np

    from repro_torch.kernels.flash_attn.ops import flash_attention_ref
    from repro_torch.models.attention import _expand_kv
    from repro_torch.models.config import AttentionConfig
    from repro_torch.sharding.ctx import activation_sharding

    cfg = AttentionConfig(n_heads=8, n_kv_heads=2, head_dim=16)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 12, 8, 16), (2, 12, 2, 16), (2, 12, 2, 16)))
    assert _expand_kv(k, v, cfg)[0] is k          # no mesh: grouped
    with activation_sharding(_StubMesh()):        # model 4 ∤ 2 KV heads
        ke, ve = _expand_kv(k, v, cfg)
    assert ke.shape == (2, 12, 8, 16)
    assert torch.equal(ke, k.repeat_interleave(4, dim=2))
    assert torch.equal(flash_attention_ref(q, ke, ve),
                       flash_attention_ref(q, k, v))


def test_microbatches_split_each_ranks_rows():
    """With gradient accumulation on a mesh, microbatch i is every rank's
    i-th block of its own rows (no row moves); off a mesh, the batch's
    i-th block."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.steps import _microbatch

    x = torch.arange(16).reshape(8, 2)
    assert torch.equal(_microbatch(x, 1, 2), x[4:])
    with fake_group(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        local = x[:4]                             # rank 0's rows
        dx = DTensor.from_local(local, mesh, [Shard(0), Replicate()],
                                run_check=False)
        mb = _microbatch(dx, 1, 2)
        assert tuple(mb.placements) == (Shard(0), Replicate())
        assert mb.shape == (4, 2)
        assert torch.equal(mb.to_local(), local[2:])
