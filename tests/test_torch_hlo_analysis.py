"""The port's per-rank op analyzer (``launch/hlo_analysis.analyze``)
against the JAX package's HLO analyzer.

The six cases of ``tests/test_hlo_analysis.py`` each assert the value
JAX's ``analyze`` gives on the same function in this process (a loop of
products stands in for a scan, a nested loop for the nested scan).  A
sharded product on a fake 2×2 group is held against JAX on a 2×2 mesh of
placeholder devices (in a subprocess: the device count is fixed before
JAX starts).  A product on a fake 16×16 group counts one rank's local
product once, not the global one beside it.  The flash-attention
wrappers' fake branch (fake CUDA tensors, as the dry run traces them):
the kernel's work as ``kernels/work.py`` prices it, no launch, the
kernel's own checks.  ~10 s on one thread; the ``cuda`` case (the
autograd function: a CPU-only build of torch has no autograd for fake
CUDA tensors, nor indexing) runs on the card only.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import work
from repro_torch.kernels.flash_attn.ops import (flash_attention,
                                               flash_attention_bwd,
                                               flash_attention_ref)
from repro_torch.launch.hlo_analysis import analyze

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (it shares the machine
    with the other pytest workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_analyze():
    """``(hlo(fn, *shapes), analyze)`` of the JAX package."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.launch.hlo_analysis import analyze as janalyze

    def hlo(fn, *shapes):
        structs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
        return jax.jit(fn).lower(*structs).compile().as_text()
    return hlo, janalyze


def _randn(*shape):
    return torch.from_numpy(
        np.random.default_rng(0).standard_normal(shape).astype(np.float32))


def test_single_matmul_flops(jax_analyze):
    hlo, janalyze = jax_analyze
    want = janalyze(hlo(lambda a, b: a @ b, (64, 128), (128, 32)))["flops"]
    got = analyze(lambda a, b: a @ b, _randn(64, 128), _randn(128, 32))
    assert want == 2 * 64 * 128 * 32
    assert got["flops"] == want


def test_loop_of_products_counts_every_trip(jax_analyze):
    import jax
    hlo, janalyze = jax_analyze

    def scan(a, b):
        return jax.lax.scan(lambda c, _: (c @ b, None), a, None, length=7)[0]

    def loop(a, b):
        for _ in range(7):
            a = a @ b
        return a

    want = janalyze(hlo(scan, (32, 32), (32, 32)))["flops"]
    assert want == 7 * 2 * 32 ** 3
    assert analyze(loop, _randn(32, 32), _randn(32, 32))["flops"] == want


def test_nested_loops_multiply(jax_analyze):
    import jax
    hlo, janalyze = jax_analyze

    def scan(a, b):
        def outer(c, _):
            return jax.lax.scan(lambda ci, _: (ci @ b, None), c, None,
                                length=5)[0], None
        return jax.lax.scan(outer, a, None, length=3)[0]

    def loop(a, b):
        for _ in range(3):
            for _ in range(5):
                a = a @ b
        return a

    want = janalyze(hlo(scan, (16, 16), (16, 16)))["flops"]
    assert want == 15 * 2 * 16 ** 3
    assert analyze(loop, _randn(16, 16), _randn(16, 16))["flops"] == want


def test_batched_dot_counts_batch_dims(jax_analyze):
    import jax.numpy as jnp
    hlo, janalyze = jax_analyze
    want = janalyze(hlo(lambda a, b: jnp.einsum("bsk,kd->bsd", a, b),
                        (4, 8, 16), (16, 8)))["flops"]
    got = analyze(lambda a, b: torch.einsum("bsk,kd->bsd", a, b),
                  _randn(4, 8, 16), _randn(16, 8))
    assert want == 2 * 4 * 8 * 8 * 16
    assert got["flops"] == want


def test_bytes_positive_and_bounded(jax_analyze):
    """Both within the reference's bound.  XLA fuses ``a * 2 + 1`` into
    one kernel reading and writing the array once; the port dispatches
    two ops, each reading and writing it: exactly twice JAX's bytes, and
    the same elementwise count."""
    hlo, janalyze = jax_analyze
    want = janalyze(hlo(lambda a: a * 2.0 + 1.0, (256, 256)))
    got = analyze(lambda a: a * 2.0 + 1.0, _randn(256, 256))
    nbytes = 256 * 256 * 4
    for r in (want, got):
        assert nbytes <= r["bytes_accessed"] <= 6 * nbytes
    assert want["bytes_accessed"] == 2 * nbytes
    assert got["bytes_accessed"] == 2 * want["bytes_accessed"]
    assert got["elementwise_flops"] == want["elementwise_flops"]


def test_elementwise_flops_counted(jax_analyze):
    import jax.numpy as jnp
    hlo, janalyze = jax_analyze
    want = janalyze(hlo(lambda a: jnp.tanh(a) * a, (128,)))
    got = analyze(lambda a: torch.tanh(a) * a, _randn(128))
    assert want["elementwise_flops"] >= 2 * 128
    assert got["elementwise_flops"] == want["elementwise_flops"]


def test_memory_counts_arguments_outputs_and_the_peak():
    """``y`` and ``z`` are live together at the add: the peak is two
    arrays; ``y`` dies with the call, ``z`` is the output."""
    def f(x):
        y = x * 2
        z = y + 1
        return z

    x = _randn(64, 32)
    n = x.numel() * 4
    mem = analyze(f, x)["memory"]
    assert mem == {"argument_size_bytes": n, "output_size_bytes": n,
                   "temp_size_bytes": 2 * n}
    # An in-place update allocates nothing and outputs its argument.
    mem = analyze(lambda t: t.mul_(2), x)["memory"]
    assert mem == {"argument_size_bytes": n, "output_size_bytes": 0,
                   "temp_size_bytes": 0}


_JAX_SHARDED = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.launch.hlo_analysis import analyze
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
x = jax.ShapeDtypeStruct((64, 128), jnp.float32,
                         sharding=NamedSharding(mesh, P("data", None)))
w = jax.ShapeDtypeStruct((128, 32), jnp.float32,
                         sharding=NamedSharding(mesh, P("model", None)))
hl = analyze(jax.jit(lambda a, b: a @ b).lower(x, w).compile().as_text())
print(json.dumps({"flops": hl["flops"], "coll": hl["collective_bytes"]}))
"""


def _fake_mesh(shape, device):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, shape, mesh_dim_names=("data", "model"))


def test_sharded_product_per_rank_matches_jax():
    """x (64, 128) over ``data``, w (128, 32) over ``model`` (its
    contracted dim): each rank multiplies (32, 64)·(64, 32) and the
    partial sums meet in one all-reduce of the (32, 32) f32 block."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.dryrun import fake_group

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _JAX_SHARDED], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    with fake_group(4):
        mesh = _fake_mesh((2, 2), "cpu")
        x = DTensor.from_local(_randn(32, 128), mesh, [Shard(0), Replicate()],
                               run_check=False)
        w = DTensor.from_local(_randn(64, 32), mesh, [Replicate(), Shard(0)],
                               run_check=False)
        got = analyze(lambda a, b: (a @ b).redistribute(
            mesh, [Shard(0), Replicate()]), x, w)
    assert want["flops"] == got["flops"] == 131072
    assert want["coll"] == {"all-reduce": 4096.0, "total": 4096.0}
    assert got["collective_bytes"] == {"all-reduce": 4096, "total": 4096}


def test_16x16_product_counts_the_local_product_once():
    """(256, 4096)·(4096, 4096) f32, x over ``data``, w's contracted dim
    over ``model``: one rank runs (16, 256)·(256, 4096), 3.36e7 flops —
    not the 8.6e9 of that plus the global product DTensor's sharding
    propagation runs on placeholders."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.dryrun import fake_group

    with fake_group(256):
        mesh = _fake_mesh((16, 16), "cuda")      # a real mesh, fake tensors
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(16, 4096, device="cuda"), mesh,
                                   [Shard(0), Replicate()], run_check=False)
            w = DTensor.from_local(torch.empty(256, 4096, device="cuda"),
                                   mesh, [Replicate(), Shard(0)],
                                   run_check=False)
            for _ in range(2):      # the second call hits DTensor's caches
                got = analyze(lambda a, b: (a @ b).redistribute(
                    mesh, [Shard(0), Replicate()]), x, w)
                assert got["flops"] == 2 * 16 * 256 * 4096 == 33554432
                assert got["collective_bytes"] == {
                    "all-reduce": 16 * 4096 * 4, "total": 16 * 4096 * 4}


SHAPE = dict(b=2, s=48, h=4, hkv=2, dh=32, window=16)


def _qkv(device, dtype=torch.bfloat16, dh=SHAPE["dh"], requires_grad=False):
    b, s, h, hkv = SHAPE["b"], SHAPE["s"], SHAPE["h"], SHAPE["hkv"]
    return tuple(torch.empty(shape, dtype=dtype, device=device,
                             requires_grad=requires_grad)
                 for shape in ((b, s, h, dh), (b, s, hkv, dh),
                               (b, s, hkv, dh)))


def test_fake_flash_attention_counts_its_work_and_launches_nothing():
    b, s, h, hkv, dh, window = (SHAPE[k] for k in
                                ("b", "s", "h", "hkv", "dh", "window"))
    before = (flash_attention.launches, flash_attention_bwd.launches)
    with FakeTensorMode():
        q, k, v = _qkv("cuda")
        got = analyze(lambda *t: flash_attention(*t, window=window), q, k, v)
        out = got["result"]
        assert out.shape == q.shape and out.dtype == q.dtype
        assert got["kernels"] == {"flash_attn": 1}
        n_bytes, n_ops = work.flash_attn_work(b, s, h, hkv, dh, window, 2)
        assert got["flops"] == n_ops == 4 * dh * b * h * (
            16 * 17 // 2 + (s - 16) * 16)
        assert got["bytes_accessed"] == n_bytes

        # The backward kernel's fake branch (called directly: a CPU-only
        # build of torch has no autograd for fake CUDA tensors).
        lse = torch.empty((b, h, s), dtype=torch.float32, device="cuda")
        got = analyze(lambda *t: flash_attention_bwd(*t, window=window),
                      q, k, v, out, out, lse)
        assert got["kernels"] == {"flash_attn_bwd": 1}
        bwd_bytes, bwd_ops, recomputed = work.flash_attn_bwd_work(
            b, s, h, hkv, dh, window, 2)
        assert got["flops"] == bwd_ops + recomputed == 10 * n_ops // 4
        assert got["bytes_accessed"] == bwd_bytes
        assert [tuple(g.shape) for g in got["result"]] == [
            tuple(t.shape) for t in (q, k, v)]
    assert (flash_attention.launches, flash_attention_bwd.launches) == before


def test_fake_flash_attention_runs_the_kernels_checks():
    with FakeTensorMode():
        q, k, v = _qkv("cuda", dh=24)
        with pytest.raises(ValueError, match="multiple of 16"):
            flash_attention(q, k, v)
        q, k, v = _qkv("cuda", dh=32)
        lse = torch.empty((SHAPE["b"], SHAPE["h"], SHAPE["s"]),
                          dtype=torch.bfloat16, device="cuda")
        with pytest.raises(TypeError, match="lse has dtype"):
            flash_attention_bwd(q, k, v, q, q, lse)


def test_real_cpu_tensors_take_the_plain_version():
    q, k, v = (_randn(*t.shape) for t in _qkv("meta", dtype=torch.float32))
    before = flash_attention.launches
    got = analyze(lambda *t: flash_attention(*t, window=SHAPE["window"]),
                  q, k, v)
    assert torch.equal(got["result"],
                       flash_attention_ref(q, k, v, window=SHAPE["window"]))
    assert got["kernels"] == {} and flash_attention.launches == before
    # The plain version's two einsums over every (query, key) square.
    b, s, h, dh = SHAPE["b"], SHAPE["s"], SHAPE["h"], SHAPE["dh"]
    assert got["flops"] == 4 * b * h * s * s * dh


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_launch_counts_what_the_fake_trace_counts(cuda_device):
    """The kernels launched on the card record the figures their fake
    branches record for the same shapes."""
    def step(q, k, v):
        out = flash_attention(q, k, v, window=SHAPE["window"])
        return torch.autograd.grad(out.float().sum(), (q, k, v))

    gen = torch.Generator(cuda_device).manual_seed(0)
    q, k, v = (torch.randn(t.shape, generator=gen, device=cuda_device,
                           dtype=torch.bfloat16).requires_grad_()
               for t in _qkv("meta"))
    before = (flash_attention.launches, flash_attention_bwd.launches)
    real = analyze(step, q, k, v)
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    with FakeTensorMode():
        fake = analyze(step, *_qkv("cuda", requires_grad=True))
    assert real["kernels"] == fake["kernels"] == {"flash_attn": 1,
                                                  "flash_attn_bwd": 1}
    assert real["flops"] == fake["flops"]
