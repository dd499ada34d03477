"""The op analyzer's weighed chunk loops against the per-iteration trace.

``launch/hlo_analysis.analyze`` traces a ``kernels/work.chunk_loop`` (the
WKV and Mamba scans) through its first two iterations and its last, and
weighs the second by the trip count, as the JAX package's analyzer weighs
a scan's body.  Every count (FLOPs, elementwise FLOPs, bytes, collective
bytes, ops, kernel calls) and the memory figures must equal the trace of
every iteration: rwkv6's WKV loop and jamba's Mamba scan at smoke width
over enough chunks to end in a padded one, and a smoke jamba prefill (both
kinds of layer) cut to 1100 tokens on a fake (2, 2, 2) group.  With grad
on (a train step), and on real tensors (a calibration), every iteration
runs.  ~40 s on one thread.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(fn, *args):
    """``analyze`` weighed and per iteration, results dropped."""
    from repro_torch.launch.hlo_analysis import analyze

    out = []
    for weigh in (True, False):
        rec = analyze(fn, *args, weigh_loops=weigh)
        rec.pop("result")
        out.append(rec)
    return out


def test_wkv_loop_weighed_equals_per_iteration():
    """167 tokens: 6 chunks of 32, the last padded."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.rwkv import _wkv_chunked

    b, s, h, dk = 3, 167, 4, 64
    with FakeTensorMode(), torch.no_grad():
        r, k, v = (torch.empty(b, s, h, dk) for _ in range(3))
        logw, u = torch.empty(b, s, h, dk), torch.empty(h, dk)
        state0 = torch.empty(b, h, dk, dk)
        weighed, full = _both(_wkv_chunked, r, k, v, logw, u, state0)
    assert weighed == full
    assert weighed["flops"] > 0


def test_mamba_scan_weighed_equals_per_iteration():
    """1100 tokens: 5 chunks of 256, the last padded (76 live)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.models.mamba import init_mamba, mamba_block

    cfg = get_config("jamba-v0.1-52b", smoke=True)
    with FakeTensorMode(), torch.no_grad():
        params = init_mamba(torch.Generator(), cfg.d_model, cfg.mamba)
        x = torch.empty(2, 1100, cfg.d_model, dtype=torch.bfloat16)
        weighed, full = _both(
            lambda p, x: mamba_block(p, x, cfg.mamba)[0], params, x)
    assert weighed == full
    assert weighed["n_ops"] > 0


def test_short_jamba_prefill_cell_weighed_equals_per_iteration():
    """A smoke jamba prefill cut to 1100 tokens on a fake (2, 2, 2)
    ``("pod", "data", "model")`` group (DTensor state)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun import (_strided_shard_bookkeeping_real,
                                           build_cell, fake_group)

    with fake_group(8):
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        with FakeTensorMode(), _strided_shard_bookkeeping_real():
            step, args, _ = build_cell("jamba-v0.1-52b", "prefill_32k", mesh,
                                       smoke=True, device="cpu", seq=1100)
            weighed, full = _both(step, *args)
    assert weighed == full
    assert weighed["collective_bytes"]["total"] > 0


def test_chunk_loop_runs_every_iteration_with_grad_or_unweighed():
    """Outside an analyzer, and inside one while autograd records (a train
    step's loops), the body runs for every chunk, in order, on real
    tensors: the same values as a plain loop."""
    from repro_torch.kernels.work import chunk_loop, weighing_loops

    def run(grad: bool, runner=None):
        seen = []

        def body(c, carry):
            seen.append(c)
            return carry * 2, carry + c

        x = torch.tensor(np.arange(3.0), requires_grad=grad)
        with torch.set_grad_enabled(grad):
            if runner is None:
                ys, carry = chunk_loop(6, body, x)
            else:
                with weighing_loops(runner):
                    ys, carry = chunk_loop(6, body, x)
        return seen, ys, carry

    def refuse(*args):
        raise AssertionError("weighed while autograd records")

    for grad, runner in ((False, None), (True, None), (True, refuse)):
        seen, ys, carry = run(grad, runner)
        x = torch.tensor(np.arange(3.0))
        assert seen == list(range(6))
        assert torch.equal(carry.detach(), x + 15)
        assert [y.detach().tolist() for y in ys] == [
            (2 * (x + sum(range(c)))).tolist() for c in range(6)]


def test_real_loop_under_the_analyzer_runs_every_iteration():
    """On real tensors (the calibration's real steps) the analyzer runs and
    counts every iteration: the WKV's outputs equal the plain call's, bit
    for bit, and its counts the per-iteration trace's."""
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.models.rwkv import _wkv_chunked

    rng = np.random.default_rng(0)
    b, s, h, dk = 2, 167, 2, 64
    r, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, dk))
                                .astype(np.float32)) for _ in range(3))
    logw = -torch.from_numpy(rng.random((b, s, h, dk)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((h, dk)).astype(np.float32))
    state0 = torch.zeros(b, h, dk, dk)
    with torch.no_grad():
        want = _wkv_chunked(r, k, v, logw, u, state0)
        weighed = analyze(_wkv_chunked, r, k, v, logw, u, state0)
        full = analyze(_wkv_chunked, r, k, v, logw, u, state0,
                       weigh_loops=False)
    for got in (weighed.pop("result"), full.pop("result")):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert weighed == full
