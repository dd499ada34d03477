"""A whole run at smoke size on the CPU (the harness's look for a card
skipped): what it imports, its result line, and that ``correct`` comes
out false when the timed path is broken underneath: a token altered where
it is produced, a decode step that leaves its state unchanged, half of the
batch left out of the decode steps (its rows the pad token).  The numbers
compared are the committed cells' own (``limits/<workload>.json``), at the
smoke limits of ``smoke.LIMITS``."""

import subprocess
import sys
import time

import numpy as np
import pytest

from perfbench.tests import smoke
from perfbench import harness

def _run(kind, fault=None, seed=2 ** 31 + 99, trace=False):
    c = smoke.cell(kind, limits=smoke.limits(kind))
    c["mix"].check_requests = 6
    return harness.run_cell(harness.ROOT, c, seed, 2.0, trace,
                            time.perf_counter(), device="cpu", fault=fault)


def _wrap_megastep(engine, change):
    inner = engine.backend.megastep

    def megastep(*a, **k):
        block, *rest = inner(*a, **k)
        return (change(np.array(block)), *rest)
    engine.backend.megastep = megastep


def altered_token(engine):
    """Every decoded token the host receives is off by one."""
    _wrap_megastep(engine, lambda b: (b + 1) % 256)


def half_the_batch(engine):
    """The upper half of the slots is left out of each decode step: its
    rows come back as the pad token 0."""
    def change(b):
        b[:, b.shape[1] // 2:] = 0
        return b
    _wrap_megastep(engine, change)


def state_unchanged(engine):
    """The decode step writes nothing back: rwkv's state and token shifts,
    attention's keys and values stay as the prefill left them."""
    from repro_torch.models import attention, blocks
    mp = pytest.MonkeyPatch()
    mp.setattr(blocks, "_commit_", lambda *a, **k: None)
    mp.setattr(attention, "put_rows_", lambda *a, **k: None)
    engine._perfbench_undo = mp


@pytest.mark.parametrize("kind", ["rwkv", "attn"])
def test_sound_smoke_run_is_correct(kind):
    r = _run(kind)
    assert r["correct"] and r["failed"] == 0, r["check"]
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert set(r["check"]) == set(smoke.limits(kind))
    assert r["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("fault", [altered_token, half_the_batch,
                                   state_unchanged])
@pytest.mark.parametrize("kind", ["rwkv", "attn"])
def test_a_broken_timed_path_is_not_correct(kind, fault):
    undo = []

    def apply(engine):
        fault(engine)
        if hasattr(engine, "_perfbench_undo"):
            undo.append(engine._perfbench_undo)
    try:
        r = _run(kind, apply)
    finally:
        for mp in undo:
            mp.undo()
    assert not r["correct"], r["check"]


def test_traced_smoke_run_reports_per_layer_metrics():
    r = _run("rwkv", trace=True)
    assert "slot_util.decode" in r["metrics"]
    assert "decode_step_ms.decode" in r["metrics"]
    assert r["device"]["window_s"] > 0 and "breakdown" in r


_SMOKE_RUN = r"""
import sys, time
sys.path[:0] = [{root!r}, {src!r}]
from perfbench.tests import smoke
from perfbench import harness
c = smoke.cell({kind!r})
harness.run_cell(harness.ROOT, c, 5, 1.0, False, time.perf_counter(), device="cpu")
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


@pytest.mark.parametrize("kind", ["rwkv", "attn"])
def test_a_run_loads_neither_jax_nor_the_jax_package(kind):
    code = _SMOKE_RUN.format(root=str(smoke.ROOT), src=str(smoke.ROOT / "src"),
                             kind=kind)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=smoke.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    mods = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_without_a_card_the_run_exits_nonzero_and_prints_nothing():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "rwkv6-longgen", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=smoke.ROOT)
    assert out.returncode != 0 and out.stdout == ""
