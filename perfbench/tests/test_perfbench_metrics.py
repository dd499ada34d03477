"""The end-to-end numbers are taken over all requests and all the window's
time, so that a stall moves them; the per-layer readers read what they
should and return nothing where there is nothing to read."""


import time

import numpy as np
import pytest

from perfbench.tests import smoke
from perfbench import harness, work
from perfbench.trace import Interval, TraceData


def _window(recs, t0=0.0, t1=10.0, trace=None, spans=()):
    c = smoke.cell("attn", loop="open")
    return harness.Window(c["cfg"]["model"], c["cfg"]["head"], c["mix"], t0,
                          t1, recs, {"decode_steps": 10,
                                     "active_slot_steps": 30}, list(spans),
                          trace)


def _steady(n=40, gap=0.25, ttft=0.2, tpot=0.05, tokens=10, stall=None,
            t1=10.0):
    """n requests due every ``gap`` s from 0, each answered after ``ttft``
    and streaming ``tokens`` tokens ``tpot`` apart; ``stall`` = (at, s)
    holds every token due to reach the host after ``at`` back ``s``
    seconds.  Tokens after ``t1`` never arrive."""
    recs = []
    for i in range(n):
        due = i * gap
        times = [due + ttft + tpot * j for j in range(tokens)]
        if stall:
            times = [t + stall[1] if t >= stall[0] else t for t in times]
        got = [t for t in times if t <= t1]
        r = harness.Rec(i, np.zeros(8, np.int32), tokens, None, due,
                        seen=len(got))
        if got:
            r.first_t, r.last_t, r.win_from, r.win_to = got[0], got[-1], 0, len(got)
        if len(got) == tokens:
            r.done_t = got[-1]
        recs.append(r)
    return recs


def test_steady_window_reads_its_own_numbers():
    recs = _steady()
    e = harness.end_to_end(_window(recs))
    assert e["ttft_p95_ms"] == pytest.approx(200.0)
    assert e["ttft_mean_ms"] == pytest.approx(200.0)
    assert e["tpot_p95_ms"] == pytest.approx(50.0)
    # the last request's tokens after t1 never came: 389 of 400
    assert e["out_tok_s"] == pytest.approx(sum(r.seen for r in recs) / 10.0)
    assert sum(r.seen for r in recs) == 389
    assert e["prompt_tok_s"] == pytest.approx(40 * 8 / 10.0)


def test_a_stall_moves_the_tail_of_all_requests():
    """A 1.5 s stall at t = 5 s: every request in flight or due then waits;
    the tails see it, where a median over requests would not."""
    base = harness.end_to_end(_window(_steady()))
    recs = _steady(stall=(5.0, 1.5))
    stalled = harness.end_to_end(_window(recs))
    assert stalled["ttft_p95_ms"] > base["ttft_p95_ms"] + 1000
    assert stalled["ttft_mean_ms"] > base["ttft_mean_ms"] + 100
    assert stalled["tpot_p95_ms"] > base["tpot_p95_ms"] + 50
    assert stalled["out_tok_s"] < base["out_tok_s"]


def test_an_unanswered_request_counts_with_its_wait_so_far():
    recs = _steady(n=20)
    for r in recs[-2:]:
        r.first_t = r.last_t = r.done_t = None
        r.seen, r.win_from, r.win_to = 0, None, 0
    e = harness.end_to_end(_window(recs, t1=30.0))
    # the two unanswered ones waited 30 - 4.75 and 30 - 4.5 s: the top of 20
    assert e["ttft_p95_ms"] > 20000
    assert e["ttft_mean_ms"] > 2500


def test_tokens_before_the_window_do_not_count():
    recs = _steady(n=4)
    for r in recs:
        r.win_from = r.win_to = None
    e = harness.end_to_end(_window(recs))
    assert e["out_tok_s"] == 0.0


class _FakeEngine:
    """The engine's face as the harness drives it: each step prefills what
    waits (its first token) and gives every active request ``per_step``
    tokens more, ``step_s`` seconds a step.  It keeps each step's time and
    the tokens and prompt tokens that step first brought to the host."""

    def __init__(self, n_slots=4, per_step=3, step_s=0.01):
        self.outputs, self.finished, self.queue = {}, {}, []
        self.stats = {"decode_steps": 0, "active_slot_steps": 0}
        self.n_slots, self.per_step, self.step_s = n_slots, per_step, step_s
        self.active, self.budget, self.plen = [], {}, {}
        self.log = []                   # (end time, tokens, prompt tokens)
        self.now = 0.0
        self.sched = self

    @property
    def n_active(self):
        return len(self.active)

    def submit(self, prompt, budget, arrival=None, tenant=None):
        rid = len(self.budget)
        self.budget[rid], self.plen[rid] = budget, len(prompt)
        self.queue.append(rid)
        return rid

    def step(self):
        tokens = prompts = 0
        while self.queue and len(self.active) < self.n_slots:
            rid = self.queue.pop(0)
            self.active.append(rid)
            self.outputs[rid] = [1]
            tokens, prompts = tokens + 1, prompts + self.plen[rid]
        for rid in list(self.active):
            out = self.outputs[rid]
            n = min(self.per_step, self.budget[rid] - len(out))
            out.extend([1] * n)
            tokens += n
            if len(out) == self.budget[rid]:
                self.active.remove(rid)
                self.finished[rid] = out
        self.stats["decode_steps"] += 1
        time.sleep(self.step_s)
        self.log.append((time.perf_counter(), tokens, prompts))


def test_the_warm_step_before_the_window_does_not_count():
    """A closed loop's first step prefills every client's first request
    and decodes a megastep before the window opens: neither its tokens
    nor its prompts are the window's work."""
    from perfbench import traffic
    mix = traffic.Mix("fake", smoke.mix_spec("closed"))
    engine = _FakeEngine()
    run = harness.drive(engine, mix, mix.stream(2 ** 31 + 5, 256), 0.5,
                        False, [])
    w = harness.Window({}, {}, mix, run["t0"], run["t1"], run["recs"],
                       run["stats"], [], None)
    first = engine.log[0]
    assert first[0] < w.t0 and first[1] > 0 and first[2] > 0
    inside = [e for e in engine.log if w.t0 <= e[0] <= w.t1]
    assert len(inside) == len(engine.log) - 1
    e = harness.end_to_end(w)
    assert e["out_tok_s"] * w.seconds == pytest.approx(
        sum(x[1] for x in inside))
    assert e["prompt_tok_s"] * w.seconds == pytest.approx(
        sum(x[2] for x in inside))


def test_model_flops_match_a_hand_count_at_smoke_size():
    """One attention request of prompt 8 whose tokens 0..9 all arrived in
    the window: its prefill and 9 decode tokens."""
    w = _window(_steady(n=1))
    cfg, head = w.cfg, w.head
    d, ff, v, n = 64, 128, 256, 2
    q, kv = 4 * 16, 2 * 16
    params = n * (2 * d * q + 2 * d * kv + 3 * d * ff)
    assert work.matmul_params(cfg) == params
    attn_pair = n * 4 * 16 * 4                   # two products a key, per head
    prefill = 2 * params * 8 + attn_pair * (8 * 9 // 2) + 2 * v * d
    sketch = 2 * d * 32 + 2 * 32 * 128 + 128 * v
    decode = sum(2 * params + sketch + attn_pair * (8 + i) for i in range(1, 10))
    got = w.model_flops()
    assert got["prefill"] == prefill and got["decode"] == decode


def test_readers_return_nothing_without_a_trace_or_spans():
    w = _window(_steady())
    for name in ("fused_decode_roofline.decode", "flash_attn_roofline.chat",
                 "device_idle.decode", "decode_step_ms.decode",
                 "prefill_ms_per_ktok.chat"):
        assert harness.reader(harness.ROOT, name)(w) is None


def test_trace_readers():
    k = [Interval("void fused_decode_kernel<0, 8>", 0.0, 0.002),
         Interval("flash_attn_tc_kernel<128>", 0.0105, 0.0110),
         Interval("gemm", 0.003, 0.004)]
    notes = [Interval("pb.prefill:1x8", 0.010, 0.012),
             Interval("pb.megastep:4x3", 0.0, 0.003)]
    w = _window(_steady(), trace=TraceData(k, notes, 0.020),
                spans=[("prefill", 1.0, 1.5, (1, 8)), ("insert", 1.5, 1.6, 1),
                       ("megastep", 2.0, 2.4, (4, 3))])
    assert harness.reader(harness.ROOT, "device_idle.decode")(w) == \
        pytest.approx(100 * (1 - 0.0035 / 0.020))
    least = max(work.flash_attn_work(1, 8, 4, 2, 16, None, 2)[0] / work.PEAK_BYTES,
                work.flash_attn_work(1, 8, 4, 2, 16, None, 2)[1] / work.PEAK_BF16)
    assert harness.reader(harness.ROOT, "flash_attn_roofline.chat")(w) == \
        pytest.approx(100 * least / 0.0005)
    fb, fo = work.fused_decode_work(4, 64, w.head, 256,
                                    work.expected_rows(128, 16, 3 + 1))
    assert harness.reader(harness.ROOT, "fused_decode_roofline.decode")(w) == \
        pytest.approx(100 * max(fb / work.PEAK_BYTES, fo / work.PEAK_F32) / 0.002)
    assert harness.reader(harness.ROOT, "decode_step_ms.decode")(w) == \
        pytest.approx(100.0)
    assert harness.reader(harness.ROOT, "prefill_ms_per_ktok.chat")(w) == \
        pytest.approx(0.6 * 1e3 / 0.008)
    assert harness.reader(harness.ROOT, "slot_util.decode")(w) == \
        pytest.approx(75.0)


def test_busy_is_the_union_of_kernel_intervals():
    t = TraceData([Interval("a", 0, 2), Interval("b", 1, 3),
                   Interval("c", 5, 6)], [], 10.0)
    assert t.busy_s() == pytest.approx(4.0)
    assert t.idle_gaps()[0] == ("host: engine and harness", 2.0)
