"""One run of one cell: load, warm up, serve a window of traffic through the
port's continuous-batching engine, measure, check the served tokens against
the plain reference, print the result line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<name>.json``), a traffic mix (``traffic/<name>.json``) and has
its check's limits in ``limits/<workload>.json``; each per-layer metric has
its reader in ``metrics/<name>.py`` (or ``metrics/<name before the first
dot>.py``).  Nothing here names a cell.

The program is driven through its public serving entry only:
``repro_torch.api.LM`` and ``LM.engine`` (``launch.engine.make_engine``),
then ``ServeEngine.submit`` and ``ServeEngine.step``; a request is
submitted with ``arrival=engine.now`` when its time comes, and
``engine.outputs`` is read after every step for the tokens that reached
the host.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench import reference, traffic, weights, work
from perfbench.trace import SLICE_S, Slice, TraceData

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Rec:
    """One request's life as the client sees it (host clock)."""
    rid: int
    prompt: np.ndarray
    budget: int
    tenant: Optional[int]
    due: float
    seen: int = 0
    first_t: Optional[float] = None
    last_t: Optional[float] = None
    done_t: Optional[float] = None
    win_from: Optional[int] = None      # first token index that arrived in the window
    win_to: int = 0


@dataclasses.dataclass
class Window:
    """What a metric reader sees of one run."""
    cfg: dict
    head: dict
    mix: traffic.Mix
    t0: float
    t1: float
    recs: List[Rec]
    stats: Dict[str, int]               # the engine's counters over the window
    spans: List[tuple]                  # (name, t0, t1, meta) of traced runs
    trace: Optional[TraceData]

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def in_window(self, t: Optional[float]) -> bool:
        return t is not None and self.t0 <= t <= self.t1

    def model_flops(self) -> Dict[str, float]:
        """Model FLOPs of the work completed in the window: each prefill
        whose first token arrived in it, each decode token that did."""
        out = {"prefill": 0.0, "decode": 0.0}
        for r in self.recs:
            if r.win_from is None:
                continue
            a = r.win_from
            if a == 0:
                out["prefill"] += work.prefill_flops(self.cfg, len(r.prompt))
                a = 1
            out["decode"] += work.decode_flops(self.cfg, self.head,
                                               len(r.prompt), a, r.win_to)
        return out


# -- the cell's files -----------------------------------------------------

def load_cell(root: Path, workload: str) -> dict:
    bench = json.loads((root.parent / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"unknown workload {workload!r}")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root.parent / conf["file"]).read_text())
    mix = traffic.Mix.load(root, cell["traffic"])
    limits_file = root / "limits" / f"{workload}.json"
    limits = (json.loads(limits_file.read_text()) if limits_file.exists()
              else None)
    end_to_end = [m for m in bench["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    return {"cell": cell, "cfg": cfg, "mix": mix, "limits": limits,
            "end_to_end": end_to_end, "per_layer": per_layer}


def reader(root: Path, name: str) -> Callable[[Window], Optional[float]]:
    """The per-layer metric's reader: ``metrics/<name>.py``'s ``read``,
    else the one of the name's part before its first dot."""
    for stem in (name, name.split(".")[0]):
        path = root / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"perfbench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise SystemExit(f"no reader for per-layer metric {name!r}")


# -- the system under test --------------------------------------------------

def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import AttentionConfig
    base = get_config(cfg["arch"], smoke=cfg.get("smoke", False))
    over = {"n_layers": cfg["model"]["n_layers"]}
    if cfg["model"]["kind"] == "attn":
        a = cfg["model"]["attention"]
        over["attention"] = AttentionConfig(
            n_heads=a["n_heads"], n_kv_heads=a["n_kv_heads"],
            head_dim=a["head_dim"], rope_theta=a["rope_theta"])
    mc = base.scaled(**over)
    m = cfg["model"]
    for key in ("d_model", "d_ff", "vocab_size", "tie_embeddings", "norm_eps"):
        if getattr(mc, key) != m[key]:
            raise SystemExit(f"{cfg['arch']}: the port's {key} is "
                             f"{getattr(mc, key)}, the configuration's {m[key]}")
    return mc


def head_config(head: dict):
    from repro_torch.models.config import SketchHeadConfig
    return SketchHeadConfig(n_rows=head["n_rows"], n_buckets=head["n_buckets"],
                            k=head["k"], proj_dim=head["proj_dim"],
                            bandwidth=head["bandwidth"])


class Served:
    """The program's objects of one run: the LM, its engine, the heads."""

    def __init__(self, cfg: dict, mix: traffic.Mix, seed: int, device,
                 params: dict):
        from repro_torch.api import LM, HeadCache, SketchHead
        m, h = cfg["model"], cfg["head"]
        self.heads: Dict[Optional[int], dict] = {}
        spec = SketchHead(cfg=head_config(h), backend="fused")
        head_cache = None
        if mix.tenants:
            head_cache = HeadCache(
                lambda t: weights.draw_head(h, m["d_model"], m["vocab_size"],
                                            seed, t, device),
                mix.tenants["capacity"])
            for t in range(mix.tenants["n"]):
                head_cache.acquire(t)
                head_cache.release(t)
        else:
            self.heads[None] = weights.draw_head(h, m["d_model"],
                                                 m["vocab_size"], seed, 0,
                                                 device)
            spec = spec.with_params(self.heads[None])
        self.lm = LM(params, model_config(cfg), spec, torch.device(device))
        self.engine = self.lm.engine(mix.n_slots, mix.max_seq,
                                     decode_chunk=mix.decode_chunk,
                                     head_cache=head_cache)

    def close(self) -> None:
        self.engine.close()
        self.engine = self.lm = None


def instrument(engine, spans: list, annotate: bool) -> None:
    """Spans around the backend's prefill, insert and megastep calls (the
    prefill's synchronised), each inside a ``pb.<name>:<shape>``
    annotation: a prefill's (G, P), a megastep's steps and active slots,
    an insert's rows."""
    backend = engine.backend
    for name, sync in (("prefill", True), ("insert", True),
                       ("megastep", False)):
        fn = getattr(backend, name)

        def timed(*a, _fn=fn, _name=name, _sync=sync, **k):
            meta = (tuple(np.shape(a[0])) if _name == "prefill"
                    else (a[5], int(np.sum(a[3]))) if _name == "megastep"
                    else len(a[2]))
            label = f"pb.{_name}:" + "x".join(map(str, np.atleast_1d(meta)))
            t = time.perf_counter()
            with torch.profiler.record_function(label) if annotate else _null():
                out = _fn(*a, **k)
                if _sync and torch.cuda.is_available():
                    torch.cuda.synchronize()
            spans.append((_name, t, time.perf_counter(), meta))
            return out
        setattr(backend, name, timed)


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# -- the run ---------------------------------------------------------------

def warm_up(engine, mix: traffic.Mix, tenants: bool) -> None:
    """Every shape the window uses, once: a prefill at the mix's longest
    prompt and at its shortest, and megasteps (the decode step's capture)."""
    lens = [mix.spec["prompt"]["hi"], mix.spec["prompt"]["lo"]]
    rids = [engine.submit(np.zeros(n, np.int32), mix.decode_chunk + 2,
                          arrival=engine.now, tenant=0 if tenants else None)
            for n in lens]
    while any(r not in engine.finished for r in rids):
        engine.step()


def drive(engine, mix: traffic.Mix, stream: traffic.Stream, seconds: float,
          traced: bool, spans: list) -> dict:
    """The warm load, then the window: requests submitted when due, tokens
    watched after every step.  Returns the records and the window's
    times, counters and trace."""
    recs: Dict[int, Rec] = {}
    live: List[int] = []
    queue: List[tuple] = []             # (time, requests waiting) after each step
    now = time.perf_counter

    def submit(req: traffic.Request, due: float, budget: int) -> None:
        rid = engine.submit(req.prompt, budget, arrival=engine.now,
                            tenant=req.tenant)
        recs[rid] = Rec(rid, req.prompt, budget, req.tenant, due)
        live.append(rid)

    t0 = math.inf                       # the window opens below

    def collect(t: float) -> None:
        for rid in list(live):
            out = engine.outputs.get(rid)
            r = recs[rid]
            n = len(out) if out else 0
            if n > r.seen:
                if r.first_t is None:
                    r.first_t = t
                r.last_t = t
                if t >= t0:
                    if r.win_from is None:
                        r.win_from = r.seen
                    r.win_to = n
                r.seen = n
            if rid in engine.finished:
                r.done_t = t
                live.remove(rid)
                if mix.loop == "closed":
                    req = stream.next()
                    submit(req, t, req.budget)

    start = now()
    if mix.loop == "closed":
        first = [stream.next() for _ in range(mix.spec["clients"])]
        for req, b in zip(first, traffic.residual_budgets(
                [r.budget for r in first])):
            submit(req, start, b)
        # The first requests' prefills and a megastep: what they bring to
        # the host is seen before the window opens, and is not its work.
        engine.step()
        collect(now())
        t0 = now()
    else:
        t0 = start + float(mix.spec.get("warm_s", 0.0))
    t_end = t0 + seconds
    stats0 = None if mix.loop == "open" else dict(engine.stats)
    prof = Slice(torch.cuda.is_available()) if traced else None
    # The window's last seconds: the profiler's stop, which reduces its
    # records, comes after the window has closed.
    prof_at = t0 + max(0.0, seconds - SLICE_S)
    t = now()
    while True:
        if mix.loop == "open":
            while stream.peek().due + t0 <= t:
                req = stream.next()
                submit(req, req.due + t0, req.budget)
            if stats0 is None and t >= t0:
                stats0 = dict(engine.stats)
        if prof is not None and prof.fresh and t >= prof_at:
            prof.start()
        if t >= t_end:
            break
        if not engine.sched.n_active and not engine.queue:
            wake = [t_end]
            if mix.loop == "open":
                wake.append(stream.peek().due + t0)
            if prof is not None and prof.fresh:
                wake.append(prof_at)
            time.sleep(max(0.0, min(wake) - t))
            t = now()
            continue
        engine.step()
        t = now()
        collect(t)
        queue.append((t, len(engine.queue)))
    stats1 = dict(engine.stats)
    if prof is not None and prof.running:
        prof.stop()
    if stats0 is None:
        stats0 = stats1
    return {"recs": list(recs.values()), "t0": t0, "t1": t,
            "stats": {k: stats1[k] - stats0.get(k, 0) for k in stats1},
            "trace": prof.data() if prof is not None else None,
            "queue": queue}


def p95(values: List[float]) -> Optional[float]:
    return float(np.percentile(values, 95)) if values else None


def end_to_end(w: Window) -> Dict[str, float]:
    """The user-facing numbers of one window (see BENCHMARK.json)."""
    recs = w.recs
    due = [r for r in recs if w.t0 <= r.due < w.t1]
    ttft = [((r.first_t if r.first_t is not None and r.first_t <= w.t1
              else w.t1) - r.due) * 1e3 for r in due]
    tpot = [(r.last_t - r.first_t) / (r.seen - 1) * 1e3 for r in recs
            if w.in_window(r.done_t) and r.seen > 1]
    out_tok = sum(r.win_to - r.win_from for r in recs if r.win_from is not None)
    prompt_tok = sum(len(r.prompt) for r in recs if w.in_window(r.first_t))
    return {"out_tok_s": out_tok / w.seconds,
            "ttft_mean_ms": float(np.mean(ttft)) if ttft else None,
            "ttft_p95_ms": p95(ttft),
            "tpot_p95_ms": p95(tpot), "prompt_tok_s": prompt_tok / w.seconds,
            "_due": len(due), "_finished": sum(w.in_window(r.done_t)
                                              for r in recs),
            "_ttft_quartiles_ms": (np.percentile(ttft, [25, 50, 75, 90])
                                   .tolist() if ttft else None)}


def sample_for_check(recs: List[Rec], finished: Dict[int, list], n: int,
                     seed: int) -> List[dict]:
    """``n`` finished requests drawn from the seed, the longest answer
    among them."""
    done = sorted((r for r in recs if r.rid in finished),
                  key=lambda r: (-len(finished[r.rid]), r.rid))
    if not done:
        return []
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 29])
    rest = done[1:]
    pick = [done[0]] + [rest[i] for i in sorted(
        rng.choice(len(rest), min(n - 1, len(rest)), replace=False))]
    return [{"rid": r.rid, "prompt": r.prompt, "budget": r.budget,
             "served": np.asarray(finished[r.rid], np.int64),
             "tenant": r.tenant} for r in pick]


def check_readings(worst: Dict[str, float]) -> Dict[str, float]:
    """The numbers a cell's limits may name, from the reference's gaps
    over the sample: the widest gap of a first token (dense head) and of
    a decode token (sketched head), the decode tokens' mean gap, and the
    share of them whose gap exceeds 0.05."""
    nan = float("nan")
    return {"first_gap": worst.get("first", nan),
            "decode_gap": worst.get("decode", nan),
            "decode_gap_mean": worst.get("decode_mean", nan),
            "decode_share_over_0.05": worst.get("decode_over_0.05", nan)}


def judge(readings: Dict[str, float], limits: Optional[dict],
          wrong_len: int, sampled: bool) -> tuple:
    """``(correct, failed, check)`` of one set of readings against the
    cell's limits: each limit a reading must not exceed; a reading with no
    limit, or no reading, fails.  The program's readings and the control's
    are judged by this one rule."""
    limits = limits or {name: None for name in readings}
    check = {name: {"value": None if math.isnan(readings[name])
                    else readings[name], "limit": lim}
             for name, lim in limits.items()}
    failed = wrong_len + sum(v["limit"] is None or v["value"] is None
                             or not v["value"] <= v["limit"]
                             for v in check.values())
    return sampled and failed == 0, failed, check


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(root: Path, c: dict, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", control: bool = False,
             fault: Optional[Callable] = None) -> dict:
    """One run of the cell ``c`` (:func:`load_cell`); returns the result
    line's dict (and, with ``control``, the control's verdict and readings
    under the same limits, as ``"control"``).  ``fault`` patches the served
    engine before the window (the fault tests)."""
    cfg, mix = c["cfg"], c["mix"]
    m = cfg["model"]
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params = weights.draw_backbone(m, seed, device)
    served = Served(cfg, mix, seed, device, params)
    engine = served.engine
    spans: list = []
    if trace:
        instrument(engine, spans, annotate=True)
    warm_up(engine, mix, bool(mix.tenants))
    if fault is not None:
        fault(engine)
    setup_s = time.perf_counter() - t_start
    stream = mix.stream(seed, m["vocab_size"])
    spans.clear()
    run = drive(engine, mix, stream, seconds, trace, spans)
    win = Window(m, cfg["head"], mix, run["t0"], run["t1"], run["recs"],
                 run["stats"], [s for s in spans if s[1] >= run["t0"]],
                 run["trace"])
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    e2e = end_to_end(win)
    finished = {rid: list(v) for rid, v in engine.finished.items()}
    sample = sample_for_check(run["recs"], finished, mix.check_requests, seed)
    served.close()
    del served, engine
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    head_cfg = cfg["head"]
    tenant_heads: Dict[Optional[int], dict] = {}

    def heads(t):
        if t not in tenant_heads:
            tenant_heads.clear()
            tenant_heads[t] = weights.draw_head(
                head_cfg, m["d_model"], m["vocab_size"], seed,
                0 if t is None else t, device)
        return tenant_heads[t]

    worst = reference.check_requests(
        params, m, heads, head_cfg, sorted(sample, key=lambda r: r["tenant"] or 0),
        reference.Precision("fp8") if control else None)
    wrong_len = sum(len(r["served"]) != r["budget"] for r in sample)
    correct, failed, check = judge(check_readings(worst), c["limits"],
                                   wrong_len, bool(sample))
    result = {"correct": correct, "attempted": e2e["_due"] or len(run["recs"]),
              "failed": 0 if correct else max(1, failed)}
    units = {x["name"]: x["unit"] for x in c["end_to_end"] + c["per_layer"]}
    metrics = {}
    if not trace:
        for x in c["end_to_end"]:
            val = setup_s if x["name"] == "setup_s" else e2e.get(x["name"])
            if val is not None:
                metrics[x["name"]] = {"value": val, "unit": units[x["name"]]}
    else:
        for x in c["per_layer"]:
            val = reader(root, x["name"])(win)
            if val is not None:
                metrics[x["name"]] = {"value": val, "unit": units[x["name"]]}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace and win.trace is not None:
        dev["busy_s"] = win.trace.busy_s()
        dev["window_s"] = win.trace.window_s
        result["breakdown"] = {"device_ops": win.trace.device_ops(),
                               "idle_gaps": win.trace.idle_gaps()}
    result["device"] = dev
    result["check"] = check
    result["_info"] = {"due": e2e["_due"], "finished_in_window":
                       e2e["_finished"], "window_s": win.seconds,
                       "ttft_q_ms": e2e["_ttft_quartiles_ms"],
                       "ttft_p95_ms": e2e["ttft_p95_ms"],
                       "tpot_p95_ms": e2e["tpot_p95_ms"],
                       "out_tok_s": e2e["out_tok_s"],
                       "readings": check_readings(worst),
                       "sampled": [(r["rid"], len(r["prompt"]),
                                    len(r["served"])) for r in sample],
                       "stats": win.stats}
    if control:
        ctl = check_readings({k[len("control_"):]: v for k, v in worst.items()
                              if k.startswith("control_")})
        ctl_correct, _, ctl_check = judge(ctl, c["limits"], 0, bool(sample))
        result["control"] = {"correct": ctl_correct, "check": ctl_check}
    return result
