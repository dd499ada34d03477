"""Deterministic synthetic token pipeline with sharded host loading.

The JAX package's ``data/pipeline.py``, the port's own copy (plain numpy,
so it gives the reference's batches bit for bit): each host materializes
only its shard of the global batch (``host_slice``), tokens come from a
counter-based hash (stateless and seekable: a restart at step N gives the
same batch without replaying N steps), and a prefetch thread keeps
``prefetch`` batches ready.  A real deployment swaps ``synthetic_batch``
for a tokenized-shard reader behind the same iterator contract.  The
batches are numpy arrays; the training loop moves them to its device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    n_encoder_tokens: int = 0
    d_model: int = 0          # for encoder-state stubs


def _counter_hash(counters: np.ndarray, seed: int) -> np.ndarray:
    """Stateless splitmix-style integer hash (uint64 → uint64)."""
    x = counters.astype(np.uint64) + np.uint64(seed * 0x9E3779B97F4A7C15 + 1)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def synthetic_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Deterministic batch for ``step`` — this host's slice only.

    Token stream has Zipf-ish marginals + a short-range copy structure so the
    LM loss is learnable (tests assert loss decreases).
    """
    per_host = cfg.global_batch // cfg.n_hosts
    base = (np.int64(step) * cfg.global_batch + cfg.host_id * per_host)
    rows = base + np.arange(per_host, dtype=np.int64)[:, None]
    cols = np.arange(cfg.seq_len + 1, dtype=np.int64)[None, :]
    h = _counter_hash(rows * (cfg.seq_len + 1) + cols, cfg.seed)
    # Zipf-ish marginal: square a uniform to skew towards low ids.
    u = (h % np.uint64(1 << 30)).astype(np.float64) / float(1 << 30)
    toks = (u * u * cfg.vocab_size).astype(np.int32)
    # Copy structure: every 8th position repeats position-4 tokens.
    toks[:, 8::8] = toks[:, 4:-4:8][:, : toks[:, 8::8].shape[1]]
    batch = {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:].astype(np.int32),
    }
    if cfg.n_encoder_tokens:
        he = _counter_hash(
            rows * np.int64(cfg.n_encoder_tokens * cfg.d_model)
            + np.arange(cfg.n_encoder_tokens * cfg.d_model, dtype=np.int64)[None, :],
            cfg.seed + 1)
        enc = ((he % np.uint64(1 << 16)).astype(np.float32) / (1 << 15) - 1.0)
        batch["encoder_states"] = enc.reshape(
            per_host, cfg.n_encoder_tokens, cfg.d_model).astype(np.float32)
    return batch


class PrefetchingLoader:
    """Background-thread prefetch over synthetic_batch (host-local shard)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, prefetch: int = 2):
        self.cfg = cfg
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = synthetic_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
