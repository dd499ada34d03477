"""The one traffic generator: a mix file of parameters → requests.

A mix (``traffic/<name>.json``) gives the loop (``closed``: ``clients``
that each send their next request when the last one's final token has
reached them; ``open``: Poisson arrivals at ``rate`` a second), the
distributions of prompt and output lengths, the engine's ``n_slots``,
``max_seq`` and ``decode_chunk``, optional ``tenants`` (a count and a Zipf
exponent), the warm load, and how many finished requests the check
compares.

Every seed serves the same work in another order: lengths, arrival gaps and
tenants are drawn in blocks of ``BLOCK`` requests at the block's stratified
quantiles ((i + ½)/BLOCK of each distribution), and the seed shuffles each
block and draws the prompt token ids.  So two seeds differ by the order of
one multiset, not by its mean.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from statistics import NormalDist
from typing import List, Optional

import numpy as np

BLOCK = 64


def _ppf(dist: dict, u: np.ndarray) -> np.ndarray:
    """Lengths at quantiles ``u`` of a length distribution, as integers in
    [lo, hi]: ``loguniform``, ``lognormal`` (``median``, ``sigma``, then
    clipped), ``uniform``."""
    lo, hi = dist["lo"], dist["hi"]
    kind = dist["dist"]
    if kind == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif kind == "uniform":
        x = lo + u * (hi - lo + 1) - 0.5
    elif kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(p)) for p in u])
        x = dist["median"] * np.exp(dist["sigma"] * z)
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def _strata() -> np.ndarray:
    return (np.arange(BLOCK) + 0.5) / BLOCK


def _zipf_block(n: int, s: float) -> np.ndarray:
    """BLOCK tenant ids with counts ∝ 1/(t+1)^s (largest remainders)."""
    p = 1.0 / np.arange(1, n + 1) ** s
    p /= p.sum()
    want = p * BLOCK
    counts = np.floor(want).astype(int)
    for t in np.argsort(-(want - counts))[:BLOCK - counts.sum()]:
        counts[t] += 1
    return np.repeat(np.arange(n), counts)


@dataclasses.dataclass
class Request:
    """One generated request: prompt ids, output budget, tenant, and for
    an open loop its due time in seconds from the window's opening
    (negative: the warm load)."""
    index: int
    prompt: np.ndarray
    budget: int
    tenant: Optional[int] = None
    due: Optional[float] = None


class Mix:
    """A traffic mix read from its file."""

    def __init__(self, name: str, spec: dict):
        self.name = name
        self.spec = spec
        self.loop = spec["loop"]
        if self.loop not in ("open", "closed"):
            raise ValueError(f"mix {name}: loop must be open or closed")
        self.n_slots = spec["n_slots"]
        self.max_seq = spec["max_seq"]
        self.decode_chunk = spec["decode_chunk"]
        self.tenants = spec.get("tenants")
        self.check_requests = spec["check"]["requests"]
        if spec["prompt"]["hi"] + spec["output"]["hi"] > self.max_seq + 1:
            raise ValueError(f"mix {name}: the longest prompt and answer "
                             f"exceed max_seq")

    @classmethod
    def load(cls, root: Path, name: str) -> "Mix":
        return cls(name, json.loads((root / "traffic" / f"{name}.json")
                                    .read_text()))

    def prompt_lengths(self) -> np.ndarray:
        """The distinct prompt lengths a block holds (every seed's)."""
        return np.unique(_ppf(self.spec["prompt"], _strata()))

    def stream(self, seed: int, vocab: int) -> "Stream":
        return Stream(self, seed, vocab)


class Stream:
    """The seed's endless sequence of requests of a mix, block by block."""

    def __init__(self, mix: Mix, seed: int, vocab: int):
        self.mix = mix
        self.rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 17])
        self.vocab = vocab
        self._buf: List[Request] = []
        self._made = 0
        self._t = -float(mix.spec.get("warm_s", 0.0))

    def _block(self) -> None:
        spec, rng = self.mix.spec, self.rng
        plen = rng.permutation(_ppf(spec["prompt"], _strata()))
        outl = rng.permutation(_ppf(spec["output"], _strata()))
        ten = (rng.permutation(_zipf_block(self.mix.tenants["n"],
                                           self.mix.tenants["zipf_s"]))
               if self.mix.tenants else [None] * BLOCK)
        gaps = (rng.permutation(-np.log1p(-_strata())) / spec["rate"]
                if self.mix.loop == "open" else None)
        for i in range(BLOCK):
            due = None
            if gaps is not None:
                self._t += float(gaps[i])
                due = self._t
            prompt = rng.integers(0, self.vocab, int(plen[i]), dtype=np.int32)
            self._buf.append(Request(self._made, prompt, int(outl[i]),
                                     None if ten[i] is None else int(ten[i]),
                                     due))
            self._made += 1

    def next(self) -> Request:
        if not self._buf:
            self._block()
        return self._buf.pop(0)

    def peek(self) -> Request:
        if not self._buf:
            self._block()
        return self._buf[0]


def residual_budgets(budgets: List[int]) -> List[int]:
    """Warm budgets of a closed loop's first requests: each client's first
    answer is cut to a share (i + ½)/n of its length, the shares over the
    clients spread evenly, so that the clients' answers end at staggered
    times from the window's opening, as in a loop that has run a while."""
    n = len(budgets)
    return [max(1, int(math.ceil(b * (i + 0.5) / n)))
            for i, b in enumerate(budgets)]
