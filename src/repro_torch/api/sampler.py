"""Sampler: the decode-time sampling policy, and the threefry key chain.

``Sampler(temperature, top_k, top_p, seed)`` is the JAX package's
``repro.api.sampler.Sampler``: greedy argmax at ``temperature == 0`` (the
key untouched), else one split of the carried key per sample, the logits
divided by the temperature, filtered by top-k then top-p, and a
categorical draw (the Gumbel-max trick) from the split-off key.

The key chain is ``jax.random``'s threefry2x32 as JAX 0.9.0 runs it with
``jax_threefry_partitionable=True`` (its default): :func:`prng_key`,
:func:`split`, :func:`random_bits`, :func:`uniform` and
:func:`categorical` give its keys, bits and uniforms bit for bit.  A key
is a (2,) int64 tensor holding two uint32 words; every word is kept in
an int64 with explicit 32-bit masks (torch has no uint32 arithmetic on
every device), and nothing reads a value back to the host, so a sample
runs inside a captured CUDA graph.  The Gumbel noise is
``-log(-log(u))``, ``u`` uniform on [tiny, 1) (``jax.random.gumbel``'s
default "low" mode); its ``log`` is the device's, which may round an ulp
away from XLA's (``repro_torch.parity.check_sampled_tokens`` holds the
tokens to that).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
F32_TINY = torch.finfo(torch.float32).tiny
F32_MIN = torch.finfo(torch.float32).min


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry_2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The threefry2x32 block cipher (20 rounds) of counter words ``(x1,
    x2)`` under key words ``(k1, k2)``: uint32 values in int64 tensors
    (the keys may be 0-d); returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (64-bit types off): the words ``(0,
    seed mod 2³²)``, as a (2,) int64 tensor on ``device``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def _counters(n: int, device):
    """The (hi, lo) words of the 64-bit iota ``0 .. n - 1``."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys, the i-th the cipher
    of the counter i (the fold-like split of the partitionable mode)."""
    hi, lo = _counters(num, key.device)
    b1, b2 = threefry_2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: one cipher block per
    element of the row-major iota, its two words xor-ed (int64 holding
    uint32)."""
    hi, lo = _counters(math.prod(shape), key.device)
    b1, b2 = threefry_2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits as the mantissa of a float in [1, 2), minus 1, scaled and
    shifted, and clamped below at ``minval``."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    dev = key.device
    lo = torch.full((), minval, dtype=torch.float32, device=dev)
    hi = torch.full((), maxval, dtype=torch.float32, device=dev)
    return torch.maximum(lo, (floats - 1.0) * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel``'s "low" mode: ``-log(-log(u))``, u uniform on
    [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    first argmax of Gumbel noise plus the logits (int64)."""
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=-1)


@dataclasses.dataclass(frozen=True)
class Sampler:
    """The decode-time sampling policy as one hashable spec.

    Attributes:
      temperature: 0 → greedy argmax (default); > 0 → softmax sampling.
      top_k: keep only the k largest logits (0 disables).
      top_p: keep the smallest nucleus with probability mass ≥ p
        (1.0 disables).
      seed: the seed of the per-run key chain.

    Raises:
      ValueError: on a negative temperature / top_k, or top_p ∉ (0, 1].
    """

    temperature: float = 0.0   # 0 → greedy
    top_k: int = 0             # 0 → no top-k filter
    top_p: float = 1.0         # 1 → no nucleus filter
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def is_greedy(self) -> bool:
        """True when ``temperature == 0`` (argmax; the key is never split)."""
        return self.temperature == 0.0

    def init_key(self, device="cpu") -> torch.Tensor:
        """The root of this sampler's key chain (``PRNGKey(seed)``)."""
        return prng_key(self.seed, device)

    def sample(self, key: torch.Tensor,
               logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One token per row of the (B, V) logits.

        Returns ``(next_key, tokens)``: the advanced chain key (``key``
        itself when greedy) and (B,) int64 token ids — greedy, the first
        maximum of each row, as ``jnp.argmax`` picks it."""
        if self.is_greedy:
            return key, torch.argmax(logits, dim=-1)
        keys = split(key)
        logits = logits.to(torch.float32)
        if self.temperature != 1.0:
            # A device fill, not a host scalar: CUDA divides by a host
            # scalar as a product by its reciprocal, which rounds otherwise.
            logits = logits / torch.full((), self.temperature,
                                         dtype=torch.float32,
                                         device=logits.device)
        if self.top_k or self.top_p < 1.0:
            logits = filter_logits(self, logits)
        return keys[0], categorical(keys[1], logits)

    def describe(self) -> str:
        """Short human-readable policy summary."""
        if self.is_greedy:
            return "greedy"
        parts = [f"t={self.temperature:g}"]
        if self.top_k:
            parts.append(f"top_k={self.top_k}")
        if self.top_p < 1.0:
            parts.append(f"top_p={self.top_p:g}")
        return f"sample({','.join(parts)},seed={self.seed})"


def filter_logits(sampler: Sampler, logits: torch.Tensor) -> torch.Tensor:
    """Top-k then top-p in f32; untouched logits keep their bits, cut ones
    become the f32 minimum.  Top-k thresholds on the k-th largest value
    (ties survive); top-p keeps the smallest prefix of the descending
    sort whose softmax mass reaches ``top_p`` (a token is cut where the
    mass before it already does) and thresholds on its smallest logit."""
    logits = logits.to(torch.float32)
    if sampler.top_k and sampler.top_k < logits.shape[-1]:
        kth = torch.topk(logits, sampler.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, F32_MIN, logits)
    if sampler.top_p < 1.0:
        desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        cut = torch.cumsum(probs, dim=-1) - probs >= sampler.top_p
        keep_min = torch.where(cut, float("inf"), desc).amin(dim=-1,
                                                             keepdim=True)
        logits = torch.where(logits < keep_min, F32_MIN, logits)
    return logits
