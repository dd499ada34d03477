"""MLP teacher networks of the paper's Table 2 settings: init, forward and
a small Adam training loop for classification (logits + softmax CE) and
regression (scalar + MSE).  Plain PyTorch with autograd; random draws come
from one ``torch.Generator`` (init, then the batches), where JAX splits its
key."""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.core.distill import _adam_init, _adam_update, value_and_grad


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int
    hidden: Tuple[int, ...]
    out_dim: int

    @property
    def layer_sizes(self) -> Tuple[int, ...]:
        return (self.in_dim, *self.hidden, self.out_dim)


def init_mlp(generator: torch.Generator, config: MLPConfig) -> list:
    """He-normal weights and zero biases, one ``{"w", "b"}`` per layer."""
    sizes = config.layer_sizes
    dev = generator.device
    return [{"w": torch.randn((a, b), generator=generator, device=dev)
             * math.sqrt(2.0 / a),
             "b": torch.zeros((b,), device=dev)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def mlp_forward(params: list, x: torch.Tensor) -> torch.Tensor:
    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def mlp_loss(params: list, xb: torch.Tensor, yb: torch.Tensor,
             task: str) -> torch.Tensor:
    """Softmax cross-entropy on int labels, or MSE on float targets."""
    out = mlp_forward(params, xb)
    if task == "classification":
        logp = torch.log_softmax(out, dim=-1)
        return -torch.mean(torch.gather(logp, 1, yb.long()[:, None]))
    return torch.mean((out[:, 0] - yb) ** 2)


def train_mlp(generator: torch.Generator, config: MLPConfig, x: torch.Tensor,
              y: torch.Tensor, *, task: str = "classification",
              n_steps: int = 2000, batch_size: int = 256, lr: float = 1e-3
              ) -> Tuple[list, dict]:
    """Train the teacher on ``x``/``y`` (on the generator's device); ``y``
    is int labels (classification) or float targets."""
    params = init_mlp(generator, config)
    opt = _adam_init(params)
    n = x.shape[0]
    first = loss = None
    for _ in range(n_steps):
        idx = torch.randint(0, n, (batch_size,), generator=generator,
                            device=generator.device)
        xb, yb = x[idx], y[idx]
        loss, grads = value_and_grad(lambda p: mlp_loss(p, xb, yb, task),
                                     params)
        params, opt = _adam_update(params, grads, opt, lr, 0.0)
        first = loss if first is None else first
    return params, {"first_loss": float("nan") if first is None else float(first),
                    "last_loss": float("nan") if loss is None else float(loss)}


@torch.no_grad()
def accuracy(params: list, x: torch.Tensor, y: torch.Tensor) -> float:
    pred = torch.argmax(mlp_forward(params, x), dim=-1)
    return float(torch.mean((pred == y).to(torch.float32)))


@torch.no_grad()
def mae(params: list, x: torch.Tensor, y: torch.Tensor) -> float:
    return float(torch.mean(torch.abs(mlp_forward(params, x)[:, 0] - y)))
