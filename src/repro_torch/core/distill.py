"""Teacher → kernel-student distillation (the paper's §3.4 recipe).

  1. Train (or receive) a teacher network f_N.
  2. Fit the kernel model f_K(q) = Σ α_j K(Aᵀq, x_j) to f_N's outputs with
     MSE loss and Adam, M ≪ N anchors.
  3. Freeze f_K into a RepresenterSketch for deployment.

Plain PyTorch with autograd: no step reaches a kernel (none does in JAX
either).  Adam is the JAX package's own, written out term by term
(``_adam_init``/``_adam_update``), not ``torch.optim.Adam``, so one step
compares with the reference's.  Random draws come from one
``torch.Generator`` in the order init, anchors, batches, where JAX splits
its key three ways.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.core.kernel_model import KernelModel


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    n_steps: int = 2000
    batch_size: int = 256
    lr: float = 3e-3
    weight_decay: float = 0.0
    # L1 penalty on the alphas: the sketch's bucket-collision noise floor
    # scales with Σ|α|/√R (Theorem 1's variance bound), so sparse small-mass
    # alphas buy estimation accuracy per unit of sketch memory.
    alpha_l1: float = 0.0


def _flatten(tree) -> Tuple[List[torch.Tensor], Callable]:
    """Leaves of a dict/list tree of tensors (dict keys in sorted order, as
    JAX orders them, so two dicts with the same keys line up), and the
    function that builds the same tree from a list of new leaves."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def unflatten(new):
        out, i = [], 0
        for (_, build), n in zip(parts, sizes):
            out.append(build(new[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, unflatten


def value_and_grad(loss_fn: Callable, params):
    """``(loss, grads)`` of ``loss_fn(params)`` by autograd; ``grads`` has
    the tree structure of ``params``; both are detached."""
    leaves, unflatten = _flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(unflatten(leaves))
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), unflatten(list(grads))


def _adam_init(params) -> dict:
    leaves, unflatten = _flatten(params)
    return {"mu": unflatten([torch.zeros_like(p) for p in leaves]),
            "nu": unflatten([torch.zeros_like(p) for p in leaves]),
            "t": 0}


@torch.no_grad()
def _adam_update(params, grads, state, lr, wd, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step, term by term the JAX package's ``_adam_update``
    (bias-corrected moments, decoupled ``wd·p``), each term one
    ``torch._foreach_*`` launch over all leaves:

        mu = b1·m + (1 − b1)·g          nu = b2·v + ((1 − b2)·g)·g
        p' = p − lr·(m̂ / (√v̂ + eps) + wd·p),  m̂ = mu / (1 − b1ᵗ), …
    """
    t = state["t"] + 1
    p, unflatten = _flatten(params)
    g = _flatten(grads)[0]
    mu = torch._foreach_add(torch._foreach_mul(_flatten(state["mu"])[0], b1),
                            torch._foreach_mul(g, 1 - b1))
    nu = torch._foreach_add(torch._foreach_mul(_flatten(state["nu"])[0], b2),
                            torch._foreach_mul(torch._foreach_mul(g, 1 - b2),
                                               g))
    # The bias corrections in f32 from f32 β, as the reference computes
    # them: 1 − βᵗ cancels, so a double evaluation would differ by
    # hundreds of ulps at small t.
    bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
    bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)
    denom = torch._foreach_add(
        torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
    update = torch._foreach_add(
        torch._foreach_div(torch._foreach_div(mu, bc1), denom),
        torch._foreach_mul(p, wd))
    new = torch._foreach_sub(p, torch._foreach_mul(update, lr))
    return unflatten(new), {"mu": unflatten(mu), "nu": unflatten(nu), "t": t}


def distill_loss(model: KernelModel, config: DistillConfig, params,
                 xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """MSE of the kernel model against (scaled) teacher outputs, plus the
    optional L1 penalty on the alphas."""
    mse = torch.mean((model.apply(params, xb) - yb) ** 2)
    if config.alpha_l1:
        mse = mse + config.alpha_l1 * torch.mean(torch.abs(params["alphas"]))
    return mse


def distill(generator: torch.Generator,
            teacher_fn: Callable[[torch.Tensor], torch.Tensor],
            train_x: torch.Tensor, model: KernelModel,
            config: DistillConfig = DistillConfig()
            ) -> Tuple[dict, Dict[str, float]]:
    """Fit ``model`` to ``teacher_fn`` on the (unlabeled) inputs ``train_x``
    (on the generator's device).

    Returns the learned kernel-model params and ``{"final_mse",
    "first_loss", "last_loss"}``.  The teacher's outputs, standardized by
    their std (folded back into the alphas at the end), are the regression
    targets, as in Figure 1 of the paper.
    """
    dev = generator.device
    params = model.init(generator)
    # Anchor the points on (projected) data samples: a random-normal init
    # leaves whole data regions uncovered by the narrow k-fold LSH kernel.
    n = train_x.shape[0]
    idx = torch.randint(0, n, (model.config.n_points,), generator=generator,
                        device=dev)
    params["points"] = model.transform(params, train_x[idx])
    opt = _adam_init(params)
    with torch.no_grad():
        targets = teacher_fn(train_x)
    t_scale = torch.clamp(targets.std(correction=0), min=1e-6)
    targets = targets / t_scale

    first = loss = None
    for _ in range(config.n_steps):
        idx = torch.randint(0, n, (config.batch_size,), generator=generator,
                            device=dev)
        xb, yb = train_x[idx], targets[idx]
        loss, grads = value_and_grad(
            lambda p: distill_loss(model, config, p, xb, yb), params)
        params, opt = _adam_update(params, grads, opt, config.lr,
                                   config.weight_decay)
        first = loss if first is None else first
    head = min(n, 4096)
    with torch.no_grad():
        final = distill_loss(model, config, params, train_x[:head],
                             targets[:head])
    params = dict(params, alphas=params["alphas"] * t_scale)
    return params, {"final_mse": float(final),
                    "first_loss": float("nan") if first is None else float(first),
                    "last_loss": float("nan") if loss is None else float(loss)}
