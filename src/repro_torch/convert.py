"""Carry the JAX package's params across to the port.

``params_from_numpy`` takes the JAX params as a nested dict of numpy arrays
in the JAX tree layout (``embed``, ``head``, ``final_norm``,
``periods/pos0/{norm1, norm2, mixer/...}`` stacked over periods) — the
caller does the ``np.asarray`` on the JAX side — and returns the same tree
of torch tensors.  ``torch.from_numpy`` rejects numpy's ``bfloat16``
(an extension dtype), so those leaves travel as their int16 bits.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device="cuda"):
    """The port's params (same tree) on ``device`` from numpy leaves."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return _leaf(tree, device)
