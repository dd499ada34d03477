"""Synthetic UCI-style tabular datasets for the paper reproduction.

The paper evaluates on UCI/libsvm tasks (Adult, phishing, skin, SUSY,
abalone, YearMSD).  Those files are not available offline, so we generate
synthetic datasets with matching (n_features, task type, approximate size)
and — crucially — *learnable nonlinear structure* so the NN → kernel → sketch
pipeline faces a realistic function.  Ground truth is a random shallow
teacher with interactions + threshold nonlinearities.

This keeps the paper's protocol intact: train an MLP, distill it into the
weighted LSH-kernel representation, sketch it, and compare
accuracy/memory/FLOPs.  Absolute accuracies differ from the paper's (the
data differ); the *relative* claims (Kernel ≈ NN, RS ≈ Kernel, 17–114×
memory reduction at parity) are what ``repro_torch.launch.paper_repro``
reproduces.

A copy of the JAX package's ``data/tabular.py`` (numpy only): within one
process both give the same arrays.  ``make_dataset`` seeds with
``hash(spec.name)``, Python's salted string hash, so the arrays change from
one process to the next unless ``PYTHONHASHSEED`` is fixed; the copy keeps
that, so the two packages agree.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TabularSpec:
    name: str
    n_features: int
    n_train: int
    n_test: int
    task: str                 # 'classification' (binary) | 'regression'
    nn_hidden: Tuple[int, ...]  # paper Table 2 architecture
    rs_R: int                 # paper Table 2 sketch params
    rs_K: int


# Paper Table 2 settings, sizes scaled to run in CI minutes on 1 CPU core.
DATASETS: Dict[str, TabularSpec] = {
    "adult":    TabularSpec("adult", 123, 20000, 5000, "classification",
                            (512, 256, 128), 500, 1),
    "phishing": TabularSpec("phishing", 68, 8000, 2000, "classification",
                            (512, 256, 128), 300, 3),
    "skin":     TabularSpec("skin", 3, 20000, 5000, "classification",
                            (256, 128, 64), 300, 3),
    "susy":     TabularSpec("susy", 18, 20000, 5000, "classification",
                            (1024, 512, 256, 128, 64), 1000, 2),
    "abalone":  TabularSpec("abalone", 8, 3300, 800, "regression",
                            (256, 128), 300, 1),
    "yearmsd":  TabularSpec("yearmsd", 90, 20000, 5000, "regression",
                            (1024, 512, 256, 128), 500, 3),
}


def make_dataset(spec: TabularSpec, seed: int = 0):
    """Generate (x_train, y_train, x_test, y_test) float32/int32 arrays."""
    rng = np.random.default_rng(seed + hash(spec.name) % (2**31))
    n = spec.n_train + spec.n_test
    x = rng.standard_normal((n, spec.n_features)).astype(np.float32)
    # Sparse binary-ish features for high-dim sets (UCI libsvm style).
    if spec.n_features > 50:
        x = (x > 0.8).astype(np.float32)

    # Random shallow teacher: interactions + thresholds.
    w1 = rng.standard_normal((spec.n_features, 32)) / np.sqrt(spec.n_features)
    b1 = rng.standard_normal(32) * 0.5
    w2 = rng.standard_normal(32)
    h = np.tanh(x @ w1 + b1)
    score = h @ w2 + 0.5 * (h[:, 0] * h[:, 1]) + 0.25 * np.abs(h[:, 2])

    if spec.task == "classification":
        y = (score > np.median(score)).astype(np.int32)
        # 5% label noise like real tabular data.
        flip = rng.random(n) < 0.05
        y = np.where(flip, 1 - y, y)
    else:
        noise = rng.standard_normal(n) * 0.1 * score.std()
        y = (score + noise).astype(np.float32)

    tr, te = spec.n_train, spec.n_test
    return x[:tr], y[:tr], x[tr:tr + te], y[tr:tr + te]
