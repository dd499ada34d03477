"""The paper's Table 1 on one tabular dataset: NN teacher → weighted-kernel
student (distilled) → Representer Sketch, with accuracy (or MAE), memory
and FLOPs of each.

Protocol per dataset (paper §3.4/§4), as the JAX package's
``benchmarks/table1_repro.py:run_dataset``:

  1. Train the Table-2 MLP teacher.
  2. Distill it into the weighted LSH-kernel model (M ≪ N anchors,
     asymmetric projection A, MSE on teacher outputs).
  3. Freeze into a Representer Sketch (Table-2 R, K; L from the budget):
     ``lsh_hash`` then ``race_update`` per build chunk.
  4. Query the test set through the sketch: ``lsh_hash`` then
     ``race_query``.

Memory counts parameters (sketch: C·L·R + d·d', paper §4.3) at 8 bytes;
FLOPs use the paper's inference model.  Two things are kept from the
reference as they are: the regression sketch's memory is counted at
``budget["rows"]`` though it is frozen with twice that many rows, and
``make_dataset`` seeds with Python's salted ``hash(name)``, so the data
change between processes unless ``PYTHONHASHSEED`` is fixed (the record's
``data_checksum`` tells runs apart).

Seeds: the reference's ``PRNGKey(seed)``, ``PRNGKey(seed + 1)`` and
``PRNGKey(seed + 2)`` (teacher, distillation, freeze) become
``torch.Generator(device).manual_seed(seed + k)`` for the same k; torch's
draws differ from ``jax.random``'s, and a CUDA generator's from a CPU one's.

  PYTHONPATH=src python -m repro_torch.launch.paper_repro --dataset adult \\
      [--full] [--device cuda]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.core.distill import DistillConfig, distill
from repro_torch.core.kernel_model import (KernelModel, KernelModelConfig,
                                           mlp_flops, mlp_memory_params)
from repro_torch.core.teacher import MLPConfig, mlp_forward, train_mlp
from repro_torch.data.tabular import DATASETS, make_dataset

#: The reference's fast budget (``benchmarks/table1_repro.py:FAST``).
FAST = {"nn_steps": 1200, "distill_steps": 1500, "n_points": 256,
        "rows": 1200, "train_cap": 12000, "test_cap": 3000}
#: Paper scale: FAST updated as ``benchmarks/run.py --full`` does.
FULL = dict(FAST, nn_steps=4000, distill_steps=5000, n_points=512,
            rows=2000, train_cap=10**9, test_cap=10**9)


def _metric(task: str, out: torch.Tensor, y: torch.Tensor) -> float:
    if task == "classification":
        return float(torch.mean((torch.argmax(out, -1) == y).to(torch.float32)))
    return float(torch.mean(torch.abs(out[:, 0] - y)))


def data_checksum(*arrays: np.ndarray) -> str:
    """Short digest of the dataset's arrays (it varies with the process's
    string-hash seed)."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:12]


def _sync(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def run_dataset(name: str, budget: Dict = FAST, seed: int = 0,
                device="cuda") -> Dict:
    """One Table-1 row on ``device``.

    Returns the reference's record (``nn``, ``kernel``, ``rs`` metrics,
    memory in MB, FLOPs, their reductions, ``seconds``) plus ``stage_seconds``
    (teacher, distill, freeze, query), ``data_checksum``, ``n_rows``,
    ``n_buckets`` and, under ``parts``, the frozen sketch, its state, the
    transformed test queries and the kernel params, so a caller can hold
    the freeze and the query against their plain versions.
    """
    from repro_torch.api.lm import check_device

    device = check_device(device)
    spec = DATASETS[name]
    xtr, ytr, xte, yte = make_dataset(spec, seed=seed)
    xtr, ytr = xtr[: budget["train_cap"]], ytr[: budget["train_cap"]]
    xte, yte = xte[: budget["test_cap"]], yte[: budget["test_cap"]]
    checksum = data_checksum(xtr, ytr, xte, yte)
    xtr_t, xte_t = (torch.from_numpy(a).to(device) for a in (xtr, xte))
    ytr_t, yte_t = (torch.from_numpy(a).to(device) for a in (ytr, yte))
    n_out = 2 if spec.task == "classification" else 1
    stage, clock = {}, [_sync(device)]
    t0 = clock[0]

    def lap(name):
        now = _sync(device)
        stage[name], clock[0] = now - clock[0], now

    mlp_cfg = MLPConfig(spec.n_features, spec.nn_hidden, n_out)
    teacher, _ = train_mlp(torch.Generator(device).manual_seed(seed), mlp_cfg,
                           xtr_t, ytr_t, task=spec.task,
                           n_steps=budget["nn_steps"])
    with torch.no_grad():
        nn_metric = _metric(spec.task, mlp_forward(teacher, xte_t), yte_t)
    lap("teacher")

    proj_dim = min(max(spec.n_features // 2, 4), 32)
    model = KernelModel(KernelModelConfig(
        in_dim=spec.n_features, proj_dim=proj_dim,
        n_points=budget["n_points"], n_outputs=n_out, bandwidth=2.0,
        k=spec.rs_K))
    # Regression is precision-hungry: the sketch's collision-noise floor
    # (Σ|α|/√R) must sit below the target MAE, so regression tasks get an
    # L1-regularized distillation and a wider array.
    regression = spec.task == "regression"
    kparams, _ = distill(
        torch.Generator(device).manual_seed(seed + 1),
        lambda x: mlp_forward(teacher, x), xtr_t, model,
        DistillConfig(n_steps=budget["distill_steps"], lr=5e-3,
                      alpha_l1=1e-3 if regression else 0.0))
    with torch.no_grad():
        kernel_metric = _metric(spec.task, model.apply(kparams, xte_t), yte_t)
    lap("distill")

    n_buckets = 64 if regression else max(spec.rs_R // 10, 16)
    n_rows = budget["rows"] * (2 if regression else 1)
    with torch.no_grad():
        sk, state = model.freeze(torch.Generator(device).manual_seed(seed + 2),
                                 kparams, n_rows=n_rows, n_buckets=n_buckets)
        lap("freeze")
        queries = model.transform(kparams, xte_t)
        rs_out = sk.query(state, queries)
        lap("query")
    rs_metric = _metric(spec.task, rs_out, yte_t)

    nn_mem = mlp_memory_params(mlp_cfg.layer_sizes) * 8 / 1e6   # 64-bit, MB
    rs_mem = model.sketch_memory_params(budget["rows"], n_buckets) * 8 / 1e6
    nn_fl = mlp_flops(mlp_cfg.layer_sizes)
    rs_fl = model.sketch_flops(budget["rows"], n_buckets)
    return {
        "dataset": name, "task": spec.task,
        "nn": nn_metric, "kernel": kernel_metric, "rs": rs_metric,
        "nn_mem_mb": nn_mem, "rs_mem_mb": rs_mem,
        "mem_reduction": nn_mem / rs_mem,
        "nn_flops": nn_fl, "rs_flops": rs_fl,
        "flop_reduction": nn_fl / rs_fl,
        "seconds": time.perf_counter() - t0,
        "stage_seconds": stage, "data_checksum": checksum,
        "n_rows": n_rows, "n_buckets": n_buckets,
        "parts": {"sketch": sk, "state": state, "queries": queries,
                  "kparams": kparams},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="adult", choices=sorted(DATASETS))
    ap.add_argument("--full", action="store_true",
                    help="paper-scale budget (FULL) instead of FAST")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run_dataset(args.dataset, FULL if args.full else FAST,
                    device=args.device)
    metric = "accuracy" if r["task"] == "classification" else "MAE"
    print(f"dataset={r['dataset']} ({r['task']}, metric={metric}, "
          f"data checksum {r['data_checksum']}, device {args.device})")
    print(f"  NN     : {r['nn']:.4f}   ({r['nn_mem_mb']:.3f} MB, "
          f"{r['nn_flops'] / 1e3:.1f}K FLOPs/query)")
    print(f"  Kernel : {r['kernel']:.4f}")
    print(f"  Sketch : {r['rs']:.4f}   ({r['rs_mem_mb']:.3f} MB, "
          f"{r['rs_flops'] / 1e3:.1f}K FLOPs/query; L={r['n_rows']}, "
          f"R={r['n_buckets']})")
    print(f"  memory reduction {r['mem_reduction']:.1f}x, "
          f"FLOP reduction {r['flop_reduction']:.1f}x, "
          f"{r['seconds']:.2f} s")
    print(json.dumps({k: v for k, v in r.items() if k != "parts"}))


if __name__ == "__main__":
    main()
