"""Multi-pod dry run: trace every (arch × shape × mesh) cell on fake
tensors over a fake process group, and count what one rank runs.

The JAX package's dry run lowers and compiles each cell's step for 512
placeholder devices.  Here a ``fake`` process group of 256 or 512 ranks
(rank 0) carries the production meshes of ``make_production_mesh`` (16×16
and 2×16×16) with no card; every leaf of the step's state is a fake
tensor (``FakeTensorMode``: shapes, dtypes and devices, no memory) placed
as a DTensor by ``sharding/rules.py`` (this rank's shard, wrapped by
``DTensor.from_local``); and the step runs under ``activation_sharding``
while ``launch/hlo_analysis.analyze`` counts the ops this rank dispatches:
per-rank FLOPs, bytes, collective bytes by kind, and memory (the
arguments, the outputs, the peak allocated during the step).

A train cell runs ``train_step`` (the loss, its backward through the
remat and the flash kernels, the in-place AdamW with ZeRO-1 state), a
prefill cell the cacheless ``prefill_step`` and a decode cell
``serve_step`` (one token against a cache of the shape's length, at its
last position).  With ``--device cuda`` (the default) the fake tensors are
CUDA tensors, so the kernel wrappers take their fake branches: the
kernels' own shape checks run and their work is counted, nothing is
launched, and no card is needed.  ``--device cpu`` traces the plain
versions instead.

Each cell's record goes to ``results/dryrun_torch/`` (the reference's
keys, with ``trace_s`` for its ``lower_s``/``compile_s``, and ``device``
and ``kernels``, calls by name).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape train_4k --mesh single [--smoke] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback
from contextlib import contextmanager
from pathlib import Path

from repro_torch.configs import SHAPES, cells

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def build_cell(arch: str, shape: str, mesh, *, smoke: bool = False,
               device: str = "cuda"):
    """``(step, args, cfg)`` of one cell on ``mesh``: ``step(*args)`` runs
    the cell's step on fake state placed by the sharding rules.  Call it
    inside a ``FakeTensorMode``."""
    from repro_torch.launch.mesh import distribute_tree, shard_like
    from repro_torch.launch.steps import (abstract_opt_state, abstract_params,
                                          input_specs, opt_config_for,
                                          prefill_step, serve_step,
                                          train_step)
    from repro_torch.sharding.ctx import on_mesh, serving
    from repro_torch.sharding.rules import (P, batch_spec, cache_shardings,
                                            params_shardings, zero1_shardings)

    def place(tree, specs):
        return distribute_tree(tree, specs, mesh, shard_like)

    spec = input_specs(arch, shape, smoke=smoke, device=device)
    cfg, kind, seq = spec["cfg"], spec["kind"], spec["seq"]
    params = abstract_params(cfg, device)
    params = place(params, params_shardings(params, mesh))
    bspec = batch_spec(spec["batch"], mesh)

    def along_batch(x):
        return None if x is None else place(x, P(bspec))

    if kind == "train":
        opt_cfg = opt_config_for(cfg)
        opt = abstract_opt_state(cfg, lean=opt_cfg.lean, device=device)
        z1 = zero1_shardings(opt.mu, mesh)
        # The step stays a plain tensor, as launch/train.py keeps it.
        opt = type(opt)(step=opt.step, mu=place(opt.mu, z1),
                        nu=place(opt.nu, z1),
                        master=None if opt.master is None
                        else place(opt.master, z1))
        batch = {k: along_batch(v) for k, v in spec["batch_inputs"].items()}

        def step(p, o, b):
            with on_mesh(mesh):
                return train_step(p, o, b, cfg, opt_cfg)
        return step, (params, opt, batch), cfg

    enc = along_batch(spec["encoder_states"])
    tokens = along_batch(spec["tokens"])
    if kind == "prefill":
        def step(p, t, e):
            with serving(mesh):
                return prefill_step(p, t, cfg, encoder_states=e)
        return step, (params, tokens, enc), cfg

    cache = place(spec["cache"], cache_shardings(spec["cache"], mesh,
                                                 spec["batch"]))

    # The port's scalar decode takes its position on the host (an int), so
    # the reference's 0-d ``pos`` argument is no tensor here.
    def step(p, c, t, e):
        with serving(mesh):
            return serve_step(p, c, t, cfg, pos=seq - 1, encoder_states=e)
    return step, (params, cache, tokens, enc), cfg


@contextmanager
def fake_group(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks, this
    process rank 0 (no communication: collectives return what they are
    given), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs its own fake process group; "
                           "one is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextmanager
def _strided_shard_bookkeeping_real():
    """DTensor sizes a strided shard (a dim split over a mesh dim inside
    another's split) from small index tensors it reads back on the host,
    which a fake tensor cannot give: that bookkeeping runs outside the
    fake mode, on real index tensors, as on a real run."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard

    orig = _StridedShard.__dict__["local_shard_size_and_offset"]

    def sized(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)

    _StridedShard.local_shard_size_and_offset = sized
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def run_cell(arch: str, shape: str, mesh_kind: str, *, smoke: bool = False,
             device: str = "cuda", save: bool = True,
             verbose: bool = True) -> dict:
    """Trace one cell on the 16×16 (``single``) or 2×16×16 (``multi``)
    mesh of a fake group and return (and save) its per-rank record."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.mesh import make_production_mesh

    multi = mesh_kind == "multi"
    with fake_group(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type=device)
        t0 = time.time()
        with FakeTensorMode(), _strided_shard_bookkeeping_real():
            step, args, cfg = build_cell(arch, shape, mesh, smoke=smoke,
                                         device=device)
            hl = analyze(step, *args)
        trace_s = time.time() - t0

    result = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_kind,
        "device": device,
        "n_devices": math.prod(mesh.shape),
        "trace_s": round(trace_s, 1),
        # per-rank numbers from the op analyzer
        "flops": hl["flops"],
        "elementwise_flops": hl["elementwise_flops"],
        "bytes_accessed": hl["bytes_accessed"],
        "collective_bytes": hl["collective_bytes"],
        "n_ops": hl["n_ops"],
        "kernels": hl["kernels"],
        "memory_analysis": hl["memory"],
        "n_periods": cfg.n_periods,
    }
    if verbose:
        mem = hl["memory"]
        print(f"[{arch} × {shape} × {mesh_kind}] trace {trace_s:.1f}s  "
              f"flops={result['flops']:.3e} "
              f"coll={hl['collective_bytes']['total']:.3e}B "
              f"arg={mem['argument_size_bytes']} "
              f"temp={mem['temp_size_bytes']} kernels={hl['kernels']}",
              flush=True)
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        out = RESULTS_DIR / f"{arch}__{shape}__{mesh_kind}.json"
        out.write_text(json.dumps(result, indent=1))
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="architecture id")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every runnable (arch × shape) cell")
    ap.add_argument("--smoke", action="store_true",
                    help="use reduced configs (CI sanity)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the fake tensors' device: cuda takes the kernels' "
                         "fake branches, cpu their plain versions")
    args = ap.parse_args()
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    todo = list(cells()) if args.all else [(args.arch, args.shape)]
    failures = []
    for arch, shape in todo:
        for mk in meshes:
            try:
                run_cell(arch, shape, mk, smoke=args.smoke,
                         device=args.device)
            except Exception as e:  # noqa: BLE001 — report-and-continue CLI
                failures.append((arch, shape, mk, repr(e)[:200]))
                traceback.print_exc()
                print(f"FAIL [{arch} × {shape} × {mk}]: {e!r}",
                      file=sys.stderr)
    if failures:
        print(f"\n{len(failures)} failures:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("\nAll dry-run cells traced.")


if __name__ == "__main__":
    main()
