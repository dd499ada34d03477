"""End-to-end training launcher.

The JAX package's ``launch/train.py`` on the port: random params (seed
0), AdamW (``optim/adamw.py``; warmup a tenth of ``--steps``, the
cosine over ``--steps``), the synthetic token stream through its prefetch
thread (``data/pipeline.py``), ``launch/steps.train_step`` (the forward
rematerialized period by period, the attention on the ``flash_attn``
kernels forward and backward), async checkpoints every ``--ckpt-every``
steps with a restart from the latest complete one, and the step-time
tracker.  It prints the reference's step lines.  A restart resumes the
data stream at the restored step + 1, so a resumed run equals the
continuous one (the reference's loader restarts at batch 0).

  PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-large \\
      --smoke --device cpu --steps 20 [--batch 8 --seq 128 --lr 3e-4] \\
      [--ckpt-dir DIR --ckpt-every 50] [--log-every 10]

On the card (``--device cuda``, the default) musicgen-large trains at full
width and depth: its 3.23 B params hold 51.7 GB of state (bf16 params and
grads, f32 master and moments).

Under an initialised process group (``torchrun``; gloo on the CPU, NCCL
on cards) the run is SPMD over ``make_host_mesh(model=--model-parallel)``,
a (world / m, m) mesh, as the reference runs over its host mesh: the
params placed by ``params_shardings``, the AdamW moments and master by
``zero1_shardings`` (each rank steps its own block), the batch split by
``batch_spec``, the activations constrained by ``activation_sharding``.
Without a group, ``--model-parallel 1`` is the single-device run (the
reference's 1×1 mesh) and any other value raises.

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch \
      musicgen-large --smoke --device cpu --model-parallel 2
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional

import torch

from repro_torch.api.lm import check_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, PrefetchingLoader
from repro_torch.launch.steps import train_step
from repro_torch.models.model import init_model
from repro_torch.optim.adamw import OptimizerConfig, init_adamw
from repro_torch.runtime.failure import StragglerTracker
from repro_torch.sharding.ctx import on_mesh, replicated


def train(arch: str = "stablelm-12b", *, smoke: bool = False,
          steps: int = 100, batch: int = 8, seq: int = 128, lr: float = 3e-4,
          ckpt_dir: str = "", ckpt_every: int = 50, log_every: int = 10,
          model_parallel: int = 1, device="cuda",
          n_layers: Optional[int] = None,
          on_step: Optional[Callable[[int, dict], None]] = None,
          log: Callable[[str], None] = print) -> dict:
    """Train ``arch`` for ``steps`` optimizer steps; returns ``{"params",
    "opt_state", "losses" (float a step run), "start" (the first step run),
    "seconds"}``.

    ``n_layers`` trains the arch at that depth (whole periods).
    ``on_step(step, metrics)`` runs after each
    step with the step's metrics as floats.  With ``ckpt_dir`` a run
    restores the latest complete checkpoint there and continues after it.
    Under an initialised process group the run is SPMD over a
    ``(world / model_parallel, model_parallel)`` mesh (the module
    docstring); the returned params and state are then DTensors.

    Raises:
      ValueError: ``model_parallel`` other than 1 without an initialised
        process group, or one that does not divide its world; ``ckpt_dir``
        on a mesh.
    """
    import torch.distributed as dist

    device = check_device(device)
    mesh = None
    if model_parallel != 1 or (dist.is_available() and dist.is_initialized()):
        if ckpt_dir:
            raise ValueError("ckpt_dir on a mesh: checkpoints of DTensor state "
                             "are not written (each rank would write its own "
                             "copy into one directory)")
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(model=model_parallel, device_type=device.type)
    cfg = get_config(arch, smoke=smoke)
    if n_layers is not None:
        cfg = cfg.scaled(n_layers=n_layers)
    opt_cfg = OptimizerConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                              total_steps=steps)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch,
                          n_encoder_tokens=cfg.n_encoder_tokens,
                          d_model=cfg.d_model)
    params = init_model(cfg, torch.Generator(device).manual_seed(0))
    opt_state = init_adamw(params)
    if mesh is not None:
        params, opt_state = _place_train_state(params, opt_state, mesh)

    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and ckpt.latest_step() is not None:
        (params, opt_state), start = ckpt.restore((params, opt_state))
        start += 1
        log(f"restored step {start - 1}")

    loader = PrefetchingLoader(data_cfg, start_step=start)
    tracker = StragglerTracker()
    losses, metrics = [], {}
    t_all = time.time()
    try:
        for step in range(start, steps):
            _, host = next(loader)
            batch_t = {k: torch.from_numpy(v).to(device)
                       for k, v in host.items()}
            if mesh is not None:
                batch_t = _place_batch(batch_t, mesh)
            t0 = time.time()
            with on_mesh(mesh):
                params, opt_state, m = train_step(params, opt_state, batch_t,
                                                  cfg, opt_cfg)
            metrics = {k: float(replicated(v)) for k, v in m.items()}
            tracker.record(0, time.time() - t0)
            losses.append(metrics["loss"])
            if on_step is not None:
                on_step(step, metrics)
            if step % log_every == 0:
                log(f"step {step:5d} loss {metrics['loss']:.4f} "
                    f"ce {metrics['ce']:.4f} gnorm {metrics['grad_norm']:.3f} "
                    f"lr {metrics['lr']:.2e} "
                    f"({time.time() - t0:.2f}s)")
            if ckpt and step and step % ckpt_every == 0:
                ckpt.save(step, (params, opt_state))
        if ckpt:
            ckpt.wait()
    finally:
        loader.close()
    dur = time.time() - t_all
    log(f"done: {steps - start} steps in {dur:.1f}s "
        f"({(steps - start) / max(dur, 1e-9):.2f} steps/s), "
        f"final loss {metrics.get('loss', float('nan')):.4f}")
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "start": start, "seconds": dur}


def _place_train_state(params, opt_state, mesh):
    """Params by ``params_shardings``; the moments and master by
    ``zero1_shardings`` (their own block a rank); the step replicated."""
    from repro_torch.launch.mesh import distribute_tree
    from repro_torch.sharding.rules import params_shardings, zero1_shardings

    z1 = zero1_shardings(params, mesh)
    params = distribute_tree(params, params_shardings(params, mesh), mesh)
    return params, type(opt_state)(
        step=opt_state.step,
        mu=distribute_tree(opt_state.mu, z1, mesh),
        nu=distribute_tree(opt_state.nu, z1, mesh),
        master=(None if opt_state.master is None
                else distribute_tree(opt_state.master, z1, mesh)))


def _place_batch(batch: dict, mesh) -> dict:
    """Each batch array split over the data axes by ``batch_spec``."""
    from repro_torch.launch.mesh import distribute
    from repro_torch.sharding.rules import P, batch_spec

    return {k: distribute(v, P(batch_spec(v.shape[0], mesh)), mesh)
            for k, v in batch.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="stablelm-12b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    if "WORLD_SIZE" in os.environ:          # launched by torchrun
        from repro_torch.launch.mesh import join_launcher_group
        device = join_launcher_group(device)
    train(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
          seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
          ckpt_every=args.ckpt_every, log_every=args.log_every,
          model_parallel=args.model_parallel, device=device)


if __name__ == "__main__":
    main()
