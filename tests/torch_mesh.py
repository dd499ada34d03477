"""Runs a test file's multi-process scenarios on spawned gloo ranks.

The port's mesh tests run SPMD as ``torchrun`` would: ``world`` fresh
Python processes, one CPU thread each, joined into a gloo process group
through a ``TCPStore`` that this process opens on a port the OS picks (so
pytest-xdist workers never collide).  Every rank imports the file by path
and calls its scenario function ``fn(rank, world, *args)``; rank 0 writes
the returned dict of numpy values, which :func:`run_ranks` hands back.
A rank that fails or a run that outlives ``timeout`` fails the test with
the ranks' last output, and every process is stopped.

  python tests/torch_mesh.py <file> <function> <rank> <world> <port> <out> [args]
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def run_ranks(test_file: str, fn: str, world: int = 4,
              timeout: float = 300.0, args=()) -> dict:
    """Run ``fn(rank, world, *args)`` (string ``args``) of ``test_file`` on
    ``world`` spawned gloo ranks; returns rank 0's dict.  Raises
    AssertionError on a failed rank or a timeout."""
    from torch.distributed import TCPStore

    store = TCPStore("127.0.0.1", 0, None, True, wait_for_workers=False)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src")]
                   + [p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "rank0.pkl"
        logs = [Path(tmp) / f"rank{r}.log" for r in range(world)]
        procs = []
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, test_file, fn, str(r),
                     str(world), str(store.port), str(out), *args],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                failed = [p for p in procs if p.returncode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        if any(c != 0 for c in codes) or not out.exists():
            tails = "\n".join(f"--- rank {r} (exit {c}) ---\n"
                              + logs[r].read_text()[-3000:]
                              for r, c in enumerate(codes))
            raise AssertionError(f"{Path(test_file).name}:{fn} on {world} "
                                 f"ranks: exit codes {codes} (a rank still "
                                 f"running at {timeout:.0f} s is killed)\n"
                                 f"{tails}")
        with open(out, "rb") as f:
            return pickle.load(f)


def _main(test_file, fn, rank, world, port, out, *args):
    import importlib.util

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.TCPStore("127.0.0.1", int(port), int(world), False)
    dist.init_process_group("gloo", store=store, rank=int(rank),
                            world_size=int(world))
    spec = importlib.util.spec_from_file_location("_mesh_case", test_file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    result = getattr(mod, fn)(int(rank), int(world), *args)
    dist.barrier()
    # No rank closes its connections while another is still inside the
    # barrier (gloo would see "connection closed by peer" there): each
    # counts itself out through the store and waits for the rest.
    store.add("finished", 1)
    while store.add("finished", 0) < int(world):
        time.sleep(0.05)
    dist.destroy_process_group()
    if int(rank) == 0:
        tmp = out + ".part"
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, out)


if __name__ == "__main__":
    _main(*sys.argv[1:])
