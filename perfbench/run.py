"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic (``BENCHMARK.json``), draws the
weights and heads from the seed on the card, warms up the shapes the cell
uses, serves ``--seconds`` of traffic through ``repro_torch``'s engine,
checks a sample of the served tokens against the plain reference, and
prints one JSON line: the end-to-end metrics (``--trace 0``) or the
per-layer ones with the device trace (``--trace 1``).  Exits non-zero,
printing no result, without a CUDA card, or if a module of JAX or of the
JAX package was loaded.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --control

also runs the check's control, the reference in float8 put in the
program's place (``reference.Precision("fp8")``), on the same sample, and
judges it by the cell's limits: the line gains ``"control"``, whose
``correct`` has to come out false.  The benchmark's own runs do not use it.
"""

import os
import time


def _process_age() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _environment() -> None:
    """Every cache of the program inside the checkout, at fixed paths, and
    no JAX behind a library's back."""
    cache = ROOT / ".perfbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also judge the float8 control by the cell's limits")
    args = ap.parse_args(argv)
    _environment()
    # This folder itself is not a place to import from (its trace.py would
    # shadow the standard library's): the package is imported by its name.
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != HERE]
    import torch
    from perfbench import harness

    cell = harness.load_cell(HERE, args.workload)
    chips = cell["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(HERE, cell, args.seed, args.seconds,
                              bool(args.trace), T_START,
                              control=args.control)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: modules loaded that the run may not load: {bad}",
              file=sys.stderr)
        return 3
    info = result.pop("_info")
    print(f"perfbench: {args.workload} seed {args.seed}: {json.dumps(info)}",
          file=sys.stderr)
    if args.control:
        result["control"] = result.pop("control")
        for name, v in result["control"]["check"].items():
            print(f"control {name} {v['value']!r} limit {v['limit']!r}",
                  file=sys.stderr)
    result["check"] = result.pop("check")
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
