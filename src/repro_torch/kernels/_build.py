"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Every ``csrc/*.cu`` becomes its own shared library with a plain C
interface, built on first use into ``_build/`` beside this file (listed in
``.gitignore``) and named after a digest of the sources and flags, so a
changed source is rebuilt and an unchanged one is not.  All missing
libraries build at once, one nvcc process per source; a source with a line
``// BUILD_PARTS n`` is compiled as n translation units at once (``-c
-DBUILD_PART=0`` .. ``n - 1``, the source picking what each holds) and
then linked.  A failed build raises with nvcc's output.  Nothing here runs
at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_PARTS = re.compile(rb"^// BUILD_PARTS (\d+)$", re.M)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels need the "
                           "CUDA toolkit")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}.{h.hexdigest()[:16]}.so"


def _parts(name: str) -> int:
    """Translation units of ``csrc/<name>.cu`` (its ``// BUILD_PARTS n``
    line, else 1)."""
    m = _PARTS.search((CSRC / f"{name}.cu").read_bytes())
    return int(m.group(1)) if m else 1


def sources() -> list:
    """Kernel names, one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, str]:
    """Build every kernel library that is missing; returns ``{name: nvcc
    output}`` for those built now (ptxas register and shared-memory
    report included)."""
    todo = [n for n in sources() if not _target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objects = [f for f in NVCC_FLAGS if f != "-shared"] + ["-c"]
    procs = {}
    for name in todo:
        tmp = _target(name).with_suffix(f".tmp{os.getpid()}")
        src = str(CSRC / f"{name}.cu")
        n = _parts(name)
        cmds = ([[nvcc, *NVCC_FLAGS, "-o", str(tmp), src]] if n == 1 else
                [[nvcc, *objects, f"-DBUILD_PART={i}", "-o", f"{tmp}.{i}.o",
                  src] for i in range(n)])
        procs[name] = (tmp, n, [subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for cmd in cmds])
    logs, failed = {}, []
    for name, (tmp, n, running) in procs.items():
        logs[name] = "".join(proc.communicate()[0] for proc in running)
        ok = not any(proc.returncode for proc in running)
        if ok and n > 1:
            objs = [f"{tmp}.{i}.o" for i in range(n)]
            link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                                   str(tmp), *objs],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            logs[name] += link.stdout
            ok = link.returncode == 0
            for obj in objs:
                Path(obj).unlink(missing_ok=True)
        if not ok:
            failed.append(name)
        else:
            os.replace(tmp, _target(name))   # atomic: no half-written .so
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        build_all()
        lib = ctypes.CDLL(str(_target(name)))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def check_launch(name: str, rc: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc:
        msg = library(name).error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
