"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). All sources compile in parallel, one ``nvcc`` each. The
libraries land in ``build/kernels/<hash>/`` under the repository root,
keyed by a hash of every source and header plus the compiler flags, so
an edited kernel never loads a stale library. Nothing here runs at
import time: the CPU-only test machines import this module without a
CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "kernels"
KERNELS = ("micro_attn_decode", "micro_attn_prefill", "flash_prefill")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# Loaded libraries of this process, by kernel name.
_LOADED: Dict[str, ctypes.CDLL] = {}


def source_hash() -> str:
    """Hash of every CUDA source and header plus the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """Directory holding the libraries built from the current sources."""
    return BUILD_ROOT / source_hash()


def find_nvcc() -> str:
    """Path of ``nvcc``; raises when no CUDA toolkit is installed."""
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def build(names: Sequence[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, in parallel.

    Returns ``{name: library path}``. The compiler's ``-Xptxas=-v``
    report (registers, shared memory, spills) is kept beside each
    library as ``<name>.log``. Raises RuntimeError with the compiler's
    output if any build fails.
    """
    out_dir = build_dir()
    libs = {n: out_dir / f"lib{n}.so" for n in names}
    todo = [n for n in names if not libs[n].exists()]
    if not todo:
        return libs
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = out_dir / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, libs[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return libs


def load(name: str, fn_name: str, argtypes) -> ctypes.CDLL:
    """Load (building first if needed) kernel ``name``'s library and
    declare ``fn_name``'s C signature; returns the library."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
