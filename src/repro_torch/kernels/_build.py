"""Build ``csrc/*.cu`` with ``nvcc`` at first use and load them with ctypes.

Each source becomes its own shared library with a plain C interface
(pointers and the stream as ``void*``; every entry returns the
``cudaError_t`` of its launch). Libraries land in ``build/repro_torch/``
at the repo root (git-ignored), named by a hash of the source and the
flags, so an edit to a source forces its rebuild and an unchanged source
is never rebuilt. ``build()`` starts one ``nvcc`` per missing library, all
at once, and waits for them together.

Nothing here runs at import time: the CPU tests import every module, and
this host may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("banked_bag", "cache_bag", "ct_scatter", "dot_interaction",
           "tiered_bag")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_functions: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    """The nvcc of the CUDA toolkit that PyTorch found (CUDA_HOME), else
    the one on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first use and need the CUDA toolkit")
    return found


def target(name: str) -> Path:
    """Path of the library for ``csrc/<name>.cu`` at its current contents."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, all nvcc
    processes in parallel. Returns ``{name: compiler output}`` for the ones
    compiled (ptxas register/shared-memory report included). Raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not target(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = target(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        logs[n] = out
        if p.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {p.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target(n))    # atomic: readers never see a stub
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of library ``name`` (built and loaded on
    first use), with its argument types declared and an int (cudaError_t)
    result."""
    key = f"{name}:{symbol}"
    if key not in _functions:
        if name not in _loaded:
            build((name,))
            _loaded[name] = ctypes.CDLL(str(target(name)))
        fn = getattr(_loaded[name], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[key] = fn
    return _functions[key]


def check(name: str, err: int, what: str) -> None:
    """Raise if a launch of library ``name`` returned a CUDA error code;
    the message carries ``cudaGetErrorString`` (each library exports it as
    ``<name>_error_string``)."""
    if err != 0:
        fn = getattr(_loaded[name], f"{name}_error_string")
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA launch failed: cudaError_t {err} "
                           f"({fn(err).decode()})")
