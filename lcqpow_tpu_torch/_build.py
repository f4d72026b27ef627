"""Build and load the port's CUDA kernels: ``nvcc`` into shared libraries
with a plain C interface, loaded with ``ctypes``.

Each library is built from the package's ``csrc/`` sources at its first use
in a process, into ``build/lcqpow_tpu_torch/<hash>/lib<name>.so`` under the
checkout (``build/`` is git-ignored), where the hash covers the sources and
the flags, so a changed source is rebuilt and an unchanged one is reused.
Beside each library, ``lib<name>.log`` keeps nvcc's output, with ptxas's
registers and spills of every kernel (``-Xptxas -v``).
The libraries' ``nvcc`` processes start together.  No PyTorch header is
compiled: a source with a plain C interface builds in seconds, where one
that includes ``torch/extension.h`` takes minutes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "lcqpow_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

#: Library name -> its sources under ``csrc/``.
LIBRARIES = {"gj": ["gj_inverse.cu"], "threefry": ["threefry.cu"],
             "matvec": ["matvec.cu"]}

_lock = threading.Lock()
_loaded: dict = {}
#: Seconds the last :func:`build_all` spent compiling (0.0 if cached).
last_build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels of lcqpow_tpu_torch "
                       "are built on the machine with the card")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in LIBRARIES[name]:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build_all() -> dict:
    """Compile every library that is not built yet, all ``nvcc`` processes
    at once.  Returns name -> path; raises with nvcc's output on failure."""
    global last_build_seconds
    t0 = time.perf_counter()
    paths = {name: _lib_path(name) for name in LIBRARIES}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    procs = {}
    for name, path in todo.items():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / s) for s in LIBRARIES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc for lib{name}.so failed "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            paths[name].with_suffix(".log").write_text(log)
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    last_build_seconds = time.perf_counter() - t0 if todo else 0.0
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built on first use).  The caller
    declares the argument and return types of the C functions it calls."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _loaded[name] = lib
        return lib
