"""Build the port's CUDA kernels from the package's own sources.

Each ``csrc/*.cu`` file compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  Libraries go to ``build/`` beside this file, named
by a hash of the source, every ``csrc/*.cuh`` header and the flags, so an
edited source or header rebuilds and an unchanged one is reused.  Nothing
links against ``libcuda``: the TMA tensor maps' encoder,
``cuTensorMapEncodeTiled``, is looked up at run time through the CUDA
runtime's ``cudaGetDriverEntryPointByVersion`` (``csrc/hopper.cuh``).
``build_all()`` starts one ``nvcc`` per source at once and waits for all
of them; ``load()`` builds on first use.

Nothing here runs at import: the CPU tests import this module on machines
that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "build")

#: kernel library name -> source file under csrc/
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu",
           "remote_copy": "remote_copy.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo"]

_BUILD_TIMEOUT_S = 600


class _Registry:
    """Loaded libraries and the build log of this process."""

    def __init__(self):
        self.lock = threading.Lock()
        self.libs: Dict[str, ctypes.CDLL] = {}
        self.log: Dict[str, Dict] = {}


_REG = _Registry()


#: where nvcc is looked for after $CUDA_HOME/bin and before PATH
NVCC_DEFAULTS = ("/usr/local/cuda/bin/nvcc",)


def nvcc_path() -> str:
    cands = list(NVCC_DEFAULTS)
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for cand in cands:
        if os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are built from source on first use")


def _lib_path(name: str) -> str:
    csrc = os.path.join(_HERE, "csrc")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in [SOURCES[name], *sorted(f for f in os.listdir(csrc)
                                         if f.endswith(".cuh"))]:
        with open(os.path.join(csrc, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all(names: List[str] = None) -> Dict[str, Dict]:
    """Compile every named kernel library that is not built yet, all nvcc
    processes started together.  Returns the build log per library:
    seconds, whether it was cached, and the ptxas report.  Raises with
    the compiler's output when a build fails."""
    names = list(SOURCES) if names is None else names
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            _REG.log.setdefault(name, {"seconds": 0.0, "cached": True,
                                       "ptxas": "", "path": out})
            continue
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(_HERE, "csrc", SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        try:
            text, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            errors.append(f"{name}: nvcc timed out\n{text}")
            continue
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)
        _REG.log[name] = {"seconds": time.perf_counter() - t0,
                          "cached": False, "ptxas": text, "path": out}
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return {n: _REG.log[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built on first use."""
    with _REG.lock:
        lib = _REG.libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_REG.log[name]["path"])
            _REG.libs[name] = lib
        return lib
