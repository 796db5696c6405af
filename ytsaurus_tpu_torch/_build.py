"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` is a file with a plain C interface. At first use it is
compiled for Hopper (`sm_90a`) into a shared library under `_build/`, named
by a hash of its source, the `csrc/*.cuh` headers and the flags, so a
changed source builds anew and an unchanged one is loaded as it is.
`load_all` builds several sources with one nvcc each, all at once. Nothing
is built when the package is imported: the CPU, where there is no nvcc,
never reaches this module's `load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

from ytsaurus_tpu_torch.errors import EErrorCode, YtError

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when the library was already built),
#          "log": nvcc's output, with ptxas's register and memory report}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise YtError("nvcc was not found: the CUDA kernels of ytsaurus_tpu_torch "
                  "build only where the CUDA toolkit is installed",
                  code=EErrorCode.InvalidConfig)


def library_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` lives: named by a hash of the
    source, the headers beside it and the flags."""
    digest = hashlib.sha256()
    for part in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def load_all(names) -> dict[str, ctypes.CDLL]:
    """The shared library of each `csrc/<name>.cu`, building first every
    source that has not been built yet, with one nvcc process each, all
    started together."""
    with _lock:
        started = {}
        for name in names:
            if name in _loaded or name in started:
                continue
            out = library_path(name)
            if out.exists():
                build_info[name] = {"seconds": 0.0, "log": ""}
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            started[name] = (proc, tmp, out, time.perf_counter())
        failed = []
        for name, (proc, tmp, out, t0) in started.items():
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed to build {name}.cu:\n{log}")
                continue
            os.replace(tmp, out)
            build_info[name] = {"seconds": seconds, "log": log}
        if failed:
            raise YtError("\n".join(failed), code=EErrorCode.InvalidConfig)
        for name in names:
            if name not in _loaded:
                _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return {name: _loaded[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The shared library built from `csrc/<name>.cu`, building it first
    if this source has not been built yet."""
    return load_all([name])[name]


def function(name: str, symbol: str, argtypes: list):
    """The C function `symbol` of `csrc/<name>.cu`, typed with `argtypes`
    and returning an int (a cudaError_t)."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
